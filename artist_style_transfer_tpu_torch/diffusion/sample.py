"""Class-conditional sampling with classifier guidance: DDPM, DDIM and DPM-Solver++(2M)
(counterpart of the JAX ``diffusion/sample.py``).

The reverse mean is shifted by the gradient of the artist classifier's log-probability
(Dhariwal & Nichol classifier guidance). The ResNet-50 is a clean-image classifier, so
the gradient is taken through the predicted x0 (the x_hat0 trick), and the frozen
classifier of 'classifier' training mode supplies the guidance as it is.

JAX runs the reverse loop as one ``lax.scan``; here it is a Python loop under
``torch.no_grad()``, the guidance gradient excepted. Randomness comes from an explicit
``torch.Generator`` (drawn on its own device, then moved); the keyword-only ``x_T=``
and ``noise=`` take given draws instead, which is how the tests feed JAX's, since torch
cannot reproduce ``jax.random``. Every sampler returns NHWC BGR [0, 255] f32 on the
model's device.
"""

from __future__ import annotations

import numpy as np
import torch

from artist_style_transfer_tpu_torch.diffusion.gaussian import GaussianDiffusion, _extract
from artist_style_transfer_tpu_torch.diffusion.unet import DiffModel, diff_model_apply
from artist_style_transfer_tpu_torch.models.resnet import ResNet50Classifier
from artist_style_transfer_tpu_torch.ops.image import bgr_to_rgb, torchvision_normalize
from artist_style_transfer_tpu_torch.utils.device import module_device, resolve_device, same_device


def _classifier_logprob_grad(classifier: ResNet50Classifier, x0_pm1: torch.Tensor,
                             y: torch.Tensor) -> torch.Tensor:
    """grad_x sum_i log p(y_i | x0_i), where x0 is NHWC BGR in [-1, 1]. The classifier
    stays frozen: only the input carries a gradient."""
    with torch.enable_grad():
        x = x0_pm1.detach().requires_grad_(True)
        # [-1,1] BGR -> RGB [0,1] -> torchvision stats, as 'classifier' mode does
        logits = classifier(torchvision_normalize(bgr_to_rgb((x + 1.0) * 0.5)))
        lp = torch.log_softmax(logits, dim=-1)
        (grad,) = torch.autograd.grad(lp.gather(-1, y[:, None]).sum(), x)
    return grad


def _setup(model: DiffModel, diffusion: GaussianDiffusion, generator, y, shape,
           classifier, classifier_y, x_T, device):
    """The device, the tables and labels on it, and x_T (given, or drawn)."""
    dev = resolve_device(device)
    if not same_device(module_device(model), dev):
        raise ValueError(f"model is on {module_device(model)}, not on {dev}")
    if classifier is not None and not same_device(module_device(classifier), dev):
        raise ValueError(f"classifier is on {module_device(classifier)}, not on {dev}")
    y = torch.as_tensor(y, dtype=torch.int64).to(dev)
    cy = y if classifier_y is None else torch.as_tensor(classifier_y, dtype=torch.int64).to(dev)
    n, (h, w) = y.shape[0], shape
    if x_T is None:
        x = _normal(generator, (n, h, w, 3), dev)
    else:
        x = _f32(x_T, dev)
        if tuple(x.shape) != (n, h, w, 3):
            raise ValueError(f"x_T has shape {tuple(x.shape)}, not {(n, h, w, 3)}")
    return dev, diffusion.to(dev), y, cy, x


def _f32(a, dev: torch.device) -> torch.Tensor:
    """A given draw (a tensor or an array) as f32 on ``dev``."""
    t = a if torch.is_tensor(a) else torch.from_numpy(np.array(a, np.float32))
    return t.to(dev, torch.float32)


def _normal(generator: torch.Generator | None, shape, dev: torch.device) -> torch.Tensor:
    if generator is None:
        raise ValueError("a generator is needed where no draws are given")
    return torch.randn(shape, generator=generator, device=generator.device).to(dev)


def _step_noise(noise, k: int, generator, like: torch.Tensor) -> torch.Tensor:
    """The k-th step's draw: ``noise[k]`` when a stack was given, else a fresh one."""
    if noise is not None:
        return _f32(noise[k], like.device)
    return _normal(generator, like.shape, like.device)


def _to_image(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> BGR [0, 255]."""
    return torch.clamp((x + 1.0) * 127.5, 0.0, 255.0)


def _guided(classifier, guidance_scale: float) -> bool:
    return classifier is not None and guidance_scale > 0.0


def diff_sample(
    model: DiffModel,
    diffusion: GaussianDiffusion,
    generator: torch.Generator | None,
    y,
    shape: tuple[int, int] = (64, 64),
    classifier: ResNet50Classifier | None = None,
    guidance_scale: float = 0.0,
    clip_x0: bool = True,
    classifier_y=None,
    *,
    x_T=None,
    noise=None,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """Class-conditional DDPM over all T steps (JAX ``diff_sample``).

    ``y`` indexes the diffusion model's own class embedding (the training corpus's
    label space); ``classifier_y`` indexes the guidance classifier's (the 19 artists of
    ``best-2.pth``) and defaults to ``y``. ``model`` (and ``classifier``) must live on
    ``device`` (``None``: CUDA). ``x_T``: the initial (N, H, W, 3) noise; ``noise``: the
    (T, N, H, W, 3) stack of per-step draws, in the loop's order (t = T-1 first).
    """
    dev, diffusion, y, cy, x = _setup(model, diffusion, generator, y, shape, classifier,
                                      classifier_y, x_T, device)
    n, T = y.shape[0], diffusion.num_timesteps
    with torch.no_grad():
        for k in range(T):
            t = T - 1 - k
            tb = torch.full((n,), t, dtype=torch.int64, device=dev)
            eps = diff_model_apply(model, x, tb, y)
            x0 = diffusion.predict_x0_from_eps(x, tb, eps)
            if clip_x0:
                x0 = torch.clamp(x0, -1.0, 1.0)
            mean = diffusion.q_posterior_mean(x0, x, tb)
            if _guided(classifier, guidance_scale):
                grad = _classifier_logprob_grad(classifier, x0, cy)
                mean = mean + guidance_scale * _extract(
                    diffusion.posterior_variance, tb, x.dim()) * grad
            z = _step_noise(noise, k, generator, x)
            nonzero = float(t > 0)
            logvar = _extract(diffusion.posterior_log_variance, tb, x.dim())
            x = mean + nonzero * torch.exp(0.5 * logvar) * z
    return _to_image(x)


def timestep_subsequence(T: int, steps: int) -> np.ndarray:
    """The ascending subsequence of ``min(steps, T)`` timesteps over [0, T-1], endpoints
    included, that DDIM and DPM++ walk in reverse (rounding may merge a few)."""
    return np.unique(np.linspace(0, T - 1, num=min(steps, T)).round().astype(np.int64))


def ddim_pairs(T: int, steps: int) -> np.ndarray:
    """DDIM's (t, t_prev) pairs, noisiest first; the last t_prev is -1."""
    ts = timestep_subsequence(T, steps)
    return np.stack([ts, np.concatenate(([-1], ts[:-1]))], axis=1)[::-1].copy()


def diff_sample_ddim(
    model: DiffModel,
    diffusion: GaussianDiffusion,
    generator: torch.Generator | None,
    y,
    shape: tuple[int, int] = (64, 64),
    steps: int = 50,
    eta: float = 0.0,
    classifier: ResNet50Classifier | None = None,
    guidance_scale: float = 0.0,
    clip_x0: bool = True,
    classifier_y=None,
    *,
    x_T=None,
    noise=None,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """DDIM (Song et al. 2021) over a ``steps``-long timestep subsequence (JAX
    ``diff_sample_ddim``): ``eta=0`` is the deterministic ODE (the only randomness is
    x_T), ``eta=1`` DDPM-like noise on the subsequence. Guidance folds into eps before
    the x0/direction split. ``noise``: for ``eta > 0``, the (steps, N, H, W, 3) stack of
    per-step draws; at ``eta=0`` nothing is drawn after x_T.
    """
    dev, diffusion, y, cy, x = _setup(model, diffusion, generator, y, shape, classifier,
                                      classifier_y, x_T, device)
    n = y.shape[0]
    acp = diffusion.alphas_cumprod
    one = torch.ones((), dtype=torch.float32, device=dev)
    with torch.no_grad():
        for k, (t, t_prev) in enumerate(ddim_pairs(diffusion.num_timesteps, steps).tolist()):
            tb = torch.full((n,), t, dtype=torch.int64, device=dev)
            a_t = acp[t]
            a_prev = acp[t_prev] if t_prev >= 0 else one
            eps = diff_model_apply(model, x, tb, y)
            x0 = diffusion.predict_x0_from_eps(x, tb, eps)
            if clip_x0:
                x0 = torch.clamp(x0, -1.0, 1.0)
            if _guided(classifier, guidance_scale):
                grad = _classifier_logprob_grad(classifier, x0, cy)
                eps = eps - guidance_scale * torch.sqrt(1.0 - a_t) * grad
                x0 = diffusion.predict_x0_from_eps(x, tb, eps)
                if clip_x0:
                    x0 = torch.clamp(x0, -1.0, 1.0)
            # eps consistent with the (clipped, guided) x0
            eps_hat = (x - torch.sqrt(a_t) * x0) / torch.sqrt(1.0 - a_t)
            sigma = (eta * torch.sqrt((1.0 - a_prev) / (1.0 - a_t))
                     * torch.sqrt(torch.clamp(1.0 - a_t / a_prev, min=0.0)))
            direction = torch.sqrt(torch.clamp(1.0 - a_prev - sigma**2, min=0.0)) * eps_hat
            x = torch.sqrt(a_prev) * x0 + direction
            if eta > 0.0 and t_prev >= 0:
                x = x + sigma * _step_noise(noise, k, generator, x)
    return _to_image(x)


def diff_sample_dpmpp(
    model: DiffModel,
    diffusion: GaussianDiffusion,
    generator: torch.Generator | None,
    y,
    shape: tuple[int, int] = (64, 64),
    steps: int = 20,
    classifier: ResNet50Classifier | None = None,
    guidance_scale: float = 0.0,
    clip_x0: bool = True,
    classifier_y=None,
    *,
    x_T=None,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """DPM-Solver++(2M) (Lu et al. 2022) in the data-prediction form (JAX
    ``diff_sample_dpmpp``), one model evaluation a step. With lambda_t = log(alpha_t /
    sigma_t), h_i = lambda_i - lambda_{i-1} and r = h_{i-1} / h_i:

        D_i = (1 + 1/(2r)) x0_i - 1/(2r) x0_{i-1}          (first step: x0_i)
        x_i = (sigma_i / sigma_{i-1}) x_{i-1} - alpha_i (e^{-h_i} - 1) D_i

    The last step targets t = 0, where sigma_0 = sqrt(beta_0) is the schedule's tiny
    noise floor. Needs ``steps >= 2``. lambda, alpha and sigma are computed on the
    subsequence in f32, as JAX computes them. Deterministic given x_T.
    """
    if steps < 2:
        raise ValueError(
            f"diff_sample_dpmpp needs steps >= 2 (multistep solver), got {steps}"
        )
    dev, diffusion, y, cy, x = _setup(model, diffusion, generator, y, shape, classifier,
                                      classifier_y, x_T, device)
    n = y.shape[0]
    ts = timestep_subsequence(diffusion.num_timesteps, steps)[::-1].copy()
    acp = diffusion.alphas_cumprod[torch.as_tensor(ts, device=dev)]
    alph = torch.sqrt(acp)
    sig = torch.sqrt(1.0 - acp)
    lam = torch.log(alph / torch.clamp(sig, min=1e-20))

    def predict_x0(x: torch.Tensor, t: int) -> torch.Tensor:
        tb = torch.full((n,), t, dtype=torch.int64, device=dev)
        eps = diff_model_apply(model, x, tb, y)
        x0 = diffusion.predict_x0_from_eps(x, tb, eps)
        if clip_x0:
            x0 = torch.clamp(x0, -1.0, 1.0)
        if _guided(classifier, guidance_scale):
            a_t = diffusion.alphas_cumprod[t]
            grad = _classifier_logprob_grad(classifier, x0, cy)
            eps = eps - guidance_scale * torch.sqrt(1.0 - a_t) * grad
            x0 = diffusion.predict_x0_from_eps(x, tb, eps)
            if clip_x0:
                x0 = torch.clamp(x0, -1.0, 1.0)
        return x0

    with torch.no_grad():
        q_prev = predict_x0(x, int(ts[0]))  # at the noisiest time
        q_prev_prev = None
        for i in range(1, len(ts)):
            h_i = lam[i] - lam[i - 1]
            if q_prev_prev is None:
                d = q_prev  # first-order warm-up step
            else:
                r = (lam[i - 1] - lam[i - 2]) / h_i
                d = (1.0 + 1.0 / (2.0 * r)) * q_prev - (1.0 / (2.0 * r)) * q_prev_prev
            x = (sig[i] / sig[i - 1]) * x - (alph[i] * torch.expm1(-h_i)) * d
            if i < len(ts) - 1:
                q_prev_prev = q_prev
                q_prev = predict_x0(x, int(ts[i]))
    return _to_image(x)
