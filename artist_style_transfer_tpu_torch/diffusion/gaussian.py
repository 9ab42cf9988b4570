"""Gaussian diffusion process: schedules, q-sampling, posterior (counterpart of the JAX
``diffusion/gaussian.py``).

Standard DDPM (Ho et al. 2020) with the linear beta schedule used by guided diffusion,
or the cosine one (Nichol & Dhariwal 2021). The tables are computed in numpy f64 and
cast to f32, as JAX computes them, so they are bit-equal to JAX's; they live as (T,)
f32 tensors on one device and are gathered by timestep.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _extract(arr: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Gather per-timestep coefficients and broadcast them to image rank."""
    out = arr[t]
    return out.reshape(out.shape + (1,) * (ndim - out.dim()))


@dataclasses.dataclass(frozen=True)
class GaussianDiffusion:
    """Precomputed diffusion coefficients for T steps, ten (T,) f32 tensors on one device."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]

    def to(self, device: str | torch.device) -> GaussianDiffusion:
        """The same tables on ``device`` (``self`` when they are there already)."""
        return GaussianDiffusion(**{f.name: getattr(self, f.name).to(device)
                                    for f in dataclasses.fields(self)})

    @staticmethod
    def make(
        num_timesteps: int = 1000,
        beta_start: float = 1e-4,
        beta_end: float = 0.02,
        schedule: str = "linear",
        device: str | torch.device = "cpu",
    ) -> GaussianDiffusion:
        """Coefficient tables for T steps on ``device`` (JAX ``GaussianDiffusion.make``).

        ``schedule``: 'linear' (DDPM) or 'cosine' (improved DDPM: alpha-bar follows
        cos^2((t/T + s)/(1 + s) * pi/2), s = 0.008, betas clipped at 0.999).
        """
        if schedule == "cosine":
            s = 0.008
            steps = np.arange(num_timesteps + 1, dtype=np.float64)
            f = np.cos((steps / num_timesteps + s) / (1.0 + s) * np.pi / 2.0) ** 2
            acp_full = f / f[0]
            betas = np.clip(1.0 - acp_full[1:] / acp_full[:-1], 0.0, 0.999)
        elif schedule == "linear":
            betas = np.linspace(beta_start, beta_end, num_timesteps, dtype=np.float64)
        else:
            raise ValueError(f"unknown schedule {schedule!r}")
        alphas = 1.0 - betas
        acp = np.cumprod(alphas)
        acp_prev = np.append(1.0, acp[:-1])
        post_var = betas * (1.0 - acp_prev) / (1.0 - acp)
        # log-variance clipped at t=0 as in DDPM (variance 0 there)
        post_logvar = np.log(np.append(post_var[1], post_var[1:]))

        def f32(a):
            return torch.from_numpy(np.asarray(a, np.float32)).to(device)

        return GaussianDiffusion(
            betas=f32(betas),
            alphas_cumprod=f32(acp),
            sqrt_alphas_cumprod=f32(np.sqrt(acp)),
            sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - acp)),
            sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / acp)),
            sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / acp - 1.0)),
            posterior_variance=f32(post_var),
            posterior_log_variance=f32(post_logvar),
            posterior_mean_coef1=f32(betas * np.sqrt(acp_prev) / (1.0 - acp)),
            posterior_mean_coef2=f32((1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp)),
        )

    def q_sample(self, x0: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """Forward process: x_t = sqrt(acp_t) x0 + sqrt(1-acp_t) eps."""
        return (
            _extract(self.sqrt_alphas_cumprod, t, x0.dim()) * x0
            + _extract(self.sqrt_one_minus_alphas_cumprod, t, x0.dim()) * noise
        )

    def predict_x0_from_eps(self, x_t: torch.Tensor, t: torch.Tensor,
                            eps: torch.Tensor) -> torch.Tensor:
        return (
            _extract(self.sqrt_recip_alphas_cumprod, t, x_t.dim()) * x_t
            - _extract(self.sqrt_recipm1_alphas_cumprod, t, x_t.dim()) * eps
        )

    def q_posterior_mean(self, x0: torch.Tensor, x_t: torch.Tensor,
                         t: torch.Tensor) -> torch.Tensor:
        return (
            _extract(self.posterior_mean_coef1, t, x0.dim()) * x0
            + _extract(self.posterior_mean_coef2, t, x0.dim()) * x_t
        )
