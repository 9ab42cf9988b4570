"""The plain reference of the 'cycle' training step: the TransformerNet, VGG16's taps, the
Grams, the content and style losses, autograd's backward and Adam with L2 weight decay,
written out by hand (torch's ``Adam(weight_decay=)`` semantics: the decay folded into the
gradient, eps outside the square root, bias corrections on the step size).

The style targets and the content features are worked out here again from the images,
with this module's own VGG16.
"""

from __future__ import annotations

import torch

from reference import nets


def cycle_targets(vgg_p: dict, paintings: torch.Tensor, chunk: int = 8) -> dict:
    """{tap: (P, C, C)} Grams of every painting (NHWC BGR [0, 255] f32)."""
    out: dict[str, list] = {}
    with torch.no_grad():
        for i in range(0, paintings.shape[0], chunk):
            for k, f in nets.vgg16(vgg_p, paintings[i:i + chunk]).items():
                out.setdefault(k, []).append(nets.gram(f))
    return {k: torch.cat(v) for k, v in out.items()}


def content_features(vgg_p: dict, images: torch.Tensor, chunk: int = 16) -> torch.Tensor:
    with torch.no_grad():
        return torch.cat([nets.vgg16(vgg_p, images[i:i + chunk], just_content=True)
                          for i in range(0, images.shape[0], chunk)])


def losses(t_p: dict, vgg_p: dict, batch, content_r22, grams: dict, step: int, job: dict,
           rows: int | None = None):
    """(content, style, total) of one step; ``rows`` keeps only the first rows of the
    batch (a fault the check must catch)."""
    if rows is not None:
        batch, content_r22 = batch[:rows], content_r22[:rows]
    gen = nets.transformer(t_p, batch)
    feats = nets.vgg16(vgg_p, gen)
    idx = step % next(iter(grams.values())).shape[0]
    style = sum((nets.gram(f) - grams[k][idx]).square().mean() for k, f in feats.items())
    content = (feats["relu2_2"] - content_r22).square().mean()
    c, s = job["content_weight"] * content, job["style_weight"] * style
    return c, s, c + s


def three_steps(t_p: dict, vgg_p: dict, content: torch.Tensor, paintings: torch.Tensor,
                perm: torch.Tensor, job: dict, steps: int = 3) -> dict:
    """The first ``steps`` steps from the weights ``t_p``: each step's losses, the first
    step's gradients, and every parameter's change after the last step."""
    grams = cycle_targets(vgg_p, paintings)
    r22 = content_features(vgg_p, content)
    params = {k: v.detach().clone().requires_grad_(True) for k, v in t_p.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    b1, b2 = job["betas"]
    lr, wd, eps, bsz = job["lr"], job["weight_decay"], job["eps"], job["batch"]
    out = {"losses": [], "grad": None}
    for t in range(steps):
        idx = perm[t * bsz:(t + 1) * bsz].to(content.device)
        c, s, total = losses(params, vgg_p, content.index_select(0, idx),
                             r22.index_select(0, idx), grams, t, job, job.get("rows"))
        grads = torch.autograd.grad(total, list(params.values()))
        out["losses"].append(torch.stack([c, s, total]).detach().double().cpu())
        with torch.no_grad():
            if t == 0:
                out["grad"] = {k: g.detach().clone() for k, g in zip(params, grads)}
            for (k, p), g in zip(params.items(), grads):
                g = g + wd * p
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v2[k].sqrt() / (1 - b2 ** (t + 1)) ** 0.5).add_(eps)
                p.addcdiv_(m[k], denom, value=-lr / (1 - b1 ** (t + 1)))
    out["delta"] = {k: (params[k] - t_p[k]).detach() for k in params}
    return out
