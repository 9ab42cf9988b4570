"""Diffusion training: the epsilon-prediction MSE over artist-labelled paintings
(counterpart of the JAX ``diffusion/train.py``).

The standard DDPM objective on the painting corpus, resident on the device, in eager
steps (:func:`diffusion_step`) over a seeded permutation an epoch, with Adam and an
exponential moving average of the weights taken after every step. JAX runs an epoch as
one jitted ``lax.scan`` and draws t and the noise from ``jax.random``; here they come
from a ``torch.Generator`` on the device, seeded from (seed + 1, epoch), and the
keyword-only ``perms=`` and ``draws=`` take given permutations and draws instead (the
tests feed JAX's through them).

``mesh`` trains data-parallel on the port's DP pattern: every rank gathers and draws
the same global batch and runs its slice; one all-reduce a step averages the gradients
and the loss, so every rank holds the same model. A ('data', 'space') mesh (JAX's
``P("data", "space")``) also spreads each image's rows over the 'space' ranks: each rank
takes its rows of its slice's images and of their noise, runs the UNet on them
(``DiffModel.forward_rows``), and the loss is the whole slice's MSE, the bands' sums
of squares summed over the 'space' line; each rank's gradient is the part from its
rows, which the sync sums over every rank and divides by the number of data slices.
The ranks must divide the images' height.
"""

from __future__ import annotations

import copy
import time

import numpy as np
import torch

from artist_style_transfer_tpu_torch.diffusion.gaussian import GaussianDiffusion
from artist_style_transfer_tpu_torch.diffusion.unet import (
    DiffModel,
    diff_model_apply,
    init_diff_model,
)
from artist_style_transfer_tpu_torch.parallel.distributed import make_global
from artist_style_transfer_tpu_torch.parallel.mesh import (
    Mesh,
    check_mesh,
    shard_batch,
    spatial_size,
)
from artist_style_transfer_tpu_torch.parallel.spatial import RowBands, row_sum
from artist_style_transfer_tpu_torch.train.loop import epoch_permutation, sync_gradients
from artist_style_transfer_tpu_torch.utils.device import resolve_device, same_device
from artist_style_transfer_tpu_torch.utils.logging import MetricLogger


def diffusion_step(
    model: DiffModel,
    optimizer: torch.optim.Optimizer,
    diffusion: GaussianDiffusion,
    x0: torch.Tensor,
    y: torch.Tensor,
    t: torch.Tensor,
    noise: torch.Tensor,
    ema: DiffModel | None = None,
    ema_decay: float | None = None,
    mesh: Mesh | None = None,
    bands: RowBands | None = None,
) -> torch.Tensor:
    """One Adam step on the eps MSE of the batch ``x0`` ([-1, 1] NHWC) with classes ``y``
    at timesteps ``t`` with ``noise``; then ``ema = ema * d + params * (1 - d)``. Under
    ``mesh`` the arguments are this rank's slice and the gradients and loss are averaged
    over the ranks; with ``bands`` (over the mesh's 'space' line) ``x0`` and ``noise``
    are this rank's band of the slice's rows, and the loss the slice's whole MSE.
    Returns the (mean) loss, a 0-d tensor on the device."""
    x_t = diffusion.q_sample(x0, t, noise)
    if bands is None:
        loss = (diff_model_apply(model, x_t, t, y) - noise).square().mean()
    else:
        xc = x_t.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        eps, _ = model.forward_rows(xc, t, y, bands)
        count = x0.shape[0] * bands.height * x0.shape[2] * x0.shape[3]
        loss = row_sum((eps.permute(0, 2, 3, 1) - noise).square(), bands) / count
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    loss = loss.detach()
    if mesh is not None:
        loss = sync_gradients(list(model.parameters()), loss[None], mesh, sharded=True)[0]
    optimizer.step()
    if ema is not None:
        with torch.no_grad():
            e, p = list(ema.parameters()), list(model.parameters())
            torch._foreach_mul_(e, ema_decay)
            torch._foreach_add_(e, torch._foreach_mul(p, 1.0 - ema_decay))
    return loss


def _epoch_generator(seed: int, epoch: int, dev: torch.device) -> torch.Generator:
    key = int(np.random.SeedSequence([seed + 1, epoch]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=dev).manual_seed(key)


def train_diffusion(
    images_bgr_255,
    labels,
    *,
    num_classes: int = 19,
    num_timesteps: int = 1000,
    num_epochs: int = 10,
    batch_size: int = 16,
    lr: float = 1e-4,
    seed: int = 0,
    base_channels: int = 64,
    mesh: Mesh | None = None,
    params: DiffModel | None = None,
    wordy: bool = True,
    schedule: str = "linear",
    ema_decay: float | None = 0.999,
    device: str | torch.device | None = None,
    perms=None,
    draws=None,
) -> tuple[DiffModel, GaussianDiffusion, np.ndarray]:
    """Train the UNet on ``device`` (``None``: CUDA); returns ``(model, diffusion,
    losses)`` with the per-epoch mean losses in f64 (JAX ``train_diffusion``).

    ``images_bgr_255``: (N, H, W, 3) BGR [0,255]; ``labels``: (N,) class ids. ``params``
    is a starting :class:`DiffModel` (copied; the caller's stays as it is), else
    :func:`init_diff_model` with ``seed``. The returned model holds the EMA weights
    (``ema_decay=None``: the raw ones); the EMA starts from the initial weights. An
    epoch is ``N // batch_size`` steps (the last partial batch dropped) over
    :func:`train.loop.epoch_permutation`, or over ``perms[epoch]`` where given;
    ``draws[epoch][step]`` is the step's ``(t, noise)`` for the global batch where
    given. ``mesh``: data-parallel over its ranks, and with a 'space' axis on row bands
    (the module docstring); its size must divide ``batch_size``, and only rank 0 logs.
    """
    check_mesh(mesh)
    dev = resolve_device(device)
    if mesh is not None:
        if batch_size % mesh.size:
            raise ValueError(f"batch_size ({batch_size}) must divide over the "
                             f"{mesh.size}-rank mesh")
        if not same_device(mesh.device, dev):
            raise ValueError(f"the mesh's device is {mesh.device}, not {dev}")
    writer = mesh is None or mesh.rank == 0
    log = MetricLogger(None, stdout=wordy and writer)
    diffusion = GaussianDiffusion.make(num_timesteps, schedule=schedule, device=dev)
    if params is None:
        model = init_diff_model(num_classes, base_channels,
                                generator=torch.Generator().manual_seed(seed), device=dev)
    else:
        model = copy.deepcopy(params).to(dev)
    make_global(mesh, model)

    data = torch.as_tensor(np.asarray(images_bgr_255, np.float32)).to(dev) / 127.5 - 1.0
    y_all = torch.as_tensor(np.asarray(labels), dtype=torch.int64).to(dev)
    n = data.shape[0]
    steps_per_epoch = n // batch_size
    bands = None
    if spatial_size(mesh) > 1:
        if data.shape[1] % 4 or data.shape[2] % 4:
            raise ValueError(f"the UNet needs H, W divisible by 4, got {tuple(data.shape[1:3])}")
        bands = RowBands.even(mesh.axis_mesh("space"), data.shape[1])
    if steps_per_epoch == 0:
        raise ValueError("fewer images than batch_size")

    optimizer = torch.optim.Adam(model.parameters(), lr=lr)  # optax.adam's defaults
    ema = copy.deepcopy(model) if ema_decay is not None else None
    losses = np.zeros((num_epochs,), np.float64)
    for epoch in range(num_epochs):
        t0 = time.time()
        perm = (epoch_permutation(seed, epoch, n) if perms is None
                else torch.from_numpy(np.array(perms[epoch], np.int64))).to(dev)
        gen = _epoch_generator(seed, epoch, dev) if draws is None else None
        step_losses = []
        for i in range(steps_per_epoch):
            idx = perm[i * batch_size: (i + 1) * batch_size]
            x0, y = data[idx], y_all[idx]
            if draws is None:
                t = torch.randint(0, num_timesteps, (batch_size,), generator=gen, device=dev)
                noise = torch.randn(x0.shape, generator=gen, device=dev)
            else:
                t, noise = (torch.from_numpy(np.array(a)).to(dev) for a in draws[epoch][i])
                t, noise = t.to(torch.int64), noise.to(torch.float32)
            x0, y, t, noise = (shard_batch(a, mesh) for a in (x0, y, t, noise))
            if bands is not None:
                a, b = bands.bounds()
                x0, noise = x0[:, a:b], noise[:, a:b]
            step_losses.append(diffusion_step(model, optimizer, diffusion, x0, y, t, noise,
                                              ema=ema, ema_decay=ema_decay, mesh=mesh,
                                              bands=bands))
        losses[epoch] = float(torch.stack(step_losses).mean())
        log.log("diffusion_epoch", epoch=epoch + 1, loss=losses[epoch],
                secs=round(time.time() - t0, 2))
    return (ema if ema is not None else model), diffusion, losses
