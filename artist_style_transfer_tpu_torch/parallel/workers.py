"""Rank functions for :func:`parallel.launch.launch`: each runs one entry point of the
port on its rank and returns what a caller compares, as numpy values.

They live here, at module level in the package, so that a spawned rank can import
them by name; the port's multi-rank tests and ``chip_smoke.py`` launch them
(:func:`run_jobs` runs several in one launch). Each takes the :class:`Mesh` that
``launch`` builds first; models cross as modules (pickled), images as numpy
arrays. The functions that run an entry point also report its wall seconds
(ending in a device sync) and the launches of the hand kernels K1 and K2 that
their rank made (0 on the CPU); with ``profile=True``, from ``torch.profiler``,
its device time and the time of its collectives: the host time of the
``gloo:``/``nccl:`` ranges and the device time of NCCL's kernels.
"""

from __future__ import annotations

import contextlib
import copy
import io
import os
import time

import numpy as np
import torch

from artist_style_transfer_tpu_torch.parallel.mesh import Mesh


def _launches() -> dict[str, int]:
    from artist_style_transfer_tpu_torch.ops.cuda import gram_kernel, qconv_kernel

    return {"k1": gram_kernel.LAUNCHES, "k2": qconv_kernel.LAUNCHES}


def _reset_launches() -> None:
    from artist_style_transfer_tpu_torch.ops.cuda import gram_kernel, qconv_kernel

    gram_kernel.LAUNCHES = qconv_kernel.LAUNCHES = 0


@contextlib.contextmanager
def recorded_scales():
    """Inside, every dynamic int8 scale the port takes (:func:`ops.qconv.absmax_scale`:
    the int8 convs' forwards and STE backwards, the int8 Gram's) is appended, as a
    float, to the list this yields, in the order taken."""
    from artist_style_transfer_tpu_torch.ops import gram, qconv

    real, seen = qconv.absmax_scale, []

    def recording(t, mesh=None):
        s = real(t, mesh)
        seen.append(float(s))
        return s

    qconv.absmax_scale = gram.absmax_scale = recording
    try:
        yield seen
    finally:
        qconv.absmax_scale = gram.absmax_scale = real


def _sync(mesh: Mesh) -> None:
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def _timed(mesh: Mesh, fn, profile: bool = False):
    """``fn()``'s result and its stats: ``secs``, ``launches``, and with ``profile``
    ``device_ms``, ``collective_host_ms`` and ``collective_device_ms``."""
    _sync(mesh)
    _reset_launches()
    prof = None
    if profile:
        from torch.profiler import ProfilerActivity, profile as torch_profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if mesh.device.type == "cuda" else [])
        prof = torch_profile(activities=acts)
        prof.start()
    t0 = time.perf_counter()
    try:
        out = fn()
        _sync(mesh)
    finally:
        secs = time.perf_counter() - t0
        if prof is not None:
            prof.stop()
    stats = {"secs": secs, "launches": _launches()}
    if prof is not None:
        from torch.autograd import DeviceType

        events = prof.key_averages()
        dev = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
        stats["device_ms"] = sum(e.self_device_time_total for e in dev) / 1e3
        stats["collective_device_ms"] = sum(e.self_device_time_total for e in dev
                                            if "nccl" in e.key.lower()) / 1e3
        stats["collective_host_ms"] = sum(
            e.cpu_time_total for e in events if e.device_type == DeviceType.CPU
            and e.key.startswith(("gloo:", "nccl:"))) / 1e3
    return out, stats


def run_jobs(mesh: Mesh, jobs: list[tuple]) -> list:
    """``fn(mesh, *args, **kwargs)`` for each ``(fn, args, kwargs)`` of ``jobs``, in order,
    on this rank: several checks in one launch."""
    return [fn(mesh, *args, **kwargs) for fn, args, kwargs in jobs]


def _on(module: torch.nn.Module, device: torch.device) -> torch.nn.Module:
    """``module`` on ``device``: itself when it is there, else a copy (the caller's module,
    in a rank that is the calling process, stays where it is)."""
    from artist_style_transfer_tpu_torch.utils.device import module_device, same_device

    return module if same_device(module_device(module), device) else copy.deepcopy(module).to(device)


def params_numpy(model: torch.nn.Module) -> dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy().copy() for k, v in model.state_dict().items()}


def train_rank(mesh: Mesh, kwargs: dict, stream: dict | None = None,
               profile: bool = False, record_scales: bool = False) -> dict:
    """``train(mesh=mesh, **kwargs)`` on this rank: its per-epoch losses, the trained
    params, the files rank 0 wrote under ``model_dir`` and the time and launches.
    ``stream``: the arguments of a ``content_file_stream`` made on the rank, which
    takes its slice of every batch from the process group. ``record_scales``: also
    every dynamic int8 scale the run took (:func:`recorded_scales`), under "scales"."""
    from artist_style_transfer_tpu_torch.data.stream import content_file_stream
    from artist_style_transfer_tpu_torch.train import train

    if stream is not None:
        kwargs = dict(kwargs, content_stream=content_file_stream(**stream))
    with recorded_scales() if record_scales else contextlib.nullcontext([]) as scales:
        (model, losses), stats = _timed(
            mesh, lambda: train(mesh=mesh, device=mesh.device, **kwargs), profile)
    if record_scales:
        stats["scales"] = np.asarray(scales)
    files = []
    if kwargs.get("model_dir"):
        for root, _, names in os.walk(kwargs["model_dir"]):
            files += [os.path.relpath(os.path.join(root, n), kwargs["model_dir"]) for n in names]
    return {"losses": losses, "params": params_numpy(model), "files": sorted(files), **stats}


def train_cli_rank(mesh: Mesh, argv: list[str]) -> dict:
    """The training CLI with ``--data_parallel`` on this rank (the process group is the
    launcher's; the CLI builds its own mesh over it)."""
    from artist_style_transfer_tpu_torch import train_style_transfer

    (model, losses), stats = _timed(
        mesh, lambda: train_style_transfer.main(argv + ["--data_parallel"]))
    return {"losses": losses, "params": params_numpy(model), **stats}


def step_trajectories_rank(mesh: Mesh, setups: list[dict]) -> list[dict]:
    """:func:`step_trajectory` of each setup, in order, on this rank."""
    return [step_trajectory(mesh, s) for s in setups]


def step_trajectory(mesh: Mesh, setup: dict) -> dict:
    """The 'cycle' step functions with ``mesh``, over the epochs' given permutations
    (``setup``: ``model``, ``vgg``, ``paintings``, ``content``, ``perms``, ``lr``,
    ``weight_decay``, ``num_epochs``, ``num_steps``, ``batch_size``, ``content_weight``,
    ``style_weight``). Returns the per-step losses, the final params and Adam's
    state, flattened."""
    from artist_style_transfer_tpu_torch.train import loop, styles

    dev = mesh.device
    model = copy.deepcopy(setup["model"]).to(dev)  # setups may share one start
    vgg = _on(setup["vgg"], dev)
    content = torch.as_tensor(setup["content"]).to(dev)
    n, b = content.shape[0], setup["batch_size"]
    targets = styles.build_style_targets("cycle", vgg, "X", paintings=setup["paintings"],
                                         batch_size=b)
    spe = -(-n // b)
    opt, sched = loop.make_optimizer(model.parameters(), setup["lr"], setup["weight_decay"],
                                     setup["num_epochs"], setup["num_steps"], spe)
    fns = loop.make_step_fns("cycle", model, vgg, targets, opt, sched,
                             content_weight=setup["content_weight"],
                             style_weight=setup["style_weight"], batch_size=b, num_content=n,
                             mesh=mesh)
    r22 = loop.precompute_content_relu2_2(vgg, content)
    losses = [fns.epoch_fn(content, r22, torch.as_tensor(p), e * spe).cpu().numpy()
              for e, p in enumerate(setup["perms"])]
    state = [v.detach().cpu().numpy().ravel() for s in opt.state_dict()["state"].values()
             for v in s.values() if torch.is_tensor(v)]
    return {"losses": np.concatenate(losses).astype(np.float64),
            "params": params_numpy(model), "adam": np.concatenate(state)}


def train_classifier_rank(mesh: Mesh, images: np.ndarray, labels: np.ndarray,
                          kwargs: dict, profile: bool = False) -> dict:
    """``train_classifier(mesh=mesh, ...)`` on this rank: its history, the best
    model's state (running statistics included), and the stats."""
    from artist_style_transfer_tpu_torch.train.classifier import train_classifier

    (best, history), stats = _timed(
        mesh, lambda: train_classifier(images, labels, mesh=mesh, device=mesh.device,
                                       **kwargs), profile)
    return {"history": history, "params": params_numpy(best), **stats}


def evaluate_rank(mesh: Mesh, model, classifier, images, artist_index: int,
                  kwargs: dict, profile: bool = False) -> dict:
    """``evaluate_with_classifier(mesh=mesh, ...)`` on this rank: the accuracy, what the
    rank printed, and the stats."""
    from artist_style_transfer_tpu_torch.infer.evaluate import evaluate_with_classifier

    model, classifier = _on(model, mesh.device), _on(classifier, mesh.device)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        acc, stats = _timed(mesh, lambda: evaluate_with_classifier(
            model, classifier, images, artist_index, mesh=mesh, device=mesh.device, **kwargs),
            profile)
    return {"acc": acc, "stdout": out.getvalue(), **stats}


def stylize_rows_rank(mesh: Mesh, model, image: np.ndarray, clip: bool,
                      profile: bool = False, record_k2: bool = False) -> dict:
    """``stylize_spatial`` (a ``TransformerNet``) or ``stylize_spatial_int8`` (a
    ``QuantizedTransformerNet``) of ``image`` on this rank: the whole output as this
    rank returns it, and the stats. ``record_k2``: also the arguments of one K2 launch
    of each distinct shape the call made (the int8 codes as numpy, the rest as they
    were) with its count, for holding K2 against its plain version at the band shapes."""
    from artist_style_transfer_tpu_torch.infer.stylize import (
        stylize_spatial,
        stylize_spatial_int8,
    )
    from artist_style_transfer_tpu_torch.models.transformer_q import QuantizedTransformerNet
    from artist_style_transfer_tpu_torch.ops.cuda import qconv_kernel

    model = _on(model, mesh.device)
    fn = stylize_spatial_int8 if isinstance(model, QuantizedTransformerNet) else stylize_spatial
    calls: dict[tuple, list] = {}
    real = qconv_kernel.conv_i8_cuda

    def recording(x, w, *rest):
        key = (tuple(x.shape), tuple(w.shape)) + tuple(str(a) for a in rest)
        if key not in calls:
            calls[key] = [(x.cpu().numpy(), w.cpu().numpy()) + rest, 0]
        calls[key][1] += 1
        return real(x, w, *rest)

    if record_k2:
        qconv_kernel.conv_i8_cuda = recording
    try:
        y, stats = _timed(mesh, lambda: fn(model, image, mesh, clip=clip, device=mesh.device),
                          profile)
    finally:
        qconv_kernel.conv_i8_cuda = real
    out = {"out": y.float().cpu().numpy() if y.dtype == torch.bfloat16 else y.cpu().numpy(),
           **stats}
    if record_k2:
        out["k2_calls"] = list(calls.values())
    return out


def first_int8_conv_rows_rank(mesh: Mesh, qmodel, x_nchw: np.ndarray) -> dict:
    """The first int8 conv of ``qmodel`` (encoder conv 2: reflect pad, stride 2) on this
    rank's band of ``x_nchw`` (the conv's real-unit bf16 input, as f32, whole): the
    int8 codes of the band's own rows and the whole int32 output, gathered."""
    from artist_style_transfer_tpu_torch.ops.qconv import quant_i8
    from artist_style_transfer_tpu_torch.parallel.spatial import RowBands, all_rows

    layer = _on(qmodel, mesh.device).encoder[0]
    x = torch.as_tensor(x_nchw).to(mesh.device, torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    bands = RowBands.split(mesh, x.shape[2])
    a, b = bands.bounds()
    acc, out_bands = layer.conv_rows(x[:, :, a:b], bands, torch.int32)
    codes = quant_i8(x[:, :, a:b], layer.sin)
    return {"codes": all_rows(codes, bands, dim=2).cpu().numpy(),
            "acc": all_rows(acc, out_bands, dim=2).cpu().numpy()}


def stream_rank(mesh: Mesh, content_dir: str, batch_size: int, height: int, width: int,
                kwargs: dict, epochs: int = 2) -> list[list[np.ndarray]]:
    """The batches of ``content_file_stream`` with its default ``_procs`` (the process
    group's) on this rank, each of ``epochs`` epochs."""
    from artist_style_transfer_tpu_torch.data.stream import content_file_stream

    stream = content_file_stream(content_dir, batch_size, height, width, **kwargs)
    return [list(stream(e)) for e in range(epochs)]
