"""Rank functions for :func:`parallel.launch.launch`: each runs one entry point of the
port on its rank and returns what a caller compares, as numpy values.

They live here, at module level in the package, so that a spawned rank can import
them by name; the port's multi-rank tests and ``chip_smoke.py`` launch them
(:func:`run_jobs` runs several in one launch). Each takes the :class:`Mesh` that
``launch`` builds first; models cross as modules (pickled), images as numpy
arrays. The functions that run an entry point also report its wall seconds
(ending in a device sync) and the launches of the hand kernels K1 and K2 that
their rank made (0 on the CPU); with ``profile=True``, from ``torch.profiler``, its
device time and the device time of NCCL's kernels.
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
    from artist_style_transfer_tpu_torch.models import resnet_q, transformer_qat, vgg
    from artist_style_transfer_tpu_torch.ops import gram, qconv

    takers = (qconv, gram, vgg, resnet_q, transformer_qat)  # the banded nets take their own
    real, seen = qconv.absmax_scale, []

    def recording(t, mesh=None):
        s = real(t, mesh)
        seen.append(float(s))
        return s

    for m in takers:
        m.absmax_scale = recording
    try:
        yield seen
    finally:
        for m in takers:
            m.absmax_scale = real


def _sync(mesh: Mesh) -> None:
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def _timed(mesh: Mesh, fn, profile: bool = False):
    """``fn()``'s result and its stats: ``secs``, ``launches``, and with ``profile``
    ``device_ms`` and ``collective_device_ms``. On CUDA the profiler records the device
    alone: both numbers are kernels' times, and the host's op events made the profiler's
    own work after the run two to four times as long (3.4-4.6 s against 1.2-2.0 s after a
    'cycle' epoch at 224², B=4, the same device ms, on an H100: ``bench_launch.py``)."""
    _sync(mesh)
    _reset_launches()
    prof = None
    if profile:
        from torch.profiler import ProfilerActivity, profile as torch_profile

        acts = [ProfilerActivity.CUDA if mesh.device.type == "cuda" else ProfilerActivity.CPU]
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


@contextlib.contextmanager
def recorded_k1():
    """Inside, every launch of kernel K1 (:func:`ops.cuda.gram_kernel.gram_matrix_cuda`)
    counts under its input's (shape, dtype) in the dict this yields."""
    from artist_style_transfer_tpu_torch.ops.cuda import gram_kernel

    real, seen = gram_kernel.gram_matrix_cuda, {}

    def recording(f, *args, **kwargs):
        key = (tuple(f.shape), str(f.dtype).replace("torch.", ""))
        seen[key] = seen.get(key, 0) + 1
        return real(f, *args, **kwargs)

    gram_kernel.gram_matrix_cuda = recording
    try:
        yield seen
    finally:
        gram_kernel.gram_matrix_cuda = real


@contextlib.contextmanager
def recorded_k2():
    """Inside, every launch of kernel K2 (:func:`ops.cuda.qconv_kernel.conv_i8_cuda`) is
    counted under its shapes and arguments in the dict this yields, whose values are
    ``[the first launch's arguments (the int8 codes as numpy, the rest as they were),
    count]``: for holding K2 against its plain version at the shapes a path gave it."""
    from artist_style_transfer_tpu_torch.ops.cuda import qconv_kernel

    real, calls = qconv_kernel.conv_i8_cuda, {}

    def recording(x, w, *rest):
        key = (tuple(x.shape), tuple(w.shape)) + tuple(str(a) for a in rest)
        if key not in calls:
            calls[key] = [(x.cpu().numpy(), w.cpu().numpy()) + rest, 0]
        calls[key][1] += 1
        return real(x, w, *rest)

    qconv_kernel.conv_i8_cuda = recording
    try:
        yield calls
    finally:
        qconv_kernel.conv_i8_cuda = real


def space_mesh(mesh: Mesh, shape: tuple[int, int]) -> Mesh:
    """A ('data', 'space') mesh of ``shape`` over ``mesh``'s process group (every rank
    calls it: it creates the axes' groups)."""
    from artist_style_transfer_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(tuple(shape), ("data", "space"), device=mesh.device)


class ArrayStream:
    """A ``train(content_stream=...)`` callable over an in-memory corpus: each epoch's
    global batches in the resident order (:func:`train.loop.epoch_permutation`), each
    process yielding its equal slice of every batch (the process group's world size
    and rank, as ``content_file_stream``, which also drops a ragged final batch the
    processes do not divide), so a streamed run sees the resident one's images."""

    def __init__(self, content: np.ndarray, batch_size: int, seed: int):
        self.content, self.batch_size, self.seed = content, batch_size, seed

    def __call__(self, epoch: int):
        import torch.distributed as dist

        from artist_style_transfer_tpu_torch.train.loop import epoch_permutation

        world = dist.get_world_size() if dist.is_initialized() else 1
        me = dist.get_rank() if dist.is_initialized() else 0
        n, b = len(self.content), self.batch_size
        perm = epoch_permutation(self.seed, epoch, n).numpy()
        for s in range(0, n, b):
            idx = perm[s: s + b]
            if len(idx) % world:
                continue
            per = len(idx) // world
            yield self.content[idx[me * per: (me + 1) * per]]


def train_rank(mesh: Mesh, kwargs: dict, stream: dict | None = None,
               profile: bool = False, record_scales: bool = False,
               shape: tuple[int, int] | None = None, record_k1: bool = False,
               record_k2: bool = False) -> dict:
    """``train(mesh=mesh, **kwargs)`` on this rank: its per-epoch losses, the trained
    params, the files rank 0 wrote under ``model_dir`` and the time and launches.
    ``stream``: the arguments of a ``content_file_stream`` made on the rank, which
    takes its slice of every batch from the process group. ``record_scales``: also
    every dynamic int8 scale the run took (:func:`recorded_scales`), under "scales".
    ``shape``: train over a ('data', 'space') mesh of that shape (:func:`space_mesh`)
    instead. ``record_k1``: also K1's launches by input shape (:func:`recorded_k1`),
    under "k1_shapes", as (shape, dtype, count); ``record_k2``: K2's by shape
    (:func:`recorded_k2`), under "k2_calls", as [arguments, count]."""
    from artist_style_transfer_tpu_torch.data.stream import content_file_stream
    from artist_style_transfer_tpu_torch.train import train

    if shape is not None:
        mesh = space_mesh(mesh, shape)
    if stream is not None:
        kwargs = dict(kwargs, content_stream=content_file_stream(**stream))
    with (recorded_scales() if record_scales else contextlib.nullcontext([]) as scales,
          recorded_k1() if record_k1 else contextlib.nullcontext({}) as k1,
          recorded_k2() if record_k2 else contextlib.nullcontext({}) as k2):
        (model, losses), stats = _timed(
            mesh, lambda: train(mesh=mesh, device=mesh.device, **kwargs), profile)
    if record_scales:
        stats["scales"] = np.asarray(scales)
    if record_k1:
        stats["k1_shapes"] = [(s, d, n) for (s, d), n in k1.items()]
    if record_k2:
        stats["k2_calls"] = list(k2.values())
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


def space_step_rank(mesh: Mesh, shape: tuple[int, int] | None, setup: dict,
                    record_scales: bool = False) -> dict:
    """One step of the global batch ``setup["content"]`` over a ('data', 'space') mesh of
    ``shape`` (None: one process, no mesh, on the rank's device; ``setup``: ``model``,
    ``vgg`` (a quantized one too), ``paintings``, ``content``, ``batch_size``,
    ``content_weight``, ``style_weight``, ``step``, and optionally ``mode`` ('cycle' by
    default), ``classifier`` (a quantized one too), ``qat`` and ``quantize_gram``), f32:
    the synced [content, style, total] losses and every parameter's synced gradient, as
    numpy (Adam with no weight decay, which leaves ``.grad`` as the
    sync made it). ``record_scales``: also every dynamic int8 scale the step took, in
    order (:func:`recorded_scales`), under "scales". On CUDA also ``peak_mem_gib``: the
    step's peak of allocated memory above what was allocated before it (the targets and
    the content features are built first)."""
    from artist_style_transfer_tpu_torch.models.resnet import ARTISTS_19
    from artist_style_transfer_tpu_torch.train import loop, styles

    if shape is not None:
        mesh = space_mesh(mesh, shape)
    dev = mesh.device
    mode = setup.get("mode", "cycle")
    model = copy.deepcopy(setup["model"]).to(dev)
    vgg = _on(setup["vgg"], dev)
    clf = None if setup.get("classifier") is None else _on(setup["classifier"], dev)
    content = torch.as_tensor(setup["content"]).to(dev)
    b = setup["batch_size"]
    targets = styles.build_style_targets(mode, vgg, ARTISTS_19[0],
                                         paintings=setup.get("paintings"), batch_size=b)
    opt, sched = loop.make_optimizer(model.parameters(), 0.0, 0.0, 1, 1, 1)
    fns = loop.make_step_fns(mode, model, vgg, targets, opt, sched,
                             content_weight=setup["content_weight"],
                             style_weight=setup["style_weight"], batch_size=b,
                             num_content=content.shape[0], classifier=clf,
                             qat=setup.get("qat", False),
                             quantize_gram=setup.get("quantize_gram", "auto"),
                             mesh=None if shape is None else mesh)
    r22 = loop.precompute_content_relu2_2(vgg, content)
    with recorded_scales() if record_scales else contextlib.nullcontext([]) as scales:
        losses, mem = _peak_mem(dev, lambda: fns.step_fn(content, r22, setup["step"]))
    out = {} if mem is None else {"peak_mem_gib": mem}
    if record_scales:
        out["scales"] = np.asarray(scales)
    return {"losses": losses.cpu().numpy().astype(np.float64),
            "grads": {k: p.grad.detach().cpu().numpy().copy()
                      for k, p in model.named_parameters()}, **out}


def _peak_mem(dev: torch.device, fn):
    """``fn()``'s result and, on a CUDA ``dev``, its peak of allocated memory above what
    was allocated before it, in GiB (None elsewhere)."""
    if dev.type != "cuda":
        return fn(), None
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = fn()
    torch.cuda.synchronize(dev)
    return out, (torch.cuda.max_memory_allocated(dev) - base) / 2**30


def train_classifier_rank(mesh: Mesh, images: np.ndarray, labels: np.ndarray,
                          kwargs: dict, profile: bool = False,
                          shape: tuple[int, int] | None = None) -> dict:
    """``train_classifier(mesh=mesh, ...)`` on this rank: its history, the best
    model's state (running statistics included), and the stats, with ``peak_mem_gib``
    on CUDA. ``shape``: over a ('data', 'space') mesh of that shape
    (:func:`space_mesh`)."""
    from artist_style_transfer_tpu_torch.train.classifier import train_classifier

    if shape is not None:
        mesh = space_mesh(mesh, shape)
    ((best, history), stats), mem = _peak_mem(mesh.device, lambda: _timed(
        mesh, lambda: train_classifier(images, labels, mesh=mesh, device=mesh.device,
                                       **kwargs), profile))
    return {"history": history, "params": params_numpy(best), "peak_mem_gib": mem, **stats}


def classifier_step_rank(mesh: Mesh, shape: tuple[int, int] | None, setup: dict) -> dict:
    """``setup.get("steps", 1)`` ``train_classifier`` steps on one global batch
    ``setup["x"]`` (NHWC, its dtype the steps') and ``setup["y"]`` (AdamW at
    ``setup.get("lr", 0.0)``, constant, the body trainable unless ``setup["freeze_body"]``)
    over a ('data', 'space') mesh of ``shape`` (None: one process, no mesh, on
    ``setup.get("device", "cpu")``), as numpy: each step's synced [loss, accuracy]
    (:func:`train.classifier.classifier_grads`), and the first step's gradients, BN
    statistics and, on CUDA, ``peak_mem_gib`` (its peak of allocated memory above what was
    allocated before it)."""
    from artist_style_transfer_tpu_torch.models.resnet import update_running_stats
    from artist_style_transfer_tpu_torch.parallel.mesh import shard_batch
    from artist_style_transfer_tpu_torch.parallel.spatial import RowBands
    from artist_style_transfer_tpu_torch.train.classifier import (
        classifier_grads,
        make_classifier_optimizer,
    )

    mesh = space_mesh(mesh, shape) if shape is not None else None
    dev = mesh.device if mesh is not None else torch.device(setup.get("device", "cpu"))
    x = torch.as_tensor(setup["x"]).to(dev)
    model = copy.deepcopy(setup["model"]).to(dev, x.dtype)
    steps = setup.get("steps", 1)
    opt, _ = make_classifier_optimizer(model, setup.get("lr", 0.0), steps, 1e-2,
                                       setup["freeze_body"], "constant")
    y, bands = torch.as_tensor(setup["y"], dtype=torch.int64).to(dev), None
    if mesh is not None:
        x, y = shard_batch(x, mesh), shard_batch(y, mesh)
        bands = RowBands.even(mesh.axis_mesh("space"), x.shape[1])
        x = x[:, slice(*bands.bounds())]
    out = {"metrics": []}
    for step in range(steps):
        (metrics, stats), mem = _peak_mem(dev, lambda: classifier_grads(model, x, y, mesh, bands))
        out["metrics"].append(metrics.cpu().numpy())
        if step == 0:
            out["grads"] = {k: p.grad.detach().cpu().numpy().copy()
                            for k, p in model.named_parameters() if p.requires_grad}
            out["stats"] = {k: (m.cpu().numpy(), v.cpu().numpy()) for k, (m, v) in stats.items()}
            out["peak_mem_gib"] = mem
        opt.step()
        update_running_stats(model, stats)
    out["metrics"] = np.stack(out["metrics"])
    return out


def evaluate_rank(mesh: Mesh, model, classifier, images, artist_index: int,
                  kwargs: dict, profile: bool = False, shape: tuple[int, int] | None = None,
                  record_k2: bool = False) -> dict:
    """``evaluate_with_classifier(mesh=mesh, ...)`` on this rank: the accuracy, what the
    rank printed, and the stats. ``shape``: over a ('data', 'space') mesh of that shape
    (:func:`space_mesh`); ``record_k2``: also K2's launches by shape
    (:func:`recorded_k2`), under "k2_calls", as [arguments, count]."""
    from artist_style_transfer_tpu_torch.infer.evaluate import evaluate_with_classifier

    if shape is not None:
        mesh = space_mesh(mesh, shape)
    model, classifier = _on(model, mesh.device), _on(classifier, mesh.device)
    out = io.StringIO()
    with (contextlib.redirect_stdout(out),
          recorded_k2() if record_k2 else contextlib.nullcontext({}) as calls):
        acc, stats = _timed(mesh, lambda: evaluate_with_classifier(
            model, classifier, images, artist_index, mesh=mesh, device=mesh.device, **kwargs),
            profile)
    if record_k2:
        stats["k2_calls"] = list(calls.values())
    return {"acc": acc, "stdout": out.getvalue(), **stats}


def eval_logits_rank(mesh: Mesh, shape: tuple[int, int] | None, model, classifier,
                     images: np.ndarray, crop_size: int, quantize: bool = False) -> dict:
    """The logits of one batch as ``evaluate_with_classifier`` computes them on this
    rank: over a ('data', 'space') mesh of ``shape``, this rank's data slice, on its band
    of rows; ``shape=None`` the whole batch in one process. ``quantize``: the int8
    pipeline, calibrated on the batch's first two images as the entry point does."""
    from artist_style_transfer_tpu_torch.infer.evaluate import eval_logits, quantize_eval_pipeline
    from artist_style_transfer_tpu_torch.parallel.distributed import make_global
    from artist_style_transfer_tpu_torch.parallel.mesh import shard_batch
    from artist_style_transfer_tpu_torch.parallel.spatial import RowBands

    mesh = space_mesh(mesh, shape) if shape is not None else None
    dev = mesh.device if mesh is not None else torch.device("cpu")
    model, classifier = _on(model, dev), _on(classifier, dev)
    if quantize:
        model, classifier = quantize_eval_pipeline(model, classifier, images[:2])
        make_global(mesh, (model, classifier))
    x, bands = torch.as_tensor(images), None
    if mesh is not None:
        x = shard_batch(x, mesh)
        bands = RowBands.even(mesh.axis_mesh("space"), x.shape[1])
        x = x[:, slice(*bands.bounds())]
    logits = eval_logits(model, classifier, x.to(dev), crop_size, mesh, bands)
    return {"logits": logits.float().cpu().numpy()}


def diffusion_rank(mesh: Mesh, images: np.ndarray, labels: np.ndarray, kwargs: dict,
                   shape: tuple[int, int] | None = None, profile: bool = False) -> dict:
    """``train_diffusion(mesh=mesh, ...)`` on this rank: its per-epoch losses, the
    returned model's params and the stats. ``shape``: over a ('data', 'space') mesh of
    that shape (:func:`space_mesh`)."""
    from artist_style_transfer_tpu_torch.diffusion.train import train_diffusion

    if shape is not None:
        mesh = space_mesh(mesh, shape)
    (model, _, losses), stats = _timed(
        mesh, lambda: train_diffusion(images, labels, mesh=mesh, device=mesh.device,
                                      **kwargs), profile)
    return {"losses": losses, "params": params_numpy(model), **stats}


def diffusion_step_rank(mesh: Mesh, shape: tuple[int, int] | None, setup: dict) -> dict:
    """One ``diffusion_step`` of the global batch ``setup`` (``model``, ``x0`` NHWC in
    [-1, 1], ``y``, ``t``, ``noise``, ``num_timesteps``) with Adam at lr 0, over a
    ('data', 'space') mesh of ``shape`` (None: one process, no mesh): the synced loss
    and every parameter's synced gradient, as numpy; on CUDA also ``peak_mem_gib``, the
    step's peak of allocated memory above what was allocated before it."""
    from artist_style_transfer_tpu_torch.diffusion.gaussian import GaussianDiffusion
    from artist_style_transfer_tpu_torch.diffusion.train import diffusion_step
    from artist_style_transfer_tpu_torch.parallel.mesh import shard_batch
    from artist_style_transfer_tpu_torch.parallel.spatial import RowBands

    mesh = space_mesh(mesh, shape) if shape is not None else None
    dev = mesh.device if mesh is not None else torch.device(setup.get("device", "cpu"))
    model = copy.deepcopy(setup["model"]).to(dev)
    diffusion = GaussianDiffusion.make(setup["num_timesteps"], device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=0.0)
    x0, y, t, noise = (torch.as_tensor(np.asarray(setup[k])).to(dev)
                       for k in ("x0", "y", "t", "noise"))
    bands = None
    if mesh is not None:
        x0, y, t, noise = (shard_batch(a, mesh) for a in (x0, y, t, noise))
        bands = RowBands.even(mesh.axis_mesh("space"), x0.shape[1])
        a, b = bands.bounds()
        x0, noise = x0[:, a:b], noise[:, a:b]
    loss, mem = _peak_mem(dev, lambda: diffusion_step(
        model, opt, diffusion, x0, y, t, noise, mesh=mesh, bands=bands))
    return {"loss": float(loss), "peak_mem_gib": mem,
            "grads": {k: p.grad.detach().cpu().numpy().copy()
                      for k, p in model.named_parameters()}}


def stylize_rows_rank(mesh: Mesh, model, image: np.ndarray, clip: bool,
                      profile: bool = False, record_k2: bool = False,
                      shape: tuple[int, int] | None = None) -> dict:
    """``stylize_spatial`` (a ``TransformerNet``) or ``stylize_spatial_int8`` (a
    ``QuantizedTransformerNet``) of ``image`` on this rank: the whole output as this
    rank returns it, and the stats. ``record_k2``: also the arguments of one K2 launch
    of each distinct shape the call made (the int8 codes as numpy, the rest as they
    were) with its count, for holding K2 against its plain version at the band shapes.
    ``shape``: over a ('data', 'space') mesh of that shape (:func:`space_mesh`)."""
    from artist_style_transfer_tpu_torch.infer.stylize import (
        stylize_spatial,
        stylize_spatial_int8,
    )
    from artist_style_transfer_tpu_torch.models.transformer_q import QuantizedTransformerNet

    if shape is not None:
        mesh = space_mesh(mesh, shape)
    model = _on(model, mesh.device)
    fn = stylize_spatial_int8 if isinstance(model, QuantizedTransformerNet) else stylize_spatial
    with recorded_k2() if record_k2 else contextlib.nullcontext({}) as calls:
        y, stats = _timed(mesh, lambda: fn(model, image, mesh, clip=clip, device=mesh.device),
                          profile)
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
