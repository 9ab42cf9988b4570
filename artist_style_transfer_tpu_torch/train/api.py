"""``train()`` — the public training entry point (counterpart of the JAX ``train/api.py``).

The signature mirrors the reference ``train()`` kwargs (train_cnn.py:144-146):
style_method, artist, num_epochs, batch_size, content_data_size, seed,
num_steps, content_weight, style_weight, lr, save_every; then the JAX
package's keyword-only extensions, and ``device``.

Flow: seed -> init TransformerNet -> VGG16 (+ the ResNet-50 classifier in
'classifier' mode) -> content corpus to the device (``data.get_content_dataset``
from ``content_dir``) -> style targets from the painting corpus
(``data.get_painting_dataset``/``get_avg_dataset`` from ``archive_dir`` and
``cache_dir``), through the Hopper Gram kernel on CUDA; labels in 'classifier'
mode -> content relu2_2 once -> one eager epoch at a time -> checkpoints,
``.npz`` and ``.pth``. A ``content_stream`` replaces the resident corpus: its
batches go through ``data.device_prefetch`` into a step that computes their
content features itself. The in-memory hooks (``content_images``,
``paintings``, ``avg_image``) replace the loaders.

``remat`` recomputes activations in the backward (``torch.utils.checkpoint``),
``preview_every`` writes a Content/Style/Transformed figure every N epochs,
``profile_dir`` traces the second epoch with ``torch.profiler``, and
``fold_batch`` is accepted and runs the direct path (JAX's batch->H fold is a
TPU layout rewrite of the same math). The int8 training options run as JAX
runs them: ``quantize_loss`` quantizes the VGG16 loss extractor once, before
the targets are built (:func:`models.vgg.quantize_vgg16_loss`), so targets,
content features and the step share it; ``qat`` and ``quantize_gram`` go to the
step; a :func:`models.resnet_q.quantize_classifier` module as ``classifier``
trains 'classifier' mode through the int8 classifier.

``mesh`` (a :class:`parallel.mesh.Mesh`; one process a rank, each calling
``train`` with the same arguments) trains data-parallel: the replicated state
(the TransformerNet, the frozen nets, the targets and the corpus) is made rank
0's (:func:`parallel.distributed.make_global`), each step runs each rank's slice
of the global batch (:func:`train.loop.make_step_fns`), and only rank 0 writes
checkpoints, exports, previews, ``style.jpg`` and ``metrics.jsonl`` while the others
wait at a barrier; ``model_dir`` must be a directory every rank sees (a resume
reads it on each). A streamed corpus yields each rank's slice of every global
batch (``content_file_stream`` takes the ranks from the process group). A mesh with
a 'space' axis larger than 1 raises ``NotImplementedError`` (ROADMAP item 12b).
"""

from __future__ import annotations

import copy
import os
import random as _random
import time

import numpy as np
import torch

from artist_style_transfer_tpu_torch.data.datasets import (
    get_avg_dataset,
    get_content_dataset,
    get_painting_dataset,
)
from artist_style_transfer_tpu_torch.data.prefetch import device_prefetch
from artist_style_transfer_tpu_torch.data.stream import ContentFileStream
from artist_style_transfer_tpu_torch.models.resnet import (
    ARTISTS_19,
    ResNet50Classifier,
    load_classifier,
)
from artist_style_transfer_tpu_torch.models.transformer import init_transformer
from artist_style_transfer_tpu_torch.models.vgg import (
    VGG16Features,
    first_quantized_conv,
    load_vgg16,
    quantize_vgg16_loss,
)
from artist_style_transfer_tpu_torch.parallel.distributed import make_global
from artist_style_transfer_tpu_torch.parallel.mesh import Mesh, data_parallel
from artist_style_transfer_tpu_torch.train import checkpoint as ckpt
from artist_style_transfer_tpu_torch.train.loop import (
    COMPUTE_DTYPES,
    check_int8_options,
    epoch_permutation,
    make_optimizer,
    make_step_fns,
    precompute_content_relu2_2,
)
from artist_style_transfer_tpu_torch.train.styles import MODES, build_style_targets
from artist_style_transfer_tpu_torch.utils.device import module_device, resolve_device, same_device
from artist_style_transfer_tpu_torch.utils.logging import MetricLogger

_FOLD_BATCH = ("auto", True, False, "vgg")


def _vgg_layers(quantize_loss: bool | str | int) -> str | int:
    """``quantize_vgg16_loss``'s ``layers`` for ``train(quantize_loss=...)``: True is "deep"."""
    return "deep" if quantize_loss is True else quantize_loss


def _check_options(*, mesh, qat, quantize_loss, quantize_gram, fold_batch) -> None:
    """Refuse, before anything is written, what JAX's ``train()`` refuses, and a mesh
    with a 'space' axis (ROADMAP item 12b)."""
    if fold_batch not in _FOLD_BATCH:
        raise ValueError(f"fold_batch must be one of {_FOLD_BATCH}, got {fold_batch!r}")
    check_int8_options(qat, quantize_gram)
    first_q = first_quantized_conv(_vgg_layers(quantize_loss)) if quantize_loss else None
    data_parallel(mesh)
    if first_q is not None and first_q < 4 and fold_batch in (True, "vgg"):
        raise NotImplementedError(  # JAX train/loop.py:301-309
            "fold_batch training needs the shallow VGG blocks in bf16: "
            "quantize_loss='all' quantizes conv1_2..conv2_2, which have "
            "no folded int8 variant; use quantize_loss='deep'"
        )
    if qat and fold_batch is True:
        raise NotImplementedError(  # JAX train/loop.py:310-315
            "qat training uses the int8 transformer forward, which has no "
            "batch->H folded variant; use fold_batch='vgg' (loss-branch "
            "fold) or 'auto' (direct path)"
        )


def _resolve_frozen(net, cls, load, path: str, dev: torch.device) -> torch.nn.Module:
    """A frozen ``cls`` net on ``dev`` from the hook (a module or its state dict) or, when
    the hook is None, ``load(path, dev)``."""
    if net is None:
        return load(path, dev)
    if isinstance(net, dict):
        model = cls()
        model.load_state_dict(net)
        return model.to(dev)
    if not same_device(module_device(net), dev):
        net = copy.deepcopy(net).to(dev)  # the caller's module stays where it is
    return net


def train(
    style_method: str = "random",
    artist: str = "Albrecht_Dürer",
    num_epochs: int = 200,
    batch_size: int = 4,
    content_data_size: int = 256,
    seed: int = 2,
    num_steps: int = 2,
    content_weight: float = 17.0,
    style_weight: float = 25.0,
    lr: float = 0.0024,
    save_every: int = 10,
    *,
    train_size: int = 224,
    weight_decay: float = 1e-4,
    model_dir: str | None = "models",
    vgg_path: str = "models/vgg16-00b39a1b.pth",
    classifier_path: str = "models/best-2.pth",
    content_dir: str = "images/content/",
    archive_dir: str = "images/archive/",
    cache_dir: str = "dicts/",
    mesh: Mesh | None = None,
    resume: bool = False,
    max_epochs_this_run: int | None = None,
    preview_every: int = 0,
    export_pth: bool = True,
    wordy: bool = True,
    # A streamed corpus (larger than the device holds): a callable (epoch: int) ->
    # iterable of (B, H, W, 3) BGR [0,255] host batches, e.g. data.content_file_stream.
    # content_data_size still sets the steps an epoch for the LR schedule.
    content_stream=None,
    # In-memory data hooks: when given, the file loaders are skipped.
    content_images: np.ndarray | None = None,  # (N, H, W, 3) BGR [0,255]
    paintings: np.ndarray | None = None,  # (P, H, W, 3) BGR [0,255]
    avg_image: np.ndarray | None = None,  # (H, W, 3) BGR [0,255]
    vgg: VGG16Features | dict | None = None,  # else loaded from vgg_path
    classifier: ResNet50Classifier | dict | None = None,  # else loaded from classifier_path
    use_kernel: str | bool = "auto",
    compute_dtype: str = "float32",
    fold_batch: str | bool = "auto",
    remat: bool = False,
    profile_dir: str | None = None,
    log_every_batches: int = 12,  # reference BATCH_INFO_EVERY (train_cnn.py:29)
    reference_typo_stats: bool = False,
    quantize_loss: bool | str = False,
    qat: bool | str = False,
    quantize_gram: bool | str = "auto",
    device: str | torch.device | None = None,
):
    """Train a TransformerNet for ``artist`` with the given style method.

    Returns (model, losses): the trained ``TransformerNet`` on ``device`` and
    the reference's (num_epochs, 3) float64 array of per-epoch [content,
    style, total] sums (train_cnn.py:281, :376-378). ``device=None`` means
    CUDA and raises without it; the CPU runs only when asked for.
    The corpus is up to ``content_data_size`` images of ``content_dir``, shuffled
    by ``seed`` and resized to ``train_size`` square, or the first
    ``content_data_size`` of ``content_images`` (the reference draws that many,
    train_cnn.py:168). The paintings of ``artist`` come from ``archive_dir``
    (or the caches in ``cache_dir``), rescaled to ``train_size``. ``metrics.jsonl``
    records where the data came from and which decoder read it (event ``data``),
    and for a streamed epoch the host seconds the loop waited on the stream.
    'classifier' mode takes the frozen classifier from ``classifier`` or, when
    that is None, from ``classifier_path``; ``artist`` must be one of
    :data:`ARTISTS_19` (else ``ValueError``), and ``reference_typo_stats``
    takes the reference training path's 0.546 G mean (train_cnn.py:272).
    """
    if style_method not in MODES:
        print("enter valid style method!")  # train_cnn.py:274
        return 0
    _check_options(mesh=mesh, qat=qat, quantize_loss=quantize_loss,
                   quantize_gram=quantize_gram, fold_batch=fold_batch)
    # Before anything is written: an artist outside the classifier's 19 raises.
    artist_index = ARTISTS_19.index(artist) if style_method == "classifier" else None
    dev = resolve_device(device)
    if mesh is not None and not same_device(mesh.device, dev):
        raise ValueError(f"the mesh's device is {mesh.device}, not {dev}")
    writer = mesh is None or mesh.rank == 0  # the one rank that writes files and prints
    wordy = wordy and writer

    # The reference seeds every RNG (train_cnn.py:147-151).
    np.random.seed(seed)
    _random.seed(seed)
    torch.manual_seed(seed)
    nprng = np.random.default_rng(seed)

    # The prefix comes before anything writes into the directory: the
    # transfer_/transfer2_ choice keys off its emptiness (train_cnn.py:173-178).
    prefix = None
    if model_dir and writer:
        if resume:
            prefix = ckpt.resume_prefix(model_dir, artist, style_method, content_weight,
                                        style_weight)
        else:
            prefix = ckpt.save_dir_prefix(model_dir, artist, style_method, content_weight,
                                          style_weight, bump=True)
    if mesh is not None:  # chosen by rank 0 before it writes anything
        prefix = mesh.broadcast_object(prefix)
    log = MetricLogger(
        jsonl_path=os.path.join(model_dir, artist, style_method, "metrics.jsonl")
        if model_dir and writer else None,
        stdout=wordy,
    )

    model = init_transformer(torch.Generator().manual_seed(seed), dev)
    vgg = _resolve_frozen(vgg, VGG16Features, load_vgg16, vgg_path, dev)
    if quantize_loss:
        # Once, before the targets: targets, content relu2_2 and the step share the int8
        # extractor, so the loss is exactly 0 at a perfect match (JAX api.py:158-167).
        # 'classifier' mode's content loss stops at relu2_2, before the 'deep' convs.
        vgg = quantize_vgg16_loss(vgg, _vgg_layers(quantize_loss),
                                  dtype=COMPUTE_DTYPES.get(compute_dtype, torch.float32))
    classifier = (_resolve_frozen(classifier, ResNet50Classifier, load_classifier,
                                  classifier_path, dev)
                  if style_method == "classifier" else None)
    data_log: dict[str, dict] = {}
    if content_stream is not None:
        content_data = None
        n_content = content_data_size
        data_log["content"] = {"source": "stream"}
        if isinstance(content_stream, ContentFileStream):
            data_log["content"]["decoder"] = content_stream.decoder
    else:
        if content_images is None:
            if wordy:
                print("Getting content dataset!")  # train_cnn.py:168
            data_log["content"] = {"source": "files"}
            content_images = get_content_dataset(content_data_size, train_size, train_size,
                                                 content_dir=content_dir, seed=seed,
                                                 stats=data_log["content"])
        else:
            data_log["content"] = {"source": "hook"}
        content_data = torch.as_tensor(
            np.asarray(content_images[:content_data_size], np.float32), device=dev)
        n_content = content_data.shape[0]

    if wordy:
        print("Getting style dataset and features!")  # train_cnn.py:180
    t0 = time.perf_counter()
    if style_method in ("random", "cycle", "smartaverage") and paintings is None:
        data_log["paintings"] = {}
        paintings = get_painting_dataset(False, train_size, train_size, archive_dir=archive_dir,
                                         cache_dir=cache_dir,
                                         stats=data_log["paintings"])[artist]
    if style_method == "average" and avg_image is None:
        data_log["paintings"] = {}
        avg_image = get_avg_dataset(train_size, train_size, archive_dir=archive_dir,
                                    cache_dir=cache_dir, stats=data_log["paintings"])[artist]
    log.log("data", **data_log)
    targets = build_style_targets(style_method, vgg, artist, paintings=paintings,
                                  avg_image=avg_image, batch_size=batch_size,
                                  artist_index=artist_index, rng=nprng, use_kernel=use_kernel)
    log.log("style_targets_built", mode=style_method, secs=time.perf_counter() - t0)
    if prefix is not None and targets.style_preview_bgr is not None:
        _on_rank0(mesh, lambda: _save_style_jpg(
            os.path.dirname(prefix), targets.style_preview_bgr,
            second=os.path.basename(prefix).startswith("transfer2")))
    if mesh is not None:  # every rank trains from rank 0's state (JAX api.py:243-254)
        make_global(mesh, [model, vgg, classifier, targets.grams, targets.labels, content_data])

    # ceil: the ragged final batch is kept (train_cnn.py:170) and counts as a
    # step for the LR schedule too.
    steps_per_epoch = -(-n_content // batch_size)
    opt, sched = make_optimizer(model.parameters(), lr, weight_decay, num_epochs, num_steps,
                                steps_per_epoch)
    fns = make_step_fns(style_method, model, vgg, targets, opt, sched,
                        content_weight=content_weight, style_weight=style_weight,
                        batch_size=batch_size, num_content=n_content, use_kernel=use_kernel,
                        compute_dtype=compute_dtype,
                        classifier=classifier,
                        reference_typo_stats=reference_typo_stats, remat=remat, qat=qat,
                        quantize_gram=quantize_gram, mesh=mesh)
    content_r22 = None
    if content_data is not None:
        content_r22 = precompute_content_relu2_2(
            vgg, content_data, dtype=torch.bfloat16 if compute_dtype == "bfloat16" else None)

    start_epoch = 0
    losses = np.full((num_epochs, 3), -1.0, np.float64)
    if resume and prefix is not None:
        found = ckpt.latest_checkpoint(prefix)
        if found is not None:
            path, _ = found
            start_epoch = ckpt.restore_checkpoint(path, model, opt, sched)
            loss_path = path[: -len(".ckpt")] + ".npy"
            if os.path.exists(loss_path):
                prev = np.load(loss_path)
                n = min(len(prev), num_epochs)
                losses[:n] = prev[:n]
            log.log("resumed", checkpoint=path, epoch=start_epoch)

    if wordy:
        print("Training!")  # train_cnn.py:278
    run_start = time.perf_counter()
    end_epoch = num_epochs
    if max_epochs_this_run is not None:
        # Time-sliced training: stop early but keep the full-run LR schedule;
        # a later resume=True call continues where this one stopped.
        end_epoch = min(num_epochs, start_epoch + max_epochs_this_run)
    # A streamed epoch advances the step counter by the batches it really ran (the
    # stream may yield more or fewer than steps_per_epoch), so the 'cycle' targets
    # neither repeat nor skip; a resume starts it from the nominal count.
    stream_step = start_epoch * steps_per_epoch
    for epoch in range(start_epoch, end_epoch):
        # The second epoch is traced (the first includes cuDNN's algorithm search), as JAX
        # traces its second (the first includes compilation).
        profiler = _start_profile(dev) if profile_dir and epoch == start_epoch + 1 else None
        t_ep = time.perf_counter()
        extra = {}
        if content_stream is not None:
            step_losses, epoch_images, extra["stream_wait_secs"] = _run_stream_epoch(
                fns, content_stream, epoch, stream_step, dev, mesh)
            stream_step += len(step_losses)
        else:
            step_losses = fns.epoch_fn(content_data, content_r22,
                                       epoch_permutation(seed, epoch, n_content),
                                       epoch * steps_per_epoch)
            epoch_images = n_content
        step_losses = step_losses.cpu().numpy().astype(np.float64)  # the epoch's one sync
        dt = time.perf_counter() - t_ep
        if profiler is not None:
            log.log("profile_written", dir=profile_dir, trace=_stop_profile(profiler, profile_dir,
                                                                            epoch))
        el = step_losses.sum(axis=0)
        losses[epoch] = el
        if log_every_batches:
            # Per-batch records (reference prints every BATCH_INFO_EVERY batches,
            # train_cnn.py:355-357), from the per-step stack: no extra sync.
            for s in range(0, len(step_losses), log_every_batches):
                log.log("batch", epoch=epoch + 1, batch=s + 1,
                        content_loss=float(step_losses[s, 0]),
                        style_loss=float(step_losses[s, 1]),
                        total_loss=float(step_losses[s, 2]), stdout=False)
        log.log("epoch", epoch=epoch + 1, content_loss=float(el[0]), style_loss=float(el[1]),
                total_loss=float(el[2]), secs=dt, images_per_sec=epoch_images / dt, **extra)
        if prefix is not None and save_every and epoch % save_every == 0:
            _on_rank0(mesh, lambda: ckpt.save_checkpoint(prefix, epoch, model, opt, sched, losses,
                                                         completed_epochs=epoch + 1))
        if (prefix is not None and preview_every and epoch % preview_every == 0
                and content_data is not None):
            # The reference's live preview (train_cnn.py:337-354) as a file, as JAX writes it.
            _on_rank0(mesh, lambda: _save_preview(
                os.path.join(os.path.dirname(prefix), f"preview_{epoch}.png"), model,
                content_data[:1], targets.style_preview_bgr, dev))

    log.log("trained", secs=time.perf_counter() - run_start)  # train_cnn.py:387
    if prefix is not None:
        _on_rank0(mesh, lambda: _save_final(prefix, end_epoch, num_epochs, model, opt, sched,
                                            losses, export_pth))
    log.close()
    return model, losses


def _on_rank0(mesh: Mesh | None, write) -> None:
    """``write()`` on rank 0 (or without a mesh); the other ranks wait until it is done."""
    if mesh is None or mesh.rank == 0:
        write()
    if mesh is not None:
        mesh.barrier()


def _save_final(prefix: str, end_epoch: int, num_epochs: int, model, opt, sched, losses,
                export_pth: bool) -> None:
    if end_epoch < num_epochs:
        # Early stop (time slice): persist the resume point.
        ckpt.save_checkpoint(prefix, end_epoch - 1, model, opt, sched, losses,
                             completed_epochs=end_epoch)
    else:
        ckpt.save_checkpoint(prefix, num_epochs, model, opt, sched, losses,
                             completed_epochs=num_epochs)
        ckpt.save_params_npz(f"{prefix}_{num_epochs}.npz", model)
        if export_pth:
            ckpt.export_pth(f"{prefix}_{num_epochs}.pth", model)


def train_from_config(config, **overrides):
    """Run :func:`train` from a :class:`TrainConfig`; keyword overrides win.

    ``data_dir`` is the root of the reference's ``images/`` layout
    (dataset.py:12-13): the content under ``<data_dir>/content/``, the Kaggle
    archive under ``<data_dir>/archive/``. ``mesh_shape`` builds a 'data' mesh of that
    shape over the process group (:func:`parallel.mesh.make_mesh`), unless a ``mesh``
    override is given.
    """
    from artist_style_transfer_tpu_torch.parallel.mesh import make_mesh
    from artist_style_transfer_tpu_torch.utils.config import TrainConfig

    if not isinstance(config, TrainConfig):
        raise TypeError(f"train_from_config takes a TrainConfig, got {type(config).__name__}")
    mesh = overrides.pop("mesh", None)
    if mesh is None and config.mesh_shape is not None:
        mesh = make_mesh(shape=tuple(config.mesh_shape),
                         device=overrides.get("device", config.device))
    kwargs = dict(
        style_method=config.style_method,
        artist=config.artist,
        num_epochs=config.num_epochs,
        batch_size=config.batch_size,
        content_data_size=config.content_data_size,
        seed=config.seed,
        num_steps=config.num_steps,
        content_weight=config.content_weight,
        style_weight=config.style_weight,
        lr=config.lr,
        save_every=config.save_every,
        train_size=config.train_size,
        weight_decay=config.weight_decay,
        model_dir=config.model_dir,
        compute_dtype=config.compute_dtype,
        log_every_batches=config.log_every_batches,
        classifier_path=config.classifier_path,
        reference_typo_stats=config.reference_typo_stats,
        device=config.device,
        content_dir=os.path.join(config.data_dir, "content/"),
        archive_dir=os.path.join(config.data_dir, "archive/"),
        mesh=mesh,
    )
    kwargs.update(overrides)
    return train(**kwargs)


def _run_stream_epoch(fns, content_stream, epoch: int, base_step: int, dev: torch.device,
                      mesh: Mesh | None = None):
    """One epoch of a streamed corpus: host batches through ``device_prefetch`` (two
    copies in flight) into the step, the losses kept on the device until the epoch ends.

    Returns the (steps, 3) losses on the device, the images seen (by every rank), and
    the host seconds the loop spent waiting for the next batch (decode, pinning and the
    copy's launch). Under a mesh each batch is this rank's slice.
    """
    losses, n_images, wait = [], 0, 0.0
    batches = (np.asarray(b, np.float32) for b in content_stream(epoch))
    t = time.perf_counter()
    for i, batch in enumerate(device_prefetch(batches, buffer_size=2, device=dev,
                                              sharding=mesh)):
        wait += time.perf_counter() - t
        n_images += int(batch.shape[0]) * (1 if mesh is None else mesh.size)
        losses.append(fns.stream_step_fn(batch, base_step + i))
        t = time.perf_counter()
    if not losses:
        raise ValueError(f"content_stream yielded no batches for epoch {epoch}")
    return torch.stack(losses), n_images, wait


def _start_profile(dev: torch.device):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_profile(prof, profile_dir: str, epoch: int) -> str:
    """End the trace and write it as a Chrome trace; returns its path."""
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"trace_epoch{epoch + 1}.json")
    prof.export_chrome_trace(path)
    return path


def _save_preview(path: str, model, first: torch.Tensor, style_bgr, dev: torch.device) -> None:
    from artist_style_transfer_tpu_torch.infer.stylize import save_figure, stylize

    out = stylize(model, first, device=dev)[0].cpu().numpy()
    save_figure(path, first[0].cpu().numpy(), out, style_bgr)


def _save_style_jpg(directory: str, image_bgr_255: np.ndarray, second: bool = False) -> None:
    """Write style.jpg / style2.jpg like the reference (train_cnn.py:191-196), where cv2 exists."""
    try:
        import cv2
    except ImportError:
        return
    name = "style2.jpg" if second else "style.jpg"
    cv2.imwrite(os.path.join(directory, name), np.clip(image_bgr_255, 0, 255).astype(np.uint8))
