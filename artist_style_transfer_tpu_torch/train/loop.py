"""The training step and epoch (counterpart of the JAX ``train/loop.py``; reference
train_cnn.py:282-359).

What carries over from the JAX loop, and what changes:

- The content corpus lives on the device, and so do its relu2_2 features,
  computed once per run (:func:`precompute_content_relu2_2`); a batch is a
  gather by index from both. The ragged final batch runs at its own size
  (the reference DataLoader keeps it, train_cnn.py:170). A streamed corpus
  (``StepFns.stream_step_fn``) computes each batch's content features in the
  step instead, as that precompute does.
- 'cycle' targets are indexed by the global step, ``step % P``.
- The optimizer is torch ``Adam(lr, weight_decay)`` (L2 folded into the
  gradient, eps outside the sqrt) with the StepLR schedule of the reference
  written per optimizer step (:func:`make_optimizer`).
- JAX's one ``lax.scan`` per epoch becomes a Python loop of eager steps.
  The per-step [content, style, total] losses stay on the device until the
  epoch ends, so the loop never waits for the card inside an epoch.
- ``jax.random`` permutations cannot be reproduced, so the epoch function
  takes its permutation as an argument, as JAX's does;
  :func:`epoch_permutation` is the port's own, keyed on (seed, epoch).
- ``remat=True`` recomputes the transformer's and the VGG's activations in the
  backward instead of keeping them (``torch.utils.checkpoint``, where JAX wraps
  both in ``jax.checkpoint``): less memory, the same losses and gradients.
- ``compute_dtype="bfloat16"`` casts the params, the batch and a copy of the
  VGG weights (and of the classifier's, BN statistics included) to bf16
  inside the step (``torch.func.functional_call``), so the master weights,
  Adam's state and the gradients stay f32, and the losses are reduced in f32.
  A quantized VGG or classifier is not cast: its int8 codes, f32 scales and
  f32 biases are exact as they are, and its real leaves were made in the
  compute dtype.
- The int8 training options, as JAX: ``qat`` runs the TransformerNet through
  its quantization-aware forward (:mod:`models.transformer_qat`); a quantized
  VGG (:func:`models.vgg.quantize_vgg16_loss`) or classifier
  (:func:`models.resnet_q.quantize_classifier`) runs its convs, and their STE
  data gradients, in int8; ``quantize_gram`` (``"auto"``: with a quantized VGG)
  sends the deep taps' Grams through the int8 Gram.

- ``mesh`` (a :class:`parallel.mesh.Mesh`, one rank a process) makes the step
  data-parallel, as JAX's GSPMD step over a 'data' mesh: each rank runs the loss
  on its equal slice of the global batch, the gradients and the reported losses
  are summed over the ranks in one all-reduce and divided by their number (JAX's
  ``pmean`` over equal shards) before Adam, so the params and Adam's state stay
  bit-identical on every rank. A batch the ranks do not divide (the ragged tail)
  runs whole on every rank, and rank 0's gradients and losses are broadcast
  (JAX's ``tail_mesh``). A streamed batch is already this rank's slice. Inside
  the step every dynamic int8 scale is the whole batch's: the loss hands the
  mesh to the int8 nets and Gram, whose autograd functions keep it for the
  backward's scales (:func:`ops.qconv.absmax_scale`). ``fold_batch`` folds nothing (the same
  math), so each rank's shard runs the direct path, as JAX's ``shard_map`` folds
  each device's shard.

- A mesh with a 'space' axis (``make_mesh((d, s), ("data", "space"))``, JAX's
  ``batch_sharding``: NHWC axis 0 over 'data', the image rows over 'space') trains
  every mode with each image's rows spread over the 'space' ranks: each rank holds a
  band of every activation of the TransformerNet (or its QAT forward), the VGG16 (or
  its int8 extractor) and, in 'classifier' mode, the ResNet-50 (or its int8 form)
  (``forward_rows``: halo rows fetched before each conv and pool, instance-norm
  statistics and the classifier head's pools over the whole image,
  :mod:`parallel.spatial`). The Grams (the int8 Gram's int32 products too) and the
  content loss are summed over the bands (:func:`ops.losses.style_loss_gram_rows`,
  :func:`ops.losses.content_loss_rows`), and the classifier's logits are the same on
  every rank, so every 'space' rank holds its data slice's whole loss. Every dynamic
  int8 scale is the max over all d·s ranks of their own rows. Each rank's parameter
  gradient is the part from its rows: the sync sums them over every rank and divides
  by d, the losses by d·s. A full batch shards over the d data slices (a batch of one
  image over (1, s) is banded); the ragged tail is banded when the mesh's size
  divides it, else it runs whole on every rank (JAX's ``tail_mesh``); a streamed
  batch (each rank's slice of the global batch) is gathered over its 'space' line
  into the data slice first, and its content relu2_2 computed banded. ``fold_batch``
  folds nothing here either (JAX folds nothing under a mesh of more than one device).

In the Gram modes every Gram of the step goes through
:func:`ops.losses.style_loss_gram`, which runs the Hopper Gram kernel on a
CUDA device: four launches a step. The 'classifier' mode computes no Gram:
the VGG stops at relu2_2 for the content loss, and the style term is the
cross-entropy of the frozen ResNet-50 classifier on the generated batch
(train_cnn.py:309-314), whose weights get no gradient.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable

import numpy as np
import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from artist_style_transfer_tpu_torch.models.resnet import ResNet50Classifier
from artist_style_transfer_tpu_torch.models.resnet_q import classifier_is_quantized
from artist_style_transfer_tpu_torch.models.transformer import RowsForward, TransformerNet
from artist_style_transfer_tpu_torch.models.transformer_qat import (
    QAT_LAYERS,
    QATForward,
    QATRowsForward,
)
from artist_style_transfer_tpu_torch.models.vgg import VGG16Features, vgg_is_quantized
from artist_style_transfer_tpu_torch.ops.image import (
    bgr_to_rgb,
    torchvision_normalize,
    vgg_caffe_preprocess,
)
from artist_style_transfer_tpu_torch.ops.losses import (
    content_loss,
    content_loss_rows,
    cross_entropy_loss,
    style_loss_gram,
    style_loss_gram_rows,
)
from artist_style_transfer_tpu_torch.parallel.mesh import (
    Mesh,
    check_mesh,
    data_size,
    shard_batch,
)
from artist_style_transfer_tpu_torch.parallel.spatial import RowBands
from artist_style_transfer_tpu_torch.train.styles import StyleTargets, select_step_grams
from artist_style_transfer_tpu_torch.utils.trace import span

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def check_int8_options(qat: bool | str, quantize_gram: bool | str) -> None:
    """Raise ``ValueError`` for a ``qat`` or ``quantize_gram`` value the step does not take."""
    if qat not in (False, True) + QAT_LAYERS:
        raise ValueError(f"qat must be False, True or one of {QAT_LAYERS}, got {qat!r}")
    if quantize_gram not in ("auto", True, False):
        raise ValueError(f"quantize_gram must be 'auto', True or False, got {quantize_gram!r}")


def make_optimizer(
    params,
    lr: float,
    weight_decay: float,
    num_epochs: int,
    num_steps: int,
    steps_per_epoch: int,
) -> tuple[torch.optim.Adam, torch.optim.lr_scheduler.LambdaLR]:
    """torch Adam(lr, weight_decay) + StepLR(num_epochs//num_steps, 0.5), per step.

    The reference steps StepLR once an epoch (train_cnn.py:375); here the
    scheduler steps after every optimizer step, at
    ``lr * 0.5 ** (step // decay_every)`` with
    ``decay_every = max(1, (num_epochs // max(1, num_steps)) * steps_per_epoch)``.
    With num_epochs < num_steps that is 1: the LR halves every step, as in JAX.
    """
    decay_every = max(1, (num_epochs // max(1, num_steps)) * steps_per_epoch)
    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda step: 0.5 ** (step // decay_every))
    return opt, sched


@dataclasses.dataclass(frozen=True)
class StepFns:
    """The loss, one optimizer step, and one epoch for one configuration."""

    # (params {name: tensor}, batch, content_r22, grams, step) -> (total, (content, style));
    # 'classifier' takes its labels from the targets and ignores grams
    loss_fn: Callable
    # (batch, content_r22, step) -> (3,) [content, style, total] on the device
    step_fn: Callable
    # (content_data, content_r22, perm, base_step) -> (steps_per_epoch, 3) on the device
    epoch_fn: Callable
    steps_per_epoch: int
    # (batch on the device, step) -> (3,) on the device: one step of a streamed corpus
    # (under a mesh, the batch is this rank's slice of the global batch)
    stream_step_fn: Callable


def make_step_fns(
    mode: str,
    model: TransformerNet,
    vgg: VGG16Features,
    targets: StyleTargets,
    optimizer: torch.optim.Optimizer,
    scheduler: torch.optim.lr_scheduler.LRScheduler,
    *,
    content_weight: float,
    style_weight: float,
    batch_size: int,
    num_content: int,
    use_kernel: str | bool = "auto",
    compute_dtype: str = "float32",
    classifier: ResNet50Classifier | None = None,
    reference_typo_stats: bool = False,
    remat: bool = False,
    qat: bool | str = False,
    quantize_gram: bool | str = "auto",
    mesh: Mesh | None = None,
) -> StepFns:
    """Build the step functions of a training run.

    ``model``, ``vgg`` and, for 'classifier', ``classifier`` live on the
    training device; the step updates ``model``'s parameters in place through
    ``optimizer`` and ``scheduler``. ``reference_typo_stats`` normalizes the
    classifier's input with the reference training path's 0.546 G mean.
    ``vgg`` and ``classifier`` may be quantized; ``qat`` (True or ``"trunk"``,
    ``"all"``) picks the int8 convs of the TransformerNet's QAT forward;
    ``quantize_gram`` (``"auto"``, True, False) the int8 Gram of the deep taps.
    ``mesh`` makes the step data-parallel over its ranks, and with a 'space' axis
    spreads each image's rows over that axis's ranks (the module docstring).
    """
    check_mesh(mesh)
    if mode == "classifier" and (classifier is None or targets.labels is None):
        raise ValueError("'classifier' training needs a classifier and the targets' labels")
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {tuple(COMPUTE_DTYPES)}, got {compute_dtype!r}")
    steps_full = num_content // batch_size
    if steps_full == 0:
        raise ValueError(f"content_data_size={num_content} < batch_size={batch_size}")
    steps_per_epoch = steps_full + (1 if num_content % batch_size else 0)
    check_int8_options(qat, quantize_gram)
    if quantize_gram == "auto":
        quantize_gram = vgg_is_quantized(vgg)
    cdtype = COMPUTE_DTYPES[compute_dtype]
    # The frozen VGG is cast once, like JAX's vgg_compute; its weights get no gradient.
    # A quantized one is left as it is (JAX train/loop.py:270-297).
    vgg_compute = (vgg if cdtype == torch.float32 or vgg_is_quantized(vgg)
                   else copy.deepcopy(vgg).to(cdtype))
    # The frozen classifier likewise, BN statistics included, as JAX casts its pytree.
    clf_compute = (classifier if classifier is None or cdtype == torch.float32
                   or classifier_is_quantized(classifier)
                   else copy.deepcopy(classifier).to(cdtype))
    forward = QATForward(model, "trunk" if qat is True else qat) if qat else model
    # The int8 nets take the mesh whose ranks share the batch, for their dynamic scales.
    int8_nets = (bool(qat), vgg_is_quantized(vgg_compute),
                 clf_compute is not None and classifier_is_quantized(clf_compute))
    num_cycle = targets.num_cycle if mode == "cycle" else 0
    # A mesh with a 'space' axis runs the banded step (a (d, 1) one too: its bands are
    # whole images, with no exchange).
    banded = mesh is not None and "space" in mesh.axis_names
    space = mesh.axis_mesh("space") if banded else None
    rows_forward = None
    if banded:
        rows_forward = (QATRowsForward(model, "trunk" if qat is True else qat) if qat
                        else RowsForward(model))

    def remat_or_call(fn, *args, **kwargs):
        if remat:
            return checkpoint(fn, *args, use_reentrant=False, **kwargs)
        return fn(*args, **kwargs)

    def loss_fn(params, batch, content_r22, grams, step, mesh=None):
        # mesh: the ranks that hold this batch between them, for the int8 scales
        qat_kw, vgg_kw, clf_kw = ({"mesh": mesh} if q else {} for q in int8_nets)
        if cdtype != torch.float32:
            params = {k: v.to(cdtype) for k, v in params.items()}
            batch = batch.to(cdtype)
        gen = remat_or_call(functional_call, forward, params, (batch,), qat_kw)
        if mode == "classifier":
            # relu2_2 alone for the content loss (train_cnn.py:64-68); BGR [0,255] ->
            # RGB [0,1] -> torchvision stats for the classifier (train_cnn.py:312).
            gen_r22 = remat_or_call(vgg_compute, vgg_caffe_preprocess(gen), just_content=True,
                                    **vgg_kw)
            logits = clf_compute(torchvision_normalize(bgr_to_rgb(gen) / 255.0,
                                                       reference_typo_stats), **clf_kw)
            s_loss = style_weight * cross_entropy_loss(logits, targets.labels[: batch.shape[0]])
        else:
            feats = remat_or_call(vgg_compute, vgg_caffe_preprocess(gen), **vgg_kw)
            gen_r22 = feats["relu2_2"]
            s_loss = style_weight * style_loss_gram(
                feats, select_step_grams(grams, step, num_cycle), use_kernel=use_kernel,
                quantize=bool(quantize_gram), mesh=mesh,
            )
        c_loss = content_weight * content_loss(gen_r22, content_r22)
        return c_loss + s_loss, (c_loss, s_loss)

    def loss_rows(params, band, bands, content_band, grams, step):
        # This rank's band of rows of its data slice: the same total and terms on every
        # rank of its 'space' line, and the part of the gradients from its rows. The
        # int8 nets' scales are the max over every rank of the mesh.
        qat_kw, vgg_kw, clf_kw = ({"mesh": mesh} if q else {} for q in int8_nets)
        if cdtype != torch.float32:
            params = {k: v.to(cdtype) for k, v in params.items()}
            band = band.to(cdtype)
        gen, gen_bands = remat_or_call(functional_call, rows_forward, params, (band, bands),
                                       qat_kw)
        if mode == "classifier":
            gen_r22, r22_bands = remat_or_call(
                vgg_compute.forward_rows, vgg_caffe_preprocess(gen), gen_bands,
                just_content=True, **vgg_kw)
            # Elementwise, so band-local; the logits are the same on every rank.
            logits = clf_compute.forward_rows(
                torchvision_normalize(bgr_to_rgb(gen) / 255.0, reference_typo_stats),
                gen_bands, **clf_kw)
            s_loss = style_weight * cross_entropy_loss(logits, targets.labels[: band.shape[0]])
        else:
            feats = remat_or_call(vgg_compute.forward_rows, vgg_caffe_preprocess(gen),
                                  gen_bands, **vgg_kw)
            gen_r22, r22_bands = feats["relu2_2"]
            s_loss = style_weight * style_loss_gram_rows(
                feats, select_step_grams(grams, step, num_cycle), use_kernel=use_kernel,
                quantize=bool(quantize_gram), mesh=mesh)
        if content_band.shape[1] != gen_r22.shape[1]:
            raise ValueError(f"the content relu2_2 band {tuple(content_band.shape)} is not "
                             f"the generated one's {tuple(gen_r22.shape)}")
        c_loss = content_weight * content_loss_rows(gen_r22, content_band, r22_bands)
        return c_loss + s_loss, (c_loss, s_loss)

    params = dict(model.named_parameters())

    def step_fn(batch, content_r22, step, local: bool = False, bands: RowBands | None = None):
        # local: the batch is this rank's slice already (a streamed batch under a mesh;
        # under a 'space' axis, its band ``bands`` of the data slice's rows, and
        # content_r22 that band's relu2_2)
        with span("train.step"):
            optimizer.zero_grad(set_to_none=True)
            # A full batch shards over the data slices (the 'space' ranks share one); the
            # ragged tail only where the mesh's size divides it, as JAX's ``tail_mesh``.
            n = batch.shape[0]
            sharded = mesh is not None and (local or n % (
                mesh.size if n < batch_size else data_size(mesh)) == 0)
            if sharded and not local:
                batch, content_r22 = shard_batch(batch, mesh), shard_batch(content_r22, mesh)
                if banded:
                    bands = RowBands.split(space, batch.shape[1])
                    batch, content_r22 = rows_of(batch, bands), rows_of(content_r22)
            with span("train.loss"):
                if banded and sharded:
                    total, (c_loss, s_loss) = loss_rows(params, batch, bands, content_r22,
                                                        targets.grams, step)
                else:
                    total, (c_loss, s_loss) = loss_fn(params, batch, content_r22, targets.grams,
                                                      step, mesh if sharded else None)
            with span("train.backward"):
                total.backward()
            with span("train.update"):
                losses = torch.stack([c_loss, s_loss, total]).detach()
                if mesh is not None:
                    losses = sync_gradients(list(params.values()), losses, mesh, sharded)
                optimizer.step()
                scheduler.step()
            return losses

    def rows_of(t, bands: RowBands | None = None):
        """This rank's band (``bands``, else split as every layer splits its output) of
        the rows (NHWC axis 1) of ``t``: the images', or relu2_2's at half their height."""
        a, b = (bands or RowBands.split(space, t.shape[1])).bounds()
        return t[:, a:b]

    def epoch_fn(content_data, content_r22, perm, base_step):
        perm = torch.as_tensor(np.array(perm), dtype=torch.long).to(content_data.device)
        losses = []
        for i in range(steps_per_epoch):
            with span("train.batch"):
                idx = perm[i * batch_size : (i + 1) * batch_size]  # the last one may be ragged
                batch, r22 = content_data.index_select(0, idx), content_r22.index_select(0, idx)
            losses.append(step_fn(batch, r22, base_step + i))
        return torch.stack(losses)

    def stream_step_fn(batch, step):
        # The content relu2_2 as precompute_content_relu2_2 gives it: the f32 VGG (or
        # the quantized one, the same extractor as the step's) without gradients,
        # then the compute dtype, so the streamed trajectory is the resident one.
        with torch.no_grad():
            bands = None
            if banded:
                # The 'space' line's slices make the data slice; this rank takes its rows,
                # and computes their relu2_2 banded.
                batch = torch.cat(space.all_gather(batch.contiguous()))
                bands = RowBands.split(space, batch.shape[1])
                batch = rows_of(batch, bands)
                r22, _ = vgg.forward_rows(vgg_caffe_preprocess(batch), bands,
                                          just_content=True, mesh=space)
            else:
                r22 = vgg(vgg_caffe_preprocess(batch), just_content=True)
        return step_fn(batch, r22 if cdtype == torch.float32 else r22.to(cdtype), step,
                       local=mesh is not None, bands=bands)

    return StepFns(loss_fn=loss_fn, step_fn=step_fn, epoch_fn=epoch_fn,
                   steps_per_epoch=steps_per_epoch, stream_step_fn=stream_step_fn)


def sync_gradients(params: list[torch.Tensor], losses: torch.Tensor, mesh: Mesh,
                   sharded: bool) -> torch.Tensor:
    """Make every rank's ``.grad`` of ``params`` and ``losses`` the same, in one
    collective: when each ran its own shard (``sharded``), the gradients' sum over the
    ranks over the number of data slices (a 'space' line's ranks each hold the part
    from their rows of one slice's gradient) and the losses' mean over the ranks (each
    rank of a line holds its slice's whole loss); else rank 0's (each ran the whole
    batch). Returns the synced losses."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = torch.cat([g.reshape(-1).float() for g in grads] + [losses.float()])
    n_grads = flat.numel() - losses.numel()
    if sharded:
        mesh.all_reduce_(flat)
        flat[:n_grads].div_(data_size(mesh))
        flat[n_grads:].div_(mesh.size)
    else:
        mesh.broadcast_(flat)
    at = 0
    for p, g in zip(params, grads):
        n = g.numel()
        if p.grad is None:
            p.grad = g
        p.grad.copy_(flat[at : at + n].view(g.shape))
        at += n
    return flat[at:].to(losses.dtype)


def precompute_content_relu2_2(
    vgg: VGG16Features, content_data: torch.Tensor, chunk: int = 16,
    dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """relu2_2 features (N, H/2, W/2, 128) of the whole content corpus, on its device.

    Computed once, in f32, ``chunk`` images at a time; ``dtype=torch.bfloat16``
    halves the resident footprint (6.4 MB an image at 224x224 in f32) for
    mixed-precision runs.
    """
    with torch.no_grad():
        out = torch.cat([
            vgg(vgg_caffe_preprocess(content_data[i : i + chunk]), just_content=True)
            for i in range(0, content_data.shape[0], chunk)
        ])
    return out.to(dtype) if dtype is not None else out


def epoch_permutation(seed: int, epoch: int, n: int) -> torch.Tensor:
    """Deterministic shuffle for (seed, epoch), so a resumed run sees the same order.

    A CPU ``torch.Generator`` seeded from ``np.random.SeedSequence([seed, epoch])``.
    """
    key = int(np.random.SeedSequence([seed, epoch]).generate_state(1, np.uint64)[0])
    return torch.randperm(n, generator=torch.Generator().manual_seed(key))
