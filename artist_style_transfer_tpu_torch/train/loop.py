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
from artist_style_transfer_tpu_torch.models.transformer import TransformerNet
from artist_style_transfer_tpu_torch.models.transformer_qat import QAT_LAYERS, QATForward
from artist_style_transfer_tpu_torch.models.vgg import VGG16Features, vgg_is_quantized
from artist_style_transfer_tpu_torch.ops.image import (
    bgr_to_rgb,
    torchvision_normalize,
    vgg_caffe_preprocess,
)
from artist_style_transfer_tpu_torch.ops.losses import (
    content_loss,
    cross_entropy_loss,
    style_loss_gram,
)
from artist_style_transfer_tpu_torch.parallel.mesh import Mesh, data_parallel, shard_batch
from artist_style_transfer_tpu_torch.train.styles import StyleTargets, select_step_grams

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
    # (under a mesh, the batch is this rank's slice)
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
    ``mesh`` makes the step data-parallel over its ranks (the module docstring); a
    mesh with a 'space' axis larger than 1 raises ``NotImplementedError``.
    """
    data_parallel(mesh)
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

    params = dict(model.named_parameters())

    def step_fn(batch, content_r22, step, local: bool = False):
        # local: the batch is this rank's slice already (a streamed batch under a mesh)
        optimizer.zero_grad(set_to_none=True)
        sharded = mesh is not None and (local or batch.shape[0] % mesh.size == 0)
        if sharded and not local:
            batch, content_r22 = shard_batch(batch, mesh), shard_batch(content_r22, mesh)
        total, (c_loss, s_loss) = loss_fn(params, batch, content_r22, targets.grams, step,
                                          mesh if sharded else None)
        total.backward()
        losses = torch.stack([c_loss, s_loss, total]).detach()
        if mesh is not None:
            losses = sync_gradients(list(params.values()), losses, mesh, sharded)
        optimizer.step()
        scheduler.step()
        return losses

    def epoch_fn(content_data, content_r22, perm, base_step):
        perm = torch.as_tensor(np.array(perm), dtype=torch.long).to(content_data.device)
        losses = []
        for i in range(steps_per_epoch):
            idx = perm[i * batch_size : (i + 1) * batch_size]  # the last one may be ragged
            losses.append(step_fn(content_data.index_select(0, idx),
                                  content_r22.index_select(0, idx), base_step + i))
        return torch.stack(losses)

    def stream_step_fn(batch, step):
        # The content relu2_2 as precompute_content_relu2_2 gives it: the f32 VGG (or
        # the quantized one, the same extractor as the step's) without gradients,
        # then the compute dtype, so the streamed trajectory is the resident one.
        with torch.no_grad():
            r22 = vgg(vgg_caffe_preprocess(batch), just_content=True)
        return step_fn(batch, r22 if cdtype == torch.float32 else r22.to(cdtype), step,
                       local=mesh is not None)

    return StepFns(loss_fn=loss_fn, step_fn=step_fn, epoch_fn=epoch_fn,
                   steps_per_epoch=steps_per_epoch, stream_step_fn=stream_step_fn)


def sync_gradients(params: list[torch.Tensor], losses: torch.Tensor, mesh: Mesh,
                   sharded: bool) -> torch.Tensor:
    """Make every rank's ``.grad`` of ``params`` and ``losses`` the same, in one
    collective: their mean over the ranks when each ran its own shard (``sharded``),
    else rank 0's (each ran the whole batch). Returns the synced losses."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = torch.cat([g.reshape(-1).float() for g in grads] + [losses.float()])
    if sharded:
        mesh.all_reduce_(flat).div_(mesh.size)
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
