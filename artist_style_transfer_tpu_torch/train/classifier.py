"""Artist-classifier training: the workflow that produces ``models/best-2.pth``
(counterpart of the JAX ``train/classifier.py``).

The reference only loads a pretrained ResNet-50 artist classifier
(classifier.py:62-63), trained in the upstream Kaggle notebook it credits
(README.md:34-35). This module trains one from the painting corpus:

- fastai-style transfer learning: ``freeze_body=True`` trains the head and every
  BatchNorm affine (fastai ``freeze()``'s ``train_bn=True``), ``freeze_body=False``
  the whole net;
- AdamW with optax's one-cycle cosine schedule (fastai ``fit_one_cycle``) or a
  constant LR (fastai ``fit``); weight decay on the conv and dense weights only;
- optional augmentation (:func:`augment_batch`: random flip and random crop from a
  reflect-padded canvas) on the card, from an explicit ``torch.Generator``;
- train-mode BN (:func:`models.resnet.classifier_apply_train`) with torch-momentum
  running-statistic updates;
- the best-validation snapshot (fastai ``SaveModelCallback``, hence the name
  ``best-2.pth``) exported as the reference's ``{'model': state_dict}``.

The corpus lives on the device; an epoch is one eager loop of drop-last steps
over a seeded permutation, its losses kept on the device until the epoch ends.

``mesh`` (a :class:`parallel.mesh.Mesh`, one process a rank) trains data-parallel,
as JAX's GSPMD step over a 'data' mesh: every rank gathers (and augments, from the
same generator) the same global batch and runs its slice; every BN normalizes by
the whole batch's statistics and folds them into its running buffers
(``batch_norm_train(mesh=)``); the gradients, the loss and the accuracy are
averaged over the ranks in one all-reduce before AdamW, so every rank holds the
same model. Validation counts each rank's correct answers and all-reduces them.
"""

from __future__ import annotations

import copy
import math
import time

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from artist_style_transfer_tpu_torch.models.resnet import (
    ResNet50Classifier,
    classifier_apply_train,
    init_classifier,
    update_running_stats,
)
from artist_style_transfer_tpu_torch.parallel.distributed import make_global
from artist_style_transfer_tpu_torch.parallel.mesh import Mesh, data_parallel, shard_batch
from artist_style_transfer_tpu_torch.train.loop import epoch_permutation, sync_gradients
from artist_style_transfer_tpu_torch.utils.device import module_device, resolve_device, same_device
from artist_style_transfer_tpu_torch.utils.logging import MetricLogger

# optax.cosine_onecycle_schedule's defaults (the JAX trainer passes only pct_start).
ONECYCLE_PCT_START = 0.25
ONECYCLE_DIV_FACTOR = 25.0
ONECYCLE_FINAL_DIV_FACTOR = 1e4
AUGMENT_SEED_OFFSET = 0x5EED  # the augmentation stream's seed: seed + this, as JAX's key


def trainable_labels(model: ResNet50Classifier, freeze_body: bool) -> dict[str, str]:
    """'train' or 'freeze' for each parameter of ``model``, by name (JAX
    ``trainable_labels``).

    BN running statistics are buffers, never gradient-trained (they update through
    :func:`update_running_stats`). With ``freeze_body=True`` the body's conv weights
    are frozen and every BN affine trains, as fastai's ``freeze()``; the head (``1.*``)
    trains whole.
    """
    labels = {}
    for mod_name, m in model.named_modules():
        for p_name, _ in m.named_parameters(recurse=False):
            name = f"{mod_name}.{p_name}" if mod_name else p_name
            train = (not freeze_body or name.startswith("1.")
                     or isinstance(m, nn.modules.batchnorm._BatchNorm))
            labels[name] = "train" if train else "freeze"
    return labels


def weight_decay_mask(model: ResNet50Classifier) -> dict[str, bool]:
    """True for the conv and dense weights only (JAX ``weight_decay_mask``: the 'w'
    leaves), as fastai's ``wd_bn_bias=False``: no BN affine and no bias decays."""
    return {
        f"{mod_name}.{p_name}" if mod_name else p_name:
            p_name == "weight" and isinstance(m, (nn.Conv2d, nn.Linear))
        for mod_name, m in model.named_modules()
        for p_name, _ in m.named_parameters(recurse=False)
    }


def onecycle_factor(step: int, total_steps: int) -> float:
    """``optax.cosine_onecycle_schedule(total_steps, 1, pct_start=0.25)(step)`` with
    optax's default ``div_factor`` and ``final_div_factor``, written out: cosine from
    1/div_factor up to 1 over ``[0, int(pct_start * T))``, cosine down to
    1/(div_factor * final_div_factor) over ``[int(pct_start * T), T)``, then flat.
    optax multiplies its scales in turn, so the floor is relative to the start.

    Defined where the first interval is not empty; where it is (``int(pct_start *
    T) == 0``), optax's schedule is NaN at every step (0/0 enters its sum), so the
    optimizer refuses such a ``T`` (:func:`make_classifier_optimizer`).
    """
    div, final_div = ONECYCLE_DIV_FACTOR, ONECYCLE_FINAL_DIV_FACTOR
    values = (1.0 / div, 1.0, 1.0 / (div * final_div))
    bounds = (0, int(ONECYCLE_PCT_START * total_steps), int(total_steps))
    for i in range(2):
        lo, hi = bounds[i], bounds[i + 1]
        if lo <= step < hi:
            pct = (step - lo) / (hi - lo)
            start, end = values[i], values[i + 1]
            return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1.0)
    return values[2]


def make_classifier_optimizer(
    model: ResNet50Classifier,
    lr: float,
    total_steps: int,
    weight_decay: float,
    freeze_body: bool,
    schedule: str = "onecycle",
) -> tuple[torch.optim.AdamW, torch.optim.lr_scheduler.LambdaLR]:
    """AdamW over the trainable parameters (JAX ``make_classifier_optimizer``), the
    scheduler stepped once a step: 'onecycle' (optax's cosine one-cycle, peak ``lr``,
    pct_start 0.25) or 'constant'.

    Frozen parameters are not handed to the optimizer, so they stay bit-unchanged and
    hold no Adam moments (optax ``set_to_zero``). Weight decay applies to the
    :func:`weight_decay_mask` group only. Sets ``requires_grad`` on exactly the
    trainable parameters.
    """
    total_steps = max(total_steps, 1)
    if schedule == "constant":
        factor = lambda step: 1.0  # noqa: E731
    elif schedule == "onecycle":
        if int(ONECYCLE_PCT_START * total_steps) == 0:
            raise ValueError(
                f"the one-cycle schedule needs at least {math.ceil(1 / ONECYCLE_PCT_START)} "
                f"steps (optax's is NaN for {total_steps}); train longer or use "
                "schedule='constant'")
        factor = lambda step: onecycle_factor(step, total_steps)  # noqa: E731
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    labels, decay = trainable_labels(model, freeze_body), weight_decay_mask(model)
    groups: tuple[list, list] = ([], [])
    for name, p in model.named_parameters():
        p.requires_grad_(labels[name] == "train")
        if p.requires_grad:
            groups[0 if decay[name] else 1].append(p)
    opt = torch.optim.AdamW(
        [{"params": groups[0], "weight_decay": weight_decay},
         {"params": groups[1], "weight_decay": 0.0}],
        lr=lr, betas=(0.9, 0.999), eps=1e-8)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, factor)


def augment_batch(generator: torch.Generator, x: torch.Tensor, pad: int = 8) -> torch.Tensor:
    """Train-time augmentation of an NHWC batch (JAX ``augment_batch``): a random
    horizontal flip of each image, then a random crop of its size from the
    reflect-padded canvas. Draws from ``generator``, which must live on ``x``'s
    device, so no value crosses to the host."""
    n, h, w, _ = x.shape
    dev = x.device
    flip = torch.rand(n, generator=generator, device=dev) < 0.5
    x = torch.where(flip.view(n, 1, 1, 1), x.flip(2), x)
    xp = F.pad(x.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode="reflect").permute(0, 2, 3, 1)
    oh = torch.randint(0, 2 * pad + 1, (n,), generator=generator, device=dev)
    ow = torch.randint(0, 2 * pad + 1, (n,), generator=generator, device=dev)
    rows = (oh[:, None] + torch.arange(h, device=dev))[:, :, None]
    cols = (ow[:, None] + torch.arange(w, device=dev))[:, None, :]
    return xp[torch.arange(n, device=dev)[:, None, None], rows, cols]


def _split_train_val(n: int, val_fraction: float, seed: int):
    """Deterministic shuffled index split, validation first (fastai ``RandomSplitter``),
    the JAX package's numpy permutation."""
    perm = np.random.default_rng(seed).permutation(n)
    n_val = int(round(n * val_fraction))
    return perm[n_val:], perm[:n_val]


def evaluate_classifier(model: ResNet50Classifier, images, labels, batch_size: int = 64,
                        mesh: Mesh | None = None) -> float:
    """Inference-mode accuracy of ``model`` over ``(images, labels)`` (JAX
    ``evaluate_classifier``), in batches on the model's device, the last one ragged.
    ``images``: NHWC RGB torchvision-normalized (numpy or a tensor).

    With ``mesh`` each rank classifies its slice of every batch the ranks divide and
    the correct counts are all-reduced; a batch they do not divide runs whole on
    every rank and counts once (JAX shards only a divisible batch)."""
    data_parallel(mesh)
    dev = module_device(model)
    n = len(images)
    labels = torch.as_tensor(np.asarray(labels), device=dev)
    correct = torch.zeros((), dtype=torch.int64, device=dev)
    sharded = torch.zeros((), dtype=torch.int64, device=dev)
    with torch.inference_mode():
        for start in range(0, n, batch_size):
            xb = torch.as_tensor(images[start: start + batch_size]).to(dev, torch.float32)
            yb = labels[start: start + batch_size]
            if mesh is not None and xb.shape[0] % mesh.size == 0:
                sharded += (model(shard_batch(xb, mesh)).argmax(-1)
                            == shard_batch(yb, mesh)).sum()
            else:
                correct += (model(xb).argmax(-1) == yb).sum()
    if mesh is not None:
        mesh.all_reduce_(sharded)
    return int(correct + sharded) / max(n, 1)


def train_classifier(
    images,
    labels,
    *,
    num_classes: int = 19,
    num_epochs: int = 8,
    batch_size: int = 32,
    lr: float = 1e-3,
    weight_decay: float = 1e-2,
    freeze_body: bool = True,
    schedule: str = "onecycle",
    augment: bool = False,
    bn_momentum: float = 0.1,
    val_fraction: float = 0.2,
    seed: int = 2,
    model: ResNet50Classifier | None = None,
    mesh: Mesh | None = None,
    wordy: bool = True,
    metrics_path: str | None = None,
    device: str | torch.device | None = None,
) -> tuple[ResNet50Classifier, dict]:
    """Train the artist classifier on ``device`` (``None``: CUDA); returns
    ``(best_model, history)`` (JAX ``train_classifier``).

    ``images``: (N, H, W, 3) float32 RGB torchvision-normalized NHWC, as
    ``data.get_painting_dataset(for_classifier=True)`` yields; ``labels``: (N,) int
    artist indices. ``model=None`` starts from :func:`models.resnet.init_classifier`
    with ``seed``; a given classifier (``load_classifier`` of a ``.pth``) is
    fine-tuned on a copy, so the caller's module is left as it was.

    ``best_model`` is the snapshot of highest validation accuracy (ties: the earliest),
    or the final model without a validation split; it comes back frozen, like a
    loaded classifier. ``history`` has per-epoch ``train_loss``, ``train_acc`` and
    ``val_acc``. ``mesh`` trains data-parallel (the module docstring); its size must
    divide ``batch_size``, and only rank 0 logs.
    """
    data_parallel(mesh)
    dev = resolve_device(device)
    if mesh is not None:
        if batch_size % mesh.size:
            raise ValueError(f"batch_size ({batch_size}) must divide over the "
                             f"{mesh.size}-device mesh")
        if not same_device(mesh.device, dev):
            raise ValueError(f"the mesh's device is {mesh.device}, not {dev}")
    images = np.asarray(images, np.float32)
    labels = np.asarray(labels, np.int32)
    n = images.shape[0]
    train_idx, val_idx = _split_train_val(n, val_fraction, seed)
    if len(train_idx) < batch_size:
        raise ValueError(
            f"train split ({len(train_idx)}) smaller than batch_size ({batch_size})")
    steps_per_epoch = len(train_idx) // batch_size  # drop-last, fastai-style

    if model is None:
        model = init_classifier(torch.Generator().manual_seed(seed), dev, num_classes)
    else:
        model = copy.deepcopy(model).to(dev)
    make_global(mesh, model)
    opt, sched = make_classifier_optimizer(model, lr, num_epochs * steps_per_epoch,
                                           weight_decay, freeze_body, schedule)
    trained = [p for p in model.parameters() if p.requires_grad]

    corpus = torch.as_tensor(images[train_idx]).to(dev)
    corpus_labels = torch.as_tensor(labels[train_idx], dtype=torch.int64).to(dev)
    val_images, val_labels = images[val_idx], labels[val_idx]
    aug = (torch.Generator(device=dev).manual_seed(seed + AUGMENT_SEED_OFFSET)
           if augment else None)

    writer = mesh is None or mesh.rank == 0
    log = MetricLogger(metrics_path if writer else None, stdout=wordy and writer)
    history: dict = {"train_loss": [], "train_acc": [], "val_acc": []}
    best_acc, best = -1.0, None
    try:
        for epoch in range(num_epochs):
            t0 = time.time()
            perm = epoch_permutation(seed, epoch, len(train_idx)).to(dev)
            sums = torch.zeros(2, device=dev)  # loss, accuracy: read once, at the epoch's end
            for s in range(steps_per_epoch):
                idx = perm[s * batch_size: (s + 1) * batch_size]
                xb, yb = corpus[idx], corpus_labels[idx]
                if aug is not None:
                    xb = augment_batch(aug, xb)
                xb, yb = shard_batch(xb, mesh), shard_batch(yb, mesh)
                logits, stats = classifier_apply_train(model, xb, mesh=mesh)
                loss = F.cross_entropy(logits, yb)
                opt.zero_grad(set_to_none=True)
                loss.backward()
                metrics = torch.stack([loss, (logits.argmax(-1) == yb).float().mean()]).detach()
                if mesh is not None:
                    metrics = sync_gradients(trained, metrics, mesh, sharded=True)
                opt.step()
                sched.step()
                update_running_stats(model, stats, bn_momentum)
                sums += metrics
            ep_loss, ep_acc = (sums / steps_per_epoch).tolist()
            val_acc = (evaluate_classifier(model, val_images, val_labels, batch_size, mesh)
                       if len(val_idx) else float("nan"))
            history["train_loss"].append(ep_loss)
            history["train_acc"].append(ep_acc)
            history["val_acc"].append(val_acc)
            log.log("classifier_epoch", epoch=epoch, train_loss=ep_loss, train_acc=ep_acc,
                    val_acc=val_acc, secs=time.time() - t0)
            if len(val_idx) and val_acc > best_acc:
                best_acc, best = val_acc, copy.deepcopy(model)
    finally:
        log.close()
    best = model if best is None else best
    return best.requires_grad_(False), history


def main(argv=None):
    import argparse
    import os

    from artist_style_transfer_tpu_torch.data.datasets import get_painting_dataset
    from artist_style_transfer_tpu_torch.parallel import initialize_multihost, make_mesh
    from artist_style_transfer_tpu_torch.train.checkpoint import (
        export_classifier_pth,
        save_params_npz,
    )

    ap = argparse.ArgumentParser(
        description="Train the ResNet-50 artist classifier on the painting corpus "
        "(the upstream workflow behind models/best-2.pth).")
    ap.add_argument("--num_epochs", type=int, default=8)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--weight_decay", type=float, default=1e-2)
    ap.add_argument("--unfreeze", action="store_true",
                    help="fine-tune the whole body (default: head+BN only)")
    ap.add_argument("--schedule", choices=("onecycle", "constant"), default="onecycle",
                    help="LR policy: fastai fit_one_cycle (default) or fit")
    ap.add_argument("--augment", action="store_true",
                    help="train-time augmentation on the device (random flip + random crop "
                    "from a reflect-padded canvas)")
    ap.add_argument("--val_fraction", type=float, default=0.2)
    ap.add_argument("--seed", type=int, default=2)
    ap.add_argument("--rescale_height", type=int, default=256)
    ap.add_argument("--rescale_width", type=int, default=256)
    ap.add_argument("--init_pth", default=None,
                    help="warm-start from an existing classifier .pth")
    ap.add_argument("--out_dir", default="models")
    ap.add_argument("--overwrite", action="store_true",
                    help="allow overwriting an existing best-2.pth")
    ap.add_argument("--data_parallel", action="store_true",
                    help="shard batches over every rank of the process group (one process "
                         "a device; initialize_multihost reads the launcher's environment)")
    ap.add_argument("--metrics", default=None, help="JSONL metrics path")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    mesh = None
    if args.data_parallel:  # one process a rank: join the launcher's process group
        initialize_multihost(backend="nccl" if dev.type == "cuda" else "gloo")
        mesh = make_mesh(device=dev)
    images, labels = get_painting_dataset(
        for_classifier=True, rescale_height=args.rescale_height,
        rescale_width=args.rescale_width, wordy=True)
    model = None
    if args.init_pth:
        from artist_style_transfer_tpu_torch.models.resnet import load_classifier

        model = load_classifier(args.init_pth, dev)
    best, history = train_classifier(
        images, labels,
        num_epochs=args.num_epochs, batch_size=args.batch_size, lr=args.lr,
        weight_decay=args.weight_decay, freeze_body=not args.unfreeze,
        schedule=args.schedule, augment=args.augment, val_fraction=args.val_fraction,
        seed=args.seed, model=model, mesh=mesh, metrics_path=args.metrics, device=dev)
    if mesh is not None and mesh.rank != 0:
        return  # rank 0 exports
    os.makedirs(args.out_dir, exist_ok=True)
    pth = os.path.join(args.out_dir, "best-2.pth")
    if os.path.exists(pth) and not args.overwrite:
        # Never clobber an existing artifact by default: best-2.pth is the
        # pretrained checkpoint every other subsystem loads.
        pth = os.path.join(args.out_dir, "best-2-retrained.pth")
        print(f"best-2.pth exists; writing {pth} (use --overwrite to replace)")
    export_classifier_pth(pth, best)
    save_params_npz(os.path.join(args.out_dir, "classifier.npz"), best)
    if args.val_fraction > 0:
        print(f"best val acc {max(history['val_acc']):.4f}; exported {pth}")
    else:
        print(f"no validation split; final train acc {history['train_acc'][-1]:.4f}; "
              f"exported {pth}")


if __name__ == "__main__":
    main()
