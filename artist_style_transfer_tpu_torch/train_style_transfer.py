"""Training CLI — ``python -m artist_style_transfer_tpu_torch.train_style_transfer``.

The flags and defaults of the JAX package's training CLI (the reference's
``train()`` kwargs, train_cnn.py:144-146, which has no argparse of its own),
plus ``--device`` (default: CUDA; ``--device cpu`` to run on the CPU).
``--precision`` sets ``ops.precision``: unset, ``highest`` (TF32 off) with
float32 and ``default`` with bfloat16.

The int8 training flags run as in JAX: ``--quantize_loss [deep|all]`` (the int8
VGG16 loss extractor), ``--qat [trunk|all]`` (the QAT TransformerNet),
``--quantize_gram auto|on|off`` (the int8 Gram of the deep taps; ``auto``: with
``--quantize_loss``). ``--data_parallel`` trains over a 'data' mesh of every rank
of the process group (one process a device; start each with the same flags, under
torchrun, Slurm or with ``COORDINATOR_ADDRESS``/``NUM_PROCESSES``/``PROCESS_ID``):
``initialize_multihost`` runs first in every case, a no-op in a single process,
which then trains as a world of one.
``--fold_batch on|vgg`` runs the direct path (the same math), ``--preview_every``
writes a figure every N epochs and ``--profile_dir`` a trace of the second
epoch. One call of the JAX CLI has no counterpart here: ``enable_compilation_cache``
(torch runs eagerly, and the kernels' build is kept in ``build/``). The process
group's backend is NCCL, or gloo with ``--device cpu``.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--style_method", default="random",
                   choices=["random", "average", "smartaverage", "cycle", "classifier"])
    p.add_argument("--artist", default="Albrecht_Dürer")
    p.add_argument("--num_epochs", type=int, default=200)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--content_data_size", type=int, default=256)
    p.add_argument("--seed", type=int, default=2)
    p.add_argument("--num_steps", type=int, default=2)
    p.add_argument("--content_weight", type=float, default=17.0)
    p.add_argument("--style_weight", type=float, default=25.0)
    p.add_argument("--lr", type=float, default=0.0024)
    p.add_argument("--save_every", type=int, default=10)
    p.add_argument("--train_size", type=int, default=224)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--model_dir", default="models")
    p.add_argument("--vgg_path", default="models/vgg16-00b39a1b.pth")
    p.add_argument("--classifier_path", default="models/best-2.pth")
    p.add_argument("--content_dir", default="images/content/")
    p.add_argument("--archive_dir", default="images/archive/")
    p.add_argument("--cache_dir", default="dicts/")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--data_parallel", action="store_true",
                   help="shard batches over every rank of the process group (one process "
                        "a device)")
    p.add_argument("--compute_dtype", default="float32", choices=["float32", "bfloat16"],
                   help="bfloat16 = mixed-precision throughput mode")
    p.add_argument("--precision", default=None, choices=["highest", "default"],
                   help="matmul/conv precision policy (ops/precision.py); unset = highest "
                        "with float32, default (TF32) with bfloat16")
    p.add_argument("--quantize_loss", nargs="?", const="deep", default=None,
                   choices=["deep", "all"], help="int8 VGG16 loss extractor from conv3_1 "
                   "(deep) or conv1_2 (all)")
    p.add_argument("--qat", nargs="?", const="trunk", default=None, choices=["trunk", "all"],
                   help="int8 QAT TransformerNet: its 128-channel convs (trunk) or all "
                        "16 interior convs")
    p.add_argument("--quantize_gram", default="auto", choices=["auto", "on", "off"],
                   help="int8 Grams for the deep taps (relu3_3, relu4_3); auto = with "
                        "--quantize_loss")
    p.add_argument("--log_every_batches", type=int, default=12,
                   help="per-batch loss records in metrics.jsonl (0 = off); reference "
                        "BATCH_INFO_EVERY")
    p.add_argument("--preview_every", type=int, default=0,
                   help="preview figure every N epochs (0 = off)")
    p.add_argument("--fold_batch", default="auto", choices=["auto", "on", "vgg", "off"],
                   help="batch->H folding: accepted, and training runs the direct path, the "
                        "same math")
    p.add_argument("--max_epochs_this_run", type=int, default=None,
                   help="stop after N epochs this invocation and persist the resume point "
                        "(continue with --resume)")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace of the second epoch here")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    return p


def main(argv=None):
    """Parse ``argv`` and train; returns ``train()``'s (model, losses)."""
    args = build_parser().parse_args(argv)
    from artist_style_transfer_tpu_torch.ops.precision import set_precision
    from artist_style_transfer_tpu_torch.parallel import initialize_multihost, make_mesh
    from artist_style_transfer_tpu_torch.train import train

    prec = args.precision
    if prec is None:
        # bf16 runs take the fast paths; f32 keeps exact parity.
        prec = "default" if args.compute_dtype == "bfloat16" else "highest"
    set_precision(prec)
    on_cpu = args.device is not None and args.device.startswith("cpu")
    initialize_multihost(backend="gloo" if on_cpu else "nccl")
    mesh = make_mesh(device=args.device) if args.data_parallel else None
    return train(
        style_method=args.style_method,
        artist=args.artist,
        num_epochs=args.num_epochs,
        batch_size=args.batch_size,
        content_data_size=args.content_data_size,
        seed=args.seed,
        num_steps=args.num_steps,
        content_weight=args.content_weight,
        style_weight=args.style_weight,
        lr=args.lr,
        save_every=args.save_every,
        train_size=args.train_size,
        weight_decay=args.weight_decay,
        model_dir=args.model_dir,
        vgg_path=args.vgg_path,
        classifier_path=args.classifier_path,
        content_dir=args.content_dir,
        archive_dir=args.archive_dir,
        cache_dir=args.cache_dir,
        mesh=mesh,
        resume=args.resume,
        compute_dtype=args.compute_dtype,
        log_every_batches=args.log_every_batches,
        preview_every=args.preview_every,
        quantize_loss=args.quantize_loss or False,
        qat=args.qat or False,
        quantize_gram={"auto": "auto", "on": True, "off": False}[args.quantize_gram],
        fold_batch={"auto": "auto", "on": True, "vgg": "vgg", "off": False}[args.fold_batch],
        max_epochs_this_run=args.max_epochs_this_run,
        profile_dir=args.profile_dir,
        wordy=not args.quiet,
        device=args.device,
    )


if __name__ == "__main__":
    main()
