"""Diffusion CLI: ``python -m artist_style_transfer_tpu_torch.diffusion.cli`` (counterpart
of the JAX ``diffusion/cli.py``, with the same subcommands, flags and defaults, and
``--device``).

Subcommands:
- ``train``: fit the UNet on the painting corpus (artist-labelled); writes the JAX-layout
  ``.npz`` and its ``.labels.json`` sidecar (class id i = the i-th artist of
  ``artists.csv``), so either package reads the other's model;
- ``sample``: class-conditional sampling (DPM-Solver++ with ``--dpmpp_steps``, else DDIM
  with ``--ddim_steps``, else DDPM), optionally guided by the artist classifier
  (``models/best-2.pth``); writes the samples side by side as one image;
- ``eval``: the classifier Fréchet distance (CFID) between DDPM samples of a trained
  model and the artist's real paintings.
"""

from __future__ import annotations

import argparse
import json
import os
import warnings


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train")
    t.add_argument("--image_size", type=int, default=64)
    t.add_argument("--num_epochs", type=int, default=50)
    t.add_argument("--batch_size", type=int, default=32)
    t.add_argument("--num_timesteps", type=int, default=1000)
    t.add_argument("--base_channels", type=int, default=64)
    t.add_argument("--lr", type=float, default=1e-4)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--schedule", choices=("linear", "cosine"), default="linear")
    t.add_argument("--ema_decay", type=float, default=0.999,
                   help="EMA decay for returned weights; 0 disables")
    t.add_argument("--archive_dir", default="images/archive/")
    t.add_argument("--cache_dir", default="dicts/")
    t.add_argument("--out", default="models/diffusion/diff_model.npz")

    s = sub.add_parser("sample")
    s.add_argument("--model", default="models/diffusion/diff_model.npz")
    s.add_argument("--artist", default="Vincent_van_Gogh")
    s.add_argument("--num_samples", type=int, default=4)
    s.add_argument("--image_size", type=int, default=64)
    s.add_argument("--num_timesteps", type=int, default=1000)
    s.add_argument("--base_channels", type=int, default=64)
    s.add_argument("--guidance_scale", type=float, default=0.0)
    s.add_argument("--classifier_path", default="models/best-2.pth")
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--schedule", choices=("linear", "cosine"), default="linear")
    s.add_argument("--dpmpp_steps", type=int, default=0,
                   help=">0: DPM-Solver++(2M) fast sampling with this many steps "
                        "(second-order multistep); takes precedence over --ddim_steps")
    s.add_argument("--ddim_steps", type=int, default=0,
                   help=">0: DDIM fast sampling with this many steps "
                        "instead of the full T-step DDPM chain")
    s.add_argument("--ddim_eta", type=float, default=0.0,
                   help="DDIM stochasticity (0 = deterministic ODE)")
    s.add_argument("--out", default="figs/diffusion_samples.png")

    e = sub.add_parser("eval")
    e.add_argument("--model", default="models/diffusion/diff_model.npz")
    e.add_argument("--artist", default="Vincent_van_Gogh")
    e.add_argument("--num_samples", type=int, default=64)
    e.add_argument("--image_size", type=int, default=64)
    e.add_argument("--num_timesteps", type=int, default=1000)
    e.add_argument("--base_channels", type=int, default=64)
    e.add_argument("--guidance_scale", type=float, default=0.0)
    e.add_argument("--classifier_path", default="models/best-2.pth")
    e.add_argument("--seed", type=int, default=0)
    e.add_argument("--schedule", choices=("linear", "cosine"), default="linear")
    e.add_argument("--sample_batch", type=int, default=16)
    e.add_argument("--archive_dir", default="images/archive/")
    e.add_argument("--cache_dir", default="dicts/")
    for sp in (t, s, e):
        sp.add_argument("--device", default=None, help="torch device (default: cuda)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    import numpy as np
    import torch

    from artist_style_transfer_tpu_torch.data.datasets import (
        get_painting_dataset,
        load_artist_names,
    )
    from artist_style_transfer_tpu_torch.diffusion.gaussian import GaussianDiffusion
    from artist_style_transfer_tpu_torch.diffusion.unet import DiffModel
    from artist_style_transfer_tpu_torch.models.resnet import ARTISTS_19, load_classifier
    from artist_style_transfer_tpu_torch.train.checkpoint import (
        load_diff_model_npz,
        save_params_npz,
    )
    from artist_style_transfer_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)

    def corpus():
        return get_painting_dataset(
            for_classifier=False, rescale_height=args.image_size,
            rescale_width=args.image_size, archive_dir=args.archive_dir,
            cache_dir=args.cache_dir)

    if args.cmd == "train":
        from artist_style_transfer_tpu_torch.diffusion.train import train_diffusion

        paintings = corpus()
        names, _ = load_artist_names(args.archive_dir)
        images, labels = [], []
        for i, n in enumerate(names):
            arr = paintings.get(n)
            if arr is None or not len(arr):
                continue
            images.append(arr)
            labels.extend([i] * len(arr))
        model, _, losses = train_diffusion(
            np.concatenate(images), np.asarray(labels), num_classes=len(names),
            num_timesteps=args.num_timesteps, num_epochs=args.num_epochs,
            batch_size=args.batch_size, base_channels=args.base_channels, lr=args.lr,
            seed=args.seed, schedule=args.schedule, ema_decay=args.ema_decay or None,
            device=dev)
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        save_params_npz(args.out, model)
        # The label space: class id i = names[i] (artists.csv row order). sample and
        # eval condition in this space, which is not ARTISTS_19's order or size.
        with open(args.out + ".labels.json", "w") as f:
            json.dump({"names": names}, f)
        print(f"wrote {args.out} (+ .labels.json); final loss {losses[-1]:.4f}")
        return args.out

    # sample and eval share the model and sampler set-up. The model's class-id space
    # comes from its training sidecar; ARTISTS_19 only for a model saved without one.
    labels_path = args.model + ".labels.json"
    if os.path.exists(labels_path):
        with open(labels_path) as f:
            model_names = json.load(f)["names"]
    else:
        warnings.warn(
            f"{labels_path} not found; assuming the model was trained with "
            "the 19-artist label space (ARTISTS_19)",
            stacklevel=1,
        )
        model_names = list(ARTISTS_19)
    if args.artist not in model_names:
        raise SystemExit(
            f"artist {args.artist!r} is not in the model's label space; "
            f"trained artists: {', '.join(model_names)}"
        )
    model_cls_id = model_names.index(args.artist)
    model = DiffModel(len(model_names), args.base_channels)
    model.load_state_dict(load_diff_model_npz(args.model))
    model.to(dev)
    diffusion = GaussianDiffusion.make(args.num_timesteps, schedule=args.schedule, device=dev)

    # Guidance uses the fixed 19-class classifier head, whose label space is
    # ARTISTS_19 whatever the model's is.
    clf_y_id = None
    if args.guidance_scale > 0:
        if args.artist not in ARTISTS_19:
            raise SystemExit(
                f"classifier guidance requires an ARTISTS_19 artist; "
                f"{args.artist!r} is not one of them"
            )
        clf_y_id = ARTISTS_19.index(args.artist)
    clf = None
    if args.guidance_scale > 0 or args.cmd == "eval":
        clf = load_classifier(args.classifier_path, dev)
    generator = torch.Generator().manual_seed(args.seed)

    def labels_of(n: int):
        return ([model_cls_id] * n, None if clf_y_id is None else [clf_y_id] * n)

    if args.cmd == "eval":
        from artist_style_transfer_tpu_torch.diffusion.evaluate import cfid
        from artist_style_transfer_tpu_torch.diffusion.sample import diff_sample

        chunks = []
        for i in range(0, args.num_samples, args.sample_batch):
            y, cy = labels_of(min(args.sample_batch, args.num_samples - i))
            chunks.append(diff_sample(
                model, diffusion, generator, y, shape=(args.image_size, args.image_size),
                classifier=clf if args.guidance_scale > 0 else None,
                guidance_scale=args.guidance_scale, classifier_y=cy, device=dev,
            ).cpu().numpy())
        gen = np.concatenate(chunks)
        real = np.asarray(corpus()[args.artist])  # (n, H, W, 3) BGR [0,255]
        score = cfid(clf, real, gen, device=dev)
        print(f"CFID={score:.3f} (artist={args.artist}, n_gen={len(gen)}, n_real={len(real)})")
        return score

    from artist_style_transfer_tpu_torch.diffusion import sample as smp

    y, cy = labels_of(args.num_samples)
    kw = dict(shape=(args.image_size, args.image_size), classifier=clf,
              guidance_scale=args.guidance_scale, classifier_y=cy, device=dev)
    if args.dpmpp_steps > 0:
        out = smp.diff_sample_dpmpp(model, diffusion, generator, y, steps=args.dpmpp_steps, **kw)
    elif args.ddim_steps > 0:
        out = smp.diff_sample_ddim(model, diffusion, generator, y, steps=args.ddim_steps,
                                   eta=args.ddim_eta, **kw)
    else:
        out = smp.diff_sample(model, diffusion, generator, y, **kw)
    import cv2

    grid = np.concatenate(out.cpu().numpy().astype(np.uint8), axis=1)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    cv2.imwrite(args.out, grid)
    print(f"wrote {args.out}")
    return args.out


if __name__ == "__main__":
    main()
