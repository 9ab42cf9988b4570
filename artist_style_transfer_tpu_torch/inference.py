"""Inference CLI — ``python -m artist_style_transfer_tpu_torch.inference``.

The flags of the JAX package's inference CLI, on the GPU (``--device cpu``
to run on the CPU). The display mode (default) stylizes one content image,
optionally blurs/sharpens it and writes a 2/3-panel figure to
figs/<artist>_<method>.png (reference inference.py:70-152). The
``--no-display`` classifier evaluation, the interactive ``--show`` window
and ``--quantize`` belong to later slices of the port and raise
``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from artist_style_transfer_tpu_torch.utils.config import InferenceConfig

_DEFAULTS = InferenceConfig()


def build_parser() -> argparse.ArgumentParser:
    """Flags mirror :class:`InferenceConfig` fields 1:1."""
    d = _DEFAULTS
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--style_method", default=d.style_method)
    p.add_argument("--artist", default=d.artist)
    p.add_argument("--model_filename", default=d.model_filename,
                   help="checkpoint inside models/<artist>/<method>/ (.pth)")
    p.add_argument("--model_dir", default=d.model_dir)
    p.add_argument("--no-display", dest="display", action="store_false",
                   help="run quantitative classifier evaluation instead")
    p.add_argument("--show", action="store_true", default=d.show)
    p.add_argument("--content_img", default=d.content_img)
    p.add_argument("--content_size_w", type=int, default=d.content_size_w)
    p.add_argument("--sharpen", action="store_true", default=d.sharpen)
    p.add_argument("--sharpen_val", type=float, default=d.sharpen_val)
    p.add_argument("--blur", action="store_true", default=d.blur)
    p.add_argument("--blur_sigma", type=float, default=d.blur_sigma)
    p.add_argument("--blur_kernel", type=int, default=d.blur_kernel)
    p.add_argument("--content_dir", default=d.content_dir)
    p.add_argument("--resize_imgs", action="store_true", default=d.resize_imgs)
    p.add_argument("--no-resize_imgs", dest="resize_imgs", action="store_false")
    p.add_argument("--resize_size", type=int, default=d.resize_size)
    p.add_argument("--num_images", type=int, default=d.num_images)
    p.add_argument("--fig_dir", default=d.fig_dir)
    p.add_argument("--classifier_path", default=d.classifier_path)
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--quantize", action="store_true", default=d.quantize)
    p.add_argument("--device", default=d.device, help="torch device (default: cuda)")
    return p


def run_display(args, model) -> str:
    """Stylize one image and write the figure; returns the figure path."""
    import cv2

    from artist_style_transfer_tpu_torch.infer.stylize import (
        gaussian_blur,
        save_figure,
        sharpen,
        stylize_batched,
    )

    im = cv2.imread(args.content_img)
    if im is None:
        raise FileNotFoundError(args.content_img)
    if args.content_size_w > 0:  # inference.py:72-76
        h, w, _ = im.shape
        im = cv2.resize(im, (args.content_size_w, int(h * args.content_size_w / w)))

    out = stylize_batched(model, [im.astype(np.float32)], device=args.device)[0]
    if args.blur:
        out = gaussian_blur(out, args.blur_sigma, args.blur_kernel)
    if args.sharpen:
        out = sharpen(out, args.sharpen_val)

    style_img = None
    if args.style_method in ("random", "artist", "average"):  # inference.py:77-78
        style_path = os.path.join(args.model_dir, args.artist, args.style_method, "style.jpg")
        if os.path.exists(style_path):
            style_img = cv2.imread(style_path)

    fig_path = os.path.join(args.fig_dir, f"{args.artist}_{args.style_method}.png")
    save_figure(fig_path, im, out, style_img)
    print(f"wrote {fig_path}")
    return fig_path


def main(argv=None):
    return _run(build_parser().parse_args(argv))


def _run(args):
    from artist_style_transfer_tpu_torch.infer.stylize import load_transfer_params

    if not args.display:
        raise NotImplementedError(
            "--no-display (classifier evaluation) comes with the port's classifier slice"
        )
    if args.show or args.quantize:
        raise NotImplementedError("--show and --quantize are not ported yet")
    model_dir = os.path.join(args.model_dir, args.artist, args.style_method)
    if args.model_filename is None or not os.path.exists(
        os.path.join(model_dir, args.model_filename)
    ):
        raise NotImplementedError(args.model_filename)  # inference.py:63-64
    model = load_transfer_params(os.path.join(model_dir, args.model_filename), args.device)
    return run_display(args, model)


if __name__ == "__main__":
    main()
