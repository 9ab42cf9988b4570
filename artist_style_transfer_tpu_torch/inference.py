"""Inference CLI — ``python -m artist_style_transfer_tpu_torch.inference``.

The flags of the JAX package's inference CLI, on the GPU (``--device cpu``
to run on the CPU). Two modes, as in the reference:

- display (default): stylize one content image, optionally blur/sharpen it,
  and write a 2/3-panel figure to figs/<artist>_<method>.png
  (inference.py:70-152);
- ``--no-display``: stylize up to ``--num_images`` JPEGs of ``--content_dir``
  and print the classifier's accuracy ``Acc=...`` (inference.py:79-166).

Both decode with OpenCV, imported only when they run; ``--no-display
--resize_imgs`` takes the native decode pool where it is available. The figure
is written with matplotlib, or with OpenCV where matplotlib is missing;
``--show`` also opens the reference's window where a display exists, and on a
headless host writes the file alone. ``--no-display --quantize`` runs the int8
eval pipeline (both nets quantized, their convs on kernel K2).
:func:`run_from_config` runs it from an :class:`InferenceConfig`.
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
    p.add_argument("--quantize", action="store_true", default=d.quantize,
                   help="eval mode: run the stylize->classify pipeline in int8 (quantized "
                        "stylizer and quantized frozen classifier)")
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
    save_figure(fig_path, im, out, style_img, show=args.show)
    print(f"wrote {fig_path}")
    return fig_path


def load_eval_images(args) -> list[np.ndarray]:
    """Up to ``--num_images`` BGR JPEGs of ``--content_dir``, shuffled by ``--seed``.

    Under ``--resize_imgs`` each is resized to ``--resize_size`` square, as the
    JAX CLI does it (its ``inference.py:116-157``): the native decode pool
    where it is available (float32 images; files it rejects are skipped),
    else, or where it read none, OpenCV on the thread pool (uint8). Otherwise
    images above 1600 rows or 1024 columns, or below 224 in either, are
    skipped (inference.py:84-101). Unreadable files are skipped. Files are
    decoded in chunks of what is still missing, in the shuffled order, so the
    result is the serial loop's.
    """
    import random as _random

    import cv2

    from artist_style_transfer_tpu_torch.data import native_loader
    from artist_style_transfer_tpu_torch.data.datasets import pool_map

    files = [f for f in os.listdir(args.content_dir) if ".jpg" in f or ".JPEG" in f]
    rng = _random.Random(args.seed) if args.seed is not None else _random
    rng.shuffle(files)
    paths = [os.path.join(args.content_dir, f) for f in files]
    size = args.resize_size

    def read(path: str) -> np.ndarray | None:
        im = cv2.imread(path)
        if im is None:
            return None
        if args.resize_imgs:
            return cv2.resize(im, (size, size))
        h, w, _ = im.shape
        return None if h > 1600 or w > 1024 or h < 224 or w < 224 else im

    def take(decode) -> list[np.ndarray]:
        content, i = [], 0
        while len(content) < args.num_images and i < len(paths):
            chunk = paths[i : i + (args.num_images - len(content))]
            i += len(chunk)
            content += [im for im in decode(chunk) if im is not None]
        return content

    content = []
    if args.resize_imgs and native_loader.available():
        def native(chunk):
            out, ok = native_loader.decode_batch(chunk, size, size)
            return [out[k] if ok[k] else None for k in range(len(chunk))]
        content = take(native)
    return content or take(lambda chunk: pool_map(read, chunk))


def run_eval(args, model) -> float:
    """Classifier-accuracy evaluation (inference.py:79-166); returns the accuracy in %."""
    from artist_style_transfer_tpu_torch.infer.evaluate import evaluate_with_classifier
    from artist_style_transfer_tpu_torch.models.resnet import ARTISTS_19, load_classifier

    classifier = load_classifier(args.classifier_path, args.device)
    content = load_eval_images(args)
    print(f"Grabbed {len(content)} images!\n")  # inference.py:102
    # Mixed sizes (under --no-resize_imgs) batch by exact shape inside.
    return evaluate_with_classifier(model, classifier, content, ARTISTS_19.index(args.artist),
                                    artists=ARTISTS_19, quantize=args.quantize,
                                    device=args.device)


def main(argv=None):
    return _run(build_parser().parse_args(argv))


def run_from_config(config: InferenceConfig, **overrides):
    """Run inference from an :class:`InferenceConfig`; its fields map 1:1 onto the
    flags, and keyword overrides win (JAX ``run_from_config``)."""
    import dataclasses

    return _run(argparse.Namespace(**{**dataclasses.asdict(config), **overrides}))


def _run(args):
    from artist_style_transfer_tpu_torch.infer.stylize import load_transfer_params

    model_dir = os.path.join(args.model_dir, args.artist, args.style_method)
    if args.model_filename is None or not os.path.exists(
        os.path.join(model_dir, args.model_filename)
    ):
        raise NotImplementedError(args.model_filename)  # inference.py:63-64
    model = load_transfer_params(os.path.join(model_dir, args.model_filename), args.device)
    if args.display:
        return run_display(args, model)
    return run_eval(args, model)


if __name__ == "__main__":
    main()
