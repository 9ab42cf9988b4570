"""Gatys iterative stylization CLI — ``python -m artist_style_transfer_tpu_torch.stylize_gatys``.

BASELINE config 1: VGG-16 Gram + content loss on a content/style image
pair, Adam on the pixels, on the GPU (``--device cpu`` to run on the CPU).
"""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--content_img", default="cuteimages/landscape.jpg")
    p.add_argument("--style_img", default="cuteimages/Pierre-Auguste_Renoir_2.jpg")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--num_steps", type=int, default=300)
    p.add_argument("--lr", type=float, default=4.0)
    p.add_argument("--content_weight", type=float, default=17.0)
    p.add_argument("--style_weight", type=float, default=25.0)
    p.add_argument("--vgg_path", default="models/vgg16-00b39a1b.pth")
    p.add_argument("--out", default="figs/gatys.png")
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    return p


def main(argv=None) -> str:
    args = build_parser().parse_args(argv)
    import cv2
    import numpy as np

    from artist_style_transfer_tpu_torch.models.vgg import load_vgg16
    from artist_style_transfer_tpu_torch.train.gatys import gatys_stylize
    from artist_style_transfer_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    vgg = load_vgg16(args.vgg_path, device)
    content = cv2.resize(cv2.imread(args.content_img), (args.size, args.size)).astype(np.float32)
    style = cv2.resize(cv2.imread(args.style_img), (args.size, args.size)).astype(np.float32)

    out, losses = gatys_stylize(
        vgg,
        content,
        style,
        num_steps=args.num_steps,
        lr=args.lr,
        content_weight=args.content_weight,
        style_weight=args.style_weight,
        device=device,
    )
    losses = losses.cpu().numpy()
    print(f"loss {losses[0]:.1f} -> {losses[-1]:.1f} over {args.num_steps} steps")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    cv2.imwrite(args.out, out.cpu().numpy().clip(0, 255).astype(np.uint8))
    print(f"wrote {args.out}")
    return args.out


if __name__ == "__main__":
    main()
