"""Inference configuration (the port's own copy of the JAX ``utils/config.py``
``InferenceConfig``; reference inference.py:24-52 constants).

``TrainConfig`` belongs to the training slice.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class InferenceConfig:
    style_method: str = "random"
    artist: str = "Pablo_Picasso"
    model_filename: str | None = None
    display: bool = True
    show: bool = False
    content_img: str = "cuteimages/landscape.jpg"
    content_size_w: int = 1024
    sharpen: bool = False
    blur: bool = False
    sharpen_val: float = 50.0
    blur_sigma: float = 1.0
    blur_kernel: int = 3
    content_dir: str = "images/content/"
    resize_imgs: bool = True
    resize_size: int = 1024
    num_images: int = 133
    fig_dir: str = "figs"
    model_dir: str = "models"
    classifier_path: str = "models/best-2.pth"
    seed: int | None = None
    quantize: bool = False
    device: str | None = None  # torch device; None means "cuda"
