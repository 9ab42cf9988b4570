"""Training and inference configuration (the port's own copy of the JAX
``utils/config.py``; reference train_cnn.py:25-44 and inference.py:24-52 constants)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class TrainConfig:
    """Training configuration. Defaults = reference defaults (train_cnn.py:25-44)."""

    style_method: str = "random"  # 'random'|'average'|'smartaverage'|'cycle'|'classifier'
    artist: str = "Albrecht_Dürer"
    num_epochs: int = 200
    batch_size: int = 4
    content_data_size: int = 256
    seed: int = 2
    num_steps: int = 2  # LR halvings: StepLR(step=num_epochs//num_steps, gamma=0.5)
    content_weight: float = 17.0
    style_weight: float = 25.0
    lr: float = 0.0024
    save_every: int = 10
    weight_decay: float = 1e-4  # reference train_cnn.py:247
    train_size: int = 224  # reference TRAIN_SIZE (gpu default), train_cnn.py:28

    compute_dtype: str = "float32"  # 'float32' for parity, 'bfloat16' for speed
    data_dir: str = "images"
    model_dir: str = "models"
    log_every_batches: int = 12  # reference BATCH_INFO_EVERY, train_cnn.py:29
    mesh_shape: tuple[int, ...] | None = None  # a 'data' mesh of this shape over the process group
    classifier_path: str = "models/best-2.pth"  # 'classifier' mode's frozen classifier
    reference_typo_stats: bool = False  # the reference training path's 0.546 G mean
    device: str | None = None  # torch device; None means "cuda"


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
