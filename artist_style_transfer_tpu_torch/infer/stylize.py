"""Feed-forward stylization (counterpart of the JAX ``infer/stylize.py``; reference
inference.py:104-125).

Takes NHWC BGR [0,255] images (uint8 or float32) and returns the stylized
batch, clipped to uint8 by default; :func:`stylize_int8` runs the quantized
net (int8 interior convs on kernel K2). :func:`stylize_spatial` and
:func:`stylize_spatial_int8` stylize one image with its rows spread over a mesh's
ranks (:mod:`parallel.spatial`).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from artist_style_transfer_tpu_torch.models.transformer import TransformerNet
from artist_style_transfer_tpu_torch.models.transformer_q import QuantizedTransformerNet
from artist_style_transfer_tpu_torch.parallel.mesh import Mesh, check_mesh
from artist_style_transfer_tpu_torch.parallel.spatial import RowBands, all_rows
from artist_style_transfer_tpu_torch.utils.device import module_device, resolve_device, same_device


def stylize(
    model: TransformerNet,
    images_bgr_255,
    clip: bool = True,
    fold_batch: bool = False,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """Stylize a batch: NHWC BGR [0,255] -> NHWC BGR on ``device`` (uint8 if ``clip``).

    uint8 input crosses to the device as uint8 and is cast there (a quarter
    of the f32 bytes). Clipping matches the reference's save-time clip
    (inference.py:116). ``model`` must already live on ``device``.
    """
    dev = resolve_device(device)
    model_dev = next(model.parameters()).device
    if not same_device(model_dev, dev):
        raise ValueError(f"model is on {model_dev}, not on {dev}")
    x = torch.as_tensor(images_bgr_255).to(dev).float()
    with torch.inference_mode():
        out = model(x, fold_batch=fold_batch)
        if clip:
            out = out.clamp(0.0, 255.0).to(torch.uint8)
    return out


def stylize_int8(
    qmodel: QuantizedTransformerNet,
    images_bgr_255,
    clip: bool = True,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """Int8 stylize (JAX ``stylize_int8``): the contract of :func:`stylize`, through the
    quantized forward with bf16 accumulators (JAX ``accum=jnp.bfloat16``).

    ``qmodel`` comes from :func:`models.transformer_q.quantize_transformer` and must
    live on ``device`` (``None`` means CUDA). Returns NHWC BGR, uint8 if ``clip``
    else bf16.
    """
    dev = resolve_device(device)
    qdev = next(qmodel.buffers()).device
    if not same_device(qdev, dev):
        raise ValueError(f"quantized model is on {qdev}, not on {dev}")
    x = torch.as_tensor(images_bgr_255).to(dev)
    with torch.inference_mode():
        out = qmodel(x, accum=torch.bfloat16)
        if clip:
            out = out.float().clamp(0.0, 255.0).to(torch.uint8)
    return out


def _spatial(net, image_bgr_255, mesh: Mesh, device, run) -> torch.Tensor:
    """The shared body of the two row-sharded entry points: this rank's band of the
    input rows through ``run(x_band, bands) -> (y_band, out_bands)``, then the whole
    output gathered on every rank. The rows spread over the 'data' line (JAX's
    ``P(None, "data")``) and repeat over 'space': each rank of a 'space' line computes
    the same band."""
    check_mesh(mesh)
    line = mesh.axis_mesh("data")
    dev = resolve_device(device)
    for name, where in (("model", module_device(net)), ("mesh", mesh.device)):
        if not same_device(where, dev):
            raise ValueError(f"{name} is on {where}, not on {dev}")
    x = torch.as_tensor(image_bgr_255)
    squeeze = x.dim() == 3
    x = x[None] if squeeze else x
    bands = RowBands.even(line, x.shape[1])
    a, b = bands.bounds()
    with torch.inference_mode():
        y, out_bands = run(x[:, a:b].to(dev), bands)
        out = all_rows(y, out_bands, dim=1)
    return out[0] if squeeze else out


def stylize_spatial(
    model: TransformerNet,
    image_bgr_255,
    mesh: Mesh,
    clip: bool = True,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """Stylize one image with its H rows spread over ``mesh``'s ranks (JAX
    ``stylize_spatial``, which shards H over the 'data' axis).

    Every rank calls it with the same image (HWC or NHWC BGR [0,255]) and computes
    its band of rows (on a ('data', 'space') mesh, the band of its 'data' line; the
    ranks of a 'space' line compute the same one, and with one data slice the whole
    image): before each conv it fetches the halo rows the conv reads from
    its neighbours, and each instance norm takes the whole image's statistics
    (:mod:`parallel.spatial`), so the activations a rank holds are about 1/n of the
    image's plus halos. Returns the whole output on every rank, the input's rank,
    uint8 if ``clip``. The 'data' line's size must divide H, as JAX's sharding needs; the
    bands at half and quarter resolution may be uneven. Equal to :func:`stylize` up
    to the order of the sums.
    """
    def run(x, bands):
        y, out_bands = model.forward_rows(x.float(), bands)
        return (y.clamp(0.0, 255.0).to(torch.uint8) if clip else y), out_bands

    return _spatial(model, image_bgr_255, mesh, device, run)


def stylize_spatial_int8(
    qmodel: QuantizedTransformerNet,
    image_bgr_255,
    mesh: Mesh,
    clip: bool = True,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """Int8 :func:`stylize_spatial` (JAX ``stylize_spatial_int8``): the quantized net
    with bf16 accumulators, as :func:`stylize_int8`, on a band of rows a rank.

    The static activation scales make every rank quantize its rows, halo rows
    included, to the single-device codes; the instance-norm statistics are the
    whole image's. Returns NHWC (or HWC) BGR on every rank, uint8 if ``clip`` else
    bf16; equal to :func:`stylize_int8` up to the order of the IN sums.
    """
    def run(x, bands):
        y, out_bands = qmodel.forward_rows(x, bands, accum=torch.bfloat16)
        return (y.float().clamp(0.0, 255.0).to(torch.uint8) if clip else y), out_bands

    return _spatial(qmodel, image_bgr_255, mesh, device, run)


def stylize_batched(
    model: TransformerNet,
    images: list[np.ndarray],
    batch_size: int = 8,
    device: str | torch.device | None = None,
) -> list[np.ndarray]:
    """Stylize variable-sized HWC images, batching same-shaped ones together.

    Groups by exact (H, W); no padding, because zero padding would shift the
    instance-norm statistics everywhere. The output size follows the net's
    conv arithmetic: equal to the input for H, W divisible by 4, else up to
    2 px larger. Returns uint8 BGR HWC arrays in input order.
    """
    groups: dict[tuple[int, int], list[int]] = {}
    for i, im in enumerate(images):
        groups.setdefault((im.shape[0], im.shape[1]), []).append(i)
    results: list[np.ndarray | None] = [None] * len(images)
    for idxs in groups.values():
        for start in range(0, len(idxs), batch_size):
            chunk = idxs[start : start + batch_size]
            stacked = np.stack([images[i] for i in chunk])
            if stacked.dtype != np.uint8:
                stacked = stacked.astype(np.float32)
            out = stylize(model, stacked, device=device).cpu().numpy()
            for j, i in enumerate(chunk):
                results[i] = out[j]
    return results  # type: ignore[return-value]


def load_transfer_params(path: str, device: str | torch.device | None = None) -> TransformerNet:
    """Load a TransformerNet from ``.pth`` (reference format) or ``.npz`` (the
    training artifact of either package) onto ``device``, in eval mode.

    Mirrors ``StyleTransfer(state_dict_filename=...)`` (cnn.py:41-42). The
    ``.ckpt`` checkpoints carry optimizer state and are for resuming training.
    """
    dev = resolve_device(device)
    if path.endswith(".npz"):
        from artist_style_transfer_tpu_torch.train.checkpoint import load_params_npz

        sd = load_params_npz(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    model = TransformerNet()
    model.load_state_dict(sd)
    return model.to(dev).eval()


def gaussian_blur(image_hwc: np.ndarray, sigma: float = 1.0, ksize: int = 3) -> np.ndarray:
    """cv2.GaussianBlur((ksize, ksize), sigma) for odd ``ksize`` (reference inference.py:120).

    Separable sampled Gaussian; numpy 'reflect' padding is cv2's default
    BORDER_REFLECT_101.
    """
    if ksize % 2 != 1:
        raise ValueError(f"ksize must be odd, got {ksize}")
    r = ksize // 2
    xs = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(xs**2) / (2 * sigma * sigma))
    k /= k.sum()
    h, w = image_hwc.shape[:2]
    pad = np.pad(image_hwc.astype(np.float64), ((r, r), (r, r), (0, 0)), mode="reflect")
    rows = sum(pad[i : i + h] * k[i] for i in range(ksize))
    out = sum(rows[:, i : i + w] * k[i] for i in range(ksize))
    return np.clip(out, 0, 255).astype(np.uint8)


def gaussian_blur_3x3(image_hwc: np.ndarray, sigma: float = 1.0) -> np.ndarray:
    """cv2.GaussianBlur(ksize=(3, 3)) equivalent (reference inference.py:120)."""
    return gaussian_blur(image_hwc, sigma, ksize=3)


def sharpen(image_hwc: np.ndarray, sharpen_val: float = 50.0) -> np.ndarray:
    """The reference's cv2.filter2D sharpen kernel (inference.py:123-125)."""
    kern = np.array([[-1, -1, -1], [-1, sharpen_val, -1], [-1, -1, -1]], np.float64) / (
        sharpen_val - 8
    )
    pad = np.pad(image_hwc.astype(np.float64), ((1, 1), (1, 1), (0, 0)), mode="reflect")
    out = np.zeros_like(image_hwc, np.float64)
    for dy in range(3):
        for dx in range(3):
            out += pad[dy : dy + image_hwc.shape[0], dx : dx + image_hwc.shape[1]] * kern[dy, dx]
    return np.clip(out, 0, 255).astype(np.uint8)


def save_figure(
    fig_path: str,
    content_bgr: np.ndarray,
    out_bgr: np.ndarray,
    style_bgr: np.ndarray | None = None,
    show: bool = False,
) -> None:
    """2-/3-panel Content/Style/Transformed figure (reference inference.py:126-152).

    With matplotlib: the reference's figure through the non-interactive Agg
    backend; ``show=True`` also opens its blocking window (inference.py:152)
    where a display and a GUI backend exist, and on a headless host writes the
    file alone. Without matplotlib: the same panels, side by side in the same
    order and place, the titles drawn as text, written with OpenCV
    (:func:`_save_figure_cv2`). Neither installed: ``RuntimeError``.
    """
    panels = 3 if style_bgr is not None else 2
    titles = ["Content", "Style", "Transformed"] if panels == 3 else ["Content", "Transformed"]
    imgs = [content_bgr, style_bgr, out_bgr] if panels == 3 else [content_bgr, out_bgr]
    imgs = [np.clip(img, 0, 255).astype(np.uint8) for img in imgs]
    os.makedirs(os.path.dirname(fig_path) or ".", exist_ok=True)
    try:
        import matplotlib
    except ImportError:
        try:
            import cv2
        except ImportError:
            raise RuntimeError("save_figure needs matplotlib or OpenCV (cv2); neither is "
                               "installed") from None
        _save_figure_cv2(cv2, fig_path, imgs, titles)
        return

    has_display = bool(os.environ.get("DISPLAY")) or sys.platform in ("darwin", "win32")
    interactive = show and has_display and matplotlib.get_backend().lower() not in _FILE_BACKENDS
    if not interactive:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=_FIGSIZE)
    try:
        for i, (img, title) in enumerate(zip(imgs, titles)):
            ax = fig.add_subplot(1, panels, i + 1)
            ax.imshow(img[..., ::-1], interpolation="nearest", aspect="auto")
            ax.set_title(title, fontsize=28)
            ax.axis("off")
        fig.savefig(fig_path)
        if interactive:
            try:
                plt.show()  # blocking, like the reference's display loop
            except Exception as e:  # a stale DISPLAY: the file is written, so warn only
                import logging

                logging.getLogger(__name__).warning("show: no interactive window (%s)", e)
    finally:
        plt.close(fig)


_FILE_BACKENDS = ("agg", "pdf", "ps", "svg", "template")
_FIGSIZE = (18, 5)  # inches, at matplotlib's default 100 dpi
# matplotlib's default subplot parameters: the axes' box within the figure, and the
# gap between axes as a fraction of their width.
_SUBPLOT = {"left": 0.125, "right": 0.9, "bottom": 0.11, "top": 0.88, "wspace": 0.2}


def _save_figure_cv2(cv2, fig_path: str, imgs: list[np.ndarray], titles: list[str]) -> None:
    """The figure of :func:`save_figure` drawn with OpenCV: a white 1800x500 canvas, each
    image stretched into the box matplotlib gives its axes (nearest neighbour, as
    ``imshow(interpolation="nearest", aspect="auto")``), its title centred above."""
    width, height = _FIGSIZE[0] * 100, _FIGSIZE[1] * 100
    sp = _SUBPLOT
    n = len(imgs)
    axes_w = (sp["right"] - sp["left"]) * width / (n + (n - 1) * sp["wspace"])
    y0, y1 = round((1 - sp["top"]) * height), round((1 - sp["bottom"]) * height)
    canvas = np.full((height, width, 3), 255, np.uint8)
    font, scale, thick = cv2.FONT_HERSHEY_SIMPLEX, 1.4, 2
    for i, (img, title) in enumerate(zip(imgs, titles)):
        x0 = round(sp["left"] * width + i * axes_w * (1 + sp["wspace"]))
        x1 = round(sp["left"] * width + i * axes_w * (1 + sp["wspace"]) + axes_w)
        canvas[y0:y1, x0:x1] = cv2.resize(img, (x1 - x0, y1 - y0),
                                          interpolation=cv2.INTER_NEAREST)
        (tw, _), _ = cv2.getTextSize(title, font, scale, thick)
        cv2.putText(canvas, title, ((x0 + x1 - tw) // 2, y0 - 14), font, scale, (0, 0, 0), thick,
                    cv2.LINE_AA)
    if not cv2.imwrite(fig_path, canvas):
        raise OSError(f"cv2 could not write {fig_path}")
