"""Image I/O (counterpart of the JAX ``utils/images.py``), plus a small PNG reader.

The reader needs only numpy and ``zlib``, so images can be read where
neither OpenCV nor PIL is installed. It takes 8-bit, non-interlaced PNGs of
colour type 2 (RGB) or 6 (RGBA) with any of the five row filters, and
returns what ``cv2.imread(path)`` returns for them: HWC uint8 BGR.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {2: 3, 6: 4}  # colour type -> samples per pixel


def to_image(tensor_bgr) -> np.ndarray:
    """BGR HWC/NHWC(1) [0,255] -> RGB HWC float64, reference to_image semantics."""
    arr = np.asarray(tensor_bgr)
    if arr.ndim == 4:
        arr = arr[0]
    return arr[..., ::-1].astype(np.float64)


def save_tensor_image(filename: str, tensor_bgr) -> None:
    """Clip to [0,255], uint8, write with cv2 (reference save_tensor_image)."""
    import cv2

    arr = np.asarray(tensor_bgr)
    if arr.ndim == 4:
        arr = arr[0]
    os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
    cv2.imwrite(filename, np.clip(arr, 0, 255).astype(np.uint8))


def imshow_array(img_rgb_255, out_path: str | None = None, title: str | None = None):
    """[0,255] RGB -> the [0,1] clipped display array (JAX ``imshow_array``; the
    reference's imshow, train_cnn.py:128-134, without its blocking ``plt.pause``).

    ``out_path`` also writes the figure: with matplotlib (Agg) as JAX writes it, the
    ``title`` above the image; where matplotlib is missing, the display array alone
    with OpenCV.
    """
    disp = np.clip(np.asarray(img_rgb_255) / 255.0, 0.0, 1.0)
    if out_path is not None:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        try:
            import matplotlib
        except ImportError:
            import cv2

            cv2.imwrite(out_path, np.round(disp[..., ::-1] * 255.0).astype(np.uint8))
            return disp
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig = plt.figure()
        plt.imshow(disp)
        if title:
            plt.title(title)
        fig.savefig(out_path)
        plt.close(fig)
    return disp


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    pos = 0
    for y in range(height):
        ftype = raw[pos]
        line = np.frombuffer(raw, np.uint8, stride, pos + 1)
        pos += stride + 1
        if ftype == 0:  # None
            cur = line.copy()
        elif ftype == 2:  # Up
            cur = line + prev
        elif ftype == 1:  # Sub: running sum per channel, mod 256
            cur = (
                np.cumsum(line.reshape(-1, bpp).astype(np.int64), axis=0) % 256
            ).astype(np.uint8).reshape(-1)
        elif ftype in (3, 4):  # Average, Paeth: left-dependent, byte by byte
            cur_l = bytearray(stride)
            up = prev.tolist()
            src = line.tolist()
            for i in range(stride):
                left = cur_l[i - bpp] if i >= bpp else 0
                if ftype == 3:
                    pred = (left + up[i]) >> 1
                else:
                    pred = _paeth(left, up[i], up[i - bpp] if i >= bpp else 0)
                cur_l[i] = (src[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur_l), np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {ftype} on row {y}")
        out[y] = cur
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit RGB/RGBA PNG to HWC uint8 BGR, as ``cv2.imread(path)`` does.

    An alpha channel is dropped, as cv2's default ``IMREAD_COLOR`` does.
    Anything else (palette, grey, 16-bit, interlaced) raises ``ValueError``.
    """
    with open(path, "rb") as fh:
        data = fh.read()
    if not data.startswith(_PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos = len(_PNG_SIGNATURE)
    header = None
    idat = []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, colour type {ctype}, "
            f"interlace {interlace}); only 8-bit non-interlaced RGB/RGBA"
        )
    ch = _CHANNELS[ctype]
    rows = _unfilter(zlib.decompress(b"".join(idat)), height, width * ch, ch)
    rgb = rows.reshape(height, width, ch)[..., :3]
    return np.ascontiguousarray(rgb[..., ::-1])
