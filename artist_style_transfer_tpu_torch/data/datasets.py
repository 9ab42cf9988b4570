"""Host-side dataset loaders (the port's own copy of the JAX ``data/datasets.py``,
mirroring the reference ``dataset.py`` API).

Loaders return **NHWC, BGR, [0,255]** numpy float32 (uint8 in the caches), as
the JAX package's do; ``train()`` moves them to the device once.

- ``get_content_dataset(size, rescale_height, rescale_width)``  (dataset.py:90-111)
- ``get_painting_dataset(for_classifier, ...)``                 (dataset.py:120-229)
- ``get_avg_dataset(rescale_height, rescale_width)``            (dataset.py:56-87)
- ``rescale_image`` / ``get_rescale_dims``                      (dataset.py:16-52)

The decode policy is JAX's: the native pool (:mod:`.native_loader`) where it
is available, with a per-file OpenCV fallback for what it rejects; else
OpenCV alone. The OpenCV route decodes on a small thread pool (``cv2.imread``,
``resize`` and ``warpAffine`` release the interpreter lock) and gives exactly
what JAX's serial loop gives: the same files in the same order, the same
skips. A loader given a ``stats`` dict fills it with the route it took
(``"decoder"``: ``"native"`` or ``"cv2"``; ``"source"`` for the painting
caches) and its counts.
"""

from __future__ import annotations

import os
import pickle
import random as _random
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, TypeVar

import numpy as np

from artist_style_transfer_tpu_torch.data import native_loader
from artist_style_transfer_tpu_torch.ops.image import TORCHVISION_MEAN_RGB, TORCHVISION_STD_RGB

try:
    import cv2
except ImportError:  # the loaders raise when they need it
    cv2 = None

ARCHIVE_DIR = "images/archive/"
CONTENT_DIR = "images/content/"
CACHE_DIR = "dicts/"  # also where the reference's full_int_*.pkl caches live
DECODE_THREADS = min(8, os.cpu_count() or 1)

_T = TypeVar("_T")
_R = TypeVar("_R")


def _require_cv2():
    if cv2 is None:
        raise RuntimeError("OpenCV is required for host-side image decode")


def pool_map(fn: Callable[[_T], _R], items: list[_T]) -> list[_R]:
    """``[fn(x) for x in items]`` on up to DECODE_THREADS threads, results in order."""
    if len(items) <= 1:
        return [fn(x) for x in items]
    with ThreadPoolExecutor(max_workers=min(DECODE_THREADS, len(items))) as pool:
        return list(pool.map(fn, items))


def load_artist_names(archive_dir: str = ARCHIVE_DIR) -> tuple[list[str], list[int]]:
    """Artist names (spaces -> underscores) and painting counts from artists.csv
    (dataset.py:122-127)."""
    import csv

    names, counts = [], []
    with open(os.path.join(archive_dir, "artists.csv"), newline="", encoding="utf-8") as f:
        for row in csv.DictReader(f):
            names.append(row["name"].replace(" ", "_"))
            counts.append(int(row["paintings"]))
    return names, counts


def get_rescale_dims(
    images_by_artist: dict[str, list[np.ndarray]],
    total_paintings: int,
    rescale_height: int = -1,
    rescale_width: int = -1,
) -> tuple[int, int]:
    """Target dims: as given, else half the corpus-average dims (dataset.py:16-33)."""
    if rescale_width > 0 and rescale_height > 0:
        return rescale_height, rescale_width
    avg_h = avg_w = 0.0
    for images in images_by_artist.values():
        for im in images:
            avg_h += im.shape[0] / total_paintings
            avg_w += im.shape[1] / total_paintings
    return int(avg_h) // 2, int(avg_w) // 2


def rescale_image(image: np.ndarray, target_height: int, target_width: int) -> np.ndarray:
    """Centered anisotropic affine rescale, the reference ``rescale`` (dataset.py:36-52),
    by cv2.warpAffine; :func:`ops.image.affine_rescale` is the same on tensors."""
    _require_cv2()
    src_h, src_w = image.shape[0], image.shape[1]
    h_s = target_height / src_h
    w_s = target_width / src_w
    M = np.array(
        [
            [w_s, 0.0, target_width / 2 - w_s * src_w / 2],
            [0.0, h_s, target_height / 2 - h_s * src_h / 2],
        ],
        dtype=np.float64,
    )
    return cv2.warpAffine(image, M, (target_width, target_height))


def cv2_decode(path: str, target_height: int, target_width: int,
               rescale: bool) -> np.ndarray | None:
    """One file through OpenCV: imread, then resize (or the affine rescale), f32; None
    where imread fails. JAX's ``_cv2_fallback_decode``: the per-file fallback for what
    the native decoder rejects (cv2.imread also reads CMYK/YCCK JPEGs and other
    formats), and the whole OpenCV route."""
    _require_cv2()
    im = cv2.imread(path)
    if im is None:
        return None
    if rescale:
        return rescale_image(im, target_height, target_width).astype(np.float32)
    return cv2.resize(im, (target_width, target_height)).astype(np.float32)


def decode_files(paths: list[str], height: int, width: int, rescale: bool, counts: dict,
                 threads: bool = True) -> list[np.ndarray | None]:
    """Decode ``paths`` to (height, width) f32 images in order, None where no decoder
    reads a file: the native pool where available with a per-file OpenCV fallback
    (``counts["cv2_fallbacks"]``), else OpenCV, on the thread pool unless ``threads``
    is False."""
    if native_loader.available():
        mode = native_loader.MODE_RESCALE if rescale else native_loader.MODE_RESIZE
        out, ok = native_loader.decode_batch(paths, height, width, mode)
        images: list[np.ndarray | None] = [out[j] if ok[j] else None for j in range(len(paths))]
        for j in np.flatnonzero(~ok):
            images[j] = cv2_decode(paths[j], height, width, rescale) if cv2 is not None else None
            counts["cv2_fallbacks"] = counts.get("cv2_fallbacks", 0) + 1
        return images
    decode = lambda p: cv2_decode(p, height, width, rescale)  # noqa: E731
    return pool_map(decode, paths) if threads else [decode(p) for p in paths]


def decoder_route() -> str:
    """The route the loaders take here: ``"native"`` or ``"cv2"``."""
    return "native" if native_loader.available() else "cv2"


def get_content_dataset(
    size: int,
    rescale_height: int,
    rescale_width: int,
    content_dir: str = CONTENT_DIR,
    seed: int | None = None,
    *,
    stats: dict | None = None,
) -> np.ndarray:
    """Up to ``size`` content images, shuffled, resized: (N, H, W, 3) BGR f32 [0,255].

    Reference dataset.py:90-111, without its all-zero dummy labels. Unreadable
    files are skipped (dataset.py:98-99). The shuffle is Python's ``random``
    seeded with ``seed`` (``None``: the global RNG, as the reference). Files are
    decoded in chunks of what is still missing, so no more files are read than
    the serial loop reads.
    """
    t0 = time.perf_counter()
    files = sorted(os.listdir(content_dir))
    rng = _random.Random(seed) if seed is not None else _random
    rng.shuffle(files)
    paths = [os.path.join(content_dir, f) for f in files]
    if not native_loader.available():
        _require_cv2()
    counts: dict = {}
    collected: list[np.ndarray] = []
    i = 0
    while len(collected) < size and i < len(paths):
        chunk = paths[i : i + (size - len(collected))]
        i += len(chunk)
        collected += [im for im in decode_files(chunk, rescale_height, rescale_width, False, counts)
                      if im is not None]
    if stats is not None:
        stats.update(decoder=decoder_route(), images=len(collected), files_read=i,
                     skipped=i - len(collected), secs=time.perf_counter() - t0, **counts)
    if not collected:
        return np.zeros((0, rescale_height, rescale_width, 3), np.float32)
    return np.stack(collected)


def _load_reference_pickles(cache_dir: str) -> dict[str, list[np.ndarray]] | None:
    """The reference's full_int_*.pkl caches, if present (dataset.py:190-193)."""
    if not os.path.isdir(cache_dir):
        return None
    files = [f for f in sorted(os.listdir(cache_dir)) if "full_int" in f]
    if not files:
        return None
    dataset: dict[str, list[np.ndarray]] = {}
    for fname in files:
        with open(os.path.join(cache_dir, fname), "rb") as f:
            dataset.update(pickle.load(f))
    return dataset


def _painting_paths(name: str, num: int, archive_dir: str, use_resized: bool) -> list[str]:
    if use_resized:
        return [os.path.join(archive_dir, "resized/resized", f"{name}_{i}.jpg")
                for i in range(1, num + 1)]
    d = os.path.join(archive_dir, "images/images", name)
    return [os.path.join(d, f) for f in sorted(os.listdir(d))] if os.path.isdir(d) else []


def _decode_paintings(
    names: Iterable[str],
    counts: Iterable[int],
    archive_dir: str,
    use_resized: bool,
    wordy: bool,
) -> dict[str, list[np.ndarray]]:
    """The Kaggle corpus JPEGs at their own sizes (dataset.py:135-164), BGR uint8 HWC,
    read by OpenCV on the thread pool; unreadable files are skipped."""
    _require_cv2()
    dataset: dict[str, list[np.ndarray]] = {}
    for name, num in zip(names, counts):
        images = pool_map(cv2.imread, _painting_paths(name, num, archive_dir, use_resized))
        dataset[name] = [im for im in images if im is not None]
        if wordy:
            print(f"{name}: {len(dataset[name])} paintings")
    return dataset


def get_painting_dataset(
    for_classifier: bool = True,
    rescale_height: int = -1,
    rescale_width: int = -1,
    use_resized: bool = True,
    save_pickle: bool = False,
    load_pickle: bool = True,
    wordy: bool = False,
    archive_dir: str = ARCHIVE_DIR,
    cache_dir: str = CACHE_DIR,
    *,
    stats: dict | None = None,
):
    """The painting corpus, the reference ``get_painting_dataset`` (dataset.py:120).

    ``for_classifier=False``: dict artist -> (n_i, H, W, 3) float32 BGR [0,255],
    every artist at one shape (dataset.py:224-228).

    ``for_classifier=True``: (images, labels): RGB [0,1] torchvision-normalized
    NHWC float32, int32 artist indices (dataset.py:201-221).

    Caches, as the JAX package keeps them: ``save_pickle``/``load_pickle`` drive
    one ``paintings_cache.npz`` (uint8 ``images`` at their final shape, int64
    ``offsets``, ``names``) that either package reads; the reference's
    ``full_int_*.pkl`` files are read when there is no npz; the reference's
    classifier cache ``in_tensors.npz``/``out_tensors.npz`` short-circuits
    everything in classifier mode (dataset.py:183-188).
    """
    t0 = time.perf_counter()

    def done(source: str, result, **fields):
        if stats is not None:
            stats.update(source=source, secs=time.perf_counter() - t0, **fields)
        return result

    if for_classifier and load_pickle:
        in_path = os.path.join(cache_dir, "in_tensors.npz")
        out_path = os.path.join(cache_dir, "out_tensors.npz")
        if os.path.exists(in_path) and os.path.exists(out_path):
            ins = np.load(in_path)["arr_0"]
            outs = np.load(out_path)["arr_0"]
            if wordy:
                print("Loaded!")  # dataset.py:187
            return done("classifier_cache", (
                np.ascontiguousarray(ins.transpose(0, 2, 3, 1)).astype(np.float32),
                np.asarray(outs, np.int32),
            ))

    names, counts = load_artist_names(archive_dir)

    npz_path = os.path.join(cache_dir, "paintings_cache.npz")
    dataset: dict[str, list[np.ndarray]] | None = None
    rescaled: dict[str, np.ndarray] | None = None
    source, fields = "decoded", {}
    if load_pickle and os.path.exists(npz_path):
        source = "npz"
        z = np.load(npz_path, allow_pickle=False)
        loaded_names = [str(n) for n in z["names"]]
        offsets = z["offsets"]
        images = z["images"]
        ch, cw = int(images.shape[1]), int(images.shape[2])
        want_h = rescale_height if rescale_height > 0 else ch
        want_w = rescale_width if rescale_width > 0 else cw
        if (want_h, want_w) == (ch, cw):
            # The npz holds images already at their training shape: reuse them as
            # they are. The avg//2 rule of get_rescale_dims would halve them on
            # every round trip (JAX datasets.py:279-290).
            rescaled = {
                n: images[offsets[i]: offsets[i + 1]].astype(np.float32)
                for i, n in enumerate(loaded_names)
            }
            th, tw = ch, cw
        else:
            # Explicit dims other than the cached shape: rescale the cached images.
            dataset = {
                n: list(images[offsets[i]: offsets[i + 1]])
                for i, n in enumerate(loaded_names)
            }
        if wordy:
            print("Loaded npz cache!")
    elif load_pickle:
        dataset = _load_reference_pickles(cache_dir)
        if dataset is not None:
            source = "pickle"
            if wordy:
                print("Loaded reference pickle cache!")
    if dataset is None and rescaled is None:
        if use_resized and rescale_height > 0 and rescale_width > 0 and native_loader.available():
            # Native fast path: decode and the affine rescale in one pass, straight
            # to the training shape.
            th, tw = rescale_height, rescale_width
            rescaled = {}
            fields = {"decoder": "native"}
            for name, num in zip(names, counts):
                paths = _painting_paths(name, num, archive_dir, use_resized)
                imgs = [im for im in decode_files(paths, th, tw, True, fields) if im is not None]
                rescaled[name] = np.stack(imgs) if imgs else np.zeros((0, th, tw, 3), np.float32)
        else:
            fields = {"decoder": "cv2"}
            dataset = _decode_paintings(names, counts, archive_dir, use_resized, wordy)

    if rescaled is None:
        total = sum(len(v) for v in dataset.values())
        th, tw = get_rescale_dims(dataset, total, rescale_height, rescale_width)
        rescaled = {}
        for artist, imgs in dataset.items():
            if len(imgs) == 0:
                rescaled[artist] = np.zeros((0, th, tw, 3), np.float32)
                continue
            rescaled[artist] = np.stack(
                pool_map(lambda im: rescale_image(im, th, tw), imgs)).astype(np.float32)

    if save_pickle:
        os.makedirs(cache_dir, exist_ok=True)
        arrs, offs, ns = [], [0], []
        for n in names:
            if n in rescaled:
                arrs.append(rescaled[n].astype(np.uint8))
                offs.append(offs[-1] + len(rescaled[n]))
                ns.append(n)
        np.savez_compressed(
            npz_path,
            images=np.concatenate(arrs) if arrs else np.zeros((0, th, tw, 3), np.uint8),
            offsets=np.array(offs, np.int64),
            names=np.array(ns),
        )
        if wordy:
            print("Saved npz cache!")

    fields["images"] = sum(len(v) for v in rescaled.values())
    if not for_classifier:
        return done(source, rescaled, **fields)

    imgs_list, labels = [], []
    for i, n in enumerate(names):
        arr = rescaled.get(n)
        if arr is None or len(arr) == 0:
            continue
        imgs_list.append(arr)
        labels.extend([i] * len(arr))
    images = np.concatenate(imgs_list) if imgs_list else np.zeros((0, th, tw, 3), np.float32)
    images = images[..., ::-1] / 255.0  # BGR -> RGB, [0,1]
    images = (images - np.asarray(TORCHVISION_MEAN_RGB, np.float32)) / np.asarray(
        TORCHVISION_STD_RGB, np.float32
    )
    return done(source, (images.astype(np.float32), np.asarray(labels, np.int32)), **fields)


def get_avg_dataset(
    rescale_height: int = -1,
    rescale_width: int = -1,
    wordy: bool = False,
    archive_dir: str = ARCHIVE_DIR,
    cache_dir: str = CACHE_DIR,
    *,
    stats: dict | None = None,
) -> dict[str, np.ndarray]:
    """Each artist's mean image, the 'average' mode's style target (dataset.py:56-87):
    dict artist -> (H, W, 3) float32 BGR [0,255], the pixel mean of the rescaled
    paintings truncated to uint8 as the reference does (dataset.py:84)."""
    paintings = get_painting_dataset(
        for_classifier=False,
        rescale_height=rescale_height,
        rescale_width=rescale_width,
        archive_dir=archive_dir,
        cache_dir=cache_dir,
        wordy=wordy,
        stats=stats,
    )
    return {
        artist: arr.mean(axis=0).astype(np.uint8).astype(np.float32)
        for artist, arr in paintings.items()
        if len(arr)
    }
