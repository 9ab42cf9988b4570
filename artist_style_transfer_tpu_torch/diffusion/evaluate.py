"""Fréchet-distance evaluation of diffusion samples (counterpart of the JAX
``diffusion/evaluate.py``).

The FID recipe (Heusel et al. 2017) with one substitution: the features are the
artist classifier's (the ResNet-50 of the reference's classifier.py:43-66, its 512-wide
penultimate layer), not InceptionV3's. The number is a *classifier* Fréchet distance
(CFID), comparable across runs of this repo, not across papers.

The features are computed in batches on the classifier's device, in f32; only the
(N, 512) features come back to the host, where the means, covariances and the matrix
square root run in numpy f64.
"""

from __future__ import annotations

import numpy as np
import torch

from artist_style_transfer_tpu_torch.models.resnet import ResNet50Classifier
from artist_style_transfer_tpu_torch.ops.image import bgr_to_rgb, torchvision_normalize
from artist_style_transfer_tpu_torch.utils.device import module_device, resolve_device, same_device


def classifier_features(classifier: ResNet50Classifier, images_bgr255, batch: int = 64,
                        device: str | torch.device | None = None) -> np.ndarray:
    """(N, 512) f32 penultimate features of NHWC BGR [0,255] images (any float or uint
    dtype), ``batch`` at a time on ``device`` (``None``: CUDA), where ``classifier`` must
    live; returned on the host."""
    dev = resolve_device(device)
    if not same_device(module_device(classifier), dev):
        raise ValueError(f"classifier is on {module_device(classifier)}, not on {dev}")
    outs = []
    with torch.inference_mode():
        for i in range(0, len(images_bgr255), batch):
            x = torch.as_tensor(np.asarray(images_bgr255[i: i + batch])).to(dev, torch.float32)
            rgb01 = bgr_to_rgb(x) / 255.0
            outs.append(classifier(torchvision_normalize(rgb01), return_features=True)
                        .cpu().numpy())
    return np.concatenate(outs, axis=0)


def _mean_cov(feats: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    mu = feats.mean(axis=0, dtype=np.float64)
    d = feats.astype(np.float64) - mu
    cov = d.T @ d / max(1, feats.shape[0] - 1)
    return mu, cov


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray,
                     sigma2: np.ndarray) -> float:
    """|mu1-mu2|^2 + tr(S1 + S2 - 2 (S1 S2)^{1/2}) for PSD S1, S2, in f64.

    tr((S1 S2)^{1/2}) is the sum of the square roots of the eigenvalues of the PSD
    matrix sqrt(S1) S2 sqrt(S1) (the same nonzero spectrum as S1 S2): two symmetric
    eigendecompositions, no general matrix square root.
    """
    mu1 = np.asarray(mu1, np.float64)
    mu2 = np.asarray(mu2, np.float64)
    s1 = (np.asarray(sigma1, np.float64) + np.asarray(sigma1, np.float64).T) / 2
    s2 = (np.asarray(sigma2, np.float64) + np.asarray(sigma2, np.float64).T) / 2
    diff = float(np.sum((mu1 - mu2) ** 2))
    w1, v1 = np.linalg.eigh(s1)
    root1 = (v1 * np.sqrt(np.clip(w1, 0.0, None))) @ v1.T
    m = root1 @ s2 @ root1
    wm = np.linalg.eigvalsh((m + m.T) / 2)
    tr_sqrt = float(np.sum(np.sqrt(np.clip(wm, 0.0, None))))
    return diff + float(np.trace(s1) + np.trace(s2)) - 2.0 * tr_sqrt


def cfid(classifier: ResNet50Classifier, real_images_bgr255, gen_images_bgr255,
         batch: int = 64, device: str | torch.device | None = None) -> float:
    """Classifier Fréchet distance between a real and a generated image set (NHWC BGR
    [0,255]): lower is better, identical sets give about 0."""
    f_real = classifier_features(classifier, real_images_bgr255, batch, device)
    f_gen = classifier_features(classifier, gen_images_bgr255, batch, device)
    mu_r, s_r = _mean_cov(f_real)
    mu_g, s_g = _mean_cov(f_gen)
    return frechet_distance(mu_r, s_r, mu_g, s_g)
