"""Deterministic synthetic 10-class 28x28 image dataset (MNIST stand-in).

Pure numpy, bit-equal to ``repro.data.synthetic``.

The port runs with no dataset download.  This generator produces a
learnable digits-like problem with the same cardinalities:
class-conditional low-frequency prototypes (7x7 Gaussian fields
bilinearly upsampled to 28x28) plus per-sample spatial jitter and pixel
noise.  A 2-conv CNN reaches >95% test accuracy on the
i.i.d. version within a few epochs, leaving headroom for the paper's
non-i.i.d. degradation effects to show.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

NUM_CLASSES = 10
IMAGE_SIZE = 28
_PROTO_RES = 7


def _upsample(x: np.ndarray, size: int) -> np.ndarray:
    """Bilinear upsample (H,W) -> (size,size)."""
    h, w = x.shape
    yi = np.linspace(0, h - 1, size)
    xi = np.linspace(0, w - 1, size)
    y0 = np.floor(yi).astype(int)
    x0 = np.floor(xi).astype(int)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (yi - y0)[:, None]
    wx = (xi - x0)[None, :]
    return ((1 - wy) * (1 - wx) * x[np.ix_(y0, x0)]
            + (1 - wy) * wx * x[np.ix_(y0, x1)]
            + wy * (1 - wx) * x[np.ix_(y1, x0)]
            + wy * wx * x[np.ix_(y1, x1)])


def class_prototypes(seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    protos = []
    for _ in range(NUM_CLASSES):
        low = rng.normal(size=(_PROTO_RES, _PROTO_RES))
        img = _upsample(low, IMAGE_SIZE)
        img = (img - img.min()) / (img.max() - img.min() + 1e-9)
        protos.append(img)
    return np.stack(protos).astype(np.float32)          # (10, 28, 28)


def make_dataset(n_per_class: int, seed: int = 0,
                 noise: float = 0.35) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (images (N,28,28,1) float32 in [0,1]-ish, labels (N,) int32),
    class-balanced, deterministic in ``seed``."""
    rng = np.random.default_rng(seed + 1)
    protos = class_prototypes(seed)
    images, labels = [], []
    for c in range(NUM_CLASSES):
        base = protos[c]
        for _ in range(n_per_class):
            dy, dx = rng.integers(-2, 3, size=2)
            img = np.roll(np.roll(base, dy, axis=0), dx, axis=1)
            img = img * rng.uniform(0.7, 1.3) + rng.normal(
                scale=noise, size=base.shape)
            images.append(img)
            labels.append(c)
    images = np.stack(images)[..., None].astype(np.float32)
    labels = np.asarray(labels, np.int32)
    perm = rng.permutation(len(labels))
    return images[perm], labels[perm]


def train_test_split(images: np.ndarray, labels: np.ndarray,
                     test_frac: float = 0.15, seed: int = 0):
    rng = np.random.default_rng(seed + 2)
    n = len(labels)
    perm = rng.permutation(n)
    n_test = int(n * test_frac)
    te, tr = perm[:n_test], perm[n_test:]
    return (images[tr], labels[tr]), (images[te], labels[te])
