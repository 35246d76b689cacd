"""Deterministic synthetic stand-in for MNIST (a numpy copy of
``repro.data.mnist_like``, bit-exact to it).

We synthesize a 10-class 28x28 grayscale
dataset whose difficulty is MNIST-like: each class is a mixture of 3
Gaussian-blob prototypes on the image grid plus pixel noise, which makes
classes linearly-separable-ish but not trivially so (LeNet-300-100 reaches
60-95% within a few hundred gradient steps, mirroring the paper's curves).

Fully deterministic given the seed; train/test split sizes follow Table I
(90% / 10%).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Dataset:
    x_train: np.ndarray  # (N, 784) float32 in [0,1]
    y_train: np.ndarray  # (N,) int32
    x_test: np.ndarray
    y_test: np.ndarray

    @property
    def num_classes(self) -> int:
        return int(self.y_train.max()) + 1


def _class_prototypes(rng: np.random.Generator, num_classes: int, blobs: int):
    """Per class: `blobs` Gaussian bumps (cx, cy, sigma, amp) on the 28x28 grid."""
    protos = []
    for _ in range(num_classes):
        cx = rng.uniform(5, 23, blobs)
        cy = rng.uniform(5, 23, blobs)
        sig = rng.uniform(1.5, 4.0, blobs)
        amp = rng.uniform(0.6, 1.0, blobs)
        protos.append((cx, cy, sig, amp))
    return protos


def _render(protos, jitter_rng: np.random.Generator, n: int):
    cx, cy, sig, amp = protos
    yy, xx = np.mgrid[0:28, 0:28]
    imgs = np.zeros((n, 28, 28), np.float32)
    for b in range(len(cx)):
        jx = cx[b] + jitter_rng.normal(0, 1.2, n)
        jy = cy[b] + jitter_rng.normal(0, 1.2, n)
        js = sig[b] * np.exp(jitter_rng.normal(0, 0.15, n))
        ja = amp[b] * np.exp(jitter_rng.normal(0, 0.2, n))
        d2 = (xx[None] - jx[:, None, None]) ** 2 + (yy[None] - jy[:, None, None]) ** 2
        imgs += ja[:, None, None] * np.exp(-d2 / (2 * js[:, None, None] ** 2))
    imgs += jitter_rng.normal(0, 0.12, imgs.shape)
    return np.clip(imgs, 0.0, 1.0).reshape(n, 784).astype(np.float32)


def make_mnist_like(
    *,
    num_samples: int = 12_000,
    num_classes: int = 10,
    train_frac: float = 0.9,
    seed: int = 0,
) -> Dataset:
    rng = np.random.default_rng(seed)
    protos = _class_prototypes(rng, num_classes, blobs=3)
    per_class = num_samples // num_classes
    xs, ys = [], []
    for c in range(num_classes):
        xs.append(_render(protos[c], np.random.default_rng(seed * 1000 + c), per_class))
        ys.append(np.full(per_class, c, np.int32))
    x = np.concatenate(xs)
    y = np.concatenate(ys)
    perm = rng.permutation(len(x))
    x, y = x[perm], y[perm]
    n_train = int(train_frac * len(x))
    return Dataset(x[:n_train], y[:n_train], x[n_train:], y[n_train:])
