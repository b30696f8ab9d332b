"""MNIST-or-synthetic images for the vanilla GAN (port of
``extended_gan_tpu/data/mnist.py``).

No download: MNIST is read from a local copy (idx-ubyte, gzipped or not,
or an ``.npz`` with ``x_train``) under ``data_root``, and without one a
deterministic set of synthetic digit-like blobs stands in. Either way the
images come as float32 (N, 1, size, size) in [-1, 1], resized by nearest
neighbour where the size differs (the reference's ``transforms.Resize``),
byte for byte what the JAX package's loader gives.
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

_CANDIDATES = ("train-images-idx3-ubyte", "train-images-idx3-ubyte.gz",
               "MNIST/raw/train-images-idx3-ubyte",
               "MNIST/raw/train-images-idx3-ubyte.gz", "mnist.npz")


def load_idx_images(path: str) -> np.ndarray:
    """(n, rows, cols) uint8 of an idx3-ubyte file (gzipped when it ends in
    ``.gz``)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"{path}: bad idx magic {magic}")
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(n, rows, cols)


def find_mnist(root: str) -> np.ndarray | None:
    """The first local MNIST copy under ``root``, as uint8 images, or
    None."""
    for c in _CANDIDATES:
        p = os.path.join(root, c)
        if os.path.exists(p):
            if p.endswith(".npz"):
                with np.load(p) as z:
                    return z["x_train"]
            return load_idx_images(p)
    return None


def synthetic_digits(n: int, size: int = 28, seed: int = 0) -> np.ndarray:
    """Deterministic digit-like blobs, uint8 (n, size, size): mixtures of 2
    to 4 gaussian strokes."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    imgs = np.zeros((n, size, size), np.float32)
    for i in range(n):
        k = rng.randint(2, 5)
        for _ in range(k):
            cx, cy = rng.uniform(size * 0.2, size * 0.8, 2)
            sx, sy = rng.uniform(1.0, 4.0, 2)
            rho = rng.uniform(-0.6, 0.6)
            dx, dy = (xx - cx) / sx, (yy - cy) / sy
            imgs[i] += np.exp(-(dx**2 - 2 * rho * dx * dy + dy**2)
                              / (2 * (1 - rho**2)))
    imgs = imgs / np.maximum(imgs.max(axis=(1, 2), keepdims=True), 1e-6)
    return (imgs * 255).astype(np.uint8)


def resize_nearest(raw: np.ndarray, size: int) -> np.ndarray:
    """(n, h, h) -> (n, size, size) by nearest neighbour."""
    idx = (np.arange(size) * raw.shape[1] / size).astype(int)
    return raw[:, idx][:, :, idx]


def load_images(data_root: str = "data/mnist", *, img_size: int = 28,
                n_synthetic: int = 8192) -> np.ndarray:
    """(N, 1, img_size, img_size) float32 images in [-1, 1]."""
    raw = find_mnist(data_root) if data_root else None
    if raw is None:
        print(f"[mnist] no local MNIST under {data_root!r}; using "
              f"{n_synthetic} synthetic digit blobs")
        raw = synthetic_digits(n_synthetic, size=img_size)
    if raw.shape[1] != img_size:
        raw = resize_nearest(raw, img_size)
    x = raw.astype(np.float32) / 255.0
    x = (x - 0.5) / 0.5  # the reference's Normalize([0.5], [0.5])
    return x[:, None, :, :]


def iterate_batches(x: np.ndarray, batch_size: int, *,
                    rng: np.random.RandomState):
    """One shuffled epoch of batches; the last may be short (torch
    DataLoader's default)."""
    order = rng.permutation(len(x))
    for i in range(0, len(x), batch_size):
        yield x[order[i: i + batch_size]]
