"""Synthetic radar archives (port of the KNMI and ARAI parts of
``extended_gan_tpu/data/synthetic.py``).

Advecting smooth rain cells with temporal coherence, in the formats the
loaders read:

- KNMI: ``<dir>/{train,test}/*.pt`` integer-valued (T, V, H, W) videos in
  [0, 254];
- ARAI: ``<dir>/{training,validation}/<i>.pt`` float (T, R, 1, H, W) region
  blocks in [0, 1], and ``<dir>/metadata.json``.

For the same arguments the files hold the same values as the JAX package's
(the random draws are made in the same order from the same numpy
generator).
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np

from .io import mkdir, save_array


def _rain_video(rng: np.random.Generator, n_frames: int, h: int, w: int,
                n_cells: int = 4, max_val: float = 1.0) -> np.ndarray:
    """(T, H, W) float video of advecting gaussian cells."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    pos = rng.uniform([0, 0], [h, w], (n_cells, 2)).astype(np.float32)
    vel = rng.uniform(-1.5, 1.5, (n_cells, 2)).astype(np.float32)
    sig = rng.uniform(min(h, w) * 0.06, min(h, w) * 0.22,
                      n_cells).astype(np.float32)
    amp = rng.uniform(0.4, 1.0, n_cells).astype(np.float32)
    frames = np.zeros((n_frames, h, w), np.float32)
    for t in range(n_frames):
        for c in range(n_cells):
            cy, cx = pos[c] + vel[c] * t
            cy, cx = cy % h, cx % w
            d2 = (yy - cy) ** 2 + (xx - cx) ** 2
            frames[t] += amp[c] * np.exp(-d2 / (2 * sig[c] ** 2))
    return np.clip(frames, 0, 1) * max_val


def make_kmni_dataset(out_dir: str, *, n_train_files: int = 3,
                      n_test_files: int = 1, frames_per_file: int = 24,
                      n_vertices: int = 6, hw: int = 80,
                      seed: int = 0) -> str:
    rng = np.random.default_rng(seed)
    for sub, n_files in (("train", n_train_files), ("test", n_test_files)):
        mkdir(os.path.join(out_dir, sub))
        for i in range(n_files):
            video = np.stack(
                [_rain_video(rng, frames_per_file, hw, hw, max_val=254.0)
                 for _ in range(n_vertices)],
                axis=1,
            )  # (T, V, H, W)
            save_array(os.path.join(out_dir, sub, f"{i:010d}.pt"),
                       np.rint(video).astype(np.int16))
    with open(os.path.join(out_dir, "train", "metadata.json"), "w") as f:
        json.dump({"max": 254, "min": 0}, f)
    return out_dir


def make_arai_dataset(out_dir: str, *, n_files: int = 2,
                      frames_per_file: int = 24, n_regions: int = 5,
                      h: int = 32, w: int = 32, seed: int = 0) -> str:
    rng = np.random.default_rng(seed)
    meta = {"n_regions": n_regions}
    for sub in ("training", "validation"):
        mkdir(os.path.join(out_dir, sub))
        for i in range(n_files):
            block = np.stack([_rain_video(rng, frames_per_file, h, w)
                              for _ in range(n_regions)],
                             axis=1)[:, :, None]  # (T, R, 1, H, W)
            save_array(os.path.join(out_dir, sub, f"{i}.pt"),
                       block.astype(np.float32))
        meta[sub] = {"length": n_files * frames_per_file}
    with open(os.path.join(out_dir, "metadata.json"), "w") as f:
        json.dump(meta, f)
    return out_dir


def ensure_synthetic_kmni(folder: str | None = None) -> str:
    """The default archive in ``folder`` (by default one under the
    temporary directory), made there if it is missing."""
    folder = folder or os.path.join(tempfile.gettempdir(),
                                    "extended_gan_torch_synthetic", "kmni")
    if not os.path.isdir(os.path.join(folder, "train")):
        make_kmni_dataset(folder)
    return folder
