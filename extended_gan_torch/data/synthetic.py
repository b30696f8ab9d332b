"""Synthetic radar archives (port of the KNMI, ARAI, coastal-sea and h5
parts of ``extended_gan_tpu/data/synthetic.py``).

Advecting smooth rain cells with temporal coherence, in the formats the
loaders read:

- KNMI: ``<dir>/{train,test}/*.pt`` integer-valued (T, V, H, W) videos in
  [0, 254];
- ARAI: ``<dir>/{training,validation}/<i>.pt`` float (T, R, 1, H, W) region
  blocks in [0, 1], and ``<dir>/metadata.json``;
- coastal sea (the CycleGAN's): ``<dir>/{train,test}/<i:04d>.pt`` float
  (T, 1, H, W) frames in [0, 1];
- the DCGAN's sequence archive: ``<dir>/train/train.npy`` and
  ``<dir>/test/test_1.npy``, float (T, 1, H, W) in [0, 1]. The JAX package
  writes the same arrays as ``.h5``; the port writes ``.npy``, which needs
  no h5py.

For the same arguments the files hold the same values as the JAX package's
(the random draws are made in the same order from the same numpy
generator).

``ensure_synthetic_*`` make an archive beside its folder and rename it into
place, so a process that finds the folder finds it whole, and two processes
can ask for one archive at once: the one that loses the rename uses the
winner's.
"""

from __future__ import annotations

import json
import os
import shutil
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


def make_h5_dataset(out_dir: str, *, frames_train: int = 96,
                    frames_test: int = 48, h: int = 64, w: int = 64,
                    seed: int = 0) -> str:
    rng = np.random.default_rng(seed)
    for sub, name, n in (("train", "train", frames_train),
                         ("test", "test_1", frames_test)):
        mkdir(os.path.join(out_dir, sub))
        save_array(os.path.join(out_dir, sub, f"{name}.npy"),
                   _rain_video(rng, n, h, w)[:, None].astype(np.float32))
    return out_dir


def make_coastal_dataset(out_dir: str, *, n_train_files: int = 2,
                         n_test_files: int = 1, frames_per_file: int = 48,
                         h: int = 64, w: int = 64, seed: int = 0,
                         fmt: str = "pt") -> str:
    rng = np.random.default_rng(seed)
    for sub, n_files in (("train", n_train_files), ("test", n_test_files)):
        mkdir(os.path.join(out_dir, sub))
        for i in range(n_files):
            video = _rain_video(rng, frames_per_file, h, w)[:, None]
            save_array(os.path.join(out_dir, sub, f"{i:04d}.{fmt}"),
                       video.astype(np.float32))
    return out_dir


def _default_folder(base: str, kwargs: dict) -> str:
    """A folder under the temporary directory named after the arguments,
    so archives of different shapes never share one."""
    key = "_".join(f"{k}{v}" for k, v in sorted(kwargs.items()))
    return os.path.join(tempfile.gettempdir(), "extended_gan_torch_synthetic",
                        f"{base}_{key}" if key else base)


def _ensure(folder: str, make, kwargs: dict) -> str:
    """``make(staging, **kwargs)`` in a staging folder beside ``folder``,
    renamed to ``folder`` unless ``folder/train`` exists already."""
    if os.path.isdir(os.path.join(folder, "train")):
        return folder
    parent = os.path.dirname(os.path.abspath(folder))
    mkdir(parent)
    staging = tempfile.mkdtemp(prefix=".staging_", dir=parent)
    try:
        make(staging, **kwargs)
        os.rename(staging, folder)
    except OSError:  # another process made it first, or folder exists
        if not os.path.isdir(os.path.join(folder, "train")):
            raise
    finally:
        shutil.rmtree(staging, ignore_errors=True)
    return folder


def ensure_synthetic_h5(folder: str | None = None, **kwargs) -> str:
    """The DCGAN's archive for ``make_h5_dataset(**kwargs)`` in ``folder``
    (default: one under the temporary directory named after the
    arguments), made there if it is missing."""
    return _ensure(folder or _default_folder("h5", kwargs), make_h5_dataset,
                   kwargs)


def ensure_synthetic_kmni(folder: str | None = None) -> str:
    """The default KNMI archive in ``folder`` (default: one under the
    temporary directory), made there if it is missing."""
    return _ensure(folder or _default_folder("kmni", {}), make_kmni_dataset,
                   {})


def ensure_synthetic_coastal(folder: str | None = None, **kwargs) -> str:
    """The CycleGAN's archive for ``make_coastal_dataset(**kwargs)`` in
    ``folder`` (default: one under the temporary directory named after the
    arguments), made there if it is missing."""
    return _ensure(folder or _default_folder("coastal", kwargs),
                   make_coastal_dataset, kwargs)
