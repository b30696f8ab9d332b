"""Tensor-file IO (port of ``extended_gan_tpu/data/io.py``).

The datasets live on disk as torch ``.pt`` tensors; ``.npy`` and ``.npz``
are read too, and ``.h5`` files (key "default") where ``h5py`` is
installed. Without it an ``.h5`` file raises, naming the formats that work.
"""

from __future__ import annotations

import os

import numpy as np
import torch

_H5 = (".h5", ".hdf5")


def _h5py(path: str):
    try:
        import h5py
    except ImportError:
        raise ValueError(f"{path}: .h5 files need h5py, which is not "
                         "installed; convert them to .pt or .npy") from None
    return h5py


def load_array(path: str) -> np.ndarray:
    """Load a tensor file (.pt / .npy / .npz / .h5) as a numpy array."""
    if path.endswith(".pt"):
        return torch.load(path, map_location="cpu", weights_only=True).numpy()
    if path.endswith(".npy"):
        return np.load(path)
    if path.endswith(".npz"):
        with np.load(path) as z:
            return z[list(z.keys())[0]]
    if path.endswith(_H5):
        with _h5py(path).File(path, "r") as f:
            return f["default"][:]
    raise ValueError(f"unknown tensor file format: {path}")


def array_n_frames(path: str) -> int:
    """The length of a tensor file's leading axis, read without decoding
    its data where the format allows (.npy header, .h5 dataset shape,
    memory-mapped .pt)."""
    if path.endswith(".npy"):
        return int(np.load(path, mmap_mode="r").shape[0])
    if path.endswith(_H5):
        with _h5py(path).File(path, "r") as f:
            return int(f["default"].shape[0])
    if path.endswith(".pt"):
        try:  # zipfile-serialised tensors map without reading their data
            return int(torch.load(path, map_location="cpu", weights_only=True,
                                  mmap=True).shape[0])
        except RuntimeError:  # a legacy, non-zipfile .pt
            pass
    return len(load_array(path))


def save_array(path: str, arr: np.ndarray):
    if path.endswith(".pt"):
        torch.save(torch.from_numpy(np.ascontiguousarray(arr)), path)
    elif path.endswith(".npy"):
        np.save(path, arr)
    elif path.endswith(_H5):
        with _h5py(path).File(path, "w") as f:
            f["default"] = arr
    else:
        raise ValueError(f"unknown tensor file format: {path}")


def mkdir(path: str):
    os.makedirs(path, exist_ok=True)
