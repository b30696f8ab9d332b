"""The native host-side batch core: ctypes bindings to ``csrc/egt_native.cpp``
(port of ``extended_gan_tpu/data/native.py``).

The C++ source is the port's own copy of the JAX package's core, built with
``g++`` at first use into ``build/native/libegt_native-<hash>.so`` at the
root of the checkout, where ``<hash>`` covers the source, the compiler and
its flags, so an edited source is never served from a stale library. A
build goes to a file of its own and is renamed into place, so processes
that build at once never load half a library. Nothing is compiled when the
module is imported.

The four entry points run in C++ threads; ``ctypes.CDLL`` releases the GIL
for the length of a call:

- :func:`kmni_make_batch`: a KNMI batch, fused: window gather, ``raw *
  (1 / max_value)`` then ``** power``, crop, and the (T, V, H, W) ->
  (B, H, W, S, V) layout change;
- :func:`kmni_make_batch_merged`: the same windows as the reference's 2x3
  mosaic of vertex pairs, (B, S, 2 * crop, 3 * crop);
- :func:`window_gather`: contiguous windows of frames;
- :func:`minmax_normalize`: ``(x - min) / (max - min)`` over a whole array.

Each has a plain numpy version beside it (``reference_*``), the JAX
package's numpy path, which the tests hold the native one against. The
native path never falls back to it: a failed build raises with the
compiler's output, and a loader that should not use the core is made with
``use_native=False``. ``call_counts()`` says how many times each entry point
ran in this process.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "egt_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
ABI_VERSION = 2

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_calls = dict.fromkeys(("kmni_make_batch", "kmni_make_batch_merged",
                        "window_gather", "minmax_normalize"), 0)

_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_i64, _f32 = ctypes.c_int64, ctypes.c_float
_BATCH_ARGS = [_f32p, _i64, _i64, _i64, _i64, _i64p, _i64, _i64, _i64, _i64,
               _f32, _f32, _f32p, _f32p]
_ARGTYPES = {
    "kmni_make_batch": _BATCH_ARGS,
    "kmni_make_batch_merged": _BATCH_ARGS,
    "window_gather": [_f32p, _i64, _i64, _i64p, _i64, _i64, _f32p],
    "minmax_normalize": [_f32p, _i64, _f32, _f32],
}


def call_counts() -> dict[str, int]:
    """How many times each native entry point has run in this process."""
    return dict(_calls)


def reset_call_counts():
    for name in _calls:
        _calls[name] = 0


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join((CXX, *CXX_FLAGS)).encode())
    return BUILD_DIR / f"libegt_native-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """The core's shared library, compiled unless it is already there;
    raises with the compiler's output when the build fails."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [CXX, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"building {SOURCE.name} failed: {' '.join(cmd)}: "
                           f"{e}") from e
    if res.returncode != 0 or not tmp.exists():
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed ({' '.join(cmd)}, "
                           f"exit {res.returncode}):\n{res.stdout}"
                           f"{res.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or none
    return lib


def get_lib() -> ctypes.CDLL:
    """The loaded core, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _ARGTYPES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, None
            lib.egt_native_abi_version.restype = ctypes.c_int
            version = lib.egt_native_abi_version()
            if version != ABI_VERSION:
                raise RuntimeError(f"{SOURCE.name}: ABI version {version}, "
                                   f"the bindings take {ABI_VERSION}")
            _lib = lib
    return _lib


def _crop_hw(h, w, crop):
    ch, cw = (h, w) if crop is None else (
        crop if isinstance(crop, tuple) else (crop, crop))
    return min(ch, h), min(cw, w)


def _check_windows(starts, window, n_frames):
    """The core reads ``window`` frames from each start: keep it inside."""
    if len(starts) and (starts.min() < 0
                        or starts.max() + window > n_frames):
        raise ValueError(f"window starts {starts.min()}..{starts.max()} of "
                         f"{window} frames fall outside {n_frames} frames")


def _batch_call(name, video, starts, steps, ch, cw, max_value, power, shape):
    lib = get_lib()
    t, v, h, w = video.shape
    _check_windows(starts, 2 * steps, t)
    x = np.empty(shape, np.float32)
    y = np.empty(shape, np.float32)
    getattr(lib, name)(video, t, v, h, w, starts, len(starts), steps, ch, cw,
                       np.float32(1.0 / max_value), np.float32(power), x, y)
    _calls[name] += 1
    return x, y


def kmni_make_batch(video: np.ndarray, starts: np.ndarray, *, steps: int = 4,
                    crop: int | tuple[int, int] | None = None,
                    max_value: float = 254.0, power: float = 1.0):
    """Fused window gather + normalisation + (T, V, H, W) -> (B, H, W, S, V).

    ``video`` (T, V, H, W) raw values, ``starts`` (n,) window start frames;
    ``crop`` a square int or an (h, w) pair. Returns (x, y), each (n,
    crop_h, crop_w, steps, V) float32. The ARAI loader feeds its (N, R, H,
    W) region blocks through it with ``max_value=1``."""
    video = np.ascontiguousarray(video, np.float32)
    starts = np.ascontiguousarray(starts, np.int64)
    _, v, h, w = video.shape
    ch, cw = _crop_hw(h, w, crop)
    return _batch_call("kmni_make_batch", video, starts, steps, ch, cw,
                       max_value, power, (len(starts), ch, cw, steps, v))


def reference_kmni_make_batch(video, starts, *, steps=4, crop=None,
                              max_value=254.0, power=1.0):
    """Plain numpy version of :func:`kmni_make_batch` (divides by
    ``max_value`` where the core multiplies by its rounded inverse)."""
    video = np.ascontiguousarray(video, np.float32)
    starts = np.ascontiguousarray(starts, np.int64)
    _, _, h, w = video.shape
    ch, cw = _crop_hw(h, w, crop)
    norm = (video / max_value) ** power if power != 1.0 else video / max_value
    idx = starts[:, None] + np.arange(2 * steps)[None, :]
    wins = norm[idx][:, :, :, :ch, :cw].transpose(0, 3, 4, 1, 2)
    return (np.ascontiguousarray(wins[:, :, :, :steps]),
            np.ascontiguousarray(wins[:, :, :, steps:]))


def _mosaic_geometry(video, crop):
    _, v, h, w = video.shape
    if v < 4:
        # the mosaic reads vertex pairs up to index 3
        raise ValueError(f"merge_nodes needs >= 4 vertices for the 2x3 "
                         f"mosaic, got {v}")
    c = crop if crop is not None else h
    return min(c, h), min(c, w)


def kmni_make_batch_merged(video: np.ndarray, starts: np.ndarray, *,
                           steps: int = 4, crop: int | None = None,
                           max_value: float = 254.0, power: float = 1.0):
    """``merge_nodes`` batches: (T, V, H, W) raw video -> (x, y), each (n,
    steps, 2 * crop, 3 * crop), the vertex pairs (0, 1), (1, 2), (2, 3)
    tiled 2 high and 3 wide (the reference's merged layout)."""
    video = np.ascontiguousarray(video, np.float32)
    starts = np.ascontiguousarray(starts, np.int64)
    ch, cw = _mosaic_geometry(video, crop)
    return _batch_call("kmni_make_batch_merged", video, starts, steps, ch, cw,
                       max_value, power, (len(starts), steps, 2 * ch, 3 * cw))


def reference_kmni_make_batch_merged(video, starts, *, steps=4, crop=None,
                                     max_value=254.0, power=1.0):
    """Plain numpy version of :func:`kmni_make_batch_merged`."""
    video = np.ascontiguousarray(video, np.float32)
    starts = np.ascontiguousarray(starts, np.int64)
    ch, cw = _mosaic_geometry(video, crop)
    norm = (video / max_value) ** power if power != 1.0 else video / max_value
    idx = starts[:, None] + np.arange(2 * steps)[None, :]
    wins = norm[idx][:, :, :, :ch, :cw]  # (n, 2S, V, ch, cw)
    mosaic = np.concatenate(
        [np.concatenate((wins[:, :, i], wins[:, :, i + 1]), axis=2)
         for i in range(3)], axis=3)  # (n, 2S, 2ch, 3cw)
    return (np.ascontiguousarray(mosaic[:, :steps]),
            np.ascontiguousarray(mosaic[:, steps:]))


def window_gather(frames: np.ndarray, starts: np.ndarray, window: int):
    """(N, ...) frames + starts -> contiguous (n, window, ...) float32."""
    frames = np.ascontiguousarray(frames, np.float32)
    starts = np.ascontiguousarray(starts, np.int64)
    n, feat = len(starts), int(np.prod(frames.shape[1:]))
    _check_windows(starts, window, len(frames))
    lib = get_lib()
    out = np.empty((n, window) + frames.shape[1:], np.float32)
    lib.window_gather(frames.reshape(len(frames), feat), len(frames), feat,
                      starts, n, window, out.reshape(n, window, feat))
    _calls["window_gather"] += 1
    return out


def reference_window_gather(frames, starts, window):
    """Plain numpy version of :func:`window_gather`."""
    frames = np.ascontiguousarray(frames, np.float32)
    starts = np.ascontiguousarray(starts, np.int64)
    idx = starts[:, None] + np.arange(window)[None, :]
    return np.ascontiguousarray(frames[idx])


def minmax_normalize(data: np.ndarray) -> np.ndarray:
    """``(x - min) / (max - min)`` over the whole array, float32, in the
    core's threaded loop. A constant array gives zeros."""
    lo, hi = float(np.min(data)), float(np.max(data))
    if hi == lo:
        return np.zeros_like(data, dtype=np.float32)
    out = np.ascontiguousarray(data, np.float32).copy()
    get_lib().minmax_normalize(out, out.size, np.float32(lo), np.float32(hi))
    _calls["minmax_normalize"] += 1
    return out


def reference_minmax_normalize(data):
    """Plain numpy version of :func:`minmax_normalize`."""
    lo, hi = float(np.min(data)), float(np.max(data))
    if hi == lo:
        return np.zeros_like(data, dtype=np.float32)
    out = np.ascontiguousarray(data, np.float32).copy()
    return (out - lo) / (hi - lo)
