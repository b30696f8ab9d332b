"""The port's coastal-sea data path (the CycleGAN's) against the JAX
package's, on the CPU.

- ``make_coastal_dataset`` writes the same bytes as JAX's, file for file.
- ``CoastalSeaLoader`` (through ``get_coastal_loaders``) yields the same
  batches, byte for byte and in the same order, for several seeds, batch
  sizes and crops: every stride-1 window of a file (no truncation), a
  file too short for one window skipped (a 5-frame file planted among
  them), batches that do not span files.
- ``ResidentVideos.from_pt_frames`` holds the same video, window starts and
  per-file starts as JAX's, exactly, with the short file skipped.
"""

import os

import numpy as np
import pytest

from extended_gan_tpu.data import resident as jax_resident
from extended_gan_tpu.data import streaming as jax_streaming
from extended_gan_tpu.data import synthetic as jax_synthetic
from extended_gan_torch.data import resident, streaming, synthetic
from extended_gan_torch.data.io import save_array

KW = dict(n_train_files=3, n_test_files=2, frames_per_file=13, h=20, w=18)


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    """The port's and JAX's archives from the same seed, each with a
    5-frame file (shorter than a window of 8) planted in ``train``."""
    root = tmp_path_factory.mktemp("coastal")
    out = {}
    for side, make in (("port", synthetic.make_coastal_dataset),
                       ("jax", jax_synthetic.make_coastal_dataset)):
        out[side] = make(str(root / side), seed=11, **KW)
    short = np.random.default_rng(0).random((5, 1, 20, 18), np.float32)
    for side in out:
        save_array(os.path.join(out[side], "train", "0001a.pt"), short)
    return out


def _tree_bytes(folder):
    out = {}
    for sub in sorted(os.listdir(folder)):
        for name in sorted(os.listdir(os.path.join(folder, sub))):
            with open(os.path.join(folder, sub, name), "rb") as f:
                out[sub, name] = f.read()
    return out


@pytest.mark.parametrize("seed", [0, 7])
def test_archive_is_byte_identical(tmp_path, seed):
    ours = synthetic.make_coastal_dataset(str(tmp_path / "p"), seed=seed,
                                          **KW)
    theirs = jax_synthetic.make_coastal_dataset(str(tmp_path / "j"),
                                                seed=seed, **KW)
    got, want = _tree_bytes(ours), _tree_bytes(theirs)
    assert sorted(got) == sorted(want) and len(got) == 5
    for key in want:
        assert got[key] == want[key], key


@pytest.mark.parametrize("bs,crop,seq_len,seed", [
    (3, 16, 4, 369), (4, None, 4, 5), (2, 8, 3, 1), (64, 16, 4, 2)])
def test_loader_batches_are_byte_identical(archives, bs, crop, seq_len,
                                           seed):
    got = streaming.get_coastal_loaders(archives["port"], bs, bs + 1,
                                        seq_len=seq_len, crop=crop, seed=seed)
    want = jax_streaming.get_coastal_loaders(archives["jax"], bs, bs + 1,
                                             seq_len=seq_len, crop=crop,
                                             seed=seed)
    for split, (g, w) in enumerate(zip(got, want)):
        g, w = list(g), list(w)
        assert len(g) == len(w) > 0, split
        for (xg, yg), (xw, yw) in zip(g, w):
            for a, b in ((xg, xw), (yg, yw)):
                assert a.dtype == b.dtype == np.float32
                assert a.shape == b.shape and a.tobytes() == b.tobytes()
                assert a.shape[1:3] == (seq_len, 1)
    # 13 frames: 13 - 2 seq_len + 1 windows a file, batches within a file
    # (the 5-frame file makes none)
    per_file = 13 - 2 * seq_len + 1
    n_train = sum(len(xb) for xb, _ in
                  streaming.get_coastal_loaders(archives["port"], bs, bs,
                                                seq_len=seq_len, crop=crop,
                                                seed=seed)[0])
    assert n_train == KW["n_train_files"] * per_file


@pytest.mark.parametrize("crop,seq_len", [(64, 4), (16, 4), (None, 3)])
def test_pt_frames_store_equals_jax(archives, crop, seq_len):
    for sub in ("train", "test"):
        got = resident.ResidentVideos.from_pt_frames(
            os.path.join(archives["port"], sub), seq_len=seq_len, crop=crop)
        want = jax_resident.ResidentVideos.from_pt_frames(
            os.path.join(archives["jax"], sub), seq_len=seq_len, crop=crop)
        np.testing.assert_array_equal(got.video.numpy(),
                                      np.asarray(want.video))
        np.testing.assert_array_equal(got.starts.numpy(),
                                      np.asarray(want.starts))
        assert len(got.file_starts) == len(want.file_starts) > 0
        for g, w in zip(got.file_starts, want.file_starts):
            np.testing.assert_array_equal(g, w)
        assert (got.n_windows, got.window) == (want.n_windows, want.window)
        assert got.video.dtype.is_floating_point
        assert got.video.shape[1:] == (min(crop or 99, 20),
                                       min(crop or 99, 18))
