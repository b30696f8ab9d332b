"""The port's native batch core (``extended_gan_torch/data/native.py``,
``data/csrc/egt_native.cpp``) against the JAX package's, on the CPU.

- The port's library builds with g++ into ``build/native/``, from the
  port's own copy of the source.
- Each of the four entry points gives the JAX package's native result byte
  for byte on the same seeded inputs (power 1 and 1.5, crops of an int and
  of (h, w), the merged mosaic, ``minmax_normalize`` on a constant array
  too), and is within 1e-5 relative / 1e-6 absolute of the port's numpy
  version (``tests/test_native.py``'s bar: the core multiplies by a rounded
  1/254 where numpy divides).
- A build that fails raises, with nothing to fall back on.
"""

import numpy as np
import pytest

from extended_gan_tpu.data import native as jax_native
from extended_gan_torch.data import native

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module", autouse=True)
def both_cores():
    assert jax_native.available(), "the JAX package's core did not build"
    native.get_lib()


def _video(seed, t=16, v=6, h=12, w=14):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 255, size=(t, v, h, w)).astype(np.float32)


def _same_bytes(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32
        assert a.shape == b.shape and a.tobytes() == b.tobytes()


def test_the_library_builds_from_the_ports_source():
    lib = native.build()
    assert lib.exists() and lib.parent == native.BUILD_DIR
    assert native.SOURCE.parent.name == "csrc"
    assert native.SOURCE.parents[1] == native.BUILD_DIR.parents[1] / \
        "extended_gan_torch" / "data"
    assert native.get_lib().egt_native_abi_version() == native.ABI_VERSION
    # the function bodies are the JAX package's, byte for byte
    ours = native.SOURCE.read_text().split("#include <cmath>", 1)[1]
    theirs = open(jax_native._SRC).read().split("#include <cmath>", 1)[1]
    assert ours == theirs


@pytest.mark.parametrize("power", [1.0, 1.5])
@pytest.mark.parametrize("crop", [None, 10, (9, 11)])
def test_kmni_make_batch(power, crop):
    video = _video(0)
    starts = np.array([0, 3, 7, 8], np.int64)
    kw = dict(steps=4, crop=crop, max_value=254.0, power=power)
    before = native.call_counts()["kmni_make_batch"]
    got = native.kmni_make_batch(video, starts, **kw)
    assert native.call_counts()["kmni_make_batch"] == before + 1
    _same_bytes(got, jax_native.kmni_make_batch(video, starts, **kw))
    for a, b in zip(got, native.reference_kmni_make_batch(video, starts,
                                                          **kw)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    ch, cw = (12, 14) if crop is None else (
        crop if isinstance(crop, tuple) else (crop, crop))
    assert got[0].shape == (4, ch, cw, 4, 6)


def test_kmni_make_batch_region_blocks():
    """The ARAI loader's use: (N, R, H, W) blocks with max_value 1, crop
    larger than the block, which takes the whole block."""
    video = np.random.default_rng(1).random((12, 5, 9, 9), np.float32)
    starts = np.arange(5, dtype=np.int64)
    kw = dict(steps=4, crop=(16, 16), max_value=1.0, power=1.0)
    got = native.kmni_make_batch(video, starts, **kw)
    _same_bytes(got, jax_native.kmni_make_batch(video, starts, **kw))
    _same_bytes(got, native.reference_kmni_make_batch(video, starts, **kw))


@pytest.mark.parametrize("power", [1.0, 1.5])
@pytest.mark.parametrize("crop", [None, 8])
def test_kmni_make_batch_merged(power, crop):
    video = _video(2, h=10, w=10)
    starts = np.array([1, 2, 8], np.int64)
    kw = dict(steps=4, crop=crop, max_value=254.0, power=power)
    got = native.kmni_make_batch_merged(video, starts, **kw)
    _same_bytes(got, jax_native.kmni_make_batch_merged(video, starts, **kw))
    for a, b in zip(got, native.reference_kmni_make_batch_merged(
            video, starts, **kw)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    c = 10 if crop is None else crop
    assert got[0].shape == (3, 4, 2 * c, 3 * c)


def test_the_mosaic_needs_four_vertices():
    video = _video(3, v=3)
    starts = np.array([0], np.int64)
    for fn in (native.kmni_make_batch_merged,
               native.reference_kmni_make_batch_merged):
        with pytest.raises(ValueError, match="4 vertices"):
            fn(video, starts)


def test_window_gather():
    frames = np.random.default_rng(4).standard_normal((20, 3, 4)).astype(
        np.float32)
    starts = np.array([0, 5, 11, 14], np.int64)
    got = native.window_gather(frames, starts, 6)
    assert got.shape == (4, 6, 3, 4)
    _same_bytes([got], [jax_native.window_gather(frames, starts, 6)])
    _same_bytes([got], [native.reference_window_gather(frames, starts, 6)])


@pytest.mark.parametrize("kind", ["random", "constant"])
def test_minmax_normalize(kind):
    rng = np.random.default_rng(5)
    data = (rng.standard_normal((3, 70, 50)) * 7 + 3 if kind == "random"
            else np.full((4, 5), 2.5))
    got = native.minmax_normalize(data)
    _same_bytes([got], [jax_native.minmax_normalize(data)])
    want = native.reference_minmax_normalize(data)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if kind == "constant":
        assert got.dtype == np.float32 and not got.any()
    else:
        assert got.min() == 0.0 and abs(got.max() - 1.0) <= 1e-6


def test_windows_outside_the_video_raise():
    video = _video(7, t=12)
    for starts in ([0, 5], [-1]):  # 5 + 8 frames > 12
        with pytest.raises(ValueError, match="outside"):
            native.kmni_make_batch(video, np.array(starts, np.int64))
    with pytest.raises(ValueError, match="outside"):
        native.window_gather(np.zeros((10, 3), np.float32),
                             np.array([4], np.int64), 7)


def test_a_failed_build_raises_and_nothing_falls_back(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX", "false")
    video, starts = _video(6), np.array([0], np.int64)
    with pytest.raises(RuntimeError, match="failed"):
        native.kmni_make_batch(video, starts)
    assert list(tmp_path.iterdir()) == []  # no half-written library
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="failed"):
        native.minmax_normalize(np.arange(4.0))
