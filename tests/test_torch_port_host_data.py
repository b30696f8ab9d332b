"""The port's KNMI and ARAI host pipelines against the JAX package's, on
the CPU.

- ``KmniLoader``: the same batches, byte for byte, the same ``file_length``
  and, in global mode, the same ``n_decodes`` as the JAX loader for the same
  seed and options: ``use_native`` on and off, ``shuffle_mode`` batch and
  global, ``shuffle_pool`` 4, 2 and 0, ``merge_nodes`` off and on, and the
  cap on decoded videos with pool 0 over 20 files (no more than
  ``MAX_CACHED_VIDEOS`` held, re-decodes counted as JAX counts them).
- ``AraiLoader``: the native batches are the JAX native loader's and the
  port's own numpy path's, byte for byte.
- The conv-GAT driver trains with ``shuffle_mode="global"``: from the JAX
  init (converted) on the same archive its history is the JAX driver's
  within the 1% budget (``BASELINE.md:71``), and a run stopped mid-epoch by
  a counting shutdown and resumed is the uninterrupted run bit for bit
  (the resumed epoch replays the same global order from a fresh loader).
- The ``Prefetcher`` that moves batches to the device stops its thread
  when its consumer stops early, and waits for it, so no producer is left
  inside a transfer when a preempted run exits.
"""

import contextlib
import os
import threading
import time

import jax
import numpy as np
import pytest

from extended_gan_tpu.data import native as jax_native
from extended_gan_tpu.data import streaming as jax_streaming
from extended_gan_tpu.train import gat_driver as jax_gat_driver
from extended_gan_torch.data import native, streaming, synthetic
from extended_gan_torch.models.convert import from_flax_params
from extended_gan_torch.train import checkpoint as ckpt
from extended_gan_torch.train import gat_driver
from test_torch_port_gat_family import one_torch_thread  # noqa: F401 - the autouse fixture
from test_torch_port_preempt import CountingShutdown
from test_torch_port_resume import assert_gat_runs_equal, latest

BUDGET = 0.01  # BASELINE.md:71


@pytest.fixture(scope="module")
def knmi(tmp_path_factory):
    root = tmp_path_factory.mktemp("knmi")
    return os.path.join(synthetic.make_kmni_dataset(
        str(root), n_train_files=5, n_test_files=1, frames_per_file=20,
        hw=12), "train")


def _same_epoch(got, want):
    n = 0
    for (xg, yg), (xw, yw) in zip(got, want, strict=True):
        for a, b in ((xg, xw), (yg, yw)):
            assert a.dtype == b.dtype == np.float32
            assert a.shape == b.shape and a.tobytes() == b.tobytes()
        n += 1
    return n


# (use_native, shuffle_mode, shuffle_pool, merge_nodes)
CASES = [(nat, "batch", 4, merge) for nat in (True, False)
         for merge in (False, True)] + \
    [(True, "global", pool, merge) for pool in (4, 2, 0)
     for merge in (False, True)]


@pytest.mark.parametrize("use_native,mode,pool,merge", CASES)
def test_kmni_loader_matches_jax(knmi, use_native, mode, pool, merge):
    assert jax_native.available()
    kw = dict(crop=10, shuffle=True, merge_nodes=merge, seed=7,
              use_native=use_native, shuffle_mode=mode, shuffle_pool=pool)
    got = streaming.KmniLoader(3, knmi, **kw)
    want = jax_streaming.KmniLoader(3, knmi, None, **kw)
    assert got.file_length == want.file_length
    assert got.use_native == want.use_native
    if mode == "global":
        assert got.n_decodes == want.n_decodes == 0  # headers only
    n = _same_epoch(got, want)
    assert n >= 10
    if mode == "global":
        assert got.n_decodes == want.n_decodes == len(got.files)
        assert got.file_length == 2 * 5 * 9


def test_the_decoded_video_cache_is_capped_with_one_pool(tmp_path):
    folder = os.path.join(synthetic.make_kmni_dataset(
        str(tmp_path), n_train_files=20, n_test_files=1, frames_per_file=16,
        hw=8), "train")
    kw = dict(crop=8, shuffle=True, seed=2, shuffle_mode="global",
              shuffle_pool=0)
    got = streaming.KmniLoader(8, folder, **kw)
    want = jax_streaming.KmniLoader(8, folder, None, **kw)
    peak = 0
    for (xg, _), (xw, _) in zip(got, want, strict=True):
        assert xg.tobytes() == xw.tobytes()
        peak = max(peak, len(got._video_cache))
    assert peak == streaming.KmniLoader.MAX_CACHED_VIDEOS
    assert got.n_decodes == want.n_decodes > len(got.files)


def test_an_unknown_shuffle_mode_raises(knmi):
    with pytest.raises(ValueError, match="shuffle_mode"):
        streaming.KmniLoader(3, knmi, shuffle_mode="files")


@pytest.mark.parametrize("use_native", [True, False])
def test_arai_loader_matches_jax(tmp_path, use_native):
    root = synthetic.make_arai_dataset(str(tmp_path), n_files=2,
                                       frames_per_file=15, h=12, w=12)
    folder = os.path.join(root, "training")
    kw = dict(total_length=30, n_regions=5, downsample_size=(10, 9),
              shuffle=True, seed=4)
    calls = native.call_counts()["kmni_make_batch"]
    got = streaming.AraiLoader(3, folder, use_native=use_native, **kw)
    want = jax_streaming.AraiLoader(3, folder, None, use_native=True, **kw)
    assert _same_epoch(got, want) == len(got) == 6
    assert (native.call_counts()["kmni_make_batch"] > calls) == use_native


@pytest.mark.parametrize("stop", ["break", "raise"])
def test_a_prefetcher_stops_with_its_consumer(monkeypatch, stop):
    monkeypatch.setattr(os, "cpu_count", lambda: 8)  # the threaded path
    made = []

    def transfer(i):
        time.sleep(0.01)
        made.append(i)
        if stop == "raise" and i == 3:
            raise RuntimeError("a transfer failed")
        return i
    before = set(threading.enumerate())
    feed = iter(streaming.Prefetcher(iter(range(1000)), depth=2,
                                     transfer=transfer))
    got = []
    with pytest.raises(RuntimeError) if stop == "raise" else \
            contextlib.nullcontext():
        for i in feed:
            got.append(i)
            if i == 5:
                break
    feed.close()
    assert not [t for t in threading.enumerate() if t not in before]
    n = len(made)
    time.sleep(0.05)
    assert len(made) == n < 10  # nothing runs after the stop
    assert got == list(range(6 if stop == "break" else 3))


GLOBAL = dict(model_type="temporal", mapping_type="linear", optimizer="sgd",
              train_batch_size=4, test_batch_size=8, max_batches=6,
              downsample_size=(16, 16), dataset="synthetic", seed=13,
              shuffle_mode="global")


def test_global_shuffle_trains_as_the_jax_driver(tmp_path, monkeypatch):
    init = {}
    real_init = jax_gat_driver.create_net_state

    def keep_init(*args, **kwargs):
        state = real_init(*args, **kwargs)
        init["params"] = jax.device_get(state.params)
        return state
    monkeypatch.setattr(jax_gat_driver, "create_net_state", keep_init)
    _, want = jax_gat_driver.train(output_path=str(tmp_path / "jax"),
                                   plot=False, epochs=2, **GLOBAL)
    weights = from_flax_params(init["params"])
    real_build = gat_driver.build_model

    def build_with_jax_init(*args, **kwargs):
        model = real_build(*args, **kwargs)
        model.load_state_dict(weights)
        return model
    monkeypatch.setattr(gat_driver, "build_model", build_with_jax_init)
    _, got = gat_driver.train(output_path=str(tmp_path / "port"), epochs=2,
                              device="cpu", **GLOBAL)
    assert set(got) == set(want)
    for key, values in want.items():
        assert len(got[key]) == len(values) == 2, key
        np.testing.assert_allclose(got[key], values, rtol=BUDGET, err_msg=key)


def test_a_preempted_global_run_resumes_bit_for_bit(tmp_path, monkeypatch):
    kw = dict(GLOBAL, mapping_type="conv", optimizer="adam", max_batches=5,
              device="cpu", epochs=2, checkpoint_every=10)
    ref, run = str(tmp_path / "ref"), str(tmp_path / "run")
    gat_driver.train(output_path=ref, **kw)
    # epoch 1 reads the flag after each of its 5 steps and at its end;
    # epoch 2 stops after its third step
    monkeypatch.setattr(gat_driver, "GracefulShutdown",
                        lambda: CountingShutdown(9))
    _, cut = gat_driver.train(output_path=run, **kw)
    monkeypatch.undo()
    assert len(cut["train_loss"]) == 1
    step, saved = latest(run)
    assert step == ckpt.ckpt_step(2, 3) and int(saved["mid"]["batch"]) == 3
    gat_driver.train(output_path=run, resume=True, **kw)
    assert_gat_runs_equal(ref, run)
