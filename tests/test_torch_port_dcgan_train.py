"""The port's DCGAN training path against the JAX package's, on the CPU.

- Two epochs of four train batches and two eval batches through the port's
  ``train_single_epoch`` and ``test`` and the JAX package's, from the same
  weights (ndf = 8, B = 4, dropout off): per-step losses within rtol 5e-3,
  atol 1e-4 (the bar of ``tests/test_e2e_torch_parity.py``), per-epoch
  metrics within the 1% budget, or one sample's share of the count on a
  discriminator accuracy (one borderline score that binarises the other
  way across frameworks).
- The synthetic archive equals the JAX package's ``.h5`` arrays (the port
  writes ``.npy``), and ``H5SequenceLoader`` batches are byte-identical to
  the JAX loader's over one folder and seed, across a file boundary and a
  short last batch. ``.h5`` files read where h5py is installed and raise
  the named error where it is not.
- ``python -m extended_gan_torch.dcgan`` on the CPU: finite results,
  ``history.json`` and ``checkpoints/`` under ``--out-dir`` and nowhere
  else (``tests/test_torch_port_checkpoint.py`` reads them); the JAX driver's
  unported keywords raise, naming their ROADMAP item; a data axis without
  its processes raises; without a card the default device raises.
"""

import hashlib
import os
import sys

import h5py
import numpy as np
import pytest
import torch

from extended_gan_tpu.data import streaming as jax_streaming
from extended_gan_tpu.data import synthetic as jax_synthetic
from extended_gan_tpu.parallel import MeshContext
from extended_gan_tpu.train.dcgan_trainer import (
    make_dcgan_eval_step as jax_eval_step,
    make_dcgan_train_step as jax_train_step,
    test as jax_test,
    train_single_epoch as jax_train_single_epoch,
)
from extended_gan_tpu.core import KeySeq
from extended_gan_torch.data import io, streaming, synthetic
from extended_gan_torch.dcgan.__main__ import main as cli
from extended_gan_torch.train import dcgan_driver, dcgan_trainer
from extended_gan_torch.utils.history import TrainingHistory
from test_torch_port_dcgan import B, jax_gan, port_gan
from test_torch_port_gat_family import one_torch_thread  # noqa: F401 - the autouse fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCHS = 2
STEP_RTOL, STEP_ATOL = 5e-3, 1e-4
METRIC_BUDGET = 0.01


def _epoch_batches(rng, n):
    return [(rng.uniform(0, 1, (B, 4, 64, 64)).astype(np.float32),
             rng.uniform(0, 1, (B, 4, 64, 64)).astype(np.float32))
            for _ in range(n)]


def test_two_epochs_match_jax():
    rng = np.random.default_rng(3)
    train_batches, val_batches = _epoch_batches(rng, 4), _epoch_batches(rng, 2)
    models, txs, states = jax_gan()
    nets, opts = port_gan(states)

    port_step = dcgan_trainer.make_dcgan_train_step(*nets, *opts)
    port_eval = dcgan_trainer.make_dcgan_eval_step(*nets)
    p_steps, p_hist = [], []

    def capture_port(x, y):
        logs = port_step(x, y)
        p_steps.append([float(logs[k]) for k in ("errFD", "errTD", "errG")])
        return logs

    jstep = jax_train_step(*models, *txs)
    j_steps, j_hist = [], []

    def capture_jax(states, x, y, mask, rng):
        states, logs = jstep(states, x, y, mask, rng)
        j_steps.append([float(logs[k]) for k in ("errFD", "errTD", "errG")])
        return states, logs

    # one device: a mesh of several would pad B = 4 to a multiple of them,
    # and the JAX package's train-mode BatchNorm would see the padding
    mesh = MeshContext.create(data=1)
    states = mesh.put_replicated(states)
    keys = KeySeq(5)
    cpu = torch.device("cpu")
    for epoch in range(1, EPOCHS + 1):
        result, _ = dcgan_trainer.train_single_epoch(
            dcgan_trainer.step_logs(train_batches, capture_port, cpu,
                                    log_every=1000))
        p_hist.append(result | dcgan_trainer.test(val_batches, port_eval, cpu))
        states, result, _ = jax_train_single_epoch(
            dataloader=list(train_batches), states=states, step=capture_jax,
            mesh=mesh, batch_size=B, rng_keys=keys, epoch=epoch,
            log_every=1000)
        j_hist.append(result | jax_test(
            list(val_batches), states, jax_eval_step(*models), mesh, B,
            epoch))
    assert len(p_steps) == len(j_steps) == 4 * EPOCHS
    np.testing.assert_allclose(p_steps, j_steps, rtol=STEP_RTOL,
                               atol=STEP_ATOL)
    # one sample's share of each accuracy's count: 2B a train step, 2 (one
    # sample's denominator for real and for fake) an eval batch
    quantum = {"train_fd_accuracy": 1 / (2 * B * 4),
               "train_td_accuracy": 1 / (2 * B * 4),
               "frame_disc_accuracy": 1 / (2 * 2),
               "temp_disc_accuracy": 1 / (2 * 2)}
    for p, j in zip(p_hist, j_hist):
        assert sorted(p) == sorted(j) == sorted([
            "train_mse", "train_fd_accuracy", "train_td_accuracy",
            "frame_disc_accuracy", "temp_disc_accuracy", "pred_accuracy",
            "pred_precision", "pred_recall", "pred_mse"])
        for k, want in j.items():
            got = p[k]
            assert (abs(got - want) <= METRIC_BUDGET * abs(want)
                    or abs(got - want) <= quantum.get(k, 0.0) + 1e-9), \
                (k, got, want)


def test_synthetic_archive_matches_jax(tmp_path):
    kw = dict(frames_train=40, frames_test=20, h=16, w=16, seed=3)
    jax_synthetic.make_h5_dataset(str(tmp_path / "jax"), **kw)
    synthetic.make_h5_dataset(str(tmp_path / "port"), **kw)
    for sub, name in (("train", "train"), ("test", "test_1")):
        with h5py.File(tmp_path / "jax" / sub / f"{name}.h5", "r") as f:
            want = f["default"][:]
        got = np.load(tmp_path / "port" / sub / f"{name}.npy")
        assert got.dtype == np.float32 and got.shape[1] == 1
        np.testing.assert_array_equal(got, want)
        # the JAX package's .h5 reads the same through the port's io
        np.testing.assert_array_equal(
            io.load_array(str(tmp_path / "jax" / sub / f"{name}.h5")), want)
    # the cached default is made once, in place
    folder = synthetic.ensure_synthetic_h5(str(tmp_path / "cache"), **kw)
    assert synthetic.ensure_synthetic_h5(folder, **kw) == folder
    np.testing.assert_array_equal(
        np.load(os.path.join(folder, "test", "test_1.npy")), want)


def _same_batches(got, want):
    assert len(got) == len(want)
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.dtype == wx.dtype and gx.shape == wx.shape
        assert gx.tobytes() == wx.tobytes() and gy.tobytes() == wy.tobytes()


@pytest.mark.parametrize("shuffle", [True, False])
def test_h5_loader_batches_match_jax(tmp_path, shuffle):
    rng = np.random.default_rng(0)
    for sub, lengths in (("train", (29, 6, 21)), ("test", (17,))):
        os.makedirs(tmp_path / sub)
        for i, n in enumerate(lengths):  # 6 frames hold no window of 8
            np.save(tmp_path / sub / f"{i:02d}.npy",
                    rng.uniform(0, 1, (n, 1, 20, 20)).astype(np.float32))
    kw = dict(crop=16, in_seq_len=4, out_seq_len=4, seed=7)
    folder = str(tmp_path / "train")
    got = list(streaming.H5SequenceLoader(folder, 5, shuffle=shuffle, **kw))
    want = list(jax_streaming.H5SequenceLoader(folder, 5, shuffle=shuffle,
                                               **kw))
    _same_batches(got, want)
    assert len(got) > 3 and got[0][0].shape == (5, 4, 1, 16, 16)
    assert min(len(x) for x, _ in got) < 5  # a short last batch of a file
    for g, w in zip(streaming.get_h5_loaders(str(tmp_path), 3, 4, **kw),
                    jax_streaming.get_h5_loaders(str(tmp_path), 3, 4, **kw)):
        _same_batches(list(g), list(w))


def test_h5_without_h5py_raises(tmp_path, monkeypatch):
    path = str(tmp_path / "a.h5")
    io.save_array(path, np.zeros((3, 1, 2, 2), np.float32))
    assert io.array_n_frames(path) == 3
    monkeypatch.setitem(sys.modules, "h5py", None)
    for call in (lambda: io.load_array(path), lambda: io.array_n_frames(path),
                 lambda: io.save_array(path, np.zeros(2))):
        with pytest.raises(ValueError, match=r"h5py.*\.pt or \.npy"):
            call()


def _tree_digest(folder):
    h = hashlib.sha256()
    for root, dirs, files in sorted(os.walk(folder)):
        dirs.sort()
        for f in sorted(files):
            h.update(f.encode())
            with open(os.path.join(root, f), "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()


def test_cli_trains_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    before = _tree_digest(os.path.join(REPO, "dcgan"))
    out = tmp_path / "out"
    nets, history = cli(["--device", "cpu", "--epochs", "1", "--max-batches",
                         "2", "--synthetic", "--out-dir", str(out),
                         "--train-batch-size", "4", "--test-batch-size", "8"])
    assert all(len(v) == 1 and np.isfinite(v[0])
               for v in history.history.values())
    assert "pred_mse" in history.history and "train_mse" in history.history
    assert sorted(os.listdir(tmp_path)) == ["out"]
    assert sorted(os.listdir(out)) == ["checkpoints", "history.json",
                                       "imgs", "training_plots"]
    saved = TrainingHistory.from_json(str(out / "history.json")).history
    assert saved == history.history
    assert _tree_digest(os.path.join(REPO, "dcgan")) == before
    assert all(next(n.parameters()).device.type == "cpu" for n in nets)


# the JAX driver's keywords the port refuses, a value that is not "off", and
# the ROADMAP queue 1 item that ports each
UNPORTED = [
    ("model_axis", 2, 9), ("tp_min_channels", 64, 9),
    ("fsdp", True, 9), ("fsdp_min_size", 1, 9), ("spatial", True, 9),
]


@pytest.mark.parametrize("key,value,item", UNPORTED)
def test_unported_keywords_raise_naming_their_item(key, value, item):
    with pytest.raises(NotImplementedError, match=rf"queue 1 item {item}\)"):
        dcgan_driver.train(device="cpu", **{key: value})


def test_unported_keywords_at_their_off_values_pass(monkeypatch):
    assert sorted(k for k, _, _ in UNPORTED) == \
        sorted(dcgan_driver._NOT_PORTED)
    stop = RuntimeError("past the option checks")

    def stopped(*args, **kwargs):
        raise stop

    monkeypatch.setattr(dcgan_driver, "data_axis_for", stopped)
    offs = {k: v[0][0] if isinstance(v[0], tuple) else v[0]
            for k, v in dcgan_driver._NOT_PORTED.items()}
    with pytest.raises(RuntimeError, match="past the option checks"):
        dcgan_driver.train(**offs)
    with pytest.raises(TypeError, match="bogus"):
        dcgan_driver.train(bogus=1)


def test_a_data_axis_without_its_processes_raises():
    with pytest.raises(RuntimeError, match="needs 2 processes"):
        dcgan_driver.train(device="cpu", data_axis=2)
    with pytest.raises(ValueError, match="not divisible by the data axis 3"):
        dcgan_driver.train(device="cpu", data_axis=3, resident=True,
                           train_batch_size=32)


def test_default_device_without_a_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli(["--epochs", "1", "--max-batches", "1", "--synthetic",
             "--out-dir", str(tmp_path)])
    assert os.listdir(tmp_path) == []


def test_build_dcgan_is_seeded():
    params = {**dcgan_driver.DEFAULT_PARAMS, "ndf": 8}
    a, _ = dcgan_driver.build_dcgan(params, seed=1, device="cpu")
    b, opts = dcgan_driver.build_dcgan(params, seed=1, device="cpu")
    c, _ = dcgan_driver.build_dcgan(params, seed=2, device="cpu")
    for na, nb, nc in zip(a, b, c):
        sa, sb, sc = na.state_dict(), nb.state_dict(), nc.state_dict()
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
        assert not all(torch.equal(sa[k], sc[k]) for k in sa
                       if sa[k].is_floating_point())
    group = opts[0].param_groups[0]
    assert (group["lr"], group["betas"], group["eps"]) == (2e-4, (0.5, 0.999),
                                                           1e-8)
