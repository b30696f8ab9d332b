"""The port's checkpoints (``train/checkpoint.py``) and the DCGAN driver's
use of them, on the CPU.

- A GAN checkpoint (three nets with their BatchNorm statistics, three Adam
  states, epoch, the dropout generator's state, a zeroed ``mid``) restores
  bit for bit into a fresh template, and the restored nets and optimizers
  take the next step exactly as the originals do.
- Keep-N rotation, the ``schema.json`` sidecar, the step numbering and the
  ``mid`` subtree of the JAX package, a future schema refused (directory
  and snapshot), cross-precision restore.
- ``save_model`` / ``load_model``, including a bare state_dict (the
  conv-GAT driver's ``model.pt``) read as schema v1.
- The DCGAN driver checkpoints every ``save_epoch`` epochs and at the last,
  keeping 2, and the latest holds the trained generator.
"""

import json
import os

import numpy as np
import pytest
import torch

from extended_gan_tpu.train import checkpoint as jax_checkpoint
from extended_gan_torch.data.synthetic import ensure_synthetic_h5
from extended_gan_torch.data.streaming import get_h5_loaders
from extended_gan_torch.dcgan.__main__ import main as dcgan_cli
from extended_gan_torch.train import checkpoint as ckpt
from extended_gan_torch.train.dcgan_driver import DEFAULT_PARAMS, build_dcgan
from extended_gan_torch.train.dcgan_trainer import (
    make_dcgan_train_step,
    to_nchw,
)

PARAMS = {**DEFAULT_PARAMS, "ndf": 8}


def _assert_tree_equal(a, b, where="root"):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype, where
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=where)
    elif isinstance(a, dict):
        assert sorted(a, key=str) == sorted(b, key=str), where
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


@pytest.fixture(scope="module")
def batches():
    folder = ensure_synthetic_h5(None, frames_train=256, frames_test=64,
                                 h=64, w=64)
    loader, _ = get_h5_loaders(folder, 4, 8, crop=64, in_seq_len=4,
                               out_seq_len=4, seed=3)
    return [tuple(torch.from_numpy(to_nchw(a)) for a in next(loader))
            for _ in range(2)]


def test_gan_checkpoint_round_trip_is_bitwise(tmp_path, batches):
    nets, opts = build_dcgan(PARAMS, seed=1, device="cpu")
    step = make_dcgan_train_step(*nets, *opts)
    step(*batches[0])
    drop = nets[0].ConvBlock_0.dropout_generator
    saved = {"states": ckpt.gan_states(nets, opts), "epoch": 4,
             "key": drop.get_state(), "mid": ckpt.empty_mid()}
    mgr = ckpt.CheckpointManager(str(tmp_path / "checkpoints"), max_to_keep=2)
    mgr.save(ckpt.ckpt_step(5), saved)

    fresh, fresh_opts = build_dcgan(PARAMS, seed=2, device="cpu")
    template = ckpt.gan_restore_template(
        mgr, ckpt.gan_states(fresh, fresh_opts),
        fresh[0].ConvBlock_0.dropout_generator.get_state())
    assert "mid" in template  # a v3 directory
    restored = mgr.restore(template)
    _assert_tree_equal(restored, saved)
    assert any("running_var" in k for k in restored["states"]["g"]["model"])
    assert restored["states"]["td"]["optimizer"]["state"]  # Adam moments

    # the restored state takes the next step as the original does
    for net, opt, name in zip(fresh, fresh_opts, ("g", "fd", "td")):
        net.load_state_dict(restored["states"][name]["model"])
        opt.load_state_dict(restored["states"][name]["optimizer"])
    fresh[0].ConvBlock_0.dropout_generator.set_state(restored["key"])
    want = step(*batches[1])
    got = make_dcgan_train_step(*fresh, *fresh_opts)(*batches[1])
    for k in ("errFD", "errTD", "errG"):
        assert float(got[k]) == float(want[k]), k
    for a, b in zip(nets, fresh):
        _assert_tree_equal(b.state_dict(), a.state_dict())


def test_rotation_keeps_the_newest(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path), max_to_keep=2)
    assert mgr.latest_step() is None
    assert mgr.restore({"x": torch.zeros(1)}) is None
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": torch.full((2,), float(s))})
    assert mgr.all_steps() == [3, 4]
    assert sorted(os.listdir(tmp_path)) == ["schema.json", "step_3.pt",
                                            "step_4.pt"]
    assert mgr.latest_step() == 4
    assert float(mgr.restore({"x": torch.zeros(2)})["x"][0]) == 4.0
    assert float(mgr.restore({"x": torch.zeros(2)}, step=3)["x"][0]) == 3.0


def test_sidecar_and_numbering_match_jax(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path))
    assert mgr.sidecar_version() == 1  # no sidecar yet
    assert "mid" not in ckpt.gan_restore_template(mgr, {}, None)
    mgr.save(ckpt.ckpt_step(1), {"x": torch.zeros(1)})
    with open(tmp_path / "schema.json") as f:
        assert json.load(f) == {"schema_version": 3, "format": "torch.save"}
    assert mgr.sidecar_version() == ckpt.SCHEMA_VERSION == \
        jax_checkpoint.SCHEMA_VERSION
    for e, b in ((0, 0), (3, 0), (3, 7), (12, 99_999)):
        assert ckpt.ckpt_step(e, b) == jax_checkpoint.ckpt_step(e, b)
    with pytest.raises(ValueError, match="batch"):
        ckpt.ckpt_step(1, ckpt.MID_EPOCH_STRIDE)
    mid, jmid = ckpt.empty_mid(), jax_checkpoint.empty_mid()
    assert sorted(mid) == sorted(jmid)
    for k in mid:
        np.testing.assert_array_equal(mid[k].numpy(), jmid[k])
        assert mid[k].numpy().dtype == np.asarray(jmid[k]).dtype


def test_future_schema_is_refused(tmp_path):
    d = tmp_path / "future"
    d.mkdir()
    with open(d / "schema.json", "w") as f:
        json.dump({"schema_version": ckpt.SCHEMA_VERSION + 1}, f)
    with pytest.raises(ValueError, match="schema v4"):
        ckpt.CheckpointManager(str(d))
    path = str(tmp_path / "model.pt")
    torch.save({"schema": ckpt.SCHEMA_VERSION + 1, "state_dict": {}}, path)
    with pytest.raises(ValueError, match="schema v4"):
        ckpt.load_model(path)


def test_restore_casts_to_the_template(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path))
    w = torch.randn(3, 4, dtype=torch.float64)
    mgr.save(1, {"w": w.to(torch.bfloat16), "opt": [torch.ones(2)]})
    out = mgr.restore({"w": torch.zeros(3, 4), "opt": [torch.zeros(
        2, dtype=torch.float64)]})
    assert out["w"].dtype == torch.float32
    assert out["opt"][0].dtype == torch.float64
    torch.testing.assert_close(out["w"], w.to(torch.bfloat16).float(),
                               rtol=0, atol=0)


def test_save_model_and_load_model(tmp_path):
    state = {"a.weight": torch.randn(4, 3), "a.bias": torch.randn(4),
             "bn.num_batches_tracked": torch.tensor(5)}
    path = str(tmp_path / "sub" / "model.pt")
    ckpt.save_model(path, state)
    assert torch.load(path, weights_only=True)["schema"] == ckpt.SCHEMA_VERSION
    _assert_tree_equal(ckpt.load_model(path), state)
    bare = str(tmp_path / "bare.pt")  # the conv-GAT driver's model.pt
    torch.save({k: v.double() if v.is_floating_point() else v
                for k, v in state.items()}, bare)
    loaded = ckpt.load_model(bare, state)
    assert loaded["a.weight"].dtype == torch.float32
    torch.testing.assert_close(loaded["a.weight"], state["a.weight"])


def test_dcgan_driver_checkpoints_every_save_epoch_and_the_last(tmp_path):
    out = tmp_path / "run"
    nets, history = dcgan_cli([
        "--device", "cpu", "--epochs", "3", "--max-batches", "1",
        "--synthetic", "--out-dir", str(out), "--save-epoch", "2",
        "--train-batch-size", "4", "--test-batch-size", "32"])
    assert sorted(os.listdir(out)) == ["checkpoints", "history.json",
                                       "imgs", "training_plots"]
    mgr = ckpt.CheckpointManager(str(out / "checkpoints"))
    # epochs 2 (save_epoch) and 3 (the last), each the start of the next
    assert mgr.all_steps() == [ckpt.ckpt_step(3), ckpt.ckpt_step(4)]
    restored = mgr.restore(None)
    assert restored["epoch"] == 3
    assert sorted(restored) == ["epoch", "key", "mid", "states"]
    assert sorted(restored["states"]) == ["fd", "g", "td"]
    _assert_tree_equal(restored["states"]["g"]["model"],
                       nets[0].state_dict())
    assert len(history.history["pred_mse"]) == 3
