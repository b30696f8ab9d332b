"""Resume in the port's drivers (the port's side of ``tests/test_resume.py``
and ``tests/test_checkpoint_schema.py``), on the CPU.

- conv-GAT: a run that checkpoints every epoch, stopped after epoch 2 and
  resumed to epoch 3, equals the uninterrupted 3-epoch run bit for bit:
  the model, Adam's state, the scheduler's, the key stream, ``history.json``
  and ``model.pt``.
- DCGAN (channel dropout 0.01, so the dropout stream must come back): the
  same, for the three nets, their Adam states and the stream.
- A bf16 run's checkpoint resumes into a float32 run (the port keeps
  weights and optimizer state in float32 under both precisions: the
  restore casts to the running template's dtypes, and nothing needs it).
- An eager run's checkpoint resumes under ``megastep`` (and so with
  ``capturable`` Adam on the card): the running optimizer keeps its own
  ``capturable`` flag and Adam's step count goes where that optimizer
  keeps it. On the CPU the drivers never ask for ``capturable``, so the
  file is edited to carry the other flag.
- The conv-GAT checkpoint's schema: its keys are the JAX driver's, and its
  ``mid`` holds the JAX ``_empty_gat_mid`` leaves, dtypes included.
"""

import json
import os

import numpy as np
import pytest
import torch

from extended_gan_tpu.train import gat_driver as jax_gat_driver
from extended_gan_torch.core.prng import KeySeq
from extended_gan_torch.train import checkpoint as ckpt
from extended_gan_torch.train import dcgan_driver, gat_driver
from extended_gan_torch.train.state import NetState, load_optimizer_state
from test_torch_port_gat_family import one_torch_thread  # noqa: F401 - the autouse fixture

GAT = dict(model_type="temporal", mapping_type="conv", train_batch_size=4,
           test_batch_size=8, max_batches=5, downsample_size=(16, 16),
           dataset="synthetic", seed=31, device="cpu")
DCGAN = dict(train_batch_size=4, test_batch_size=8, max_batches=4,
             synthetic=True, seed=23, device="cpu")


def dcgan_params(save_epoch):
    return {"imsize": 64, "ndf": 8, "save_epoch": save_epoch}


def assert_tree_equal(a, b, where="tree"):
    """Two trees of dicts, lists, tensors and numbers, bit for bit."""
    if isinstance(a, dict):
        assert sorted(a, key=str) == sorted(b, key=str), where
        for k in a:
            assert_tree_equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_tree_equal(x, y, f"{where}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), where
    else:
        assert a == b or (a != a and b != b), (where, a, b)


def latest(out_dir):
    """The newest full checkpoint under ``out_dir``, as saved."""
    mgr = ckpt.CheckpointManager(os.path.join(out_dir, "checkpoints"))
    return mgr.latest_step(), torch.load(
        os.path.join(out_dir, "checkpoints",
                     f"step_{mgr.latest_step()}.pt"), weights_only=True)


def read_json(path):
    with open(path) as f:
        return json.load(f)


def assert_gat_runs_equal(ref, run):
    (s_ref, c_ref), (s_run, c_run) = latest(ref), latest(run)
    assert s_ref == s_run
    assert_tree_equal(c_ref, c_run)
    assert read_json(os.path.join(ref, "history.json")) == \
        read_json(os.path.join(run, "history.json"))
    assert_tree_equal(torch.load(os.path.join(ref, "model.pt")),
                      torch.load(os.path.join(run, "model.pt")))


def assert_dcgan_runs_equal(ref, run):
    (s_ref, c_ref), (s_run, c_run) = latest(ref), latest(run)
    assert s_ref == s_run
    assert_tree_equal(c_ref, c_run)
    assert read_json(os.path.join(ref, "history.json")) == \
        read_json(os.path.join(run, "history.json"))


def test_gat_resume_at_an_epoch_boundary_is_bitwise(tmp_path):
    ref, run = str(tmp_path / "ref"), str(tmp_path / "run")
    _, h_ref = gat_driver.train(output_path=ref, epochs=3,
                                checkpoint_every=1, **GAT)
    gat_driver.train(output_path=run, epochs=2, checkpoint_every=1, **GAT)
    step, saved = latest(run)
    assert step == ckpt.ckpt_step(3) and int(saved["epoch"]) == 2
    assert saved["state"]["scheduler"]["last_epoch"] == 2
    _, h_run = gat_driver.train(output_path=run, epochs=3,
                                checkpoint_every=1, resume=True, **GAT)
    assert h_run == h_ref and len(h_ref["val_loss"]) == 3
    assert_gat_runs_equal(ref, run)


def test_dcgan_resume_with_dropout_is_bitwise(tmp_path):
    ref, run = str(tmp_path / "ref"), str(tmp_path / "run")
    _, h_ref = dcgan_driver.train(out_dir=ref, epochs=3,
                                  params=dcgan_params(1), **DCGAN)
    dcgan_driver.train(out_dir=run, epochs=2, params=dcgan_params(1),
                       **DCGAN)
    _, h_run = dcgan_driver.train(out_dir=run, epochs=3, resume=True,
                                  params=dcgan_params(1), **DCGAN)
    assert h_run.history == h_ref.history
    assert_dcgan_runs_equal(ref, run)
    # the stream came back: a restart from the seed would draw epoch 1's
    # masks again
    fresh = KeySeq(DCGAN["seed"]).state
    assert not torch.equal(latest(run)[1]["key"], fresh)


def test_a_bf16_checkpoint_resumes_in_float32(tmp_path):
    run = str(tmp_path / "run")
    gat_driver.train(output_path=run, epochs=1, checkpoint_every=1,
                     precision="bf16", **GAT)
    _, saved = latest(run)
    model, history = gat_driver.train(output_path=run, epochs=2,
                                      checkpoint_every=1, resume=True,
                                      precision="f32", **GAT)
    assert len(history["val_loss"]) == 2
    assert model.hidden_layer.heads.mapping.dtype == torch.float32
    assert all(np.isfinite(v).all() for v in history.values())
    # the template casts to its own dtypes: a float32 tree stays as saved
    state = saved["state"]["model"]
    assert all(v.dtype in (torch.float32, torch.int64) for v in state.values())
    restored = ckpt._cast_like({"w": torch.zeros(2, dtype=torch.float32)},
                               {"w": torch.ones(2, dtype=torch.bfloat16)})
    assert restored["w"].dtype == torch.float32


def test_an_eager_checkpoint_resumes_under_megastep(tmp_path):
    ref, run = str(tmp_path / "ref"), str(tmp_path / "run")
    gat_driver.train(output_path=ref, epochs=2, checkpoint_every=1,
                     megastep=2, **GAT)
    gat_driver.train(output_path=run, epochs=1, checkpoint_every=1, **GAT)
    model, history = gat_driver.train(output_path=run, epochs=2,
                                      checkpoint_every=1, resume=True,
                                      megastep=2, **GAT)
    assert len(history["val_loss"]) == 2
    assert all(np.isfinite(v).all() for v in history.values())
    # the megastep run from the start: the same epoch 2 from the same state
    # (its groups of 2 are eager steps on the CPU)
    assert read_json(os.path.join(ref, "history.json"))["val_loss"][1] == \
        history["val_loss"][1]


@pytest.mark.parametrize("saved_flag", [True, False])
def test_the_running_optimizer_keeps_its_capturable_flag(saved_flag):
    p = torch.nn.Parameter(torch.ones(3))
    writer = torch.optim.Adam([p], lr=1e-3)
    p.grad = torch.full((3,), 0.5)
    writer.step()
    saved = writer.state_dict()
    saved["param_groups"][0]["capturable"] = saved_flag
    q = torch.nn.Parameter(torch.zeros(3))
    reader = torch.optim.Adam([q], lr=1e-3)  # the CPU's: not capturable
    load_optimizer_state(reader, saved)
    assert reader.param_groups[0]["capturable"] is False
    step = reader.state[q]["step"]
    assert step.device.type == "cpu" and float(step) == 1.0
    assert torch.equal(reader.state[q]["exp_avg"], writer.state[p]["exp_avg"])


def test_netstate_round_trips_model_optimizer_and_scheduler():
    net = torch.nn.Linear(3, 2)
    opt = torch.optim.Adam(net.parameters(), lr=1e-3)
    sched = torch.optim.lr_scheduler.StepLR(opt, 1, gamma=0.5)
    net(torch.ones(1, 3)).sum().backward()
    opt.step()
    sched.step()
    tree = NetState(net, opt, sched).state_dict()
    twin = torch.nn.Linear(3, 2)
    t_opt = torch.optim.Adam(twin.parameters(), lr=1e-3)
    t_sched = torch.optim.lr_scheduler.StepLR(t_opt, 1, gamma=0.5)
    NetState(twin, t_opt, t_sched).load_state_dict(tree)
    assert_tree_equal(NetState(twin, t_opt, t_sched).state_dict(), tree)
    assert t_opt.param_groups[0]["lr"] == 5e-4


def test_gat_checkpoint_schema_matches_jax(tmp_path):
    run = str(tmp_path / "run")
    gat_driver.train(output_path=run, epochs=1, checkpoint_every=1, **GAT)
    _, saved = latest(run)
    # the JAX driver's template keys (gat_driver.py:571-576), ``state``
    # holding the net, its optimizer and its scheduler
    assert sorted(saved) == ["best", "epoch", "key", "lr", "mid", "state"]
    assert sorted(saved["state"]) == ["model", "optimizer", "scheduler"]
    mid, jmid = saved["mid"], jax_gat_driver._empty_gat_mid()
    assert sorted(mid) == sorted(jmid)
    for k in mid:
        assert mid[k].numpy().dtype == np.asarray(jmid[k]).dtype, k
        assert mid[k].numpy() == jmid[k]
    assert_tree_equal(ckpt.empty_gat_mid(), mid)
    with open(os.path.join(run, "checkpoints", "schema.json")) as f:
        assert json.load(f)["schema_version"] == 3
