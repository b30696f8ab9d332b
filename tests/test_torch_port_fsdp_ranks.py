"""FSDP / ZeRO-3 (``extended_gan_torch/parallel/fsdp.py``) on two gloo
ranks on the CPU (``torch_dp_ranks.run``), against the data axis without
it, the port's one process in float64 and JAX's one-device step.

- The narrow DCGAN (ndf 8, 64x64) in its default and ``fused_prop``
  bodies and the narrow CycleGAN, two SGD steps, FSDP at ``min_size`` 1
  (every leaf with an even axis cut, BatchNorm's affine included) and at
  4096: the logs and the full state after the steps equal the data axis's
  without FSDP bit for bit. At two ranks each element of a sum is one
  addition of two values, whichever collective makes it (the flat
  all-reduce or FSDP's reduce-scatter), and Adam and SGD act elementwise,
  so the blocks step as the full leaves do.
- The narrow UNet (cross-rank BatchNorm, K3's plain twin), GAT3D (K1's
  plain twin), GAT3D with K2's fused mapping (plain twin; its 74 x 74 1x1
  weight is cut at 4096) and the narrow MoE UNet with its experts sharded
  by EP and the rest by FSDP: two Adam steps of the conv-GAT optimizer
  (L2 decay 0.01), bit for bit against the data axis alone; the UNet's
  also under remat; ``PerVertexBatchNorm2d`` alone with its affine cut.
- Against one process in float64 (the plain path alone, no code of the
  axis): the DCGAN's and the UNet's FSDP steps within the data-parallel
  tests' bound: ``TRAIN_TOL`` of each tensor's largest entry, or
  ``SENS_FACTOR`` times how far the one process's float32 step lies from
  its float64 step or from itself on an input under 1e-7 noise.
- Against JAX's one-device DCGAN step (``tests/test_fsdp.py``'s check):
  the weights JAX draws, dropout off, one Adam step of the drivers'
  optimizer, FSDP at ``min_size`` 1: the losses within rtol 1e-4, atol
  1e-5, the weights within atol 5e-4.
- A planted fault must miss the bound by more than 10x: FD's and TD's
  working weights not gathered after their optimizer's step, so stage 5
  of the default body trains G against the discriminators before it.
- Resume through the DCGAN driver: two epochs with FSDP equal one epoch
  resumed to two with FSDP, without it from FSDP's checkpoint, and with it
  from a checkpoint written without it, bit for bit; the checkpoints hold
  full leaves.
- The CLIs: ``--fsdp --data-axis 2 --device cpu`` through the dcgan,
  cycle_gan (with ``--megastep 2``) and gat CLIs, which report every rank
  in sync; the gat run's ``model.pt`` holds full leaves; an axis of one
  prints JAX's line.
"""

from __future__ import annotations

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_dp_ranks as ranks
from extended_gan_tpu.core import KeySeq
from extended_gan_tpu.models import dcgan as jax_dcgan
from extended_gan_tpu.parallel import MeshContext
from extended_gan_tpu.train.dcgan_trainer import (
    GANStates,
    make_dcgan_train_step as jax_dcgan_step,
)
from extended_gan_tpu.train.state import create_net_state
from extended_gan_torch.models.convert import from_flax_params
from extended_gan_torch.parallel import fsdp
from test_torch_port_gan_data_parallel import _batch, _case
from test_torch_port_gat_family import one_torch_thread  # noqa: F401 - the autouse fixture
from test_torch_port_gat_smaat import SENS_FACTOR, TRAIN_TOL, gap, perturbed

B = 8
GAN_STEPS = 2
GAN = {"default": ("dcgan", {}), "fused_prop": ("dcgan",
                                                dict(fused_prop=True)),
       "cyclegan": ("cyclegan", {})}
MODELS = ("unet", "gat", "k2", "moe")
STALE_D = "fsdp1 default stale_d"


def _gan_case(body, fsdp_min=None, **kw):
    kind, opts = GAN[body]
    case = _case(kind, B)
    case.update(body=opts, fsdp=fsdp_min, steps=GAN_STEPS)
    case.update(kw)
    return case


def _model_state(kind):
    torch.manual_seed(0)
    if kind == "moe":
        model = ranks.make_moe_model(False)
        hw = ranks.MOE_HW
    elif kind == "k2":
        from extended_gan_torch.models.gat.gat3d import Model

        model = Model(ranks.HW, ranks.HW, ranks.V, attention_type="temporal",
                      mapping_type="conv", use_pallas=True,
                      use_pallas_mapping=True)
        hw = ranks.HW
    else:
        model = ranks.make_model(kind)
        hw = ranks.HW
    rng = np.random.default_rng(3)
    shape = (B, hw, hw, ranks.T, ranks.MOE_V if kind == "moe" else ranks.V)
    return (model.state_dict(), rng.random(shape, np.float32),
            rng.random(shape, np.float32))


def _model_case(kind, fsdp_min=None, **kw):
    state, x, y = _model_state(kind)
    return dict(kind=kind, state=state, x=x, y=y, fsdp=fsdp_min, steps=2,
                **kw)


def _jax_adam():
    """JAX's DCGAN (ndf 8, dropout off) with the drivers' Adam, its
    states, and the port's state_dicts of them."""
    models = (jax_dcgan.Generator(nc=ranks.GAN_NC, dropout=0.0),
              jax_dcgan.FrameDiscriminator(nc=ranks.GAN_NC,
                                           ndf=ranks.GAN_NDF),
              jax_dcgan.TemporalDiscriminator(nc=ranks.GAN_NC,
                                              ndf=ranks.GAN_NDF,
                                              dropout=0.0))
    im = ranks.GAN_IM
    samples = (jnp.zeros((2, im, im, ranks.GAN_NC)),) * 2 + (
        jnp.zeros((2, im, im, 2 * ranks.GAN_NC)),)
    tx = optax.adam(2e-4, b1=0.5, b2=0.999, eps=1e-8)
    keys = KeySeq(5)
    states = GANStates(*(create_net_state(m, tx, keys.next(), s)
                         for m, s in zip(models, samples)))
    dicts = [from_flax_params(jax.device_get(s.params),
                              jax.device_get(s.batch_stats))
             for s in (states.g, states.fd, states.td)]
    return models, tx, states, dicts


@functools.cache
def _jax_one_device():
    """JAX's one Adam step on one device: the logs and each net's
    parameters under the port's names."""
    models, tx, states, _ = _jax_adam()
    step = jax_dcgan_step(*models, tx, tx, tx)
    mesh = MeshContext.create(data=1)
    x, y = (np.moveaxis(a, 1, -1) for a in _batch(B))
    xb, yb, mb = mesh.put_batch(x, y, np.ones(B, np.float32))
    new, logs = step(mesh.put_replicated(states), xb, yb, mb,
                     jax.random.PRNGKey(0))
    new = jax.device_get(new)
    return ({k: float(logs[k]) for k in ("errFD", "errTD", "errG")},
            [from_flax_params(s.params) for s in (new.g, new.fd, new.td)])


def _payload(tmp):
    gan = {}
    for body in GAN:
        gan[f"dp {body}"] = _gan_case(body)
        gan[f"fsdp1 {body}"] = _gan_case(body, 1)
    gan["fsdp4096 default"] = _gan_case("default", 4096)
    gan[STALE_D] = _gan_case("default", 1, fault="stale_d")
    x, y = _batch(B)
    gan["jax adam"] = dict(kind="dcgan", body={}, dropout=0.0, x=x, y=y,
                           states=_jax_adam()[3], fsdp=1, opt="adam",
                           steps=1)
    model = {}
    for kind in MODELS:
        model[f"dp {kind}"] = _model_case(kind)
        model[f"fsdp {kind}"] = _model_case(
            kind, 4096 if kind == "k2" else 1)
    model["dp unet remat"] = _model_case("unet", remat=True)
    model["fsdp unet remat"] = _model_case("unet", 1, remat=True)
    rng = np.random.default_rng(8)
    pv = dict(state={"weight": torch.from_numpy(rng.uniform(
        0.5, 1.5, 4).astype(np.float32)), "bias": torch.from_numpy(
        rng.standard_normal(4).astype(np.float32)),
        "running_mean": torch.zeros(3, 4), "running_var": torch.ones(3, 4),
        "num_batches_tracked": torch.tensor(0)},
        x=rng.standard_normal((12, 4, 5, 5)).astype(np.float32),
        dy=rng.standard_normal((12, 4, 5, 5)).astype(np.float32))
    bn = {"dp per-vertex bn": pv, "fsdp per-vertex bn": dict(pv, fsdp=1)}
    resume = dict(out=str(tmp / "resume"), kw=dict(
        max_batches=2, train_batch_size=4, test_batch_size=64,
        params={"ndf": 8, "save_epoch": 1}))
    return {"gan": gan, "model": model, "bn": bn, "resume": resume}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both ranks' results, and the CLI runs, started together."""
    tmp = tmp_path_factory.mktemp("fsdp_ranks")
    finish = ranks.start("fsdp_cases", 2, tmp, _payload(tmp))
    clis = _start_clis(tmp)
    return finish(600), {k: _finish_cli(p) for k, p in clis.items()}, tmp


def _assert_same(a, b, what):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), what
        for k in a:
            _assert_same(a[k], b[k], f"{what} {k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (u, v) in enumerate(zip(a, b)):
            _assert_same(u, v, f"{what} {i}")
    else:
        assert np.array_equal(np.asarray(a), np.asarray(b)), what


@pytest.mark.parametrize("name", [f"fsdp1 {body}" for body in GAN]
                         + ["fsdp4096 default"])
def test_gan_fsdp_equals_the_data_axis_bit_for_bit(two_ranks, name):
    got = two_ranks[0][0]
    want = got["dp " + name.split(" ", 1)[1]]
    _assert_same(got[name]["logs"], want["logs"], "logs")
    _assert_same(got[name]["state"], want["state"], "state")
    assert got[name]["in_sync"] > 0


@pytest.mark.parametrize("kind", list(MODELS) + ["unet remat"])
def test_model_fsdp_equals_the_data_axis_bit_for_bit(two_ranks, kind):
    got = two_ranks[0][0]
    fs, dp = got[f"fsdp {kind}"], got[f"dp {kind}"]
    assert fs["sharded"] > 0 and dp["sharded"] == 0
    assert fs["losses"] == dp["losses"]
    _assert_same(fs["state"], dp["state"], kind)
    assert fs["in_sync"] > 0


def test_per_vertex_batch_norm_reads_the_gathered_affine(two_ranks):
    """``PerVertexBatchNorm2d`` with its (C,) weight and bias cut in two
    (min_size 1) normalises with the gathered affine and steps its
    blocks as the data axis's full leaves step, bit for bit; its (V, C)
    running statistics are buffers, never cut."""
    got = two_ranks[0][0]
    fs, dp = got["fsdp per-vertex bn"], got["dp per-vertex bn"]
    _assert_same(fs, dp, "per-vertex bn")
    assert fs["state"][0]["running_mean"].shape == (3, 4)


def test_every_rank_ends_with_the_same_full_state(two_ranks):
    r0, r1 = two_ranks[0]
    for name in r0:
        if name != "resume":
            _assert_same(r0[name]["state"], r1[name]["state"], name)
    _assert_same(r0["fsdp per-vertex bn"]["y"], r1["fsdp per-vertex bn"]["y"],
                 "per-vertex bn rows")


def _gaps(got, want, twins):
    """Each full leaf's gap over its bound, the worst first."""
    out = []
    for i, tree in enumerate(want):
        for k, w in tree.items():
            sens = max(gap(a[i][k], b[i][k]) for a, b in twins)
            out.append((gap(got[i][k], w) / max(TRAIN_TOL,
                                                 SENS_FACTOR * sens), k))
    return sorted(out, reverse=True)


@functools.cache
def _one_process_gan(dtype=torch.float32, perturb=False, fault=None):
    case = _gan_case("default", None)
    if perturb:
        case["x"], case["y"] = perturbed(case["x"]), perturbed(case["y"])
    return ranks.fsdp_gan_run(case, None, dtype)["state"]


def _gan_twins():
    return ((_one_process_gan(), _one_process_gan(torch.float64)),
            (_one_process_gan(perturb=True), _one_process_gan()))


def test_gan_fsdp_meets_one_process_in_float64(two_ranks):
    got = two_ranks[0][0]["fsdp1 default"]["state"]
    worst = _gaps(got, _one_process_gan(torch.float64), _gan_twins())
    assert worst[0][0] <= 1.0, worst[:3]


def test_unet_fsdp_meets_one_process_in_float64(two_ranks):
    case = _model_case("unet")
    p64 = ranks.fsdp_model_run(case, None, torch.float64)["state"]
    p32 = ranks.fsdp_model_run(case, None)["state"]
    noisy = dict(case, x=perturbed(case["x"]), y=perturbed(case["y"]))
    n32 = ranks.fsdp_model_run(noisy, None)["state"]
    got = two_ranks[0][0]["fsdp unet"]["state"]
    worst = _gaps([got], [p64], (([p32], [p64]), ([n32], [p32])))
    assert worst[0][0] <= 1.0, worst[:3]


def test_stale_discriminators_miss_the_bound(two_ranks):
    """FD's and TD's gathers after their step removed: G's stage 5 reads
    the discriminators before their update. The ratio to the bound is
    printed (``-s``)."""
    got = two_ranks[0][0][STALE_D]["state"]
    worst = _gaps(got, _one_process_gan(torch.float64), _gan_twins())
    print(f"stale-D fault: {worst[0][0]:.1f}x the bound ({worst[0][1]})")
    assert worst[0][0] > 10.0, worst[:3]


def test_dcgan_fsdp_meets_jax_one_device_adam_step(two_ranks):
    """``tests/test_fsdp.py``'s tolerances: losses rtol 1e-4, atol 1e-5;
    the weights atol 5e-4 (one Adam step moves each by at most ~2e-4, so
    that bound catches a step that goes the wrong way or not at all)."""
    got = two_ranks[0][0]["jax adam"]
    logs, params = _jax_one_device()
    for k in ("errFD", "errTD", "errG"):
        np.testing.assert_allclose(float(got["logs"][k]), logs[k],
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    _, _, _, start = _jax_adam()
    moved = 0
    for net, want, init in zip(got["state"], params, start):
        for k, w in want.items():
            np.testing.assert_allclose(net[k], w.numpy(), atol=5e-4,
                                       err_msg=k)
            moved += int(np.abs(net[k] - init[k].numpy()).max() > 1e-5)
    assert moved > 0


def test_resume_reshards_and_crosses_with_and_without_fsdp(two_ranks):
    res = two_ranks[0][0]["resume"]
    whole = res["whole"]["state"]
    for name in ("cut", "cut_plain", "plain_cut"):
        _assert_same(res[name]["state"], whole, name)
    # FSDP runs hold blocks; the one resumed without it, full leaves
    assert all(res["whole"]["shards"]) and not any(
        res["cut_plain"]["shards"])
    _assert_same(res["plain_cut"]["shards"], res["whole"]["shards"],
                 "shards")


def test_checkpoints_hold_full_leaves(two_ranks):
    from extended_gan_torch.train.checkpoint import CheckpointManager

    tmp = two_ranks[2]
    mgr = CheckpointManager(str(tmp / "resume" / "whole" / "checkpoints"))
    tree = mgr.restore(None)
    full = ranks.gan_nets("dcgan", _case("dcgan", B)["states"], dropout=0.0)
    for name, net in zip(("g", "fd", "td"), full):
        saved = tree["states"][name]["model"]
        for k, v in net.state_dict().items():
            assert tuple(saved[k].shape) == tuple(v.shape), (name, k)


# ------------------------------------------------------------------ CLIs
CLI_ARGS = {
    "dcgan": ["-m", "extended_gan_torch.dcgan", "--epochs", "1",
              "--max-batches", "2", "--synthetic", "--train-batch-size",
              "4", "--test-batch-size", "64"],
    "cycle_gan": ["-m", "extended_gan_torch.cycle_gan", "--epochs", "1",
                  "--max-batches", "2", "--synthetic", "--train-batch-size",
                  "4", "--test-batch-size", "8", "--ndf", "8",
                  "--megastep", "2", "--fsdp-min-size", "1"],
    "gat": ["-m", "extended_gan_torch.gat", "train", "--model-type", "unet",
            "--mapping-type", "linear", "--dataset", "synthetic",
            "--downsample-size", "16", "16", "--train-batch-size", "4",
            "--test-batch-size", "4", "--epochs", "1", "--max-batches", "2",
            "--fsdp-min-size", "1"],
}


def _start_clis(tmp):
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                        "LOCAL_RANK")}
    env["OMP_NUM_THREADS"] = "1"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = {}
    for name, args in CLI_ARGS.items():
        out = str(tmp / f"cli_{name}")
        where = ["--output-path", out] if name == "gat" else ["--out-dir",
                                                               out]
        procs[name] = subprocess.Popen(
            [sys.executable, *args, "--device", "cpu", "--data-axis", "2",
             "--fsdp", *where], cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    procs["axis of one"] = subprocess.Popen(
        [sys.executable, *CLI_ARGS["dcgan"][:4], "--max-batches", "1",
         "--device", "cpu", "--fsdp", "--train-batch-size", "2",
         "--test-batch-size", "2"], cwd=root, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return procs


def _finish_cli(proc):
    out, _ = proc.communicate(timeout=600)
    return proc.returncode, out


@pytest.mark.parametrize("name", sorted(CLI_ARGS))
def test_cli_fsdp_on_two_gloo_ranks(two_ranks, name):
    rc, out = two_ranks[1][name]
    assert rc == 0, out[-3000:]
    assert "ZeRO-sharded over 2 ranks" in out, out[-3000:]
    assert "[data axis] 2 ranks in sync" in out, out[-3000:]


def test_cli_gat_model_pt_holds_full_leaves(two_ranks):
    from extended_gan_torch.models.registry import build_model

    saved = torch.load(two_ranks[2] / "cli_gat" / "model.pt",
                       weights_only=True)
    model = build_model("unet", image_width=16, image_height=16,
                        n_vertices=1, mapping_type="linear", device="cpu")
    want = model.state_dict()
    assert sorted(saved) == sorted(want)
    for k, v in want.items():
        assert tuple(saved[k].shape) == tuple(v.shape), k


def test_cli_axis_of_one_prints_the_jax_line(two_ranks):
    rc, out = two_ranks[1]["axis of one"]
    assert rc == 0, out[-3000:]
    assert fsdp.AXIS_OF_ONE in out
