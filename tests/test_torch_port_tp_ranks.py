"""Tensor parallelism (``extended_gan_torch/parallel/tensor.py``) on a
(data 2, model 2) mesh of four gloo ranks on the CPU
(``torch_dp_ranks.tp_cases``), against JAX's step, the port's one process
in float64 and the data axis alone.

- The narrow DCGAN's one Adam step (JAX's one-device step, dropout off),
  and one SGD step each of the narrow CycleGAN and the narrow UNet
  (JAX's step on a data mesh), the discriminators' leaves and the UNet's
  depthwise-separable leaves of at least 16 channels cut (K3's plain twin
  on each rank's output channels), within JAX's own TP tolerances
  (``tests/test_tensor_parallel.py``): losses rtol 1e-4, atol 1e-5, the
  weights after the step atol 5e-4.
- TP x FSDP: the narrow DCGAN and UNet with FSDP at min_size 1 on top of
  TP (each TP block cut again over the data axis) equal TP alone bit for
  bit (at two data ranks each element of a sum is one addition, whichever
  collective makes it), and the DCGAN's meets one process in float64
  within the FSDP tests' bound.
- TP x EP: the narrow MoE UNet with TP and its experts sharded over the
  data axis meets one process in float64 within the same bound.
- A planted fault must miss the bound by more than 10x: the DCGAN's cut
  convs without their all-reduce of dx over the model axis.
- Resume through the DCGAN driver on this mesh: a checkpoint written with
  TP loads into a run without it and one written without it into TP's
  blocks, bit for bit; two epochs with TP equal one epoch resumed to two
  with TP, bit for bit; the checkpoints hold full leaves.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import torch_dp_ranks as ranks
from test_torch_port_data_parallel import _case as _unet_case
from test_torch_port_data_parallel import _jax_step as _jax_unet_step
from test_torch_port_fsdp_ranks import (
    _assert_same,
    _gan_case,
    _gan_twins,
    _gaps,
    _jax_adam,
    _jax_one_device,
    _model_case,
    _one_process_gan,
)
from test_torch_port_gan_data_parallel import _batch
from test_torch_port_gan_data_parallel import _case as _sgd_gan_case
from test_torch_port_gan_data_parallel import _jax_step as _jax_gan_step
from test_torch_port_gat_family import one_torch_thread  # noqa: F401 - the autouse fixture
from test_torch_port_gat_smaat import perturbed

TP = 16
# JAX's TP tolerances (tests/test_tensor_parallel.py)
LOSS_RTOL, LOSS_ATOL, PARAM_ATOL = 1e-4, 1e-5, 5e-4


def _payload(tmp):
    x, y = _batch(8)
    gan = {"jax adam": dict(kind="dcgan", body={}, dropout=0.0, x=x, y=y,
                            states=_jax_adam()[3], opt="adam", steps=1,
                            tp=TP),
           "tp default": _gan_case("default", tp=TP),
           "tp fsdp default": _gan_case("default", 1, tp=TP),
           "tp dx default": _gan_case("default", tp=TP, tp_fault="dx")}
    model = {"tp unet": _model_case("unet", tp=TP),
             "tp fsdp unet": _model_case("unet", 1, tp=TP),
             "dp moe": _model_case("moe"),
             "tp moe": _model_case("moe", tp=TP)}
    gan_sgd = {"sgd cyclegan": dict(_sgd_gan_case("cyclegan"), tp=TP)}
    sgd = {"sgd unet": dict(_unet_case("unet", 8), tp=TP)}
    resume = dict(out=str(tmp / "resume"), tp=TP, kw=dict(
        max_batches=2, train_batch_size=4, test_batch_size=64,
        params={"ndf": 8, "save_epoch": 1}))
    return {"mesh": (2, 2), "gan": gan, "model": model, "gan_sgd": gan_sgd,
            "sgd": sgd, "tp_resume": resume}


@pytest.fixture(scope="module")
def mesh_of_four(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_mesh")
    return ranks.run("tp_cases", 4, tmp, _payload(tmp), timeout=600), tmp


def test_every_rank_ends_with_the_same_full_state(mesh_of_four):
    results = mesh_of_four[0]
    for name in results[0]:
        if name == "tp_resume" or "dx" in name:
            continue
        for r in results[1:]:
            _assert_same(r[name].get("state"), results[0][name].get("state"),
                         name)
        if "in_sync" in results[0][name]:
            assert results[0][name]["in_sync"] > 0, name


def test_dcgan_adam_step_meets_jax_within_its_tp_tolerances(mesh_of_four):
    """JAX's one-device step of the drivers' Adam (dropout off), as
    ``tests/test_tensor_parallel.py`` holds its TP step."""
    got = mesh_of_four[0][0]["jax adam"]
    logs, params = _jax_one_device()
    for k in ("errFD", "errTD", "errG"):
        np.testing.assert_allclose(float(got["logs"][k]), logs[k],
                                   rtol=LOSS_RTOL, atol=LOSS_ATOL, err_msg=k)
    for net, want in zip(got["state"], params):
        for k, w in want.items():
            np.testing.assert_allclose(net[k], w.numpy(), atol=PARAM_ATOL,
                                       err_msg=k)


def test_cyclegan_sgd_step_meets_jax_within_its_tp_tolerances(mesh_of_four):
    got, want = mesh_of_four[0][0]["sgd cyclegan"], _jax_gan_step("cyclegan")
    for k, w in want["logs"].items():
        np.testing.assert_allclose(got["logs"][k], w, rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL, err_msg=k)
    for net, ref in zip(got["params"], want["params"]):
        for k, w in ref.items():
            np.testing.assert_allclose(net[k], w, atol=PARAM_ATOL, err_msg=k)


def test_unet_sgd_step_meets_jax_within_its_tp_tolerances(mesh_of_four):
    """JAX's step keeps its gradients (its optax transformation moves
    nothing): the weights after the port's SGD step are held to JAX's
    initial weights less the learning rate times them."""
    got, want = mesh_of_four[0][0]["sgd unet"], _jax_unet_step("unet")
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)
    np.testing.assert_allclose(got["nd"], want["nd"], rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)
    start = _unet_case("unet", 8)["state"]
    for k, g in want["grads"].items():
        np.testing.assert_allclose(
            got["state"][k], start[k].numpy() - ranks.SGD_LR * g,
            atol=PARAM_ATOL, err_msg=k)
    for k, s in want["state"].items():
        np.testing.assert_allclose(got["state"][k], s, atol=PARAM_ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("kind", ["default", "unet"])
def test_tp_times_fsdp_equals_tp_alone_bit_for_bit(mesh_of_four, kind):
    got = mesh_of_four[0][0]
    name = "default" if kind == "default" else "unet"
    both, alone = got[f"tp fsdp {name}"], got[f"tp {name}"]
    if kind == "unet":
        assert both["sharded"] > 0 and both["losses"] == alone["losses"]
    else:
        _assert_same(both["logs"], alone["logs"], "logs")
    _assert_same(both["state"], alone["state"], kind)
    # FD's bytes on this rank (the DCGAN's nets are G, FD, TD)
    fewer = (both["bytes"][1], alone["bytes"][1]) if kind == "default" \
        else (both["bytes"], alone["bytes"])
    assert fewer[0]["params"] < fewer[1]["params"]


def test_dcgan_tp_meets_one_process_in_float64(mesh_of_four):
    got = mesh_of_four[0][0]["tp fsdp default"]["state"]
    worst = _gaps(got, _one_process_gan(torch.float64), _gan_twins())
    assert worst[0][0] <= 1.0, worst[:3]


def test_the_dx_fault_misses_the_bound(mesh_of_four):
    """The cut convs' all-reduce of dx over the model axis dropped: each
    model rank's discriminator sends back the part of dx its own channels
    give. The ratio is printed (``-s``)."""
    got = mesh_of_four[0][0]["tp dx default"]["state"]
    worst = _gaps(got, _one_process_gan(torch.float64), _gan_twins())
    print(f"dx all-reduce dropped: {worst[0][0]:.1f}x the bound "
          f"({worst[0][1]})")
    assert worst[0][0] > 10.0, worst[:3]


def _moe_reference():
    """The narrow MoE UNet's one process in float64, and its roundoff
    twins (float32 against float64, and against its input under 1e-7
    noise: a reordered batch is no twin for the MoE's queues)."""
    case = _model_case("moe")
    p64 = ranks.fsdp_model_run(case, None, torch.float64)["state"]
    p32 = ranks.fsdp_model_run(case, None)["state"]
    noisy = dict(case, x=perturbed(case["x"]), y=perturbed(case["y"]))
    n32 = ranks.fsdp_model_run(noisy, None)["state"]
    return p64, (([p32], [p64]), ([n32], [p32]))


def test_tp_times_ep_meets_one_process_in_float64(mesh_of_four):
    """The MoE UNet with TP and its experts sharded over the data axis:
    within the bound of one process in float64, as the data axis's EP run
    is."""
    got = mesh_of_four[0][0]
    p64, twins = _moe_reference()
    for name in ("tp moe", "dp moe"):
        worst = _gaps([got[name]["state"]], [p64], twins)
        assert worst[0][0] <= 1.0, (name, worst[:3])
    assert got["tp moe"]["in_sync"] > 0


def test_resume_recuts_and_crosses_with_and_without_tp(mesh_of_four):
    """A checkpoint holds full leaves, so it loads across: TP's epoch into
    a run without TP, and a plain epoch into TP's blocks, bit for bit; a
    TP run resumed with TP equals the run that was not cut, bit for bit;
    the crossing runs train on (TP changes the order of the sums over the
    model axis, so they differ from ``whole`` by roundoff)."""
    res = mesh_of_four[0][0]["tp_resume"]
    _assert_same(res["cut_plain loaded"]["state"], res["cut 1"]["state"],
                 "TP's checkpoint without TP")
    _assert_same(res["plain_cut loaded"]["state"], res["plain"]["state"],
                 "a plain checkpoint with TP")
    _assert_same(res["cut"]["state"], res["whole"]["state"], "cut")
    # TP runs hold blocks of FD and TD; the ones without it, none
    assert all(res["whole"]["blocks"][1:]) and not any(
        res["cut_plain"]["blocks"])
    _assert_same(res["plain_cut"]["blocks"], res["whole"]["blocks"],
                 "blocks")
    for name in ("cut_plain", "plain_cut"):
        for tree, ref in zip(res[name]["state"], res["whole"]["state"]):
            for k, v in ref.items():
                assert np.isfinite(tree[k]).all(), (name, k)
                np.testing.assert_allclose(tree[k], v, atol=0.05,
                                           err_msg=f"{name} {k}")


def test_checkpoints_hold_full_leaves(mesh_of_four):
    from extended_gan_torch.train.checkpoint import CheckpointManager

    tmp = mesh_of_four[1]
    mgr = CheckpointManager(str(tmp / "resume" / "whole" / "checkpoints"))
    tree = mgr.restore(None)
    full = ranks.gan_nets("dcgan", _gan_case("default")["states"],
                          dropout=0.0)
    for name, net in zip(("g", "fd", "td"), full):
        saved = tree["states"][name]["model"]
        for k, v in net.state_dict().items():
            assert tuple(saved[k].shape) == tuple(v.shape), (name, k)
        opt = tree["states"][name]["optimizer"]["state"]
        shapes = {tuple(v.shape) for st in opt.values()
                  for v in st.values() if torch.is_tensor(v) and v.dim()}
        assert shapes <= {tuple(p.shape) for p in net.parameters()}
