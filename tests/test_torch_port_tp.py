"""Tensor parallelism's placement (``extended_gan_torch/parallel/tensor.py``)
against the JAX package's (``shard_params_tp``, ``extended_gan_tpu/parallel/
mesh.py:324-350``), a (data 1, model 2) gloo world on the CPU, and the CLIs.

- Placement, without ranks (:func:`stub_axis`): for every leaf of the
  DCGAN's discriminators (ndf 16 at ``tp_min_channels`` 32, as
  ``tests/test_tensor_parallel.py``, and ndf 64 at the default 256), a
  narrow UNet, final_smaatunet's model and the narrow MoE UNet with its
  experts sharded by EP, at M in {2, 4}: the port cuts the leaves JAX's
  rule puts over ``model``, on the port's counterpart of flax's last axis
  (read off the converter, ``tests/test_torch_port_fsdp.py``'s
  ``axis_map``), and rank r's block in the flax layout is JAX's shard on
  device r of a (1, 2) and a (2, 2) mesh (model index r % 2). Under TP x
  FSDP (JAX's ``tests/test_fsdp.py`` example, a (4, 4, 256, 512) kernel at
  data 4 x model 2, and the narrow FD at 2 x 2) each rank's FSDP block is
  JAX's device shard. The per-rank elements of FD and TD at ndf 64 are
  the ones the rule gives, 12 bytes each with Adam's moments.
- One gloo world of data 1 x model 2 (``torch_dp_ranks.tp_cases``): the
  narrow DCGAN and CycleGAN (two SGD steps, dropout off) and the narrow
  UNet (two Adam steps, K3's plain twin on the CPU) with their wide
  leaves cut, held to the port's one process in float64 within the FSDP
  tests' bound; the DCGAN's one Adam step against JAX's one-device step
  within JAX's own TP tolerances (losses rtol 1e-4, atol 1e-5, weights
  atol 5e-4); the UNet with the all-reduce of gd over the model axis
  dropped must miss the bound by more than 10x.
- The CLIs with ``--model-axis 2 --device cpu``: the DCGAN at its
  published width (FD's and TD's Conv_2 and Conv_3 cut at the default
  256), and the conv-GAT's ``generate_experiment`` of a copy of
  final_smaatunet's config with ``MODEL_AXIS = 2``; both report every rank
  in sync, and the GAT run's ``model.pt`` holds full leaves.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
from torch import nn

import torch_dp_ranks as ranks
from extended_gan_tpu.parallel import MeshContext, shard_params_tp
from extended_gan_tpu.parallel.fsdp import shard_params_fsdp
from extended_gan_torch.models.dcgan import (
    FrameDiscriminator,
    TemporalDiscriminator,
)
from extended_gan_torch.parallel import fsdp, tensor
from extended_gan_torch.parallel.expert import shard_tree_moe_ep
from extended_gan_torch.train import cyclegan_driver, dcgan_driver, gat_driver
from test_torch_port_fsdp import NETS as FULL_NETS
from test_torch_port_fsdp import axis_map, flax_leaf, leaves, to_flax
from test_torch_port_fsdp_ranks import (
    _gan_case,
    _gan_twins,
    _gaps,
    _jax_adam,
    _jax_one_device,
    _model_case,
    _one_process_gan,
)
from test_torch_port_gan_data_parallel import _batch
from test_torch_port_gat_family import one_torch_thread  # noqa: F401 - the autouse fixture
from test_torch_port_gat_smaat import perturbed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def stub_axis(model: int, rank: int, data: int = 1, data_rank: int = 0):
    """What a placement reads of a (data, model) mesh: the sizes and this
    rank's indices, no process group."""
    return types.SimpleNamespace(
        size=data, rank=data_rank, parallel=data > 1, group=None,
        model=types.SimpleNamespace(size=model, rank=rank,
                                    parallel=model > 1, group=None))


def _gen():
    return torch.Generator().manual_seed(0)


def _narrow_unet():
    torch.manual_seed(0)
    return ranks.make_model("unet")


# (net, tp_min_channels)
NETS = {
    "fd16": (lambda: FrameDiscriminator(4, 16, generator=_gen()), 32),
    "td16": (lambda: TemporalDiscriminator(4, 16, 0.0, generator=_gen()), 32),
    "dcgan_fd": (FULL_NETS["dcgan_fd"], 256),
    "dcgan_td": (FULL_NETS["dcgan_td"], 256),
    "narrow_unet": (_narrow_unet, 32),
    "final_smaatunet": (FULL_NETS["final_smaatunet"], 256),
    "moe_unet": (lambda: ranks.make_moe_model(False), 32),
}


def _jax_model_axis(a, m, min_channels):
    """Whether JAX's ``shard_params_tp`` puts flax leaf ``a`` over
    ``model`` on a (1, m) mesh."""
    mesh = MeshContext.create(data=1, model=m)
    spec = shard_params_tp({"k": a}, mesh, min_channels)["k"].sharding.spec
    return tuple(spec) == (None, None, None, "model")


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("net", sorted(NETS))
def test_placement_matches_jax_leaf_by_leaf(net, m):
    """The leaves :func:`tensor.shard_module_tp` cuts are JAX's, each on
    the port's dim of flax's last axis; the MoE's expert stacks (3-D) stay
    whole and EP shards them after TP."""
    make, min_channels = NETS[net]
    model = make()
    flat, _ = to_flax(model)
    maps = {key: axis_map(module, prefix, name, p)
            for key, prefix, module, name, p in leaves(model)}
    want = {}
    for key, a in flat.items():
        if a.ndim == 4 and _jax_model_axis(a, m, min_channels):
            want[key] = maps[key][3][0]
    axis = stub_axis(m, 0)
    placed = tensor.shard_module_tp(model, axis, min_channels)
    got = {leaf.key: leaf.dim for leaf in placed.leaves}
    assert got == want and want
    if net == "moe_unet":
        shard_tree_moe_ep(model, stub_axis(m, 0, data=2))
        assert not any(k.startswith("unet.moe") for k in got)


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)])
@pytest.mark.parametrize("net", ["fd16", "td16", "narrow_unet", "dcgan_fd"])
def test_rank_blocks_are_jax_device_shards(net, mesh):
    """Rank r's block of every cut leaf, in the flax layout, equals JAX's
    shard on device r (data index r // M, model index r % M)."""
    d, m = mesh
    make, min_channels = NETS[net]
    jmesh = MeshContext.create(data=d, model=m)
    flat, _ = to_flax(make())
    placed = shard_params_tp(dict(flat), jmesh, min_channels)
    devices = list(jmesh.mesh.devices.flat)
    for r in range(d * m):
        model = make()
        tensor.shard_module_tp(model, stub_axis(m, r % m, d, r // m),
                               min_channels)
        mods = dict(model.named_modules())
        n = 0
        for leaf in tensor.tp_net(model).leaves:
            prefix, name = leaf.key.rpartition(".")[::2]
            _, mine = flax_leaf(mods[prefix], prefix, name,
                                leaf.registered.detach().numpy())
            (theirs,) = [s.data for s in placed[leaf.key].addressable_shards
                         if s.device == devices[r]]
            np.testing.assert_array_equal(mine, np.asarray(theirs),
                                          err_msg=f"{leaf.key} rank {r}")
            n += 1
        assert n == sum(tuple(v.sharding.spec) == (None, None, None, "model")
                        for v in placed.values())


def _fsdp_blocks_match_jax(make, d, m, min_channels, min_size):
    jmesh = MeshContext.create(data=d, model=m)
    flat, _ = to_flax(make())
    placed = shard_params_fsdp(shard_params_tp(dict(flat), jmesh,
                                               min_channels), jmesh, min_size)
    devices = list(jmesh.mesh.devices.flat)
    both = 0
    for r in range(d * m):
        model = make()
        axis = stub_axis(m, r % m, d, r // m)
        tensor.shard_module_tp(model, axis, min_channels)
        fsdp.shard_module_fsdp(model, axis, min_size)
        mods = dict(model.named_modules())
        for key, p in model.named_parameters():
            leaf = fsdp.fsdp_shards(model).get(p)
            if leaf is None:
                continue
            prefix, name = key.rpartition(".")[::2]
            _, mine = flax_leaf(mods[prefix], prefix, name,
                                p.detach().numpy())
            (theirs,) = [s.data for s in placed[key].addressable_shards
                         if s.device == devices[r]]
            np.testing.assert_array_equal(mine, np.asarray(theirs),
                                          err_msg=f"{key} rank {r}")
            both += hasattr(leaf.module._parameters[leaf.name], "_fsdp_shard") \
                and any(lf.key == key for lf in tensor.tp_net(model).leaves)
    return both


def test_tp_times_fsdp_blocks_are_jax_device_shards():
    """JAX's example (``tests/test_fsdp.py:101-106``): a (4, 4, 256, 512)
    kernel at data 4 x model 2 cuts Cout over ``model`` and Cin over
    ``data``; the port's rank r holds JAX's device-r block of it, and of
    every leaf of the narrow FD at data 2 x model 2 (FSDP at min_size 1:
    every TP block cut again within it)."""
    def conv():
        torch.manual_seed(0)
        return nn.Conv2d(256, 512, 4, bias=False)

    model = conv()
    axis = stub_axis(2, 1, 4, 3)
    tensor.shard_module_tp(model, axis, 256)
    fsdp.shard_module_fsdp(model, axis, 1)
    (leaf,) = fsdp.fsdp_net(model).leaves
    assert leaf.dim == 1 and leaf.full_shape == (256, 256, 4, 4)
    assert tuple(leaf.shard.shape) == (256, 64, 4, 4)
    assert _fsdp_blocks_match_jax(conv, 4, 2, 256, 1) == 8
    assert _fsdp_blocks_match_jax(NETS["fd16"][0], 2, 2, 32, 1) > 0


# each rank's parameters at ndf 64 under the default rule
PER_RANK = [("dcgan_fd", 2, 1_455_872), ("dcgan_fd", 4, 800_512),
            ("dcgan_td", 2, 1_459_968)]


@pytest.mark.parametrize("net,m,per", PER_RANK)
def test_per_rank_elements_and_bytes(net, m, per):
    """FD holds 1,455,872 of its 2,766,592 parameters a rank at M = 2
    (17,470,464 bytes with Adam's moments against 33,199,104) and 800,512
    at M = 4; TD 1,459,968 at M = 2; on every rank."""
    make, _ = NETS[net]
    for rank in range(m):
        model = make()
        tensor.shard_module_tp(model, stub_axis(m, rank))
        assert sum(p.numel() for p in model.parameters()) == per
        opt = torch.optim.Adam(model.parameters())
        for p in model.parameters():
            p.grad = torch.zeros_like(p)
        opt.step()
        nbytes = fsdp.persistent_bytes(model, opt)
        assert nbytes["params"] + nbytes["moments"] == 12 * per


def test_final_smaatunet_elements_a_rank_are_jax_s():
    """final_smaatunet's model at M = 2 and 4: each rank's parameters are
    JAX's device-0 shards summed (23 leaves cut, every one a
    depthwise-separable conv's)."""
    make, _ = NETS["final_smaatunet"]
    flat, _ = to_flax(make())
    for m in (2, 4):
        jmesh = MeshContext.create(data=1, model=m)
        placed = shard_params_tp(dict(flat), jmesh, 256)
        dev0 = jmesh.mesh.devices.flat[0]
        want = sum(int(np.prod(s.data.shape)) for v in placed.values()
                   if hasattr(v, "addressable_shards")
                   for s in v.addressable_shards if s.device == dev0)
        want += sum(v.size for v in placed.values()
                    if not hasattr(v, "addressable_shards"))
        model = make()
        net = tensor.shard_module_tp(model, stub_axis(m, 0))
        assert len(net.leaves) == 23
        assert all(leaf.name in ("depthwise_weight", "pointwise_weight")
                   for leaf in net.leaves)
        assert sum(p.numel() for p in model.parameters()) == want


def test_spec_rules():
    """JAX's rule on the port's layouts: a conv's O (dim 0), a transposed
    conv's O (dim 1), the depthwise's C*kpl (dim 0); a leaf under
    ``min_channels``, one M does not divide, a 2-D Dense and a 5-D
    vmapped stack stay whole."""
    from extended_gan_torch.models.smaat_unet import DepthwiseSeparableConv

    def spec(module, name, m, min_channels=256):
        return tensor.tp_spec(module, name, getattr(module, name), m,
                              min_channels)

    assert spec(nn.Conv2d(128, 512, 4), "weight", 2) == 0
    assert spec(nn.Conv2d(128, 512, 4), "bias", 2) is None
    assert spec(nn.ConvTranspose2d(512, 256, 2), "weight", 4) == 1
    assert spec(nn.Conv2d(128, 128, 4), "weight", 2) is None
    assert spec(nn.Conv2d(3, 258, 1), "weight", 4) is None
    assert spec(nn.Conv2d(3, 258, 1), "weight", 2) == 0
    assert spec(nn.Linear(512, 512), "weight", 2) is None
    dsc = DepthwiseSeparableConv(128, 64, 2)
    assert spec(dsc, "depthwise_weight", 2) == 0
    assert spec(dsc, "pointwise_weight", 2) is None
    assert spec(dsc, "pointwise_weight", 2, 64) == 0
    stacked = nn.Module()
    stacked.weight = nn.Parameter(torch.zeros(3, 512, 4, 3, 3))
    assert spec(stacked, "weight", 2) is None
    assert spec(nn.Conv2d(128, 512, 4), "weight", 1) is None


def test_a_cut_leaf_without_a_column_parallel_form_raises():
    """The rule reaches a transposed conv only far below the default (the
    SmaAt-UNet's ``upconv`` at ``bilinear=False``): the placement raises,
    naming the leaf, rather than compute a wrong function."""
    model = nn.Sequential(nn.ConvTranspose2d(8, 16, 2))
    with pytest.raises(ValueError, match="0.weight.*column-parallel"):
        tensor.shard_module_tp(model, stub_axis(2, 0), 16)


@pytest.mark.parametrize("driver", [gat_driver, dcgan_driver,
                                    cyclegan_driver])
def test_every_driver_takes_the_model_axis(driver):
    import inspect

    assert not {"model_axis", "tp_min_channels"} & set(driver._NOT_PORTED)
    assert "spatial" in driver._NOT_PORTED
    params = inspect.signature(driver.train).parameters
    assert params["model_axis"].default == 1
    assert params["tp_min_channels"].default == 256


def test_a_model_axis_without_its_processes_raises():
    with pytest.raises(RuntimeError, match="model_axis=2 needs 4 processes"):
        dcgan_driver.train(device="cpu", data_axis=2, model_axis=2)
    with pytest.raises(RuntimeError, match="model_axis=2 needs 2 processes"):
        gat_driver.train(dataset="synthetic", device="cpu", model_axis=2)


# ------------------------------------------------------------ data 1 x 2
GAN_TP = 16  # ndf 8: FD's and TD's Conv_1..3 (16, 32, 64 channels)
UNET_TP = 16


def _payload():
    x, y = _batch(8)
    gan = {"tp default": _gan_case("default", tp=GAN_TP),
           "tp cyclegan": _gan_case("cyclegan", tp=GAN_TP),
           "jax adam": dict(kind="dcgan", body={}, dropout=0.0, x=x, y=y,
                            states=_jax_adam()[3], opt="adam", steps=1,
                            tp=GAN_TP)}
    model = {"tp unet": _model_case("unet", tp=UNET_TP),
             "tp unet gd": _model_case("unet", tp=UNET_TP, tp_fault="gd")}
    return {"mesh": (1, 2), "gan": gan, "model": model}


CLI = {
    "dcgan": ["-m", "extended_gan_torch.dcgan", "--epochs", "1",
              "--max-batches", "2", "--synthetic", "--train-batch-size",
              "4", "--test-batch-size", "8", "--save-epoch", "1"],
    "gat": ["-m", "extended_gan_torch.gat", "generate_experiment",
            "--train-batch-size", "4", "--test-batch-size", "8",
            "--epochs", "1", "--max-batches", "2"],
}


def _start_clis(tmp):
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                        "LOCAL_RANK")}
    env["OMP_NUM_THREADS"] = "1"
    exp = tmp / "tp_smaatunet"
    exp.mkdir()
    shutil.copy(os.path.join(REPO, "convolutional_gat", "experiments",
                             "final_smaatunet", "config.py"), exp)
    with open(exp / "config.py", "a") as f:
        f.write("\nMODEL_AXIS = 2\n")
    argv = {"dcgan": CLI["dcgan"] + ["--model-axis", "2", "--out-dir",
                                     str(tmp / "cli_dcgan")],
            "gat": CLI["gat"] + ["--exp_folder_name", str(exp),
                                 "--output-path", str(tmp / "cli_gat")]}
    return {name: subprocess.Popen(
        [sys.executable, *args, "--device", "cpu"], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, args in argv.items()}


@pytest.fixture(scope="module")
def model_axis_of_two(tmp_path_factory):
    """Both ranks' results, and the CLI runs, started together."""
    tmp = tmp_path_factory.mktemp("tp_ranks")
    clis = _start_clis(tmp)
    got = ranks.run("tp_cases", 2, tmp, _payload(), timeout=600)
    outs = {}
    for name, proc in clis.items():
        out, _ = proc.communicate(timeout=600)
        outs[name] = (proc.returncode, out)
    return got, outs, tmp


def test_every_rank_ends_with_the_same_full_state(model_axis_of_two):
    r0, r1 = model_axis_of_two[0]
    for name in r0:
        if "gd" not in name:
            ranks_equal = [np.array_equal(a, b) for t0, t1 in zip(
                *(r["state"] if isinstance(r["state"], list)
                  else [r["state"]] for r in (r0[name], r1[name])))
                for k in t0 for a, b in [(t0[k], t1[k])]]
            assert all(ranks_equal), name
            assert r0[name]["in_sync"] > 0, name


@pytest.mark.parametrize("body", ["default", "cyclegan"])
def test_gan_tp_meets_one_process_in_float64(model_axis_of_two, body):
    got = model_axis_of_two[0][0][f"tp {body}"]["state"]
    if body == "default":
        want, twins = _one_process_gan(torch.float64), _gan_twins()
    else:
        want, twins = _cyclegan_twins()
    worst = _gaps(got, want, twins)
    assert worst[0][0] <= 1.0, worst[:3]


def _cyclegan_twins():
    def run(dtype=torch.float32, perturb=False):
        case = _gan_case("cyclegan")
        if perturb:
            case["x"], case["y"] = perturbed(case["x"]), perturbed(case["y"])
        return ranks.fsdp_gan_run(case, None, dtype)["state"]

    f32 = run()
    return run(torch.float64), ((f32, run(torch.float64)),
                                (run(perturb=True), f32))


def _unet_reference():
    case = _model_case("unet")
    p64 = ranks.fsdp_model_run(case, None, torch.float64)["state"]
    p32 = ranks.fsdp_model_run(case, None)["state"]
    noisy = dict(case, x=perturbed(case["x"]), y=perturbed(case["y"]))
    n32 = ranks.fsdp_model_run(noisy, None)["state"]
    return p64, (([p32], [p64]), ([n32], [p32]))


def test_unet_tp_meets_one_process_and_the_gd_fault_misses(model_axis_of_two):
    """The narrow UNet with 16 of its leaves cut (K3's plain twin on each
    rank's output channels) within the bound; the same ranks with the gd
    all-reduce dropped miss it by more than 10x (the ratio is printed,
    ``-s``)."""
    got = model_axis_of_two[0][0]
    p64, twins = _unet_reference()
    worst = _gaps([got["tp unet"]["state"]], [p64], twins)
    assert worst[0][0] <= 1.0, worst[:3]
    fault = _gaps([got["tp unet gd"]["state"]], [p64], twins)
    print(f"gd all-reduce dropped: {fault[0][0]:.1f}x the bound "
          f"({fault[0][1]})")
    assert fault[0][0] > 10.0, fault[:3]
    assert got["tp unet"]["bytes"]["params"] < 4 * sum(
        v.size for k, v in p64.items() if "running" not in k)


def test_dcgan_tp_meets_jax_one_device_adam_step(model_axis_of_two):
    """``tests/test_tensor_parallel.py``'s tolerances: losses rtol 1e-4,
    atol 1e-5; the weights atol 5e-4."""
    got = model_axis_of_two[0][0]["jax adam"]
    logs, params = _jax_one_device()
    for k in ("errFD", "errTD", "errG"):
        np.testing.assert_allclose(float(got["logs"][k]), logs[k],
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    for net, want in zip(got["state"], params):
        for k, w in want.items():
            np.testing.assert_allclose(net[k], w.numpy(), atol=5e-4,
                                       err_msg=k)


@pytest.mark.parametrize("name", sorted(CLI))
def test_cli_model_axis_of_two_on_the_cpu(model_axis_of_two, name):
    rc, out = model_axis_of_two[1][name]
    assert rc == 0, out[-3000:]
    assert "[data axis] 1 x 2 (data x model) ranks in sync" in out, \
        out[-3000:]
    assert "leaves cut by output channel over 2 model ranks" in out, \
        out[-3000:]
    mesh = "Using mesh: data=1 model=2" if name == "gat" else \
        "mesh: data=1 model=2"
    assert mesh in out


def test_cli_gat_model_pt_holds_full_leaves(model_axis_of_two):
    from extended_gan_torch.models.registry import build_model

    saved = torch.load(model_axis_of_two[2] / "cli_gat" / "model.pt",
                       weights_only=True)
    want = build_model("unet", image_width=20, image_height=20,
                       n_vertices=6, mapping_type="linear",
                       device="cpu").state_dict()
    assert sorted(saved) == sorted(want)
    for k, v in want.items():
        assert tuple(saved[k].shape) == tuple(v.shape), k
