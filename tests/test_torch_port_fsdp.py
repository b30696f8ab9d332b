"""FSDP's placement (``extended_gan_torch/parallel/fsdp.py``) against the
JAX package's (``extended_gan_tpu/parallel/fsdp.py``), without ranks.

For every leaf of five nets at their published widths (the DCGAN at ndf
64, the CycleGAN's four nets, final_smaatunet's ``UnetModel``, the MoE
UNet at E = 8 with its experts sharded by expert parallelism, GAT3D's
final_temp_conv), at D in {2, 4, 8} and ``min_size`` in {1, 4096}: the
port cuts the leaves JAX's ``_fsdp_spec`` shards, on the port's
counterpart of JAX's axis. The counterpart is read off the converter
(``models/convert.py``): each port leaf's flax layout is :func:`to_flax`
of it, held to ``from_flax_params`` by a round trip, and an index tensor
sent through it shows which port dim each flax axis is (and which it
flips). Rank r's block of each leaf, in the flax layout, is JAX's
``addressable_shards`` for device r of ``shard_params_fsdp`` on
``MeshContext.create(data=2)``; the per-rank element counts are the ones
JAX's rule gives. A placement needs only a rank and a size here
(:func:`stub_axis`): no process group.
"""

from __future__ import annotations

import types

import jax
import numpy as np
import pytest
import torch
from torch import nn

from extended_gan_tpu.parallel import MeshContext
from extended_gan_tpu.parallel.fsdp import (
    DEFAULT_MIN_SIZE as JAX_MIN_SIZE,
    _fsdp_spec,
    shard_params_fsdp,
)
from extended_gan_torch.models.convert import from_flax_params
from extended_gan_torch.models.dcgan import (
    FrameDiscriminator,
    Generator,
    TemporalDiscriminator,
)
from extended_gan_torch.models.registry import build_model
from extended_gan_torch.parallel import fsdp
from extended_gan_torch.parallel.expert import expert_shards, shard_tree_moe_ep
from extended_gan_torch.train import cyclegan_driver, dcgan_driver, gat_driver


def stub_axis(size: int, rank: int):
    """What a placement reads of a data axis: its size and this rank."""
    return types.SimpleNamespace(size=size, rank=rank, parallel=size > 1,
                                 group=None)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


NETS = {
    "dcgan_g": lambda: Generator(4, 0.0, generator=_gen()),
    "dcgan_fd": lambda: FrameDiscriminator(4, 64, generator=_gen()),
    "dcgan_td": lambda: TemporalDiscriminator(4, 64, 0.0, generator=_gen()),
    "cyclegan": lambda: nn.ModuleDict(dict(zip(
        ("g_xy", "g_yx", "d_x", "d_y"),
        cyclegan_driver.build_cyclegan(device="cpu")[0]))),
    "final_smaatunet": lambda: build_model(
        "unet", image_width=20, image_height=20, n_vertices=6,
        mapping_type="linear", device="cpu", generator=_gen()),
    "moe_unet": lambda: build_model(
        "unet", image_width=20, image_height=20, n_vertices=6,
        mapping_type="linear", device="cpu", generator=_gen(),
        moe_experts=8),
    "final_temp_conv": lambda: build_model(
        "temporal", image_width=80, image_height=80, n_vertices=6,
        mapping_type="conv", device="cpu", generator=_gen(),
        use_pallas=False),
}


# ------------------------------------------------------- the flax layout
def _is_bn(module) -> bool:
    return "running_mean" in module._buffers


def flax_leaf(module, prefix: str, name: str, t):
    """(flax name, the port's tensor ``t`` of ``module``'s leaf ``name`` in
    the flax layout): the inverse of ``from_flax_params``."""
    a = np.asarray(t)
    if _is_bn(module) and name == "weight":
        return "scale", a
    if isinstance(module, nn.ConvTranspose2d) and name == "weight":
        return "kernel", a.transpose(2, 3, 0, 1)[::-1, ::-1]
    if isinstance(module, nn.Linear) and name == "weight":
        return "kernel", a.T
    if name.endswith("weight") and a.ndim >= 4:
        nd = a.ndim
        return name[:-len("weight")] + "kernel", a.transpose(
            *range(nd - 4), nd - 2, nd - 1, nd - 3, nd - 4)
    if name.startswith(("a_", "B_")) and prefix.rsplit(".", 1)[-1] \
            .startswith("head_"):
        return name, a[0]
    return name, a


def leaves(model):
    """(key, module, leaf name, parameter) of every parameter."""
    for mod_name, module in model.named_modules():
        for name, p in module._parameters.items():
            if p is not None:
                key = f"{mod_name}.{name}" if mod_name else name
                yield key, mod_name, module, name, p


def to_flax(model):
    """``{key: flax-layout array}`` of the model's parameters, and the flax
    params tree they make."""
    flat, tree = {}, {}
    for key, prefix, module, name, p in leaves(model):
        fname, arr = flax_leaf(module, prefix, name, p.detach().numpy())
        flat[key] = np.ascontiguousarray(arr)
        node = tree
        for part in prefix.split(".") if prefix else []:
            node = node.setdefault(part, {})
        node[fname] = flat[key]
    return flat, tree


def axis_map(module, prefix, name, p):
    """{flax axis: (port dim, flipped)} for the leaf's axes of size > 1."""
    shape = tuple(p.shape)
    idx = np.arange(p.numel(), dtype=np.float64).reshape(shape)
    strides = [int(np.prod(shape[d + 1:])) for d in range(len(shape))]
    _, a = flax_leaf(module, prefix, name, idx)
    origin = a[(0,) * a.ndim]
    out = {}
    for j, n in enumerate(a.shape):
        if n == 1:
            continue
        step = [0] * a.ndim
        step[j] = 1
        delta = a[tuple(step)] - origin
        if delta < 0:  # a flipped axis runs from the far end
            step = [0] * a.ndim
            step[j] = n - 1
            delta = a[tuple(step)] - origin
            dims = [d for d in range(len(shape))
                    if strides[d] * (n - 1) == -delta and shape[d] == n]
            out[j] = (dims[0], True)
        else:
            dims = [d for d in range(len(shape))
                    if strides[d] == delta and shape[d] == n]
            out[j] = (dims[0], False)
    return out


@pytest.fixture(scope="module")
def nets():
    return {k: make() for k, make in NETS.items()}


@pytest.mark.parametrize("net", sorted(NETS))
def test_flax_layout_round_trips_through_the_converter(net, nets):
    """:func:`to_flax` is ``from_flax_params``'s inverse on every leaf of
    the net, so the axis map read off it is the converter's."""
    model = nets[net]
    _, tree = to_flax(model)
    back = from_flax_params(tree)
    state = {k: p for k, _, _, _, p in leaves(model)}
    assert set(back) == set(state)
    for k, p in state.items():
        np.testing.assert_array_equal(back[k].numpy(), p.detach().numpy(),
                                      err_msg=k)


def jax_pick(a, dp, min_size, mesh=None):
    """The flax axis JAX's ``_fsdp_spec`` gives ``data`` (None: whole);
    ``mesh``: the leaf placed over ``data`` first (an EP expert stack)."""
    leaf = a if mesh is None else jax.device_put(a, mesh.sharding("data"))
    spec = _fsdp_spec(leaf, dp, min_size)
    return None if spec is None else list(spec).index("data")


@pytest.mark.parametrize("min_size", [1, JAX_MIN_SIZE])
@pytest.mark.parametrize("dp", [2, 4, 8])
@pytest.mark.parametrize("net", sorted(NETS))
def test_placement_matches_jax_leaf_by_leaf(net, dp, min_size):
    """The leaves :func:`fsdp.shard_module_fsdp` cuts are JAX's, each on
    the port's dim of JAX's axis (flipped where the converter flips it);
    the MoE's expert stacks, sharded by EP first, are left whole as JAX
    leaves a leaf already over ``data``."""
    model = NETS[net]()
    flat, _ = to_flax(model)
    maps = {key: axis_map(module, prefix, name, p)
            for key, prefix, module, name, p in leaves(model)}
    axis = stub_axis(dp, 0)
    shard_tree_moe_ep(model, axis)
    ep = {k for k, p in model.named_parameters() if p in expert_shards(model)}
    mesh = MeshContext.create(data=dp) if ep else None
    fsdp.shard_module_fsdp(model, axis, min_size)
    cut = {k: (leaf.dim, leaf.flipped) for k, p in model.named_parameters()
           for leaf in [fsdp.fsdp_shards(model).get(p)] if leaf is not None}
    want = {}
    for key, a in flat.items():
        j = jax_pick(a, dp, min_size, mesh if key in ep else None)
        if j is not None:
            want[key] = maps[key][j]
    assert cut == want
    if net == "moe_unet":
        assert len(ep) == 4 and not ep & set(cut)


@pytest.mark.parametrize("min_size", [1, JAX_MIN_SIZE])
@pytest.mark.parametrize("net", sorted(NETS))
def test_rank_blocks_are_jax_device_shards(net, min_size):
    """Rank r's block of every cut leaf, in the flax layout, equals JAX's
    shard on device r of ``shard_params_fsdp`` over a data axis of 2."""
    mesh = MeshContext.create(data=2)
    full = NETS[net]()
    flat, _ = to_flax(full)
    sharded = shard_params_fsdp(dict(flat), mesh, min_size)
    devices = list(mesh.mesh.devices.flat)
    for rank in range(2):
        model = NETS[net]()
        fsdp.shard_module_fsdp(model, stub_axis(2, rank), min_size)
        mods = dict(model.named_modules())
        n = 0
        for key, p in model.named_parameters():
            leaf = fsdp.fsdp_shards(model).get(p)
            if leaf is None:
                continue
            prefix, name = key.rpartition(".")[::2]
            _, mine = flax_leaf(mods[prefix], prefix, name,
                                p.detach().numpy())
            (theirs,) = [s.data for s in sharded[key].addressable_shards
                         if s.device == devices[rank]]
            np.testing.assert_array_equal(mine, np.asarray(theirs),
                                          err_msg=f"{key} rank {rank}")
            # the working weight is the whole leaf
            np.testing.assert_array_equal(
                leaf.working.detach().numpy(),
                dict(full.named_parameters())[key].detach().numpy())
            n += 1
        # JAX's rule leaves the other leaves as they were (numpy here)
        assert n == len([v for v in sharded.values()
                         if hasattr(v, "addressable_shards")])


# JAX's per-rank element counts at min_size 4096 (its rule on the CPU)
PER_RANK = [("dcgan_fd", 2, 1_384_192, 2_766_592),
            ("dcgan_fd", 4, 692_992, 2_766_592),
            ("dcgan_td", 4, 694_016, 2_770_688),
            ("dcgan_g", 4, 7_096, 13_240),
            ("final_smaatunet", 2, 2_037_284, 4_032_548),
            ("final_smaatunet", 4, 1_039_652, 4_032_548)]


@pytest.mark.parametrize("net,dp,per,total", PER_RANK)
def test_per_rank_elements_and_bytes(net, dp, per, total):
    """Each rank's persistent elements (its blocks and the leaves left
    whole) are JAX's, and with Adam's two moments in float32 its bytes are
    3 x 4 x that (FD at D = 2: 16,610,304 against 33,199,104 bytes)."""
    model = NETS[net]()
    assert sum(p.numel() for p in model.parameters()) == total
    for rank in range(dp):
        model = NETS[net]()
        fsdp.shard_module_fsdp(model, stub_axis(dp, rank), JAX_MIN_SIZE)
        assert sum(p.numel() for p in model.parameters()) == per
        opt = torch.optim.Adam(model.parameters())
        for p in model.parameters():
            p.grad = torch.zeros_like(p)
        opt.step()
        nbytes = fsdp.persistent_bytes(model, opt)
        assert nbytes["params"] + nbytes["moments"] == 12 * per
        assert nbytes["working"] == 4 * sum(
            np.prod(leaf.full_shape) for leaf in fsdp.fsdp_net(model).leaves)


def test_flipped_axis_blocks_go_to_the_ranks_in_reverse():
    """A transposed conv whose only divisible axis is a spatial one (flax
    flips it): rank r keeps the port's block D - 1 - r, which the
    converter turns into JAX's block r; the gather's layout puts it back."""
    conv = nn.ConvTranspose2d(3, 5, (4, 1))
    full = conv.weight.detach().clone()
    mesh = MeshContext.create(data=2)
    _, a = flax_leaf(conv, "upconv", "weight", full.numpy())
    sharded = shard_params_fsdp({"k": np.ascontiguousarray(a)}, mesh, 1)["k"]
    devices = list(mesh.mesh.devices.flat)
    rows = []
    for rank in range(2):
        c = nn.ConvTranspose2d(3, 5, (4, 1))
        c.load_state_dict(conv.state_dict())
        fsdp.shard_module_fsdp(c, stub_axis(2, rank), 1)
        (leaf,) = fsdp.fsdp_net(c).leaves
        assert (leaf.dim, leaf.flipped, leaf.block) == (2, True, 1 - rank)
        # ``c.weight`` is the working weight now; the block is the parameter
        assert c.weight is leaf.working
        _, mine = flax_leaf(c, "upconv", "weight", leaf.shard.detach().numpy())
        (theirs,) = [s.data for s in sharded.addressable_shards
                     if s.device == devices[rank]]
        np.testing.assert_array_equal(mine, np.asarray(theirs))
        rows.append(leaf.shard.detach().reshape(-1))
    np.testing.assert_array_equal(leaf.assemble(torch.stack(rows)).numpy(),
                                  full.numpy())
    np.testing.assert_array_equal(leaf.rows(full).numpy(),
                                  torch.stack(rows).numpy())


def test_spec_rules_of_the_jax_tests():
    """JAX's ``test_fsdp_spec_rules`` in the port's layouts: a (512, 256,
    4, 4) conv weight (HWIO (4, 4, 256, 512)) cuts Cout, dim 0; a 512 bias
    under min_size stays whole; an 81 x 81 Linear has no divisible axis;
    on a tie flax's first axis wins: a 64 -> 64 3x3 conv is HWIO (3, 3, 64,
    64), Cin first, which is the port's dim 1."""
    def spec(module, name, dp, min_size):
        return fsdp.fsdp_spec(module, name, getattr(module, name), dp,
                              min_size)

    big = nn.Conv2d(256, 512, 4)
    assert spec(big, "weight", 8, 4096) == fsdp.FsdpSpec(0, False)
    assert spec(big, "bias", 8, 4096) is None
    assert spec(nn.Linear(81, 81), "weight", 8, 1) is None
    assert spec(nn.Conv2d(64, 64, 3), "weight", 2, 1) == fsdp.FsdpSpec(
        1, False)
    # Dense (in, out): a Linear(64 -> 128) is (128, 64) in the port, flax
    # (64, 128); the larger axis is out, the port's dim 0
    assert spec(nn.Linear(64, 128), "weight", 2, 1) == fsdp.FsdpSpec(
        0, False)
    assert fsdp.DEFAULT_MIN_SIZE == JAX_MIN_SIZE


@pytest.mark.parametrize("driver", [gat_driver, dcgan_driver,
                                    cyclegan_driver])
def test_no_refusal_table_names_fsdp(driver):
    """FSDP is ported: no driver's table of unported options names it, and
    every driver takes ``fsdp`` and ``fsdp_min_size``."""
    import inspect

    assert not {"fsdp", "fsdp_min_size"} & set(driver._NOT_PORTED)
    params = inspect.signature(driver.train).parameters
    assert params["fsdp"].default is False
    assert params["fsdp_min_size"].default == JAX_MIN_SIZE


def test_axis_of_one_prints_the_jax_line(capsys):
    """``place_nets`` on an axis of one shards nothing and prints JAX's
    line; without ``fsdp`` it prints nothing."""
    net = FrameDiscriminator(4, 8)
    fsdp.place_nets(stub_axis(1, 0), [net], True)
    fsdp.place_nets(stub_axis(1, 0), [net], False)
    assert capsys.readouterr().out == fsdp.AXIS_OF_ONE + "\n"
    assert fsdp.fsdp_net(net) is None
    assert "the mesh data axis is 1" in fsdp.AXIS_OF_ONE
