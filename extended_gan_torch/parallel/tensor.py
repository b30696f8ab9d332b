"""Tensor parallelism (TP): wide conv kernels cut by output channel over the
model axis (port of ``extended_gan_tpu/parallel/mesh.py:324-362``).

The JAX package places a conv kernel, and its Adam moments, with its last
flax axis (Cout) over the mesh's ``model`` axis when the flax leaf is 4-D,
that axis has at least ``min_channels`` entries and the axis size divides
it (``shard_params_tp``, ``shard_net_state_tp``); XLA's partitioner then
derives every collective. The port writes the layer's partition out,
column-parallel, on the model axis of ``parallel/mesh.py``
(``DataAxis.model``: the ranks that share a data index):

- :func:`tp_spec` is JAX's rule on the flax leaf: the port's dim of flax's
  last axis (``fsdp._jax_axis_order``): O of an OIHW conv weight, O of a
  ``ConvTranspose2d``'s (I, O, kh, kw), C*kpl of the depthwise-separable
  conv's depthwise (C*kpl, 1, 3, 3) and Cout of its pointwise (Cout, C*kpl,
  1, 1). Leaves that are not 4-D in flax (Dense, BatchNorm, GAT3D's
  vmapped head stacks, the MoE's expert stacks) are never cut.
- :func:`shard_module_tp` places a model in place, before expert
  parallelism, FSDP and the optimizer: each cut leaf's registered
  parameter becomes this rank's block of Cout / M channels (model index
  r % M keeps block r % M, JAX's device r's shard), so the optimizer and
  Adam's moments hold 1/M of it. The model stays unaware of it: a cut
  ``nn.Conv2d`` computes through its own ``_conv_forward`` (which the port's
  models call), and a cut ``DepthwiseSeparableConv`` through its
  ``forward``; the placement gives that module a column-parallel one.
- A cut conv computes its own channels: its input enters through an
  identity whose backward sums dx over the model axis, the rank's conv runs
  with its weight block (and its slice of the replicated bias), and one
  all-gather over the model axis restores the channels; that gather's
  backward takes the rank's own slice, since what follows is replicated
  across the model axis.
- A cut depthwise-separable conv runs K3 (``ops/dsconv.py``) with the whole
  depthwise weight (its blocks gathered) and the rank's pointwise block and
  bias block: K3 computes the rank's Cout / M channels, and the channel
  all-gather follows. In the backward ``gd = g pw^T`` is a partial sum over
  the Cout blocks: one all-reduce of it over the model axis goes before the
  depthwise backward (K3's backward kernel, or the plain version), after
  which dx, ddw and ddwb are whole and the same on every model rank (each
  keeps its block of ddw), and dpw is local. The plain twin runs the same
  split (the CPU, and the smaat mapping's UNet, built without K3).
- :func:`full_state` and :func:`local_state`: checkpoints and ``model.pt``
  hold full leaves (FSDP's blocks gathered first, then TP's), and a rank
  loading full leaves cuts its blocks, so a run with TP resumes one
  without it and the reverse.

The gradient sum over the data axis (``DataAxis.all_reduce_grads``,
``fsdp.reduce_grads``) is unchanged: a block's gradient is complete on its
model rank after the backward, and the data ranks that share a model index
hold the same block.

``_reduce_gd`` and ``_reduce_dx`` are the two sums over the model axis a
backward makes; the tests and the card check plant a fault by replacing
one of them with the identity.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from .fsdp import _jax_axis_order
from .mesh import _all_gather

#: JAX's default ``tp_min_channels``
DEFAULT_MIN_CHANNELS = 256


def tp_spec(module: nn.Module, name: str, param: torch.Tensor, n_model: int,
            min_channels: int = DEFAULT_MIN_CHANNELS) -> int | None:
    """JAX's rule for ``module``'s parameter ``name`` on a model axis of
    ``n_model``: the port's dim of the flax leaf's last axis when the flax
    leaf is 4-D, that axis has at least ``min_channels`` entries and
    ``n_model`` divides it; None where JAX leaves the leaf replicated."""
    if n_model <= 1 or param.dim() != 4:
        return None
    order, _ = _jax_axis_order(module, name, param)
    c = param.shape[order[-1]]
    if c < min_channels or c % n_model:
        return None
    return order[-1]


class _TpLeaf:
    """One cut leaf: its module, name and state_dict key, the port's dim
    cut, the model axis's size, this rank's block and group, the full
    shape."""

    def __init__(self, module, name, key, dim, full, model_axis):
        self.module, self.name, self.key, self.dim = module, name, key, dim
        self.ranks, self.rank = model_axis.size, model_axis.rank
        self.group = model_axis.group
        self.full_shape = tuple(full.shape)
        self.per = full.shape[dim] // self.ranks

    @property
    def block_shape(self) -> tuple:
        shape = list(self.full_shape)
        shape[self.dim] = self.per
        return tuple(shape)

    def cut(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of a full-shaped tensor (a copy)."""
        return full.narrow(self.dim, self.rank * self.per, self.per).clone(
            memory_format=torch.contiguous_format)

    def gather(self, block: torch.Tensor) -> torch.Tensor:
        """The full tensor from every model rank's ``block``. A collective:
        every rank of the model axis calls it."""
        return _gather_dim(block.detach(), self.dim, self.group, self.ranks)

    @property
    def registered(self) -> torch.Tensor:
        """The parameter the optimizer steps: this rank's block, or FSDP's
        shard of it (``parallel/fsdp.py``)."""
        return self.module._parameters[self.name]


# ------------------------------------------------------------ collectives
def _gather_dim(t: torch.Tensor, dim: int, group, ranks: int) -> torch.Tensor:
    """Every model rank's ``t`` concatenated along ``dim``, in rank order."""
    t = t.contiguous()
    flat = t.reshape(-1)
    out = flat.new_empty((ranks * flat.numel(),))
    _all_gather(out, flat, group)
    return torch.cat(out.view((ranks,) + tuple(t.shape)).unbind(0), dim)


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist

    dist.all_reduce(t, group=group)
    return t


def _reduce_gd(gd: torch.Tensor, group) -> torch.Tensor:
    """The depthwise-separable conv's backward: the sum over the model axis
    of each rank's gd = g_block pw_block^T."""
    return _all_reduce(gd, group)


def _reduce_dx(dx: torch.Tensor, group) -> torch.Tensor:
    """A cut conv's backward: the sum over the model axis of each rank's
    dx from its weight block."""
    return _all_reduce(dx, group)


class _Replicate(torch.autograd.Function):
    """The identity; its backward sums the gradient over the model axis
    (the input of a cut conv, which each rank reads with its block)."""

    @staticmethod
    def forward(ctx, x, leaf):
        ctx.group = leaf.group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce_dx(g.contiguous().clone(), ctx.group), None


class _Gather(torch.autograd.Function):
    """Every model rank's ``t`` concatenated along ``dim``; backward: this
    rank's slice of the gradient (what follows is replicated across the
    model axis, so every rank's gradient is the whole one)."""

    @staticmethod
    def forward(ctx, t, dim, leaf):
        ctx.dim, ctx.leaf = dim, leaf
        return _gather_dim(t, dim, leaf.group, leaf.ranks)

    @staticmethod
    def backward(ctx, g):
        leaf = ctx.leaf
        per = g.shape[ctx.dim] // leaf.ranks
        return g.narrow(ctx.dim, leaf.rank * per, per).contiguous(), \
            None, None


class _Slice(torch.autograd.Function):
    """This rank's slice of a replicated ``t`` along ``dim`` (a cut conv's
    bias); backward: every model rank's slice gathered, the whole
    gradient on every rank."""

    @staticmethod
    def forward(ctx, t, dim, leaf):
        ctx.dim, ctx.leaf = dim, leaf
        per = t.shape[dim] // leaf.ranks
        return t.narrow(dim, leaf.rank * per, per).contiguous()

    @staticmethod
    def backward(ctx, g):
        leaf = ctx.leaf
        return _gather_dim(g, ctx.dim, leaf.group, leaf.ranks), None, None


# ------------------------------------------------------------ the layers
def _tp_conv_forward(conv: nn.Conv2d, leaf: _TpLeaf, x, weight, bias):
    """``nn.Conv2d._conv_forward`` of a conv whose weight is this rank's
    block of output channels: its channels, then every rank's gathered."""
    x = _Replicate.apply(x, leaf)
    if bias is not None:
        bias = _Slice.apply(bias, 0, leaf)
    y = F.conv2d(x, weight, bias, conv.stride, conv.padding, conv.dilation,
                 conv.groups)
    return _Gather.apply(y, 1, leaf)


class _DscPlan:
    """A cut depthwise-separable conv: its depthwise and pointwise leaves
    (None where whole) and the model axis they are cut over."""

    def __init__(self, dw: _TpLeaf | None, pw: _TpLeaf | None):
        self.dw, self.pw = dw, pw
        any_leaf = dw or pw
        self.group, self.ranks, self.rank = (any_leaf.group, any_leaf.ranks,
                                             any_leaf.rank)


class _TpDSConv(torch.autograd.Function):
    """K3 (``kernel``) or its plain version on this rank's output channels.
    Inputs as ``ops.dsconv.reference_dsc``'s, but ``dw`` (3, 3, C*kpl /
    M) and ``pw`` (C*kpl, Cout / M) are this rank's blocks where cut."""

    @staticmethod
    def forward(ctx, x, dw, dwb, pw, pwb, plan, kernel, keep_d):
        from ..ops import dsconv

        if plan.dw is not None:
            dw = _gather_dim(dw, 2, plan.group, plan.ranks)
        if plan.pw is not None:
            per = pw.shape[-1]
            pwb = pwb[plan.rank * per:(plan.rank + 1) * per]
        if kernel:
            out, d = dsconv._launch(x, dw, dwb, pw, pwb, keep_d=keep_d)
        else:
            out, d = dsconv.reference_dsc(x, dw, dwb, pw, pwb), None
        if plan.pw is not None:
            out = _gather_dim(out, 3, plan.group, plan.ranks)
        ctx.plan, ctx.kernel = plan, kernel
        ctx.save_for_backward(x, dw, dwb, pw, d)
        return out

    @staticmethod
    def backward(ctx, g):
        from ..ops import dsconv

        x, dw, dwb, pw, d = ctx.saved_tensors
        plan = ctx.plan
        ckpl, per = pw.shape
        g = g.contiguous()
        g_own = (g[..., plan.rank * per:(plan.rank + 1) * per]
                 if plan.pw is not None else g)
        g2 = g_own.reshape(-1, per)
        if d is None:
            d = dsconv._depthwise(x, dw, dwb)
        dpw = d.reshape(-1, ckpl).t() @ g2
        # the replicated bias's gradient: whole, from the whole g
        dpwb = g.reshape(-1, g.shape[-1]).sum(0)
        gd = (g2 @ pw.t()).view(x.shape[:3] + (ckpl,))
        if plan.pw is not None:
            gd = _reduce_gd(gd, plan.group)
        need_dx = ctx.needs_input_grad[0]
        if ctx.kernel and dsconv.bwd_takes(*x.shape, ckpl):
            dx, ddw, ddwb = dsconv._launch_bwd(gd, x, dw, need_dx=need_dx)
        else:
            dx, ddw, ddwb = dsconv.reference_depthwise_backward(
                gd, x, dw, need_dx)
            if ctx.kernel:
                dsconv.bwd_plain_count += 1
        if plan.dw is not None:
            own = ckpl // plan.ranks
            ddw = ddw[..., plan.rank * own:(plan.rank + 1) * own]
        return dx, ddw, ddwb, dpw, dpwb, None, None, None


def _tp_dsc_forward(module, plan: _DscPlan, x):
    """``DepthwiseSeparableConv.forward`` with its leaves cut by
    :func:`shard_module_tp`: (N, C, H, W) -> (N, nout, H, W)."""
    from ..core.precision import cast_to

    dw = module.depthwise_weight[:, 0].permute(1, 2, 0)
    pw = module.pointwise_weight[:, :, 0, 0].t()
    kernel = module.use_pallas and x.device.type == "cuda"
    keep_d = kernel and torch.is_grad_enabled() and pw.requires_grad

    def f32(t):  # the kernel's and its plain version's float32, contiguous
        return (t.float() if t.dtype == torch.bfloat16 else t).contiguous()

    y = _TpDSConv.apply(f32(x.permute(0, 2, 3, 1)), f32(dw),
                        f32(module.depthwise_bias), f32(pw),
                        f32(module.pointwise_bias), plan, kernel, keep_d)
    return cast_to(y.permute(0, 3, 1, 2), module.dtype)


# ---------------------------------------------------------------- placing
class TpNet:
    """A model's TP placement (:func:`shard_module_tp`): its cut leaves in
    ``named_modules()`` order."""

    def __init__(self, leaves: list):
        self.leaves = leaves

    def block_numel(self) -> int:
        return sum(math.prod(leaf.block_shape) for leaf in self.leaves)

    def full_numel(self) -> int:
        return sum(math.prod(leaf.full_shape) for leaf in self.leaves)


def tp_net(model: nn.Module) -> TpNet | None:
    """``model``'s TP placement, or None."""
    return model.__dict__.get("_tp_net")


def _column_parallel(module, name) -> bool:
    """Whether the port has a column-parallel form for this leaf."""
    from ..models.smaat_unet import DepthwiseSeparableConv

    if isinstance(module, DepthwiseSeparableConv):
        return name in ("depthwise_weight", "pointwise_weight")
    return (isinstance(module, nn.Conv2d) and name == "weight"
            and module.groups == 1 and module.padding_mode == "zeros")


def shard_module_tp(model: nn.Module, axis,
                    min_channels: int = DEFAULT_MIN_CHANNELS) -> TpNet | None:
    """The driver's TP placement, in place (JAX ``shard_net_state_tp``):
    every parameter of ``model`` that :func:`tp_spec` cuts over
    ``axis.model`` becomes this rank's block, and its module computes
    column-parallel. Run it before expert parallelism, FSDP and the
    optimizer. Returns the placement; None on a model axis of one or where
    no leaf is cut. Raises for a leaf the rule cuts whose layer has no
    column-parallel form in the port (only at a ``min_channels`` far below
    the default)."""
    from ..models.smaat_unet import DepthwiseSeparableConv

    model_axis = axis.model
    if not model_axis.parallel:
        return None
    leaves, seen = [], set()
    for prefix, module in model.named_modules():
        cut = {}
        for name, p in list(module._parameters.items()):
            if p is None or id(p) in seen:
                continue
            seen.add(id(p))
            dim = tp_spec(module, name, p, model_axis.size, min_channels)
            if dim is None:
                continue
            key = f"{prefix}.{name}" if prefix else name
            if not _column_parallel(module, name):
                raise ValueError(
                    f"tensor parallelism cuts {key} ({type(module).__name__},"
                    f" {tuple(p.shape)}) at tp_min_channels={min_channels}, "
                    "and the port has no column-parallel form for that "
                    "layer; raise tp_min_channels above its output channels")
            leaf = _TpLeaf(module, name, key, dim, p, model_axis)
            block = nn.Parameter(leaf.cut(p.detach()),
                                 requires_grad=p.requires_grad)
            block._tp_leaf = leaf
            module._parameters[name] = block
            cut[name] = leaf
            leaves.append(leaf)
        if not cut:
            continue
        if isinstance(module, DepthwiseSeparableConv):
            module.forward = functools.partial(
                _tp_dsc_forward, module,
                _DscPlan(cut.get("depthwise_weight"),
                         cut.get("pointwise_weight")))
        else:
            module._conv_forward = functools.partial(
                _tp_conv_forward, module, cut["weight"])
    if not leaves:
        return None
    net = TpNet(leaves)
    model.__dict__["_tp_net"] = net
    return net


def tp_blocks(model: nn.Module) -> list:
    """The tensors of ``model`` that hold a TP block, which differ by model
    rank: each cut leaf's registered parameter, or under FSDP its working
    weight (FSDP's shards are checked apart)."""
    net = tp_net(model)
    if net is None:
        return []
    return [leaf.module.__dict__[leaf.name]
            if hasattr(leaf.registered, "_fsdp_shard") else leaf.registered
            for leaf in net.leaves]


# ------------------------------------------------------------------ state
def _map_leaves(tree: dict, model, optimizer, fn) -> dict:
    """A NetState tree (``{"model"[, "optimizer", "scheduler"]}``) with
    ``fn(tensor, leaf)`` applied to each cut leaf's entry and to its
    optimizer state's tensors (Adam's moments; not the step)."""
    net = tp_net(model)
    if net is None:
        return tree
    keys = {leaf.key: leaf for leaf in net.leaves}
    out = dict(tree)
    out["model"] = {k: fn(v, keys[k]) if k in keys else v
                    for k, v in tree["model"].items()}
    if "optimizer" in tree and optimizer is not None:
        regs = {id(leaf.registered): leaf for leaf in net.leaves}
        params = [p for g in optimizer.param_groups for p in g["params"]]
        index = {i: regs[id(p)] for i, p in enumerate(params)
                 if id(p) in regs}
        saved = tree["optimizer"]
        out["optimizer"] = {**saved, "state": {
            i: {k: fn(v, index[i])
                if i in index and torch.is_tensor(v) and v.dim() else v
                for k, v in st.items()}
            for i, st in saved["state"].items()}}
    return out


def full_state(tree: dict, model, optimizer=None) -> dict:
    """A NetState tree of this rank (FSDP's blocks already gathered) with
    every TP block and its optimizer state gathered: full leaves, the same
    on every rank. A collective: every rank calls it."""
    return _map_leaves(tree, model, optimizer,
                       lambda v, leaf: leaf.gather(v))


def full_state_dict(model, state: dict | None = None) -> dict:
    """``state`` (default: ``model.state_dict()``; FSDP's blocks gathered
    first) with its TP blocks gathered (:func:`full_state`)."""
    state = model.state_dict() if state is None else state
    return full_state({"model": state}, model)["model"]


def local_state(tree: dict, model, optimizer=None) -> dict:
    """The reverse of :func:`full_state`: a tree of full leaves cut to this
    rank's blocks (a tree already cut passes unchanged)."""
    def cut(v, leaf):
        return leaf.cut(v) if tuple(v.shape) == leaf.full_shape else v

    return _map_leaves(tree, model, optimizer, cut)


def describe(model, axis) -> str:
    """The driver's line on a placement."""
    net = tp_net(model)
    m = axis.model.size
    if net is None:
        return (f"[tp] no leaf of {type(model).__name__} is cut over "
                f"{m} model ranks")
    params = list(model.parameters())
    mine = sum(p.numel() * p.element_size() for p in params)
    elem = params[0].element_size()
    full = mine + (net.full_numel() - net.block_numel()) * elem
    return (f"[tp] {type(model).__name__}: {len(net.leaves)} leaves cut by "
            f"output channel over {m} model ranks, {net.block_numel()} of "
            f"their {net.full_numel()} elements on this rank; its "
            f"parameters {mine} bytes ({3 * mine} with Adam's moments) "
            f"against {full} ({3 * full}) replicated")


def place_nets(axis, nets, min_channels: int = DEFAULT_MIN_CHANNELS):
    """The GAN drivers' TP placement of ``nets`` (JAX ``dcgan_driver.py:
    155-171``, ``cyclegan_driver.py:199-215``: the discriminators): each
    net cut (:func:`shard_module_tp`) and described; nothing on a model
    axis of one."""
    if not axis.model.parallel:
        return
    for net in nets:
        shard_module_tp(net, axis, min_channels)
        print(describe(net, axis))
