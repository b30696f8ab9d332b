"""FSDP / ZeRO-3: parameters and Adam's moments sharded over the data axis
(port of ``extended_gan_tpu/parallel/fsdp.py``).

The JAX package annotates every large leaf (and its Adam moments) with a
``data``-sharded ``NamedSharding`` and lets XLA's SPMD partitioner derive
the schedule: an all-gather of each shard before its use, a reduce-scatter
of its gradient back to the shard, and an optimizer update local to each
shard. The port writes that schedule out with explicit collectives
(``parallel/mesh.py``'s ``_all_gather`` and ``_reduce_scatter``, the ones
expert parallelism uses):

- :func:`fsdp_spec` is JAX's ``_fsdp_spec`` (``:50-77``): a leaf stays
  whole when it is a scalar, has fewer than ``min_size`` elements or no
  axis divisible by D; otherwise its largest divisible axis, the first on
  a tie in JAX's axis order, is cut into D contiguous blocks, rank r
  keeping block r. The port's layouts are not flax's (conv weights OIHW
  against HWIO, ``nn.Linear``'s (out, in) against Dense's (in, out), the
  transposed conv's (in, out, kh, kw) flipped in both spatial axes:
  ``models/convert.py``), so the rule walks the port's dims in JAX's order
  (:func:`_jax_axis_order`) and a flipped axis's blocks go to the ranks in
  reverse: rank r holds the elements JAX's device r holds.
- :func:`shard_module_fsdp` places a model in place, after expert
  parallelism and before its optimizer is built: each sharded leaf's
  registered parameter becomes this rank's block, so ``parameters()``,
  ``state_dict()``, the optimizer and Adam's moments hold 1/D of it. The
  expert shards (``parallel/expert.py``) stay as they are, as JAX's rule
  leaves a leaf already sharded over ``data``. The full leaf that the
  forward reads, the working weight, is a tensor of the same name in the
  module's instance dict, where it shadows the parameter: the layers, the
  cross-rank BatchNorm and the kernels' wrappers read it as they read any
  weight, and their backwards leave its gradient in its ``.grad``.
- :func:`refresh_after` follows each step of a net's optimizer with one
  flat all-gather of the net's shards into its working weights: a net is
  re-gathered after its own optimizer step, before any forward reads it
  (the DCGAN's default body reads D right after D's step). Inside a CUDA
  graph (``train/megastep.py``) the gather is captured with the step.
- :func:`reduce_grads` takes ``DataAxis.all_reduce_grads``'s place in the
  trainers: the working weights' gradients go to their shards' ``.grad``
  through one reduce-scatter, the replicated parameters' gradients and the
  step's logs through the flat all-reduce as before.
- :func:`full_state` and :func:`local_state`: checkpoints and ``model.pt``
  hold full leaves (the shards and their moments gathered), and a rank
  loading a tree takes its blocks, so a run with FSDP resumes one without
  it and the reverse. Under tensor parallelism (``parallel/tensor.py``)
  a cut leaf's FSDP block lies within the rank's TP block: its gather
  gives the TP block, which ``tensor.full_state`` gathers next.

Deviations from JAX: explicit collectives where JAX has GSPMD derive them;
and the working weights live for the whole run, one static buffer a leaf
(the CUDA graphs name their addresses, and the evaluation, the figures and
the returned model read them without a collective), where XLA frees a
gathered weight after its use. So what FSDP takes off a rank is the
optimizer's share: the parameters it steps and Adam's two moments, 1/D of
each sharded leaf's three copies.
"""

from __future__ import annotations

import math
import typing

import torch
from torch import nn

from .mesh import DataAxis, _all_gather, _reduce_scatter

#: Leaves with fewer elements than this stay replicated (16 KiB of f32).
DEFAULT_MIN_SIZE = 4096

#: The drivers' line for FSDP on an axis of one (JAX ``gat_driver.py:441-444``)
AXIS_OF_ONE = ("[fsdp] requested but the mesh data axis is 1 — nothing to "
               "shard (FSDP shards intra-slice over the data axis; on a "
               "hybrid mesh put DP on 'data', not only 'dcn')")


class FsdpSpec(typing.NamedTuple):
    """Where a leaf is cut: the port's ``dim``, and whether the converter
    flips that axis (the blocks then go to the ranks in reverse)."""

    dim: int
    flipped: bool


def _jax_axis_order(module: nn.Module, name: str,
                   param: torch.Tensor) -> tuple[tuple[int, ...], tuple]:
    """(the port's dim of each axis of the flax leaf, in flax's order; the
    port's dims that ``models/convert.py`` flips) of ``module``'s parameter
    ``name``: a conv ``*weight`` (..., O, I, kh, kw) is flax's (..., kh, kw,
    I, O), a 2-D ``nn.Linear`` weight Dense's (in, out), a
    ``ConvTranspose2d`` weight (I, O, kh, kw) flax's flipped (kh, kw, I, O);
    BatchNorm's weight (flax's ``scale``) and every other leaf keep their
    order."""
    nd = param.dim()
    same = tuple(range(nd)), ()
    if not name.endswith("weight") or "running_mean" in module._buffers:
        return same
    if isinstance(module, nn.ConvTranspose2d):
        return (2, 3, 0, 1), (2, 3)
    if nd == 2:
        return (1, 0), ()
    if nd >= 4:
        return (*range(nd - 4), nd - 2, nd - 1, nd - 3, nd - 4), ()
    return same


def fsdp_spec(module: nn.Module, name: str, param: torch.Tensor, dp: int,
              min_size: int = DEFAULT_MIN_SIZE) -> FsdpSpec | None:
    """JAX's ``_fsdp_spec`` for ``module``'s parameter ``name`` over a data
    axis of ``dp``: None where JAX leaves the leaf whole (a scalar, fewer
    than ``min_size`` elements, no axis divisible by ``dp``), else the
    port's counterpart of the axis JAX shards (the largest divisible one,
    the first such in JAX's order on a tie). The expert shards, which JAX
    skips as already sharded, are left out by :func:`shard_module_fsdp`.
    A tensor parallelism block keeps its cut dim, as JAX keeps a leaf's
    ``model`` axis (``_fsdp_spec``), so the data cut falls within the
    rank's block, and its size is judged as the whole leaf's."""
    shape = tuple(param.shape)
    # a tensor parallelism block (``parallel/tensor.py``): JAX keeps its
    # ``model`` axis and judges the leaf by its global size
    tp = getattr(param, "_tp_leaf", None)
    numel = param.numel() * (tp.ranks if tp is not None else 1)
    if not shape or numel < min_size:
        return None
    order, flipped = _jax_axis_order(module, name, param)
    best = None
    for d in order:
        if shape[d] == 0 or shape[d] % dp or (tp is not None and d == tp.dim):
            continue
        if best is None or shape[d] > shape[best]:
            best = d
    return None if best is None else FsdpSpec(best, best in flipped)


class _Leaf:
    """One sharded leaf: its module and name, where it is cut, this rank's
    block (``shard``, the registered parameter) and the full working
    weight the forward reads."""

    def __init__(self, module, name, spec: FsdpSpec, full, axis: DataAxis):
        self.module, self.name = module, name
        self.dim, self.flipped = spec
        self.ranks, self.group = axis.size, axis.group
        self.full_shape = tuple(full.shape)
        self.per = full.shape[self.dim] // self.ranks
        self.pre = math.prod(self.full_shape[:self.dim])
        self.post = math.prod(self.full_shape[self.dim + 1:])
        self.numel = self.pre * self.per * self.post
        self.block = self.block_of(axis.rank)
        self.shard = None
        self.working = None

    def block_of(self, rank: int) -> int:
        return self.ranks - 1 - rank if self.flipped else rank

    @property
    def shard_shape(self) -> tuple:
        shape = list(self.full_shape)
        shape[self.dim] = self.per
        return tuple(shape)

    def cut(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of a full-shaped tensor (a copy)."""
        return full.narrow(self.dim, self.block * self.per, self.per).clone(
            memory_format=torch.contiguous_format)

    def rows(self, full: torch.Tensor) -> torch.Tensor:
        """(ranks, numel): row r is rank r's block of ``full``, flat."""
        t = full.reshape(self.pre, self.ranks, self.per,
                         self.post).transpose(0, 1)
        if self.flipped:
            t = t.flip(0)
        return t.reshape(self.ranks, self.numel)

    def assemble(self, rows: torch.Tensor) -> torch.Tensor:
        """The inverse of :meth:`rows`: the full tensor from every rank's
        flat block, in rank order."""
        t = rows.reshape(self.ranks, self.pre, self.per, self.post)
        if self.flipped:
            t = t.flip(0)
        return t.transpose(0, 1).reshape(self.full_shape)


class FsdpNet:
    """A model's FSDP placement (:func:`shard_module_fsdp`): its sharded
    leaves in ``parameters()`` order, and the optimizer hooks that gather
    them (:func:`refresh_after`)."""

    def __init__(self, model: nn.Module, axis: DataAxis, leaves: list):
        self.model, self.axis, self.leaves = model, axis, leaves
        self.hooks = []

    def gather(self):
        """Every rank's shards into the working weights: ONE flat
        all-gather for the net. A collective: every rank calls it."""
        with torch.no_grad():
            send = torch.cat([leaf.shard.detach().reshape(-1)
                              for leaf in self.leaves])
            out = send.new_empty((self.axis.size * send.numel(),))
            _all_gather(out, send, self.axis.group)
            rows = out.view(self.axis.size, -1)
            at = 0
            for leaf in self.leaves:
                leaf.working.copy_(leaf.assemble(
                    rows[:, at:at + leaf.numel]))
                at += leaf.numel

    def shard_numel(self) -> int:
        return sum(leaf.numel for leaf in self.leaves)

    def full_numel(self) -> int:
        return sum(math.prod(leaf.full_shape) for leaf in self.leaves)


def fsdp_net(model: nn.Module) -> FsdpNet | None:
    """``model``'s FSDP placement, or None."""
    return model.__dict__.get("_fsdp_net")


def shard_module_fsdp(model: nn.Module, axis: DataAxis,
                      min_size: int = DEFAULT_MIN_SIZE) -> FsdpNet | None:
    """The driver's FSDP placement, in place (JAX ``shard_params_fsdp``):
    every parameter of ``model`` that :func:`fsdp_spec` cuts, but the
    expert shards, becomes this rank's block, and its full value the
    module's working weight of that name. Build the optimizer after this,
    and :func:`refresh_after` it. Returns the placement; None on an axis of
    one or where no leaf is cut."""
    if not axis.parallel:
        return None
    from .expert import expert_shards

    skip = expert_shards(model)
    leaves, seen = [], set()
    for module in model.modules():
        for name, p in list(module._parameters.items()):
            if p is None or p in skip or id(p) in seen:
                continue
            seen.add(id(p))
            spec = fsdp_spec(module, name, p, axis.size, min_size)
            if spec is None:
                continue
            leaf = _Leaf(module, name, spec, p, axis)
            leaf.shard = nn.Parameter(leaf.cut(p.detach()),
                                      requires_grad=p.requires_grad)
            # the full leaf keeps its storage: the static working weight
            leaf.working = p.detach().requires_grad_(p.requires_grad)
            leaf.shard._fsdp_shard = leaf
            leaf.working._fsdp_working = leaf
            module._parameters[name] = leaf.shard
            module.__dict__[name] = leaf.working
            leaves.append(leaf)
    if not leaves:
        return None
    net = FsdpNet(model, axis, leaves)
    model.__dict__["_fsdp_net"] = net
    return net


def fsdp_shards(model: nn.Module) -> dict:
    """{shard parameter: its leaf} of ``model``'s FSDP placement."""
    net = fsdp_net(model)
    return {} if net is None else {leaf.shard: leaf for leaf in net.leaves}


def working_weights(model: nn.Module) -> list:
    """The full working weights of ``model``'s sharded leaves (the same on
    every rank)."""
    net = fsdp_net(model)
    return [] if net is None else [leaf.working for leaf in net.leaves]


def working(params) -> list:
    """``params`` with each FSDP shard replaced by its working weight: the
    tensors a forward reads, whose gradients a step takes."""
    return [p._fsdp_shard.working if hasattr(p, "_fsdp_shard") else p
            for p in params]


def refresh_after(optimizer: torch.optim.Optimizer, *models: nn.Module):
    """Every step of ``optimizer`` (which steps the shards of ``models``)
    ends with the gather of those models' working weights; nothing for a
    model without FSDP. The hooks are kept on each placement (``hooks``)."""
    for model in models:
        net = fsdp_net(model)
        if net is not None:
            net.hooks.append(optimizer.register_step_post_hook(
                lambda opt, args, kwargs, net=net: net.gather()))


def reduce_grads(axis: DataAxis, params, extra: torch.Tensor) -> torch.Tensor:
    """``DataAxis.all_reduce_grads`` for ``params`` that may hold working
    weights (:func:`working`): their gradients are summed over the ranks
    into their shards' ``.grad`` by ONE reduce-scatter (and cleared), the
    rest with ``extra`` by the flat all-reduce; returns the summed
    ``extra``."""
    sharded = [p for p in params
               if hasattr(p, "_fsdp_working") and p.grad is not None]
    if sharded:
        leaves = [p._fsdp_working for p in sharded]
        send = torch.cat([leaf.rows(p.grad) for leaf, p in
                          zip(leaves, sharded)], 1)
        out = send.new_empty((send.shape[1],))
        _reduce_scatter(out, send.reshape(-1), axis.group)
        at = 0
        for leaf, p in zip(leaves, sharded):
            leaf.shard.grad = out[at:at + leaf.numel].view(leaf.shard_shape)
            p.grad = None
            at += leaf.numel
    rest = [p for p in params if not hasattr(p, "_fsdp_working")]
    return axis.all_reduce_grads(rest, extra)


# ------------------------------------------------------------------ state
def gather_full(t: torch.Tensor, leaf: _Leaf) -> torch.Tensor:
    """The full tensor from every rank's block ``t`` of ``leaf`` (the
    parameter's or one of its optimizer moments). A collective: every rank
    calls it."""
    flat = t.detach().contiguous().reshape(-1)
    out = flat.new_empty((leaf.ranks * flat.numel(),))
    _all_gather(out, flat, leaf.group)
    return leaf.assemble(out.view(leaf.ranks, -1))


def _map_leaves(tree: dict, model, optimizer, fn) -> dict:
    """A NetState tree (``{"model"[, "optimizer", "scheduler"]}``) with
    ``fn(tensor, leaf)`` applied to each sharded leaf's entry and to its
    optimizer state's tensors (Adam's moments; not the step)."""
    shards = fsdp_shards(model)
    if not shards:
        return tree
    keys = {k: shards[p] for k, p in model.named_parameters()
            if p in shards}
    out = dict(tree)
    out["model"] = {k: fn(v, keys[k]) if k in keys else v
                    for k, v in tree["model"].items()}
    if "optimizer" in tree and optimizer is not None:
        params = [p for g in optimizer.param_groups for p in g["params"]]
        index = {i: shards[p] for i, p in enumerate(params) if p in shards}
        saved = tree["optimizer"]
        out["optimizer"] = {**saved, "state": {
            i: {k: fn(v, index[i])
                if i in index and torch.is_tensor(v) and v.dim() else v
                for k, v in st.items()}
            for i, st in saved["state"].items()}}
    return out


def full_state(tree: dict, model, optimizer=None) -> dict:
    """A NetState tree of this rank with every FSDP shard and its
    optimizer state gathered: full leaves, the same on every rank. A
    collective: every rank calls it."""
    return _map_leaves(tree, model, optimizer, gather_full)


def full_state_dict(model, state: dict | None = None) -> dict:
    """``state`` (default: ``model.state_dict()``) with its FSDP shards
    gathered (:func:`full_state`)."""
    state = model.state_dict() if state is None else state
    return full_state({"model": state}, model)["model"]


def local_state(tree: dict, model, optimizer=None) -> dict:
    """The reverse of :func:`full_state`: a tree of full leaves cut to this
    rank's blocks (a tree already cut passes unchanged)."""
    def cut(v, leaf):
        return leaf.cut(v) if tuple(v.shape) == leaf.full_shape else v

    return _map_leaves(tree, model, optimizer, cut)


def persistent_bytes(model, optimizer=None) -> dict:
    """This rank's persistent bytes of ``model``: ``params`` (the
    registered parameters, shards included) and ``moments`` (the
    optimizer's state tensors of more than one element), and ``working``
    (the working weights)."""
    params = list(model.parameters())
    moments = 0
    if optimizer is not None:
        moments = sum(v.numel() * v.element_size() for p in params
                      for v in optimizer.state.get(p, {}).values()
                      if torch.is_tensor(v) and v.dim())
    return {"params": sum(p.numel() * p.element_size() for p in params),
            "moments": moments,
            "working": sum(w.numel() * w.element_size()
                           for w in working_weights(model))}


def describe(model, axis: DataAxis) -> str:
    """The driver's line on a placement."""
    net = fsdp_net(model)
    if net is None:
        return (f"[fsdp] no leaf of {type(model).__name__} is large enough "
                f"to shard over {axis.size} ranks")
    params = list(model.parameters())
    mine = sum(p.numel() * p.element_size() for p in params)
    full = mine + sum((math.prod(leaf.full_shape) - leaf.numel)
                      * leaf.shard.element_size() for leaf in net.leaves)
    return (f"[fsdp] {type(model).__name__}: {len(net.leaves)} leaves "
            f"ZeRO-sharded over {axis.size} ranks, {net.shard_numel()} of "
            f"their {net.full_numel()} elements on this rank; its "
            f"parameters {mine} bytes ({3 * mine} with Adam's moments) "
            f"against {full} ({3 * full}) replicated")


def place_nets(axis: DataAxis, nets, fsdp: bool,
               min_size: int = DEFAULT_MIN_SIZE):
    """The GAN drivers' placement of ``nets`` (JAX ``dcgan_driver.py:
    155-180``, ``cyclegan_driver.py:199-222``): with ``fsdp`` on an axis
    of more than one rank, each net sharded (:func:`shard_module_fsdp`)
    and described; on an axis of one, JAX's line."""
    if not fsdp:
        return
    if not axis.parallel:
        print(AXIS_OF_ONE)
        return
    for net in nets:
        shard_module_fsdp(net, axis, min_size)
        print(describe(net, axis))
    print("[fsdp] params + Adam moments ZeRO-sharded over the data axis")
