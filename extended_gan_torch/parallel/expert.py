"""Expert parallelism (EP): the Switch-MoE's experts sharded over the data
axis (port of ``extended_gan_tpu/parallel/expert.py``).

Each rank of the axis holds ``E / D`` experts' weights (``w1``, ``b1``,
``w2``, ``b2``, and so their Adam moments); the router is replicated. The
tokens stay data-parallel: each rank routes its own rows.

Ported function by function from the JAX module:

- :func:`moe_param_spec`, :func:`shard_moe_params_ep`: which leaves of a
  ``SwitchMoE`` shard, and this rank's slice of them;
- :func:`shard_tree_moe_ep`: the same over a whole model, in place (the
  driver's placement, before the optimizer is built, so Adam's moments are
  sliced too); nothing where the axis is 1 or does not divide E (JAX
  ``:72-74``);
- :func:`make_moe_ep_apply`: the explicit program, each rank routing its
  N/D tokens with a per-shard capacity, two all-to-alls carrying the slots
  to their experts' ranks and back, the aux loss averaged over the ranks.

What the JAX driver computes is not that program: under ``jit`` its
``SwitchMoE`` sees the global batch (capacity and queue positions over
every token of a routing group), and GSPMD partitions the dispatch over
the sharded expert stacks. :func:`moe_apply_global` computes that on the
ranks: each rank's queue positions start after the tokens that the ranks
before it routed to the same expert (the global token order is rank order,
``DataAxis.rows``), the capacity is the global group's, and the slots are
global, each rank filling its own and leaving zeros elsewhere. Adding zeros
is exact, so a reduce-scatter over the expert axis gives each owner its
experts' complete slots, and an all-gather brings the results back: one
exchange of static shapes, which a CUDA graph captures. The aux loss is
each rank's share ``E * sum_e f_e * (sum of local p_e) / N`` with the
global fractions ``f``, so the shares sum to the global loss and the
trainer's loss all-reduce counts it once.

The collectives are autograd functions whose backward is the matching
collective (all-to-all and all-to-all, all-gather and reduce-scatter), so
an owner's expert gradient is complete after the backward: the expert
shards stay out of the trainer's flat all-reduce
(:func:`replicated_parameters`). Checkpoints and ``model.pt`` hold all E
experts (:func:`full_state`), and a rank loading one takes its slice
(:func:`local_state`).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..models.moe import (
    SwitchMoE,
    expert_capacity,
    expert_ffn,
    moe_layers,
    route_top1,
)
from .mesh import DataAxis, _all_gather, _reduce_scatter

# the SwitchMoE leaves with a leading expert axis
EXPERT_LEAVES = ("w1", "b1", "w2", "b2")


# ------------------------------------------------------------ collectives
class _AllToAll(torch.autograd.Function):
    """Chunk r of dim 0 goes to rank r; rank r's chunks arrive in rank
    order. Its backward is the same exchange of the gradient."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _AllToAll.apply(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    """Every rank's ``t`` stacked in rank order on dim 0; backward: the
    reduce-scatter of the gradient."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        size = dist.get_world_size(group)
        out = t.new_empty((size * t.shape[0],) + tuple(t.shape[1:]))
        _all_gather(out, t.contiguous(), group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _ReduceScatter.apply(g, ctx.group), None


class _ReduceScatter(torch.autograd.Function):
    """The sum over the ranks of ``t``, rank r keeping chunk r of dim 0;
    backward: the all-gather of the gradient."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        size = dist.get_world_size(group)
        out = t.new_empty((t.shape[0] // size,) + tuple(t.shape[1:]))
        _reduce_scatter(out, t.contiguous(), group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _AllGather.apply(g, ctx.group), None


def all_to_all(t, axis: DataAxis):
    return _AllToAll.apply(t, axis.group)


def all_gather(t, axis: DataAxis):
    return _AllGather.apply(t, axis.group)


def reduce_scatter(t, axis: DataAxis):
    return _ReduceScatter.apply(t, axis.group)


# ---------------------------------------------------------------- placing
def moe_param_spec(params: dict, n_experts: int) -> dict:
    """{leaf name: whether it shards over the data axis} for a SwitchMoE
    param dict: a leading expert axis shards, the router stays whole."""
    return {k: (v.dim() >= 1 and v.shape[0] == n_experts and k != "router")
            for k, v in params.items()}


def _slice(n_experts: int, axis: DataAxis) -> slice:
    per = n_experts // axis.size
    return slice(axis.rank * per, (axis.rank + 1) * per)


def shard_moe_params_ep(params: dict, axis: DataAxis, n_experts: int) -> dict:
    """This rank's leaves of a SwitchMoE param dict: the E/D experts it
    owns, the router whole."""
    spec = moe_param_spec(params, n_experts)
    own = _slice(n_experts, axis)
    return {k: v[own] if spec[k] else v for k, v in params.items()}


def shard_tree_moe_ep(model: torch.nn.Module, axis: DataAxis):
    """The driver's EP placement, in place: every SwitchMoE of ``model``
    routes over ``axis`` (:func:`moe_apply_global`), and where the axis
    divides its E, keeps only this rank's E/D experts as its parameters
    (build the optimizer after this). Nothing on an axis of one; where D
    does not divide E the experts stay replicated, as in JAX, and their
    gradients go through the trainer's all-reduce."""
    if not axis.parallel:
        return
    for m in moe_layers(model):
        m.axis = axis
        if m.num_experts % axis.size:
            continue
        own = _slice(m.num_experts, axis)
        for name in EXPERT_LEAVES:
            full = getattr(m, name)
            setattr(m, name, torch.nn.Parameter(
                full.detach()[own].clone(), requires_grad=full.requires_grad))
        m.experts = (own.start, own.stop)


def expert_shards(model: torch.nn.Module) -> dict:
    """{parameter: (its SwitchMoE, leaf name)} of every expert shard of
    ``model``."""
    return {getattr(m, name): (m, name) for m in moe_layers(model)
            if m.experts is not None for name in EXPERT_LEAVES}


def replicated_parameters(model: torch.nn.Module) -> list:
    """``model``'s parameters but its expert shards: the ones the trainer's
    gradient all-reduce sums."""
    shards = expert_shards(model)
    return [p for p in model.parameters() if p not in shards]


# ------------------------------------------------------------------ state
def _shard_keys(model: torch.nn.Module) -> dict:
    """{state_dict key: (SwitchMoE, leaf name)} of the expert shards."""
    shards = expert_shards(model)
    return {k: shards[p] for k, p in model.named_parameters()
            if p in shards}


def _opt_index(optimizer, shards) -> dict:
    """{index in the optimizer's state_dict: its expert shard}."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    return {i: p for i, p in enumerate(params) if p in shards}


def _gather(t: torch.Tensor, axis: DataAxis) -> torch.Tensor:
    """Every rank's expert shard ``t`` stacked in rank order: all E."""
    return axis.gather_rows(t.detach().clone()).flatten(0, 1)


def gather_experts(tensors: dict, model, axis: DataAxis) -> dict:
    """``tensors`` keyed by ``model``'s parameter names (its state_dict,
    its gradients), each expert shard's gathered from the ranks: all E. A
    collective: every rank calls it."""
    keys = _shard_keys(model)
    return {k: _gather(v, axis) if k in keys else v
            for k, v in tensors.items()}


def _map_shards(tree: dict, model, optimizer, fn) -> dict:
    """A NetState tree (``{"model", "optimizer"[, "scheduler"]}``) with
    ``fn(tensor, its SwitchMoE)`` applied to every expert shard's leaf and
    to its optimizer state's tensors (Adam's moments; not the step)."""
    shards = expert_shards(model)
    if not shards:
        return tree
    keys = _shard_keys(model)
    out = dict(tree)
    out["model"] = {k: fn(v, keys[k][0]) if k in keys else v
                    for k, v in tree["model"].items()}
    if "optimizer" in tree:
        index = _opt_index(optimizer, shards)
        saved = tree["optimizer"]
        out["optimizer"] = {**saved, "state": {
            i: {k: fn(v, shards[index[i]][0])
                if i in index and torch.is_tensor(v) and v.dim() else v
                for k, v in st.items()}
            for i, st in saved["state"].items()}}
    return out


def full_state(tree: dict, model, optimizer, axis: DataAxis) -> dict:
    """A NetState tree of this rank with every expert shard and its Adam
    moments gathered: all E experts, the same on every rank. A
    collective: every rank calls it."""
    return _map_shards(tree, model, optimizer,
                       lambda v, m: _gather(v, axis))


def full_state_dict(model, axis: DataAxis) -> dict:
    """``model.state_dict()`` with all E experts (:func:`gather_experts`)."""
    return gather_experts(model.state_dict(), model, axis)


def local_state(tree: dict, model, optimizer) -> dict:
    """The reverse of :func:`full_state`: a tree with all E experts cut to
    this rank's slices (a tree already cut passes unchanged)."""
    def cut(v, m):
        lo, hi = m.experts
        return v[lo:hi] if v.shape[0] == m.num_experts else v

    return _map_shards(tree, model, optimizer, cut)


# ---------------------------------------------------------------- routing
def make_moe_ep_apply(axis: DataAxis, *, n_experts: int, capacity: int,
                      dtype=torch.float32):
    """The explicit EP program (JAX ``:90-149``): ``apply(params, tokens)
    -> (out, aux)`` with ``tokens`` this rank's (N/D, C) and ``params``
    this rank's leaves (:func:`shard_moe_params_ep`); ``capacity`` is the
    per-expert slot count of each rank's shard. Each rank routes its own
    tokens, builds its (E, cap, C) slots, one all-to-all sends them to
    their experts' ranks ((E/D, D*cap, C)), the local experts run, a second
    all-to-all brings the results back, and the combine is local; ``aux``
    is the ranks' mean."""
    d = axis.size
    if n_experts % d:
        raise ValueError(f"n_experts {n_experts} not divisible by data-axis "
                         f"size {d}")
    per = n_experts // d

    def apply(params, tokens):
        dispatch, combine, aux = route_top1(tokens, params["router"],
                                            capacity)
        slots = torch.einsum("nec,nd->ecd", dispatch.to(dtype),
                             tokens.to(dtype))
        c = slots.shape[-1]
        # (E, cap, C): chunk r (experts r*E/D..) to rank r, which stacks
        # the D ranks' chunks: (D, E/D, cap, C) -> (E/D, D*cap, C)
        recv = all_to_all(slots, axis).view(d, per, capacity, c)
        inputs = recv.transpose(0, 1).reshape(per, d * capacity, c)
        outputs = expert_ffn(params["w1"], params["b1"], params["w2"],
                             params["b2"], inputs, dtype=dtype)
        # back: (E/D, D, cap, C) -> chunk r to rank r -> (E, cap, C)
        send = outputs.view(per, d, capacity, c).transpose(0, 1)
        back = all_to_all(send.reshape(n_experts, capacity, c), axis)
        out = torch.einsum("nec,ecd->nd", combine.to(dtype), back)
        others = axis.all_reduce(aux.detach().clone()) - aux.detach()
        # the ranks' mean, differentiable in this rank's own term
        return out, (aux + others) / d

    return apply


def moe_apply_global(moe: SwitchMoE, tokens: torch.Tensor, axis: DataAxis,
                     dtype=torch.float32):
    """``moe`` on this rank's ``tokens`` (G, n, C), G routing groups that
    span the ranks (group g's global tokens: every rank's g-th group in
    rank order), computing what one process computes on the global batch:
    ``(out (G, n, C), aux share (G,), load (G, E))``, the load the global
    group's. ``moe``'s expert leaves are this rank's shards
    (:func:`shard_tree_moe_ep`) or all E."""
    g, n, c = tokens.shape
    e = moe.num_experts
    # the global group's tokens: every rank's share of the group's rows
    total = sum(axis.sizes(n))
    cap = expert_capacity(total, e, moe.capacity_factor)
    ftype = torch.promote_types(tokens.dtype, torch.float32)
    probs = torch.softmax(tokens.to(ftype) @ moe.router.to(ftype), dim=-1)
    onehot = (probs.argmax(-1)[..., None] == torch.arange(
        e, device=tokens.device)).to(ftype)                   # (G, n, E)
    gate = (probs * onehot).sum(-1)
    # per group and expert, the tokens each rank routed there (exact in
    # float32 below 2**24), gathered without gradient
    counts = axis.gather_rows(onehot.sum(1).detach())       # (D, G, E)
    before = counts[:axis.rank].sum(0)
    position = (onehot.cumsum(1) + before[:, None, :]) * onehot
    pos = position.sum(-1) - 1.0
    keep = (pos < cap) & (pos >= 0)
    slot = (pos.long()[..., None] == torch.arange(
        cap, device=tokens.device)).to(ftype)
    dispatch = onehot[..., None] * slot[..., None, :] \
        * keep[..., None, None].to(ftype)                   # (G, n, E, cap)
    combine = dispatch * gate[..., None, None]
    routed = counts.sum(0)                                  # (G, E)
    aux = e * ((routed / total) * probs.sum(1) / total).sum(-1)
    load = routed.clamp(max=cap)
    slots = torch.einsum("gnec,gnd->egcd", dispatch.to(dtype),
                         tokens.to(dtype))                  # (E, G, cap, C)
    if moe.experts is not None:
        # the owners' complete slots: every rank's, summed (zeros but its
        # own), then the local experts, then every rank's results
        mine = reduce_scatter(slots, axis)                  # (E/D, G, cap, C)
        outputs = expert_ffn(moe.w1, moe.b1, moe.w2, moe.b2,
                             mine.reshape(mine.shape[0], -1, c), dtype=dtype)
        outputs = all_gather(outputs, axis).view(e, g, cap, c)
    else:
        outputs = expert_ffn(moe.w1, moe.b1, moe.w2, moe.b2,
                             slots.reshape(e, -1, c),
                             dtype=dtype).view(e, g, cap, c)
    out = torch.einsum("gnec,egcd->gnd", combine.to(dtype), outputs)
    return out, aux, load
