"""Switch-style mixture-of-experts FFN over a feature map's tokens (port of
``extended_gan_tpu/models/moe.py``).

Top-1 routing with a static per-expert capacity; dispatch and combine are
one-hot products (``(..., tokens, E, capacity)``), as in JAX: plain batched
matrix products, no gather or scatter, so every shape is fixed and the
step captures into a CUDA graph. Tokens past an expert's capacity are
dropped (the expert adds nothing; they pass through the residual). The
load-balance loss is Switch's ``E * sum_e f_e * p_e``.

Both one-hots are comparisons against an ``arange``: ``F.one_hot`` raises
on a position past the capacity (``jax.nn.one_hot`` gives a row of zeros,
which the ``keep`` mask zeroes anyway) and checks its input's range with a
host sync on the card, which a graph capture refuses.

Routing groups. Routing depends on which tokens share a queue, so
:class:`SwitchMoE` routes groups of rows of its (N, C, h, w) input apart,
each with the capacity of its own size, and sums the groups' losses. Its
``group = (stride, span)`` names them: row ``r`` is in lane ``r % stride``,
and a group is ``span`` consecutive rows of one lane (``span`` 0: all of
them). ``(1, 0)``, the default, routes the whole batch as one group; the
model that holds the module sets the geometry of its own layout.

Tokens are taken in (row, h, w) order within a group, as JAX flattens its
NHWC map; the queue positions, and so the drops, follow that order.

bf16 (``core/precision.py``), op for op as in JAX: the router's product,
softmax, argmax and the loss run in float32 (in float64 for float64
tokens, where JAX stays in float32); dispatch, the experts' FFN
and combine run in the module's dtype (the gate rounded to it in combine);
the output is cast to the input's dtype before the residual.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from .gat.layers import lecun_normal_


def expert_capacity(n_tokens: int, n_experts: int,
                    capacity_factor: float) -> int:
    """Static per-expert token capacity (at least 1)."""
    return max(1, math.ceil(capacity_factor * n_tokens / n_experts))


def _onehot(index: torch.Tensor, n: int,
            dtype=torch.float32) -> torch.Tensor:
    """One-hot of ``index`` over ``n`` classes; an index outside [0, n)
    gives a row of zeros."""
    return (index[..., None] == torch.arange(
        n, device=index.device, dtype=index.dtype)).to(dtype)


def route_top1(tokens: torch.Tensor, router_w: torch.Tensor, capacity: int):
    """Top-1 capacity-bounded routing of ``tokens`` (..., N, C) (leading
    axes are groups routed apart) with ``router_w`` (C, E), in float32
    (float64 for float64 tokens: a float64 twin routes in float64).

    Returns ``dispatch`` (..., N, E, capacity) 0/1, ``combine`` (dispatch
    times the router's gate) and ``aux`` (...,), the load-balance loss (1
    at uniform routing)."""
    e = router_w.shape[-1]
    ftype = torch.promote_types(tokens.dtype, torch.float32)
    logits = tokens.to(ftype) @ router_w.to(ftype)
    probs = torch.softmax(logits, dim=-1)                   # (..., N, E)
    onehot = _onehot(probs.argmax(dim=-1), e, ftype)
    gate = (probs * onehot).sum(-1)                         # (..., N)
    # each token's place in its expert's queue, in token order
    position = onehot.cumsum(dim=-2) * onehot               # 1-based
    pos = position.sum(-1) - 1.0
    keep = (pos < capacity) & (pos >= 0)
    pos_onehot = _onehot(pos.long(), capacity, ftype)
    dispatch = onehot[..., :, None] * pos_onehot[..., None, :]
    dispatch = dispatch * keep[..., None, None].to(ftype)
    combine = dispatch * gate[..., None, None]
    fraction = onehot.mean(dim=-2)                          # (..., E)
    mean_prob = probs.mean(dim=-2)
    aux = e * (fraction * mean_prob).sum(-1)
    return dispatch, combine, aux


def expert_ffn(w1, b1, w2, b2, expert_inputs, dtype=torch.float32):
    """Every expert's 2-layer ReLU MLP on its slots: ``expert_inputs``
    (..., E, capacity, C) with w1 (E, C, H), b1 (E, H), w2 (E, H, C), b2
    (E, C), one batched product a layer."""
    x = expert_inputs.to(dtype)
    h = torch.einsum("...ecd,edh->...ech", x, w1.to(dtype)) + \
        b1.to(dtype)[:, None, :]
    h = F.relu(h)
    return torch.einsum("...ech,ehd->...ecd", h, w2.to(dtype)) + \
        b2.to(dtype)[:, None, :]


def moe_apply_dense(params: dict, tokens: torch.Tensor, capacity: int,
                    dtype=torch.float32):
    """Route, dispatch, the experts' FFN and combine. ``params`` holds
    ``router`` (C, E) and ``w1``, ``b1``, ``w2``, ``b2``. Returns ``(out
    (..., N, C), aux (...,), load (..., E))``: ``out`` without the residual,
    ``load`` the tokens each expert kept (a diagnostic, not a loss)."""
    dispatch, combine, aux = route_top1(tokens, params["router"], capacity)
    expert_inputs = torch.einsum("...nec,...nd->...ecd", dispatch.to(dtype),
                                 tokens.to(dtype))
    expert_outputs = expert_ffn(params["w1"], params["b1"], params["w2"],
                                params["b2"], expert_inputs, dtype=dtype)
    out = torch.einsum("...nec,...ecd->...nd", combine.to(dtype),
                       expert_outputs)
    return out, aux, dispatch.sum(dim=(-3, -1))


class SwitchMoE(nn.Module):
    """``y = x + MoE(tokens of x)`` on an NCHW map of ``channels``. The
    weights are the flax tree's, in its layouts: ``router`` (C, E), ``w1``
    (E, C, H), ``b1`` (E, H), ``w2`` (E, H, C), ``b2`` (E, C), H =
    ``hidden_mult`` C; flax's ``lecun_normal`` counts the expert axis as a
    receptive field, so w1's fan in is E*C and w2's E*H.

    ``group`` sets the routing groups (the module docstring); their owner
    sets it. Inside :func:`sow_moe` every forward appends ``(aux, load)``:
    its groups' summed loss and the tokens each expert kept. Under the
    float32 policy the experts run in the input's dtype (a float64 twin
    stays float64), under another policy in that dtype."""

    def __init__(self, channels, num_experts=8, hidden_mult=2,
                 capacity_factor=1.25, generator=None, dtype=torch.float32):
        super().__init__()
        c, e, hid = channels, num_experts, channels * hidden_mult
        self.num_experts = e
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        self.router = nn.Parameter(torch.empty(c, e))
        self.w1 = nn.Parameter(torch.empty(e, c, hid))
        self.b1 = nn.Parameter(torch.zeros(e, hid))
        self.w2 = nn.Parameter(torch.empty(e, hid, c))
        self.b2 = nn.Parameter(torch.zeros(e, c))
        lecun_normal_(self.router, c, generator)
        lecun_normal_(self.w1, e * c, generator)
        lecun_normal_(self.w2, e * hid, generator)
        self.group = (1, 0)
        self.sown = None

    def grouped_tokens(self, x):
        """(N, C, h, w) -> (groups, tokens a group, C), each group's tokens
        in (row, h, w) order."""
        n, c, h, w = x.shape
        stride, span = self.group
        span = span or n // stride
        t = x.permute(0, 2, 3, 1).reshape(n // (stride * span), span, stride,
                                          h * w, c)
        return t.transpose(1, 2).reshape(-1, span * h * w, c)

    def forward(self, x):  # (N, C, h, w) -> (N, C, h, w)
        n, c, h, w = x.shape
        grouped = self.grouped_tokens(x)
        cap = expert_capacity(grouped.shape[1], self.num_experts,
                              self.capacity_factor)
        params = {"router": self.router, "w1": self.w1, "b1": self.b1,
                  "w2": self.w2, "b2": self.b2}
        dtype = x.dtype if self.dtype == torch.float32 else self.dtype
        out, aux, load = moe_apply_dense(params, grouped, cap, dtype=dtype)
        if self.sown is not None:
            self.sown.append((aux.sum(), load.sum(0)))
        stride, span = self.group
        span = span or n // stride
        out = out.reshape(-1, stride, span, h * w, c).transpose(1, 2)
        out = out.reshape(n, h, w, c).to(x.dtype)
        return x + out.permute(0, 3, 1, 2)


def moe_layers(model: nn.Module) -> list:
    """Every :class:`SwitchMoE` of ``model``."""
    return [m for m in model.modules() if isinstance(m, SwitchMoE)]


@contextlib.contextmanager
def sow_moe(layers):
    """Collect ``(aux, load)`` of every forward of ``layers`` (the JAX
    package's ``"losses"`` and ``"routing"`` collections) into the list it
    yields; outside it nothing is kept (a forward recomputed under remat
    adds nothing)."""
    sown = []
    for m in layers:
        m.sown = sown
    try:
        yield sown
    finally:
        for m in layers:
            m.sown = None
