"""Graph-attention layers (port of ``models/gat/layers.py``).

Initialisers are ``torch.nn.init``-style functions that fill a tensor in
place from an explicit ``torch.Generator``. A parameter of shape
``(..., fan_in, fan_out)`` treats its leading axes as a stack of independent
parameters (the head axis of a multi-head block, which the JAX package gets
from ``nn.vmap``): the fans come from the last two axes, as flax computes
them for one head.

The adjacency and score functions accept the same leading head axis, and
normalise each head's adjacency on its own, as ``vmap`` does.

The baseline models' layers (:class:`GraphAttentionLayer`,
:class:`GraphAttentionLayer2D` and their multi-head concatenations) have no
head axis: each head is a module ``attention_{i}`` holding ``W``, ``a``
and ``B`` in the reference's layout, so its ``model.pt`` loads with
``load_state_dict(strict=True)``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ...core.precision import cast_to, to_float32


@torch.no_grad()
def xavier_gain_1414(tensor: torch.Tensor,
                     generator: torch.Generator | None = None) -> torch.Tensor:
    """flax ``variance_scaling(1.414**2, "fan_avg", "uniform")``."""
    fan_in, fan_out = tensor.shape[-2], tensor.shape[-1]
    limit = math.sqrt(3.0 * 1.414**2 / ((fan_in + fan_out) / 2.0))
    return tensor.uniform_(-limit, limit, generator=generator)


@torch.no_grad()
def lecun_normal_(tensor: torch.Tensor, fan_in: int,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """flax ``lecun_normal()``: a normal truncated at two deviations,
    rescaled so the truncated draw has variance ``1 / fan_in``."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return torch.nn.init.trunc_normal_(tensor, 0.0, std, -2.0 * std,
                                       2.0 * std, generator=generator)


@torch.no_grad()
def adjacency_b_init(tensor: torch.Tensor,
                     generator: torch.Generator | None = None) -> torch.Tensor:
    return tensor.fill_(1e-6)


def normalized_adjacency(B_param: torch.Tensor) -> torch.Tensor:
    """(B + I) -> min-max normalise -> D^-1/2 A D^-1/2, per head over the
    last two axes."""
    v = B_param.shape[-1]
    adj = B_param + torch.eye(v, dtype=B_param.dtype, device=B_param.device)
    lo = adj.amin(dim=(-2, -1), keepdim=True)
    hi = adj.amax(dim=(-2, -1), keepdim=True)
    adj = (adj - lo) / (hi - lo)
    inv_sqrt = 1.0 / torch.sqrt(adj.sum(dim=-1))
    return adj * inv_sqrt[..., :, None] * inv_sqrt[..., None, :]


def pairwise_scores(Wh: torch.Tensor, a: torch.Tensor, alpha: float):
    """e[..., i, j] = leaky_relu(Wh_i . a1 + Wh_j . a2) over the second-to-
    last axis of Wh (..., M, E). a: (..., 2E), its leading axes broadcast
    against Wh's without the (M, E) pair."""
    e_dim = Wh.shape[-1]
    a1, a2 = a[..., :e_dim, None], a[..., e_dim:, None]
    s1 = (Wh @ a1)[..., 0]  # (..., M)
    s2 = (Wh @ a2)[..., 0]
    return F.leaky_relu(s1[..., :, None] + s2[..., None, :], alpha)


def _attention_params(module, in_features, out_features, n_vertices,
                      generator):
    """``W`` (in, out), ``a`` (2E, 1) and ``B`` (V, V): the flax layers'
    parameters, in the reference's layout (its ``model.pt`` loads as is)."""
    module.W = nn.Parameter(torch.empty(in_features, out_features))
    module.a = nn.Parameter(torch.empty(2 * out_features, 1))
    module.B = nn.Parameter(torch.empty(n_vertices, n_vertices))
    xavier_gain_1414(module.W, generator)
    xavier_gain_1414(module.a, generator)
    adjacency_b_init(module.B, generator)


class GraphAttentionLayer(nn.Module):
    """1-D GAT layer over vertices (port of ``layers.py:62-101``):
    (N, V, C) or (N, C, T, V), flattened to (N, V, C*T), -> (N, V, E)."""

    def __init__(self, in_features, out_features, n_vertices, alpha=0.2,
                 generator=None, dtype=torch.float32):
        super().__init__()
        self.alpha = alpha
        self.dtype = dtype
        _attention_params(self, in_features, out_features, n_vertices,
                          generator)

    def forward(self, h):
        if h.dim() == 4:
            n, c, t, v = h.shape
            h = h.permute(0, 3, 1, 2).reshape(n, v, c * t)
        # the product in ``dtype``, the attention in float32 (as in JAX)
        Wh = to_float32(cast_to(h, self.dtype)
                        @ cast_to(self.W, self.dtype))  # (N, V, E)
        e = pairwise_scores(Wh, self.a[:, 0], self.alpha)  # (N, V, V)
        attention = normalized_adjacency(self.B) @ torch.softmax(e, dim=-1)
        return F.elu(attention @ Wh)


class GATMultiHead(nn.Module):
    """``nheads`` :class:`GraphAttentionLayer` heads named ``attention_{i}``,
    concatenated on the feature axis (port of ``layers.py:104-128``)."""

    def __init__(self, nfeat, nhid, n_vertices, alpha=0.2, nheads=1,
                 generator=None, dtype=torch.float32):
        super().__init__()
        self.nheads = nheads
        for i in range(nheads):
            self.add_module(f"attention_{i}", GraphAttentionLayer(
                nfeat, nhid, n_vertices, alpha, generator, dtype))

    def forward(self, x):
        return torch.cat([getattr(self, f"attention_{i}")(x)
                          for i in range(self.nheads)], dim=-1)


class GraphAttentionLayer2D(nn.Module):
    """2-D GAT layer keeping (C, T) apart (port of ``layers.py:131-174``):
    (N, C, T, V) -> (N, C, E, V). As in the reference, the softmax runs
    over the feature axis C, and the adjacency mixes after the attention."""

    def __init__(self, in_features, out_features, n_vertices, alpha=0.2,
                 generator=None, dtype=torch.float32):
        super().__init__()
        self.alpha = alpha
        self.dtype = dtype
        _attention_params(self, in_features, out_features, n_vertices,
                          generator)

    def forward(self, h):
        Wh = to_float32(cast_to(h.permute(0, 3, 1, 2), self.dtype)
                        @ cast_to(self.W, self.dtype))  # (N, V, C, E)
        e_dim = self.W.shape[1]
        s1 = Wh @ self.a[:e_dim]  # (N, V, C, 1)
        s2 = Wh @ self.a[e_dim:]
        e = F.leaky_relu(s1[:, :, None, :, 0] + s2[:, None, :, :, 0],
                         self.alpha)  # (N, V, V, C)
        attention = torch.softmax(e, dim=-1)  # over C
        # h2[n, i, o, c] = sum_j Wh[n, j, c, o] * att[n, i, j, c]
        h2 = torch.einsum("njco,nijc->nioc", Wh, attention)
        h3 = torch.einsum("nioc,iv->ncov", h2, normalized_adjacency(self.B))
        return F.elu(h3)


class GATMultiHead2D(nn.Module):
    """``nheads`` :class:`GraphAttentionLayer2D` heads named
    ``attention_{i}``, concatenated on the E axis (port of
    ``layers.py:177-201``)."""

    def __init__(self, nfeat, nhid, n_vertices, alpha=0.2, nheads=1,
                 generator=None, dtype=torch.float32):
        super().__init__()
        self.nheads = nheads
        for i in range(nheads):
            self.add_module(f"attention_{i}", GraphAttentionLayer2D(
                nfeat, nhid, n_vertices, alpha, generator, dtype))

    def forward(self, x):
        return torch.cat([getattr(self, f"attention_{i}")(x)
                          for i in range(self.nheads)], dim=2)
