"""Graph-attention building blocks (port of ``models/gat/layers.py:31-59``).

Initialisers are ``torch.nn.init``-style functions that fill a tensor in
place from an explicit ``torch.Generator``. A parameter of shape
``(..., fan_in, fan_out)`` treats its leading axes as a stack of independent
parameters (the head axis of a multi-head block, which the JAX package gets
from ``nn.vmap``): the fans come from the last two axes, as flax computes
them for one head.

The adjacency and score functions accept the same leading head axis, and
normalise each head's adjacency on its own, as ``vmap`` does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


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
