"""Autoregressive multi-horizon rollout (port of ``serve/rollout.py``).

Every frame-prediction model here maps a context window to an equally
shaped prediction window; a K-step rollout feeds each prediction back as
the next context. The JAX package compiles the K steps into one
``lax.scan`` program; PyTorch runs eagerly, so here it is a Python loop
whose device work is queued without a host round trip between steps.
"""

from __future__ import annotations

from typing import Callable

import torch


def make_rollout(fwd: Callable, steps: int, concat_axis: int | None = None,
                 final_only: bool = False) -> Callable:
    """Wrap a shape-preserving ``fwd`` into a K-step rollout.

    ``rolled(x)`` returns the stacked horizon ``(B, steps, *x.shape[1:])``
    (window k at index k); with ``concat_axis``, the windows concatenated
    along that axis of ``x`` (``-2`` for the GAT (B, H, W, T, V) layout);
    with ``final_only``, window K alone, shaped like ``x``.
    """
    if steps < 1:
        raise ValueError(f"rollout steps must be >= 1, got {steps}")
    if final_only and concat_axis is not None:
        raise ValueError("final_only emits one window; concat_axis "
                         "does not apply")

    def rolled(x):
        if concat_axis is not None:
            if not -x.ndim <= concat_axis < x.ndim:
                raise ValueError(f"concat_axis {concat_axis} out of range "
                                 f"for a {x.ndim}-d input")
            if concat_axis % x.ndim == 0:
                raise ValueError("concat_axis cannot be the batch axis")
        windows = []
        h = x
        for _ in range(steps):
            y = fwd(h)
            if y.shape != h.shape:
                raise ValueError(
                    f"rollout needs a shape-preserving forward; got "
                    f"{tuple(h.shape)} -> {tuple(y.shape)}")
            h = y
            if not final_only:
                windows.append(y)
        if final_only:
            return h
        if concat_axis is None:
            return torch.stack(windows, dim=1)
        return torch.cat(windows, dim=concat_axis)

    return rolled
