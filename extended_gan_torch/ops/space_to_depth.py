"""2x2 space-to-depth for the DCGAN generator's stride-1 4x4 convs (port of
``extended_gan_tpu/ops/space_to_depth.py``).

A (B, C, H, W) map is viewed as (B, 4C, H/2, W/2): each 2x2 block of
pixels becomes four channel groups, phase-major (packed channel ``(2 dy +
dx) C + c``, the JAX package's order; ``F.pixel_unshuffle`` is
channel-major and does not match it). A stride-1 "same" 4x4 conv (pads 1
before, 2 after) is then a stride-1 3x3 conv of the packed map with pads
(1, 1) and 4x the input and output channels: the same linear map, its
extra taps multiplying structural zeros, so only the summation order
differs.

Derivation (:func:`pack_conv_weights`): output phase p at packed cell i is
output pixel 2i + p = sum_k w[k] x[2i + p + k - 1]; writing that input
pixel as packed cell i + u, phase q gives k = 2u + q - p + 1, and u spans
{-1, 0, 1}: three packed taps.

:func:`packed_conv_same` is the JAX package's ``lax.conv_general_dilated``,
not a Pallas kernel, so the port runs it as a cuDNN convolution.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F


def pack2(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, 4C, H/2, W/2), phase-major channels."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // 2, 2, w // 2, 2)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(b, 4 * c, h // 2, w // 2)


def unpack2(xp: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack2`."""
    b, c4, h2, w2 = xp.shape
    c = c4 // 4
    x = xp.reshape(b, 2, 2, c, h2, w2)
    return x.permute(0, 3, 4, 1, 5, 2).reshape(b, c, 2 * h2, 2 * w2)


@functools.cache
def _selector(device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """S[a, q, p, k] = 1 iff k == 2 (a - 1) + q - p + 1 (a: packed tap, q:
    input phase, p: output phase, k: the 4x4 kernel's tap), made on
    ``device`` from ``arange`` s, with no copy from the host (a CUDA graph
    may capture it)."""
    a, q, p, k = (torch.arange(n, device=device).view(
        [n if i == j else 1 for j in range(4)])
        for i, n in enumerate((3, 2, 2, 4)))
    return (k == 2 * (a - 1) + q - p + 1).to(dtype)


def pack_conv_weights(w: torch.Tensor) -> torch.Tensor:
    """OIHW (Cout, Cin, 4, 4) -> (4 Cout, 4 Cin, 3, 3): a 0/1 einsum, so
    gradients flow back to the 4x4 kernel. Output channel ``(2 py + px)
    Cout + o``, input channel ``(2 qy + qx) Cin + i``."""
    cout, cin = w.shape[:2]
    s = _selector(w.device, w.dtype)
    # a, b: packed taps; q, r: input phases (y, x); p, t: output phases
    wp = torch.einsum("aqpk,brtl,oikl->ptoqriab", s, s, w)
    return wp.reshape(4 * cout, 4 * cin, 3, 3)


def packed_conv_same(xp: torch.Tensor, wp: torch.Tensor,
                     bias: torch.Tensor | None = None) -> torch.Tensor:
    """Stride-1 conv of a packed map with packed weights, pads (1, 1);
    ``bias`` (4 Cout,), phase-major, as ``bias.repeat(4)`` gives it."""
    return F.conv2d(xp, wp, bias, padding=1)
