"""int8 x int8 -> int32 convolution, the product of the w8a8 generator.

Port of the integer convolution at ``extended_gan_tpu/serve/quantize.py``
(``lax.conv_general_dilated(xi, q, (1, 1), "SAME", ...,
preferred_element_type=int32)``). XLA computes it outside any Pallas kernel,
so here a library product does the work too: an im2col of the already
quantised activation (int8 views and one int8 copy), then ``torch._int_mm``,
cuBLASLt's integer tensor-core path. int8 goes in and int32 comes out: no
float value stands in for an integer on the card.

Layouts are the JAX package's: x (B, H, W, Cin) int8, the kernel (kh, kw,
Cin, Cout) int8 (HWIO), the result (B, H, W, Cout) int32; stride 1, SAME
padding as XLA pads it ((k - 1) // 2 before, k // 2 after: 1 and 2 for the
generator's 4x4 kernels).

``_int_mm`` on the card takes m > 16 rows and k and n in multiples of 8.
The product's depth is 16 Cin for a 4x4 kernel (a multiple of 8); the
generator's last two layers have Cout = 4, so n is zero-padded to 8, and
a batch of fewer than 17 pixels gets zero rows. Zero padding is exact in
integer arithmetic, and the padded rows and columns are cut off again.

- :func:`reference_int8_conv` is the plain version: the same im2col and a
  float64 product, which is exact here (every product and partial sum is
  an integer below 127 * 127 * K < 2**53). The CPU path runs it, and the
  card's product is held against it.
- :func:`int8_conv2d` runs ``_int_mm`` for CUDA tensors and the plain
  version for CPU tensors; there is no fallback from one to the other.

``launch_count`` counts the card's ``_int_mm`` calls (CPU calls do not
count).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

launch_count = 0

_MIN_ROWS = 17  # _int_mm on the card needs m > 16


def _check(xq, wq):
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"int8 operands expected, got {xq.dtype} and "
                        f"{wq.dtype}")
    if xq.dim() != 4 or wq.dim() != 4 or xq.shape[-1] != wq.shape[2]:
        raise ValueError(f"x {tuple(xq.shape)} (B, H, W, Cin) does not fit "
                         f"the kernel {tuple(wq.shape)} (kh, kw, Cin, Cout)")
    if xq.device != wq.device:
        raise ValueError(f"x on {xq.device}, the kernel on {wq.device}")


def _im2col(xq: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*H*W, kh*kw*C) rows of SAME-padded patches, in the
    kernel's (kh, kw, C) order; any dtype (views, then one copy)."""
    c = xq.shape[-1]
    top, left = (kh - 1) // 2, (kw - 1) // 2
    xp = F.pad(xq, (0, 0, left, kw - 1 - left, top, kh - 1 - top))
    patches = xp.unfold(1, kh, 1).unfold(2, kw, 1)  # (B, H, W, C, kh, kw)
    return patches.permute(0, 1, 2, 4, 5, 3).reshape(-1, kh * kw * c)


def reference_int8_conv(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The plain version: exact int32 accumulators from a float64 product."""
    _check(xq, wq)
    kh, kw, cin, cout = wq.shape
    cols = _im2col(xq, kh, kw).double()
    acc = cols @ wq.reshape(kh * kw * cin, cout).double()
    return acc.to(torch.int32).reshape(*xq.shape[:3], cout)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int8_conv2d(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """SAME, stride-1 conv of int8 x (B, H, W, Cin) with the int8 kernel
    (kh, kw, Cin, Cout) -> int32 (B, H, W, Cout)."""
    global launch_count
    _check(xq, wq)
    if xq.device.type == "cpu":
        return reference_int8_conv(xq, wq)
    if xq.device.type != "cuda":
        raise ValueError(f"unsupported device {xq.device}")
    kh, kw, cin, cout = wq.shape
    cols = _im2col(xq, kh, kw)
    m, k = cols.shape
    kp, n_p, mp = _round_up(k, 8), _round_up(cout, 8), max(m, _MIN_ROWS)
    if (mp, kp) != (m, k):
        cols = F.pad(cols, (0, kp - k, 0, mp - m))
    # the kernel as (n, k) rows, handed over transposed: the column-major
    # operand of cuBLASLt's int8 "TN" product
    w = wq.reshape(k, cout).t()
    if (n_p, kp) != (cout, k):
        w = F.pad(w, (0, kp - k, 0, n_p - cout))
    acc = torch._int_mm(cols, w.contiguous().t())
    launch_count += 1
    return acc[:m, :cout].reshape(*xq.shape[:3], cout)
