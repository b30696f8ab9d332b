"""Fused depthwise-separable convolution (K3): the wrapper of ``csrc/dsconv.cu``.

Port of ``extended_gan_tpu/ops/pallas/dsconv.py``. Depthwise 3x3 (``kpl``
filters per input channel, grouped order: depthwise channel ``g*kpl + j``
reads input channel ``g``, which is torch's ``groups=C`` order) plus bias,
then pointwise 1x1 plus bias; SAME padding, stride 1, NHWC f32. The kernel
keeps the depthwise result on chip; see the note at the top of the CUDA
source for its design and bound. The TPU kernel's tile-order permutation
and VMEM rules (``_tile_order``, ``_fits_vmem``, ``_pick_tile``) served the
TPU's lane layout and memory and have no counterpart here: one CUDA kernel
takes every shape.

- :func:`reference_dsc` is the plain PyTorch version (the JAX
  ``_reference_dsc``). The CPU path runs it, the card's kernel is held
  against it, and the backward is its autograd, as the JAX ``_bwd`` is the
  ``jax.vjp`` of ``_reference_dsc``.
- :func:`fused_dsconv` launches the kernel for CUDA tensors and runs the
  plain version for CPU tensors; there is no fallback from one to the other.

``launch_count`` counts kernel launches (CPU calls and backwards do not).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

launch_count = 0


def reference_dsc(x, dw, dwb, pw, pwb):
    """Plain version: x (N, H, W, C); dw (3, 3, C*kpl) grouped order; dwb
    (C*kpl,); pw (C*kpl, Cout); pwb (Cout,). Returns (N, H, W, Cout)."""
    c, ckpl = x.shape[-1], dw.shape[-1]
    h, w = x.shape[1], x.shape[2]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    x_rep = xp.repeat_interleave(ckpl // c, dim=-1) if ckpl != c else xp
    acc = torch.zeros(x.shape[:3] + (ckpl,), dtype=torch.float32,
                      device=x.device)
    for di in range(3):
        for dj in range(3):
            acc = acc + x_rep[:, di:di + h, dj:dj + w, :] * dw[di, dj]
    acc = acc + dwb
    return acc @ pw + pwb


class _FusedDSConv(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the plain version (CPU). Backward: the
    autograd of the plain version on the saved inputs, on either device."""

    @staticmethod
    def forward(ctx, x, dw, dwb, pw, pwb):
        ctx.save_for_backward(x, dw, dwb, pw, pwb)
        if x.device.type == "cpu":
            return reference_dsc(x, dw, dwb, pw, pwb)
        return _launch(x, dw, dwb, pw, pwb)

    @staticmethod
    def backward(ctx, grad):
        needs = ctx.needs_input_grad
        inputs = [t.detach().requires_grad_(n)
                  for t, n in zip(ctx.saved_tensors, needs)]
        with torch.enable_grad():
            out = reference_dsc(*inputs)
        grads = iter(torch.autograd.grad(
            out, [t for t, n in zip(inputs, needs) if n], grad))
        return tuple(next(grads) if n else None for n in needs)


def fused_dsconv(x, dw, dwb, pw, pwb):
    """Depthwise 3x3 (+bias) -> pointwise 1x1 (+bias), SAME, stride 1, f32.
    Shapes as :func:`reference_dsc`; differentiable in every input."""
    n, h, w, c = x.shape
    ckpl, cout = dw.shape[-1], pw.shape[-1]
    if dw.shape != (3, 3, ckpl) or ckpl % c or dwb.shape != (ckpl,) \
            or pw.shape != (ckpl, cout) or pwb.shape != (cout,):
        raise ValueError(
            f"dw {tuple(dw.shape)}, dwb {tuple(dwb.shape)}, pw "
            f"{tuple(pw.shape)}, pwb {tuple(pwb.shape)} do not fit x "
            f"{tuple(x.shape)}: want (3, 3, C*kpl), (C*kpl,), (C*kpl, Cout), "
            f"(Cout,)")
    return _FusedDSConv.apply(x, dw, dwb, pw, pwb)


def _launch(x, dw, dwb, pw, pwb):
    global launch_count
    for name, t in (("x", x), ("dw", dw), ("dwb", dwb), ("pw", pw),
                    ("pwb", pwb)):
        if t.device != x.device or t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 on {x.device}, got "
                            f"{t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n, h, w, c = x.shape
    ckpl, cout = dw.shape[-1], pw.shape[-1]
    if x.numel() == 0:
        raise ValueError(f"x {tuple(x.shape)} is empty")
    out = x.new_empty((n, h, w, cout))
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), dw.data_ptr(), dwb.data_ptr(), pw.data_ptr(),
                pwb.data_ptr(), out.data_ptr(), n, h, w, c, ckpl, cout, stream)
    if rc != 0:
        raise RuntimeError(f"dsconv_fwd launch failed: CUDA error {rc}")
    launch_count += 1
    return out


@functools.cache
def _kernel():
    from .build import load

    fn = load("dsconv").dsconv_fwd
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 6 + [i32] * 6 + [vp]
    fn.restype = i32
    return fn
