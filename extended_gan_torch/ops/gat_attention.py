"""Fused GAT attention (K1): the wrapper of ``csrc/gat_attention.cu``.

Port of ``extended_gan_tpu/ops/pallas/gat_attention.py``. Per (head, batch
element), on ``m`` of shape (M, P) with P = G * group_size (groups
contiguous): pooled-descriptor scores from ``a = [a1; a2]`` -> leaky_relu
-> row softmax -> adjacency mixing -> ELU(att @ m). The kernel reads ``m``
once per pass and writes ``out`` once; see the note at the top of the CUDA
source for its design and bound.

- :func:`reference_impl` is the plain PyTorch version (the JAX
  ``_reference_impl``, same signature and (B, M, P) layout, returning the
  kernel's four outputs). The CPU path runs it, and the card's kernel is
  held against it.
- :func:`fused_gat_attention` launches the kernel for CUDA tensors and runs
  the plain version for CPU tensors; there is no fallback from one to the
  other. It takes a leading head axis so one launch covers every head of a
  multi-head block, as the vmapped ``pallas_call`` does in JAX.
- :func:`attend_temporal` is the (B, H, W, T, V) layout wrapper.

``launch_count`` counts kernel launches (CPU calls do not count).
"""

from __future__ import annotations

import ctypes
import functools

import torch

launch_count = 0
_MAX_M = 8  # the CUDA entry point is instantiated for M = 1..8


def reference_impl(m, w1, w2, adj_norm, alpha, group_size):
    """Plain version: m (..., M, P); w1/w2 (..., 1, P) group-repeated rows;
    adj_norm (..., M, M). Returns (out, att0, att, pos), out like m and the
    others (..., M, M)."""
    s1 = torch.sum(m * w1, dim=-1, keepdim=True) / group_size  # (..., M, 1)
    s2 = torch.sum(m * w2, dim=-1, keepdim=True) / group_size
    e = s1 + s2.transpose(-1, -2)
    e = torch.where(e > 0, e, alpha * e)
    pos = (e > 0).to(m.dtype)
    att0 = torch.softmax(e, dim=-1)
    att = adj_norm @ att0
    out = att @ m
    return torch.where(out > 0, out, torch.expm1(out)), att0, att, pos


def fused_gat_attention(m, a, adj_norm, alpha, group_size):
    """m: (NH, B, M, P) float32 with P = G * group_size; a: (NH, 2G), per
    head [a1; a2] indexed by group; adj_norm: (NH, M, M) normalised
    adjacency. Returns (out, att0, att, pos): out (NH, B, M, P), the others
    (NH, B, M, M)."""
    nh, b, mm, p = m.shape
    if p % group_size:
        raise ValueError(f"P={p} is not a multiple of group_size={group_size}")
    g = p // group_size
    if a.shape != (nh, 2 * g) or adj_norm.shape != (nh, mm, mm):
        raise ValueError(f"a {tuple(a.shape)} / adj_norm "
                         f"{tuple(adj_norm.shape)} do not fit m {tuple(m.shape)}")
    if m.device.type == "cpu":
        w1 = a[:, :g].repeat_interleave(group_size, dim=1)[:, None, None, :]
        w2 = a[:, g:].repeat_interleave(group_size, dim=1)[:, None, None, :]
        return reference_impl(m, w1, w2, adj_norm[:, None], alpha, group_size)
    return _launch(m, a, adj_norm, float(alpha), group_size)


def _launch(m, a, adj_norm, alpha, group_size):
    global launch_count
    nh, b, mm, p = m.shape
    for name, t in (("m", m), ("a", a), ("adj_norm", adj_norm)):
        if t.device != m.device or t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 on {m.device}, got "
                            f"{t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 1 <= mm <= _MAX_M:
        raise ValueError(f"the kernel takes 1 <= M <= {_MAX_M}, got M={mm}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (m, a, adj_norm)):
        raise NotImplementedError(
            "the CUDA kernel has no backward yet (ROADMAP: training slice, "
            "K1 backward); run it under torch.no_grad()/inference_mode()")
    out = torch.empty_like(m)
    att0, att, pos = (m.new_empty((nh, b, mm, mm)) for _ in range(3))
    fn = _kernel()
    with torch.cuda.device(m.device):
        stream = torch.cuda.current_stream(m.device).cuda_stream
        rc = fn(m.data_ptr(), a.data_ptr(), adj_norm.data_ptr(),
                out.data_ptr(), att0.data_ptr(), att.data_ptr(),
                pos.data_ptr(), nh, b, mm, p, group_size, alpha, stream)
    if rc != 0:
        raise RuntimeError(f"gat_attention_fwd launch failed: CUDA error {rc}")
    launch_count += 1
    return out, att0, att, pos


@functools.cache
def _kernel():
    from .build import load

    fn = load("gat_attention").gat_attention_fwd
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 7 + [i32] * 5 + [ctypes.c_float, vp]
    fn.restype = i32
    return fn


def attend_temporal(mapped, a, adj_norm, alpha=0.2):
    """Temporal attention + ELU in the model's layout: mapped
    (B, H, W, T, V), a (2V,), adj_norm (T, T) already normalised; or all
    three with a leading head axis (NH, ...), which runs every head in one
    launch. Returns ELU(mixed) in the layout of ``mapped``."""
    heads = mapped.dim() == 6
    if not heads:
        mapped, a, adj_norm = mapped[None], a[None], adj_norm[None]
    nh, b, h, w, t, v = mapped.shape
    # (NH, B, H, W, T, V) -> (NH, B, T, V, H, W) -> (NH, B, T, V*HW):
    # groups are vertices, group_size = HW
    m = mapped.permute(0, 1, 4, 5, 2, 3).contiguous().view(nh, b, t, v * h * w)
    out = fused_gat_attention(m, a.contiguous(), adj_norm.contiguous(),
                              alpha, h * w)[0]
    out = out.view(nh, b, t, v, h, w).permute(0, 1, 4, 5, 2, 3)
    return out if heads else out[0]
