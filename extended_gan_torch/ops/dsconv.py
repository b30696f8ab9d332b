"""Fused depthwise-separable convolution (K3): the wrapper of ``csrc/dsconv.cu``.

Port of ``extended_gan_tpu/ops/pallas/dsconv.py``. Depthwise 3x3 (``kpl``
filters per input channel, grouped order: depthwise channel ``g*kpl + j``
reads input channel ``g``, which is torch's ``groups=C`` order) plus bias,
then pointwise 1x1 plus bias; SAME padding, stride 1, NHWC f32. The forward
kernel keeps the depthwise result on chip; see the note at the top of the
CUDA source for its design and bound. The TPU kernel's tile-order
permutation and VMEM rules (``_tile_order``, ``_fits_vmem``, ``_pick_tile``)
served the TPU's lane layout and memory and have no counterpart here: one
CUDA kernel takes every shape, with the slices of the depthwise channels
that :func:`_split_plan` picks.

- :func:`reference_dsc` is the plain PyTorch version (the JAX
  ``_reference_dsc``) and :func:`reference_dsc_backward` its gradient,
  written out as the 9 shifted sums (the JAX ``_bwd`` is ``jax.vjp`` of
  ``_reference_dsc``). The CPU path runs them, and the card's kernels are
  held against them.
- :func:`fused_dsconv` runs the forward kernel for CUDA tensors and the
  plain version for CPU tensors; its backward runs the backward kernel
  with two matrix products on the card and :func:`reference_dsc_backward`
  on the CPU. There is no fallback from one to the other.

``launch_count`` and ``bwd_launch_count`` count the forward and backward
kernels' launches (CPU calls do not count).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

launch_count = 0
bwd_launch_count = 0

_CHUNK = 32  # depthwise channels of the forward's inner loop (kTK)
_TILE = 128  # output pixels a forward block (kTM)
_COLS = 64  # output channels a forward block (kTN)
# The forward's two stages of x, (128 + 2W + 2) x 32 floats each, at most
# kMaxFwdSmem: images up to about 330 pixels wide.
_FWD_SMEM = (227 - 28) * 1024
# About two waves of forward blocks on an H100 SXM: 132 SMs, two blocks an
# SM (``__launch_bounds__(256, 2)``).
_FILL_BLOCKS = 2 * 132 * 2
# Backward blocks aimed at: two an SM over all channel groups, so that the
# per-block ddw partials stay few; each block's staged gd and x within
# _BWD_SMEM bytes of shared memory, so that two fit an SM.
_BWD_BLOCKS = 2 * 132
_BWD_SMEM = 100 * 1024
_BWD_WARPS = 16  # warps a backward block (kBwdThreads / 32)


def _depthwise(x, dw, dwb):
    """d (N, H, W, C*kpl): the depthwise 3x3 plus bias, as 9 shifted sums."""
    c, ckpl = x.shape[-1], dw.shape[-1]
    h, w = x.shape[1], x.shape[2]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    x_rep = xp.repeat_interleave(ckpl // c, dim=-1) if ckpl != c else xp
    acc = torch.zeros(x.shape[:3] + (ckpl,), dtype=torch.float32,
                      device=x.device)
    for di in range(3):
        for dj in range(3):
            acc = acc + x_rep[:, di:di + h, dj:dj + w, :] * dw[di, dj]
    return acc + dwb


def reference_dsc(x, dw, dwb, pw, pwb):
    """Plain version: x (N, H, W, C); dw (3, 3, C*kpl) grouped order; dwb
    (C*kpl,); pw (C*kpl, Cout); pwb (Cout,). Returns (N, H, W, Cout)."""
    return _depthwise(x, dw, dwb) @ pw + pwb


def reference_depthwise_backward(gd, x, dw, need_dx=True):
    """Plain version of the backward kernel: from gd = dL/dd (N, H, W, CK),
    (dx or None, ddw (3, 3, CK), ddwb (CK,)), as 9 shifted sums each."""
    n, h, w, c = x.shape
    ckpl = dw.shape[-1]
    kpl = ckpl // c
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    x_rep = xp.repeat_interleave(kpl, dim=-1) if kpl > 1 else xp
    ddw = torch.stack([(x_rep[:, di:di + h, dj:dj + w, :] * gd).sum((0, 1, 2))
                       for di in range(3) for dj in range(3)]).view(3, 3, ckpl)
    dx = None
    if need_dx:
        # the transposed stencil: tap (di, dj) reads gd at (h-di+1, w-dj+1)
        gp = F.pad(gd, (0, 0, 1, 1, 1, 1))
        acc = torch.zeros_like(gd)
        for di in range(3):
            for dj in range(3):
                acc = acc + gp[:, 2 - di:2 - di + h, 2 - dj:2 - dj + w, :] \
                    * dw[di, dj]
        dx = acc.view(n, h, w, c, kpl).sum(-1)
    return dx, ddw, gd.sum((0, 1, 2))


def reference_dsc_backward(x, dw, dwb, pw, g, need_dx=True):
    """Plain gradient of :func:`reference_dsc` for the cotangent g (N, H, W,
    Cout): (dx or None, ddw, ddwb, dpw, dpwb)."""
    ckpl, cout = pw.shape
    d = _depthwise(x, dw, dwb)
    g2 = g.reshape(-1, cout)
    gd = (g2 @ pw.t()).view(d.shape)
    dx, ddw, ddwb = reference_depthwise_backward(gd, x, dw, need_dx)
    return dx, ddw, ddwb, d.reshape(-1, ckpl).t() @ g2, g2.sum(0)


class _FusedDSConv(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the plain version (CPU). Backward: two
    matrix products and the backward kernel (CUDA), or
    :func:`reference_dsc_backward` (CPU)."""

    @staticmethod
    def forward(ctx, x, dw, dwb, pw, pwb, keep_d):
        if x.device.type == "cpu":
            out, d = reference_dsc(x, dw, dwb, pw, pwb), None
        else:
            out, d = _launch(x, dw, dwb, pw, pwb, keep_d=keep_d)
        ctx.save_for_backward(x, dw, dwb, pw, d)
        return out

    @staticmethod
    def backward(ctx, g):
        x, dw, dwb, pw, d = ctx.saved_tensors
        needs = ctx.needs_input_grad[:5]
        if x.device.type == "cpu":
            grads = reference_dsc_backward(x, dw, dwb, pw, g,
                                           need_dx=needs[0])
        else:
            grads = _backward_cuda(x, dw, pw, d, g, needs)
        return tuple(t if n else None for t, n in zip(grads, needs)) + (None,)


def _backward_cuda(x, dw, pw, d, g, needs):
    """(dx, ddw, ddwb, dpw, dpwb) on the card, each None where ``needs``
    says so. dpw = d^T g and gd = g pw^T are plain matrix products, which
    the JAX package leaves to XLA: torch.matmul runs them in exact f32 as
    long as torch.backends.cuda.matmul.allow_tf32 is False (torch's
    default, which the parity checks keep). The backward kernel takes gd."""
    ckpl, cout = pw.shape
    g2 = g.reshape(-1, cout)
    dpw = d.view(-1, ckpl).t() @ g2 if needs[3] else None
    dpwb = g2.sum(0) if needs[4] else None
    dx = ddw = ddwb = None
    if any(needs[:3]):
        gd = (g2 @ pw.t()).view(x.shape[:3] + (ckpl,))
        dx, ddw, ddwb = _launch_bwd(gd, x, dw, need_dx=needs[0])
    return dx, ddw, ddwb, dpw, dpwb


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
    # the forward kernel writes d for dpw only when autograd will ask for it
    keep_d = torch.is_grad_enabled() and pw.requires_grad
    return _FusedDSConv.apply(x, dw, dwb, pw, pwb, keep_d)


def _cdiv(a, b):
    return -(-a // b)


def _split_plan(n, h, w, c, ck, cout):
    """ks: the depthwise channels of each slice of CK, a whole number of
    32-channel chunks; slice s is [s*ks, min((s+1)*ks, CK)), so the slices
    cover CK exactly. One slice (ks covers CK) where the grid of 128-pixel
    by 64-channel tiles already holds about two waves; else enough slices
    to bring it there, with at least two chunks a slice (more, and adding
    the slices' partial sums costs more than the blocks gain)."""
    blocks = _cdiv(n * h * w, _TILE) * _cdiv(cout, _COLS)
    chunks = _cdiv(ck, _CHUNK)
    if blocks >= _FILL_BLOCKS or chunks < 4:
        return chunks * _CHUNK
    per = max(2, chunks // _cdiv(_FILL_BLOCKS, blocks))
    return per * _CHUNK


def _bwd_plan(n, h, w, c, ck):
    """(cc, ppw, blocks) of the backward kernel: input channels a block
    (its cc * kpl depthwise channels fill at most a warp's 32 lanes), pixels
    a lane, and pixel runs (16 warps x ppw x the warp's pixel slots each).
    A block stages its run and the taps around it, run + 2W + 2 rows of cc *
    (kpl + 1) floats (``bwd_smem_bytes`` in the CUDA source), within
    _BWD_SMEM: images up to 190 (kpl = 1) to 250 (kpl = 2) pixels wide."""
    kpl = ck // c
    cc = min(c, 32 // kpl)
    slots = 32 // (cc * kpl)
    runs = max(1, _BWD_BLOCKS // _cdiv(c, cc))
    m = n * h * w
    rows = _BWD_SMEM // (4 * cc * (kpl + 1))
    fit = (rows - 2 * w - 2) // (_BWD_WARPS * slots)
    if fit < 1:
        raise ValueError(f"rows of width {w} are too wide for the backward "
                         f"kernel's staged taps ({_BWD_SMEM} bytes a block)")
    ppw = min(64, fit, max(1, _cdiv(m, runs * _BWD_WARPS * slots)))
    return cc, ppw, _cdiv(m, _BWD_WARPS * ppw * slots)


def _check(named, device):
    for name, t in named:
        if t.device != device or t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 on {device}, got "
                            f"{t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(x, dw, dwb, pw, pwb, *, keep_d=False, ks=None):
    """(out, d or None). ``ks``: channels a slice of CK in place of
    :func:`_split_plan`'s."""
    global launch_count
    out, d, _ws, args = fwd_args(x, dw, dwb, pw, pwb, keep_d=keep_d, ks=ks)
    call(_lib().dsconv_fwd, x.device, args)
    launch_count += 1
    return out, d


def _launch_bwd(gd, x, dw, *, need_dx):
    """(dx or None, ddw (3, 3, CK), ddwb (CK,)) from gd (N, H, W, CK)."""
    global bwd_launch_count
    dx, grads, _part, args = bwd_args(gd, x, dw, need_dx=need_dx)
    call(_lib().dsconv_bwd, x.device, args)
    bwd_launch_count += 1
    return dx, grads[:9].view(3, 3, dw.shape[-1]), grads[9]


def fwd_args(x, dw, dwb, pw, pwb, *, keep_d=False, ks=None):
    """Checks the forward's inputs and allocates its outputs and scratch:
    (out, d or None, the slices' workspace or None, the arguments of the C
    entry point ``dsconv_fwd`` but its stream). The caller holds the
    tensors until the launch."""
    _check((("x", x), ("dw", dw), ("dwb", dwb), ("pw", pw), ("pwb", pwb)),
           x.device)
    n, h, w, c = x.shape
    ckpl, cout = dw.shape[-1], pw.shape[-1]
    if x.numel() == 0:
        raise ValueError(f"x {tuple(x.shape)} is empty")
    ks = ks or _split_plan(n, h, w, c, ckpl, cout)
    if 2 * (_TILE + 2 * w + 2) * _CHUNK * 4 > _FWD_SMEM:
        raise ValueError(f"rows of width {w} are too wide for the forward "
                         f"kernel's staged x ({_FWD_SMEM} bytes a block)")
    slices = _cdiv(ckpl, ks)
    out = x.new_empty((n, h, w, cout))
    d = x.new_empty((n, h, w, ckpl)) if keep_d else None
    ws = x.new_empty((slices, n * h * w, cout)) if slices > 1 else None
    return out, d, ws, (x.data_ptr(), dw.data_ptr(), dwb.data_ptr(),
                        pw.data_ptr(), pwb.data_ptr(), out.data_ptr(),
                        _ptr(d), _ptr(ws), n, h, w, c, ckpl, cout, ks)


def bwd_args(gd, x, dw, *, need_dx):
    """Checks the backward's inputs and allocates its outputs and scratch:
    (dx or None, grads (10, CK): ddw's 9 taps then ddwb, the blocks'
    partials, the arguments of the C entry point ``dsconv_bwd`` but its
    stream). The caller holds the tensors until the launch."""
    _check((("gd", gd), ("x", x), ("dw", dw)), x.device)
    n, h, w, c = x.shape
    ckpl = dw.shape[-1]
    if gd.shape != x.shape[:3] + (ckpl,):
        raise ValueError(f"gd {tuple(gd.shape)} does not fit x "
                         f"{tuple(x.shape)} and CK = {ckpl}")
    if ckpl // c > 32:
        raise ValueError(f"kpl = {ckpl // c}: the backward kernel takes at "
                         "most 32 depthwise channels an input channel")
    cc, ppw, blocks = _bwd_plan(n, h, w, c, ckpl)
    part = x.new_empty((blocks, 10, ckpl))
    grads = x.new_empty((10, ckpl))
    dx = torch.empty_like(x) if need_dx else None
    return dx, grads, part, (gd.data_ptr(), x.data_ptr(), dw.data_ptr(),
                             _ptr(dx), part.data_ptr(), grads.data_ptr(), n,
                             h, w, c, ckpl, cc, ppw, blocks)


def call(entry, device, args):
    """Runs a C entry point of ``dsconv.cu`` on the current stream of
    ``device``; raises if it reports a CUDA error."""
    with torch.cuda.device(device):
        rc = entry(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry.__name__} launch failed: CUDA error {rc}")


def _ptr(t):
    return None if t is None else t.data_ptr()


@functools.cache
def _lib():
    from .build import load

    return bind(load("dsconv"))


def bind(lib):
    """Declares the C entry points of a library built from ``dsconv.cu``."""
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.dsconv_fwd.argtypes = [vp] * 8 + [i32] * 7 + [vp]
    lib.dsconv_bwd.argtypes = [vp] * 6 + [i32] * 8 + [vp]
    for fn in (lib.dsconv_fwd, lib.dsconv_bwd):
        fn.restype = i32
    return lib
