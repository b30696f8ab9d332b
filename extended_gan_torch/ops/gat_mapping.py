"""Fused conv-mapping bottleneck (K2): the wrapper of ``csrc/gat_mapping.cu``.

Port of ``extended_gan_tpu/ops/pallas/gat_mapping.py``. Per head, on images
of ``Cin`` channels: conv 3x3 (Cin -> F) + ReLU -> conv 1x1 (F -> F) + ReLU
-> conv 3x3 (F -> Cout), SAME padding, stride 1, exact f32. The kernels keep
the F-wide intermediates on chip; see the note at the top of the CUDA source
for their design and bound. The TPU kernels' row layout (``_geom``,
``_pack``, ``_unpack``, ``_row_mask`` and the 23-row zero apron) and
``_pick_tile``'s VMEM rule served Mosaic's 2-D matmuls and the TPU's memory
and have no counterpart here: the CUDA kernels read the images where they
lie and tile them spatially.

- :func:`reference_bottleneck` is the plain PyTorch version: the conv
  composition of the JAX package's ``nn.Conv`` path (``gat3d.py:170-180``),
  run as grouped ``F.conv2d`` over the heads. The CPU path runs it, the
  card's kernels are held against it, and GAT3D's conv mapping runs it when
  ``use_pallas_mapping`` is off.
- :func:`fused_conv_bottleneck` is a ``torch.autograd.Function``: CUDA
  tensors go to the kernels, forward and backward; CPU tensors go to the
  plain version and its autograd. Neither falls back to the other. Its
  weights carry a leading head axis and every head reads the same ``x``, so
  one launch covers every head of a multi-head block, as ``jax.vmap`` over
  the ``custom_vjp`` does in JAX. ``dx`` sums the heads' input gradients and
  is computed only when ``x`` needs one.

Layouts: ``x`` is (N, H, W, Cin), or GAT3D's (B, H, W, Cin, V) with image
``b * V + v``; the output is (NH, N, H, W, Cout), or (NH, B, H, W, Cout, V).
Weights are torch's OIHW behind the head axis: w1 (NH, F, Cin, 3, 3), b1
(NH, F), w2 (NH, F, F, 1, 1), b2 (NH, F), w3 (NH, Cout, F, 3, 3), b3
(NH, Cout).

``fwd_launch_count`` and ``bwd_launch_count`` count kernel launches (CPU
calls do not count); the backward is itself a kernel here.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

fwd_launch_count = 0
bwd_launch_count = 0
_MAX_C = 8  # Cin and Cout the kernels take (kMaxC)
_MAX_F_FWD = 80  # hidden width the forward kernel takes (kMaxFwdF)
_SMEM_LIMIT = 232448  # shared memory one block can have on Hopper


def reference_bottleneck(x, w1, b1, w2, b2, w3, b3):
    """Plain version, in the layouts of the module docstring."""
    nh, f = b1.shape
    cout = b3.shape[1]
    if x.dim() == 5:
        b, h, w, c, v = x.shape
        # fold V into the batch: (B, H, W, C, V) -> (B*V, C, H, W)
        xb = x.permute(0, 4, 3, 1, 2).reshape(b * v, c, h, w)
    else:
        _, h, w, c = x.shape
        xb = x.permute(0, 3, 1, 2)
    if nh > 1:  # one copy of the channels per head for the grouped convs
        xb = xb.repeat(1, nh, 1, 1)
    y = F.relu(F.conv2d(xb, w1.reshape(nh * f, c, 3, 3), b1.reshape(-1),
                        padding=1, groups=nh))
    y = F.relu(F.conv2d(y, w2.reshape(nh * f, f, 1, 1), b2.reshape(-1),
                        groups=nh))
    y = F.conv2d(y, w3.reshape(nh * cout, f, 3, 3), b3.reshape(-1),
                 padding=1, groups=nh)  # (images, NH * Cout, H, W)
    if x.dim() == 5:
        return y.view(b, v, nh, cout, h, w).permute(2, 0, 4, 5, 3, 1)
    return y.view(-1, nh, cout, h, w).permute(1, 0, 3, 4, 2)


class _FusedConvBottleneck(torch.autograd.Function):
    """Forward and backward: the kernels (CUDA) or the plain version and
    its autograd (CPU)."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, w3, b3):
        ctx.save_for_backward(x, w1, b1, w2, b2, w3, b3)
        if x.device.type == "cpu":
            return reference_bottleneck(x, w1, b1, w2, b2, w3, b3)
        return _launch_fwd(x, w1, b1, w2, b2, w3, b3)

    @staticmethod
    def backward(ctx, grad):
        needs = ctx.needs_input_grad
        if grad.device.type == "cpu":
            inputs = [t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, needs)]
            with torch.enable_grad():
                out = reference_bottleneck(*inputs)
            grads = iter(torch.autograd.grad(
                out, [t for t, n in zip(inputs, needs) if n], grad))
            return tuple(next(grads) if n else None for n in needs)
        grads = _launch_bwd(*ctx.saved_tensors, grad.contiguous(),
                            need_dx=needs[0])
        return tuple(g if n else None for g, n in zip(grads, needs))


def fused_conv_bottleneck(x, w1, b1, w2, b2, w3, b3):
    """3x3 -> ReLU -> 1x1 -> ReLU -> 3x3 SAME bottleneck for every head at
    once; shapes and layouts as in the module docstring. Differentiable in
    every input."""
    if x.dim() not in (4, 5) or b1.dim() != 2 or b3.dim() != 2:
        raise ValueError(f"x {tuple(x.shape)}, b1 {tuple(b1.shape)}, b3 "
                         f"{tuple(b3.shape)}: want x (N, H, W, Cin) or "
                         f"(B, H, W, Cin, V), b1 (NH, F), b3 (NH, Cout)")
    cin = x.shape[3]
    (nh, f), cout = b1.shape, b3.shape[1]
    want = {"w1": (nh, f, cin, 3, 3), "w2": (nh, f, f, 1, 1), "b2": (nh, f),
            "w3": (nh, cout, f, 3, 3), "b3": (nh, cout)}
    for name, t in (("w1", w1), ("w2", w2), ("b2", b2), ("w3", w3),
                    ("b3", b3)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} {tuple(t.shape)} does not fit x "
                             f"{tuple(x.shape)} and b1 {tuple(b1.shape)}: "
                             f"want {want[name]}")
    # a bf16 model's tensors cast to float32 at the boundary, as the JAX
    # wrapper casts (its ``:277-284``); the casts' gradients go back in bf16
    # (its ``:368-374``). Other dtypes reach the kernel's check as they are.
    return _FusedConvBottleneck.apply(
        *(t.float() if t.dtype == torch.bfloat16 else t
          for t in (x, w1, b1, w2, b2, w3, b3)))


def _geometry(x, tensors):
    """Checks what the kernels take; returns (B, V, H, W, Cin)."""
    for name, t in tensors:
        if t.device != x.device or t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 on {x.device}, got "
                            f"{t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.numel() == 0:
        raise ValueError(f"x {tuple(x.shape)} is empty")
    if x.dim() == 5:
        b, h, w, c, v = x.shape
    else:
        (b, h, w, c), v = x.shape, 1
    return b, v, h, w, c


def _widths(cin, f, cout, backward):
    if not (1 <= cin <= _MAX_C and 1 <= cout <= _MAX_C):
        raise ValueError(f"the kernels take 1 to {_MAX_C} input and output "
                         f"channels, got Cin={cin}, Cout={cout}")
    if not backward and f > _MAX_F_FWD:
        raise ValueError(f"the forward kernel takes a hidden width of at most "
                         f"{_MAX_F_FWD}, got F={f}")
    smem = _lib().gat_mapping_smem_bytes(cin, f, cout, int(backward))
    if smem > _SMEM_LIMIT:
        raise ValueError(f"hidden width F={f} needs {smem} bytes of shared "
                         f"memory a block, more than {_SMEM_LIMIT}")


def _blocks(x, nh):
    """Blocks a head: one a streaming multiprocessor over all heads."""
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return max(1, sms // nh)


def _launch_fwd(x, w1, b1, w2, b2, w3, b3):
    global fwd_launch_count
    b, v, h, w, cin = _geometry(x, (
        ("x", x), ("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2),
        ("w3", w3), ("b3", b3)))
    (nh, f), cout = b1.shape, b3.shape[1]
    _widths(cin, f, cout, backward=False)
    shape = x.shape[:3] + (cout,) + x.shape[4:]
    out = x.new_empty((nh,) + shape)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _lib().gat_mapping_fwd(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), w3.data_ptr(), b3.data_ptr(), out.data_ptr(), nh,
            b, v, h, w, cin, f, cout, _blocks(x, nh), stream)
    if rc != 0:
        raise RuntimeError(f"gat_mapping_fwd launch failed: CUDA error {rc}")
    fwd_launch_count += 1
    return out


def _launch_bwd(x, w1, b1, w2, b2, w3, b3, g, *, need_dx):
    """(dx or None, dw1, db1, dw2, db2, dw3, db3)."""
    global bwd_launch_count
    b, v, h, w, cin = _geometry(x, (
        ("x", x), ("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2),
        ("w3", w3), ("grad", g)))
    (nh, f), cout = b1.shape, b3.shape[1]
    want = (nh,) + x.shape[:3] + (cout,) + x.shape[4:]
    if tuple(g.shape) != want:
        raise ValueError(f"grad {tuple(g.shape)} does not fit the output "
                         f"{want}")
    _widths(cin, f, cout, backward=True)
    blocks = _blocks(x, nh)
    per_head = f * cin * 9 + 2 * f + f * f + cout * f * 9 + cout
    partials = x.new_empty((nh, blocks, per_head))
    dx = torch.empty_like(x) if need_dx else None
    dx_heads = x.new_empty((nh,) + x.shape) if need_dx and nh > 1 else None
    grads = [torch.empty_like(t) for t in (w1, b1, w2, b2, w3, b3)]
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _lib().gat_mapping_bwd(
            x.data_ptr(), g.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), w3.data_ptr(), ptr(dx),
            ptr(dx_heads), partials.data_ptr(), *(t.data_ptr() for t in grads),
            nh, b, v, h, w, cin, f, cout, blocks, int(need_dx), stream)
    if rc != 0:
        raise RuntimeError(f"gat_mapping_bwd launch failed: CUDA error {rc}")
    bwd_launch_count += 1
    return (dx, *grads)


@functools.cache
def _lib():
    from .build import load

    lib = load("gat_mapping")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.gat_mapping_smem_bytes.argtypes = [i32] * 4
    lib.gat_mapping_smem_bytes.restype = ctypes.c_longlong
    lib.gat_mapping_fwd.argtypes = [vp] * 8 + [i32] * 9 + [vp]
    lib.gat_mapping_fwd.restype = i32
    lib.gat_mapping_bwd.argtypes = [vp] * 16 + [i32] * 10 + [vp]
    lib.gat_mapping_bwd.restype = i32
    return lib
