"""Fused GAT attention (K1): the wrapper of ``csrc/gat_attention.cu``.

Port of ``extended_gan_tpu/ops/pallas/gat_attention.py``. Per (head, batch
element), on ``m`` of shape (M, P) with P = G * group_size (groups
contiguous): pooled-descriptor scores from ``a = [a1; a2]`` -> leaky_relu
-> row softmax -> adjacency mixing -> ELU(att @ m). See the note at the top
of the CUDA source for the kernels' design and bound.

- :func:`reference_impl` is the plain PyTorch version of the forward (the
  JAX ``_reference_impl``, same signature and (B, M, P) layout, returning
  the kernel's four outputs) and :func:`reference_backward` that of the
  backward (the JAX ``_bwd`` cotangents, ``:170-198``). The CPU path runs
  them, and the card's kernels are held against them.
- :func:`fused_gat_attention` takes (NH, B, M, P) contiguous, with a
  leading head axis so one launch covers every head of a multi-head block,
  as the vmapped ``pallas_call`` does in JAX.
- :func:`attend_temporal` is the (B, H, W, T, V) layout wrapper. It hands
  the kernels ``mapped`` where it lies when it is pixel-major ((NH, B, H,
  W, T, V) contiguous, as K2 writes it) or plane-major (H * W contiguous in
  each (head, batch, t, v) plane, as the cuDNN mapping's view is), and its
  output keeps ``mapped``'s strides; any other layout is made contiguous
  first.

For CUDA tensors the forward launches a kernel (one thread-block cluster
per (head, batch element), or the first one-block kernel where no cluster
holds an element: :func:`_cluster_plan` picks by shape) and the backward
launches ``gat_attention_bwd``; for CPU tensors both run the plain
versions. There is no fallback from one to the other: a refused launch
raises. ``launch_count`` counts forward kernel launches, ``bwd_launch_count``
backward ones (CPU calls do not count).
"""

from __future__ import annotations

import ctypes
import functools

import torch

launch_count = 0
bwd_launch_count = 0
_MAX_M = 8  # the CUDA entry points are instantiated for M = 1..8
_MAX_MG = 128  # M * G the cluster kernels take (kMaxMG)
_HEADER_FLOATS = 1616  # the cluster kernels' shared-memory header (kHeader)
_SMEM_LIMIT = 232448  # shared memory one block can have on Hopper
_SM_SMEM = 233472  # shared memory of an SM (1 KB of it reserved a block)
_FWD_BLOCKS, _BWD_BLOCKS = 4, 2  # blocks an SM (kFwdBlocks, kBwdBlocks)
_SMS = 132  # streaming multiprocessors of an H100 SXM
_CLUSTERS = (1, 2, 4, 8, 16)  # cluster sizes; above 8 the non-portable ones


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


def reference_backward(m, a, adj_norm, out, att0, att, pos, g, alpha,
                       group_size):
    """Plain version of the backward, the JAX ``_bwd`` cotangents from the
    forward's residuals: m, out and g (NH, B, M, P); a (NH, 2G); adj_norm
    (NH, M, M); att0, att, pos (NH, B, M, M). Returns (d_m, d_a, d_adj)."""
    gs, nh = group_size, m.shape[0]
    # elu'(x) = 1 for x > 0 else exp(x) = elu(x) + 1; elu keeps the sign
    d0 = g * torch.where(out > 0, 1.0, out + 1.0)
    # out0 = att @ m
    d_att = d0 @ m.transpose(-1, -2)
    d_m = att.transpose(-1, -2) @ d0
    # att = adj_norm @ att0
    d_adj = torch.einsum("nbij,nbkj->nik", d_att, att0)
    d_att0 = adj_norm.transpose(-1, -2)[:, None] @ d_att
    # softmax rows (the max shift does not change the gradient)
    d_e = att0 * (d_att0 - (d_att0 * att0).sum(-1, keepdim=True))
    d_e = torch.where(pos > 0, d_e, alpha * d_e)  # leaky_relu'
    # e[i, j] = s1_i + s2_j, s = (m @ w) / group_size
    d_s1 = d_e.sum(-1, keepdim=True) / gs  # (NH, B, M, 1)
    d_s2 = d_e.sum(-2)[..., None] / gs
    w1, w2 = _group_rows(a, gs)
    d_m = d_m + d_s1 * w1 + d_s2 * w2
    # w = repeat(a, group_size): a's gradient sums its group
    d_w1 = (d_s1 * m).sum(dim=(1, 2))  # (NH, P)
    d_w2 = (d_s2 * m).sum(dim=(1, 2))
    d_a = torch.cat([d_w1.view(nh, -1, gs).sum(-1),
                     d_w2.view(nh, -1, gs).sum(-1)], dim=1)
    return d_m, d_a, d_adj


def _group_rows(a, group_size):
    """(NH, 2G) -> w1, w2 as (NH, 1, 1, P) group-repeated rows."""
    g = a.shape[1] // 2
    w1 = a[:, :g].repeat_interleave(group_size, dim=1)[:, None, None, :]
    w2 = a[:, g:].repeat_interleave(group_size, dim=1)[:, None, None, :]
    return w1, w2


def fused_gat_attention(m, a, adj_norm, alpha, group_size):
    """m: (NH, B, M, P) float32 with P = G * group_size, contiguous on the
    card; a: (NH, 2G), per head [a1; a2] indexed by group; adj_norm:
    (NH, M, M) normalised adjacency. Returns (out, att0, att, pos): out
    (NH, B, M, P), the others (NH, B, M, M)."""
    nh, b, mm, p = m.shape
    if p % group_size:
        raise ValueError(f"P={p} is not a multiple of group_size={group_size}")
    g = p // group_size
    if a.shape != (nh, 2 * g) or adj_norm.shape != (nh, mm, mm):
        raise ValueError(f"a {tuple(a.shape)} / adj_norm "
                         f"{tuple(adj_norm.shape)} do not fit m {tuple(m.shape)}")
    if m.device.type != "cpu":
        tensors = (("m", m), ("a", a), ("adj_norm", adj_norm))
        _check(tensors, m.device)
        for name, t in tensors:
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
    # (NH, B, M, G, S) -> (NH, B, S, M, G): plane-major, taken in place
    x = m.reshape(nh, b, mm, g, group_size).permute(0, 1, 4, 2, 3)
    out, att0, att, pos = _FusedGatAttention.apply(x, a, adj_norm,
                                                   float(alpha))
    return (out.permute(0, 1, 3, 4, 2).reshape(nh, b, mm, p), att0, att,
            pos)


def attend_temporal(mapped, a, adj_norm, alpha=0.2):
    """Temporal attention + ELU in the model's layout: mapped
    (B, H, W, T, V), a (2V,), adj_norm (T, T) already normalised; or all
    three with a leading head axis (NH, ...), which runs every head in one
    launch. Returns ELU(mixed) with the strides of ``mapped`` where the
    kernels take its layout (see the module docstring)."""
    heads = mapped.dim() == 6
    if not heads:
        mapped, a, adj_norm = mapped[None], a[None], adj_norm[None]
    nh, b, h, w, t, v = mapped.shape
    # pixels s = (h, w): a view wherever H and W merge, else a copy
    x = mapped.reshape(nh, b, h * w, t, v)
    out = _FusedGatAttention.apply(x, a.contiguous(), adj_norm.contiguous(),
                                   float(alpha))[0]
    out = out.view(nh, b, h, w, t, v)
    return out if heads else out[0]


def _layout(x):
    """'pixel' or 'plane' for x (NH, B, S, M, G) in a layout the kernels
    take, else None. Pixel-major: (S, M, G) contiguous; plane-major: S
    contiguous. Both dense, so an output with x's strides is too."""
    sizes, strides = x.shape, x.stride()
    dense = [(st, n) for n, st in zip(sizes, strides) if n > 1]
    expect = 1
    for st, n in sorted(dense):
        if st != expect:
            return None
        expect *= n
    _, _, s, mm, g = sizes
    want = {2: mm * g, 3: g, 4: 1}
    if all(sizes[d] == 1 or strides[d] == want[d] for d in want):
        return "pixel"
    if s == 1 or strides[2] == 1:
        return "plane"
    return None


def _strides(x, layout):
    """(sn, sb, sk, sv, pixel_major) for the kernels; a size-1 axis's
    stride is never used and is passed as 0."""
    st = [0 if n == 1 else s for n, s in zip(x.shape, x.stride())]
    return st[0], st[1], st[3], st[4], int(layout == "pixel")


def _rows(x):
    """(NH, B, S, M, G) -> (NH, B, M, P) with P = G * S: the plain
    versions' layout."""
    nh, b, s, mm, g = x.shape
    return x.permute(0, 1, 3, 4, 2).reshape(nh, b, mm, g * s)


def _elements(rows, like):
    """The reverse of :func:`_rows`, into a new tensor with ``like``'s
    strides."""
    nh, b, s, mm, g = like.shape
    out = torch.empty_like(like)
    out.copy_(rows.view(nh, b, mm, g, s).permute(0, 1, 4, 2, 3))
    return out


def _round4(n):
    return -(-n // 4) * 4


def _cluster_plan(nh, b, s, mg, *, backward=False, smem_limit=_SMEM_LIMIT,
                  cluster=None):
    """The cluster kernels' plan for NH * B elements of S pixels with M * G
    values each: (C, npix, chunk), C blocks an element, npix pixels a block
    (a multiple of 4; the last block holds the rest, at least one), chunk
    pixels in shared memory at once (npix, unless a slice outgrows it: the
    backward then walks it in chunks).

    C is the smallest cluster whose slices fit the share of an SM's shared
    memory that lets the kernel's blocks an SM run there at once (the
    forward's four, the backward's two; else the smallest whose slices fit
    a block); then doubled while the batch's clusters would cover under a
    quarter of the SMs (chip runs of ``k1_probe --clusters`` and
    ``--variants``: ``PERF.md``).
    None where no cluster holds an element (forward: the one-block kernel
    runs) or M * G is beyond the kernels. ``cluster`` forces C (tests and
    probes)."""
    if mg > _MAX_MG:
        return None
    bufs = 2 if backward else 1  # m's slice (and g's)

    def smem(pixels):
        return 4 * (_HEADER_FLOATS + bufs * pixels * mg)

    def npix(c):
        return _round4(-(-s // c))

    if cluster is None:
        share = _SM_SMEM // (_BWD_BLOCKS if backward else _FWD_BLOCKS) - 1024
        fit = [c for c in _CLUSTERS
               if smem(npix(c)) <= min(smem_limit, share)]
        fit = fit or [c for c in _CLUSTERS if smem(npix(c)) <= smem_limit]
        c = fit[0] if fit else _CLUSTERS[-1]
        while c < _CLUSTERS[-1] and 4 * nh * b * c < _SMS:
            c *= 2
        while c > 1 and (c - 1) * npix(c) >= s:  # no empty block
            c //= 2
    else:
        c = cluster
    n = npix(c)
    if smem(n) <= smem_limit:
        return c, n, n
    if not backward:
        return None
    chunk = (smem_limit // 4 - _HEADER_FLOATS) // (2 * mg) // 4 * 4
    return (c, n, chunk) if chunk >= 4 else None


class _FusedGatAttention(torch.autograd.Function):
    """x (NH, B, S, M, G) in any layout; returns (out, att0, att, pos), out
    with x's strides when x is pixel- or plane-major. ``att0``, ``att`` and
    ``pos`` are residuals, not differentiable."""

    @staticmethod
    def forward(ctx, x, a, adj_norm, alpha):
        if _layout(x) is None:
            # e.g. the linear mapping's einsum output: one explicit copy
            # to pixel-major, which the kernels take
            x = x.contiguous()
        s = x.shape[2]
        if x.device.type == "cpu":
            w1, w2 = _group_rows(a, s)
            out, att0, att, pos = reference_impl(
                _rows(x), w1, w2, adj_norm[:, None], alpha, s)
            out = _elements(out, x)
            ctx.save_for_backward(x, a, adj_norm, att0, att, pos, out)
        else:
            out, att0, att, pos = _launch_fwd(x, a, adj_norm, alpha)
            ctx.save_for_backward(x, a, adj_norm, att0, att, pos)
        ctx.alpha = alpha
        ctx.mark_non_differentiable(att0, att, pos)
        return out, att0, att, pos

    @staticmethod
    def backward(ctx, g, *_residual_grads):
        x, a, adj_norm, att0, att, pos, *out = ctx.saved_tensors
        if g.device.type == "cpu":
            d_m, d_a, d_adj = reference_backward(
                _rows(x), a, adj_norm, _rows(out[0]), att0, att, pos,
                _rows(g), ctx.alpha, x.shape[2])
            return _elements(d_m, x), d_a, d_adj, None
        return (*_launch_bwd(x, g, a, adj_norm, att0, att, pos, ctx.alpha),
                None)


def _check(tensors, device):
    for name, t in tensors:
        if t.device != device or t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 on {device}, got "
                            f"{t.dtype} on {t.device}")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _launch_fwd(x, a, adj_norm, alpha):
    global launch_count
    nh, b, s, mm, g = x.shape
    _check((("m", x), ("a", a), ("adj_norm", adj_norm)), x.device)
    if not 1 <= mm <= _MAX_M:
        raise ValueError(f"the kernel takes 1 <= M <= {_MAX_M}, got M={mm}")
    att0, att, pos = (x.new_empty((nh, b, mm, mm)) for _ in range(3))
    plan = _cluster_plan(nh, b, s, mm * g)
    lib = _lib()
    with torch.cuda.device(x.device):
        if plan is None:
            # no cluster holds an element: the one-block kernel, on
            # (NH, B, M, P) contiguous
            m = _rows(x).contiguous()
            out = torch.empty_like(m)
            rc = lib.gat_attention_fwd(
                m.data_ptr(), a.data_ptr(), adj_norm.data_ptr(),
                out.data_ptr(), att0.data_ptr(), att.data_ptr(),
                pos.data_ptr(), nh, b, mm, g * s, s, alpha,
                _stream(x.device))
            out = out.view(nh, b, mm, g, s).permute(0, 1, 4, 2, 3)
        else:
            c, npix, _ = plan
            clusters = _clusters(nh * b, mm, g, c, npix, 1, False)
            out = torch.empty_like(x)
            rc = lib.gat_attention_cluster_fwd(
                x.data_ptr(), a.data_ptr(), adj_norm.data_ptr(),
                out.data_ptr(), att0.data_ptr(), att.data_ptr(),
                pos.data_ptr(), nh, b, mm, g, s, *_strides(x, _layout(x)), c,
                npix, clusters, alpha, _stream(x.device))
    if rc != 0:
        raise RuntimeError(f"gat_attention_fwd launch failed: CUDA error {rc}")
    launch_count += 1
    return out, att0, att, pos


def _launch_bwd(x, g, a, adj_norm, att0, att, pos, alpha):
    global bwd_launch_count
    nh, b, s, mm, gg = x.shape
    _check((("g", g),), x.device)
    # On GAT3D's paths g comes in one of the two layouts (K2's mapping:
    # pixel-major at both blocks; the cuDNN mapping: plane-major, but
    # pixel-major at the output block, from the sigmoid), so no copy runs
    # there; any other layout becomes pixel-major.
    layout_g = _layout(g)
    if layout_g is None:
        g, layout_g = g.contiguous(), "pixel"
    plan = _cluster_plan(nh, b, s, mm * gg, backward=True)
    if plan is None:
        raise ValueError(f"the backward kernel takes M * G <= {_MAX_MG}, got "
                         f"M={mm}, G={gg}")
    c, npix, chunk = plan
    clusters = _clusters(nh * b, mm, gg, c, chunk, 2, True)
    width = mm * mm + 2 * gg
    d_x = torch.empty_like(x)
    ws = x.new_empty((nh * b, width))
    sums = x.new_empty((nh, width))
    with torch.cuda.device(x.device):
        rc = _lib().gat_attention_bwd(
            x.data_ptr(), g.data_ptr(), a.data_ptr(), adj_norm.data_ptr(),
            att0.data_ptr(), att.data_ptr(), pos.data_ptr(), d_x.data_ptr(),
            ws.data_ptr(), sums.data_ptr(), nh, b, mm, gg, s,
            *_strides(x, _layout(x)), *_strides(g, layout_g), c, npix, chunk,
            clusters, alpha, _stream(x.device))
    if rc != 0:
        raise RuntimeError(f"gat_attention_bwd launch failed: CUDA error {rc}")
    bwd_launch_count += 1
    return d_x, sums[:, mm * mm:], sums[:, :mm * mm].view(nh, mm, mm)


@functools.cache
def _clusters(elements, mm, g, c, pixels, buffers, backward):
    """The grid's clusters: as many as the card runs at once, ``buffers``
    slice buffers of ``pixels`` pixels a block, at most one an element
    (cached: it depends on the shape alone); raises when the card runs
    none."""
    lib = _lib()
    smem = lib.gat_attention_cluster_smem_bytes(mm, g, pixels, buffers)
    counts = [lib.gat_attention_cluster_max_clusters(mm, vec, int(backward),
                                                     c, smem)
              for vec in (0, 1)]
    if min(counts) < 1:
        raise ValueError(
            f"the card cannot run a cluster of {c} blocks with {smem} bytes "
            f"of shared memory each (M={mm}): "
            + (f"CUDA error {-min(counts)}" if min(counts) < 0
               else "no active cluster"))
    return min(elements, *counts)


@functools.cache
def _lib():
    from .build import load

    return bind(load("gat_attention"))


def bind(lib):
    """Sets the C entry points' argument and result types on ``lib``, a
    build of ``csrc/gat_attention.cu``; returns it."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    f32 = ctypes.c_float
    lib.gat_attention_fwd.argtypes = [vp] * 7 + [i32] * 5 + [f32, vp]
    lib.gat_attention_fwd.restype = i32
    lib.gat_attention_cluster_fwd.argtypes = (
        [vp] * 7 + [i32] * 5 + [i64] * 4 + [i32] * 4 + [f32, vp])
    lib.gat_attention_cluster_fwd.restype = i32
    lib.gat_attention_bwd.argtypes = (
        [vp] * 10 + [i32] * 5 + [i64] * 4 + [i32] + [i64] * 4 + [i32] * 5
        + [f32, vp])
    lib.gat_attention_bwd.restype = i32
    lib.gat_attention_cluster_smem_bytes.argtypes = [i32] * 4
    lib.gat_attention_cluster_smem_bytes.restype = i64
    lib.gat_attention_cluster_max_clusters.argtypes = [i32] * 4 + [i64]
    lib.gat_attention_cluster_max_clusters.restype = i32
    return lib
