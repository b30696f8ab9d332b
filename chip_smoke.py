#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``extended_gan_torch``) on one GPU.

  python3 chip_smoke.py      # from the root of a checkout, one NVIDIA H100

Phases, each fatal on failure (non-zero exit, no result line):

1. build   - compile every kernel in ``extended_gan_torch/ops/csrc/`` with
             nvcc (one process per source, all at once) into build/kernels/.
2. kernels - hold each kernel against its plain PyTorch version on the card
             and time both with CUDA events (median of 20 timed groups
             after warm-up): K1's forward at the twelve served shapes
             (20x20 and 80x80, B = 1, 8, 32, 1 and 3 heads) in the three
             layouts it takes (fused_gat_attention's (NH, B, M, P), K2's
             pixel-major output and the cuDNN mapping's view, the last two
             in place), and its one-block kernel at 200x200, all outputs
             at atol = rtol = 1e-5 (f32; only the summation order over P
             differs), each twice, bit-identical; K1's backward kernel at
             the 80x80 and 20x20 batch-32 blocks against autograd of the
             plain forward at K1_BWD_TOL, twice, bit-identical, timed
             beside reference_backward (the plain cotangents); K3's forward at the 18 DSC shapes of a
             final_smaatunet batch-32 forward and at the tiled TPU kernel's
             shape, at its split plan and with CK unsplit,
             and its backward (the kernel and two matrix products) at the
             18 shapes, each twice, bit-identical, with the plain depthwise
             disabled, at the roundoff-scaled tolerances stated at
             DSC_TOL_UNITS and DSC_BWD_TOL_UNITS (the backward against
             float64, with two planted faults to show the limit sees
             them); times of the kernels, the plain versions, cuDNN's pair
             of convs and its autograd (exact f32 and TF32), and the
             library's convolution_backward of the depthwise conv.
   mapping - K2 (``ops/gat_mapping.py``, forward and backward kernels)
             against the plain three-conv composition (cuDNN, TF32 off):
             the forward at final_temp_conv's hidden (3 heads) and output
             (1 head) blocks at batch 32, serve batch 1 and
             local_temporal_conv (20x20) batch 32; the backward (dx and the
             six weight and bias gradients) at both 80x80 batch-32 blocks;
             each twice, bit-identical, at the tolerance stated at
             K2_TOL_UNITS. Times of the kernels, of the composition exact
             and with TF32, their operation bounds, each kernel's share of
             the f32 peak and its build (registers, spills, shared bytes).
3. serve   - the served path as a user runs it: ``python -m
             extended_gan_torch.serve export`` of final_temp_conv (80x80) with
             --init-seed 0, ``ModelServer`` on the card behind the HTTP server
             (port 0), POSTs of batches 1, 5 and 32; every reply is checked
             for shape, finiteness and range, and against the same weights'
             forward with the plain attention; the kernel's launch count
             must be 2 per forward. Then local_temporal_conv (20x20), batch 32.
4. forward - device time of one batch-32 forward of each served model, with
             the kernel and with the plain attention, and a profile of the
             80x80 forward (kernel time by name).
5. train   - ``python -m extended_gan_torch.gat generate_experiment`` of
             final_smaatunet (SmaAt-UNet, 20x20, K3 18 launches a forward)
             and final_temp_conv (GAT3D, 80x80, K1 2 a forward and its
             backward 2 a train step), one epoch
             on the synthetic fallback, outputs in a temporary directory:
             finite losses and metrics, history.json and model.pt written
             there, launches = per-forward count x forwards (eval
             included) + per-step count x train steps (K3's backward 18 a
             step). Then, in process at batch 32, one step's gradients and
             three train steps with the kernels against the plain versions
             (exact f32), and ms per train step (the UNet in 5 alternating
             rounds, kernel path against plain, both profiled).
             K2's launch count is 0 in every CLI and serve run: its switch
             ``use_pallas_mapping`` is off unless a constructor turns it on.
6. mapping model - final_temp_conv's ``Model(..., use_pallas_mapping=True)``
             against ``False`` from the same weights, batch 32: forward
             device time and agreement, 2 K2 forward launches a forward and
             2 backward launches a backward (and 2 of K1's backward), three
             Adam steps kernel path
             against plain path, ms per train step, a profile of the
             switched step.
7. family  - the rest of the conv-GAT family, at full width from seed 0:
             final_temp_smaat (GAT3D with the smaat_unet mapping, 20x20,
             V = 6, b = 32, exact f32) in process against its plain twin:
             forward agreement and device time, 4 K1 launches a forward
             (3 + 1 unrolled heads; K3 stays off in the mapping, as in
             JAX), the mapping's output taken by K1 in place (a profile of
             attend_temporal on it records K1's kernel alone), a profile
             of the forward, one step's gradients and three SGD steps
             (K1 4 + 4 a step), ms per step with Adam; then one epoch
             through the CLI of final_temp_smaat, final_temp_conv_4heads
             (80x80), final_temp_linear_1lay, final_gat1d and final_gat2d
             (K1 4 a forward and 4 a step in the first, 0 in the rest, as
             in JAX; K2 and K3 0), each with its ms per train step; and
             final_temp_smaat exported and served over HTTP at batch 32.
8. report  - the total time, the ``kernels`` JSON line, the card's name and
             power limit, and the last line ``{"ok": true, "device":
             {...}}``.
"""

from __future__ import annotations

import io
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
TOL = 1e-5


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def time_ms(fn, *, groups=25, warmup=5, per_group=10, sleep_cycles=5_000_000):
    """Median device time of one ``fn()`` call, in ms.

    Each group of calls is queued behind a device sleep (5M cycles is about
    2.5 ms), so the host's launch overhead is hidden and the events span
    device work only."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for g in range(groups):
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(per_group):
            fn()
        end.record()
        torch.cuda.synchronize()
        if g >= warmup:
            times.append(start.elapsed_time(end) / per_group)
    return statistics.median(times)


def ptxas_entries(log):
    """{mangled kernel name: (registers, spill bytes stored + loaded,
    static shared bytes)} from nvcc's -Xptxas=-v output."""
    entries = {}
    for chunk in log.split("Compiling entry function '")[1:]:
        name = chunk.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", chunk)
        spills = re.findall(r"(\d+) bytes spill (?:stores|loads)", chunk)
        smem = re.search(r"(\d+) bytes smem", chunk)
        entries[name] = (int(regs.group(1)) if regs else None,
                         sum(int(n) for n in spills),
                         int(smem.group(1)) if smem else 0)
    return entries


def phase_build():
    """Builds every kernel source; returns each source's nvcc log."""
    from extended_gan_torch.ops import build

    t0 = time.perf_counter()
    report = build.build()
    secs = time.perf_counter() - t0
    for name, info in report.items():
        # ptxas -v: one "Used N registers" and one spill line per kernel
        regs = [int(w) for w in re.findall(r"Used (\d+) registers",
                                           info["log"])]
        spills = sum(int(w) for w in re.findall(r"(\d+) bytes spill",
                                                info["log"]))
        print(f"[build] {name}.cu: nvcc {info['seconds']:.2f} s, "
              f"{len(regs)} kernels, at most {max(regs, default=0)} "
              f"registers a thread, {spills} bytes spilled")
    print(f"[build] {len(report)} kernel source(s) compiled, "
          f"{len(build.sources()) - len(report)} already up to date, in "
          f"{secs:.2f} s into {build.BUILD_DIR}")
    return {name: info["log"] for name, info in report.items()}


def _k1_inputs(nh, b, hw, layout, seed, dev, mm=4, groups=6):
    """K1's m in ``layout``: "api" (NH, B, M, P) contiguous for
    fused_gat_attention, or (NH, B, S, M, G) for the kernels in place:
    "pixel" (K2's output) or "cudnn" (the cuDNN mapping's view of memory
    ordered (B, V, NH, T, H, W)); a (NH, 2G); adj (NH, M, M)."""
    import torch

    from extended_gan_torch.models.gat.layers import normalized_adjacency

    gen = torch.Generator(device=dev).manual_seed(seed)
    if layout == "api":
        m = torch.randn(nh, b, mm, groups * hw, device=dev, generator=gen)
    elif layout == "pixel":
        m = torch.randn(nh, b, hw, mm, groups, device=dev, generator=gen)
    else:
        m = torch.randn(b, groups, nh, mm, hw, device=dev,
                        generator=gen).permute(2, 0, 4, 3, 1)
    a = torch.randn(nh, 2 * groups, device=dev, generator=gen)
    adj = normalized_adjacency(
        torch.rand(nh, mm, mm, device=dev, generator=gen))
    return m, a, adj


def _k1_forward(k1, m, a, adj, layout, hw, alpha=0.2):
    """K1's forward in ``layout``; out as (NH, B, M, P) beside the
    residuals."""
    if layout == "api":
        return k1.fused_gat_attention(m, a, adj, alpha, hw)
    out, att0, att, pos = k1._FusedGatAttention.apply(m, a, adj, alpha)
    return (k1._rows(out), att0, att, pos)


def phase_kernels(build_logs):
    """K1 against reference_impl at the served geometry, forward in its
    three layouts (each twice, bit-identical), the one-block kernel beyond
    the clusters' reach, and the backward kernel against autograd of
    reference_impl at the batch-32 blocks; each K1 kernel's registers,
    spills and static shared bytes."""
    import torch

    from extended_gan_torch.ops import gat_attention as k1

    for name, (regs, spills, smem) in ptxas_entries(
            build_logs.get("gat_attention", "")).items():
        if "<4, 4>" in name or "Li4ELi4E" in name or "sum" in name:
            print(f"[build] {name}: {regs} registers, {spills} bytes "
                  f"spilled, {smem} bytes static shared")

    dev = torch.device("cuda")
    mm, groups, alpha = 4, 6, 0.2  # M = T = 4 frames, G = V = 6 vertices
    rows, worst = [], 0.0
    # (H*W, B, heads, layout): the twelve served shapes in the three
    # layouts, then 200x200, which no cluster holds (the one-block kernel)
    shapes = [(hw, b, nh, layout) for hw in (400, 6400) for b in (1, 8, 32)
              for nh in (1, 3) for layout in ("api", "pixel", "cudnn")]
    shapes.append((40000, 1, 1, "api"))
    for hw, b, nh, layout in shapes:
        p = groups * hw
        m, a, adj = _k1_inputs(nh, b, hw, layout, 1000 * nh + b, dev)
        rows_m = m if layout == "api" else k1._rows(m)
        w1 = a[:, :groups].repeat_interleave(hw, 1)[:, None, None, :]
        w2 = a[:, groups:].repeat_interleave(hw, 1)[:, None, None, :]
        adj_b = adj[:, None].contiguous()
        plan = k1._cluster_plan(nh, b, hw, mm * groups)
        check((plan is None) == (hw == 40000),
              f"K1 plan {plan} at heads={nh} B={b} P={p}")
        with torch.no_grad():
            got = _k1_forward(k1, m, a, adj, layout, hw)
            again = _k1_forward(k1, m, a, adj, layout, hw)
            want = k1.reference_impl(rows_m, w1, w2, adj_b, alpha, hw)
        torch.cuda.synchronize()
        err = 0.0
        for name, g_, r_, w_ in zip(("out", "att0", "att", "pos"), got,
                                    again, want):
            check(g_.shape == w_.shape,
                  f"{name} shape {g_.shape} != {w_.shape}")
            check(torch.equal(g_, r_), f"K1 {name} differs between two "
                  f"runs at heads={nh} B={b} P={p} {layout}")
            check(torch.allclose(g_, w_, atol=TOL, rtol=TOL),
                  f"K1 {name} disagrees with reference_impl at "
                  f"heads={nh} B={b} P={p} {layout}: max abs err "
                  f"{(g_ - w_).abs().max().item():.3e}")
            err = max(err, (g_ - w_).abs().max().item())
        worst = max(worst, err)
        with torch.no_grad():
            if layout == "api":
                kms = time_ms(lambda: k1.fused_gat_attention(m, a, adj, alpha,
                                                             hw))
            else:  # in place: no conversion to rows inside the timing
                kms = time_ms(lambda: k1._FusedGatAttention.apply(m, a, adj,
                                                                  alpha))
            pms = time_ms(lambda: k1.reference_impl(
                rows_m, w1, w2, adj_b, alpha, hw))
        n = nh * b * mm * p
        nbytes = 4 * (2 * n + nh * 2 * groups + nh * mm * mm
                      + 3 * nh * b * mm * mm)
        # the plane sums and s1, s2: about 1 flop an element; out: M FMAs
        # and the ELU
        flops = n * (1 + 2 * mm + 1)
        bound, by = _bound(nbytes, flops)
        rows.append(dict(heads=nh, batch=b, P=p, layout=layout,
                         cluster=plan[0] if plan else None,
                         max_abs_err=err, kernel_ms=kms, plain_ms=pms,
                         bound_ms=bound, bound_by=by))
        print(f"[kernel] gat_attention_fwd heads={nh} B={b:2d} P={p:6d} "
              f"{layout:5s} " + (f"C={plan[0]:2d}" if plan else "one-block")
              + f": max_abs_err={err:.3e} kernel={kms:.4f} ms plain="
              f"{pms:.4f} ms bound={bound:.4f} ms (twice, bit-identical)")
    return rows, worst, phase_k1_backward(k1)


# K1's backward against autograd of reference_impl, the style of the card
# test test_k1_gradient_through_the_kernel_matches_plain: 1e-4 relative to
# the largest entry of each gradient (sums over up to B * P products).
K1_BWD_TOL = 1e-4


def phase_k1_backward(k1, alpha=0.2):
    """gat_attention_bwd at final_temp_conv's and local_temporal_conv's
    batch-32 blocks (m and the cotangent in the layouts the model's paths
    hand over), each twice and bit-identical, against autograd of
    reference_impl; times of the kernel (with its sum over the batch),
    reference_backward (the plain cotangents) and autograd of
    reference_impl."""
    import torch

    dev = torch.device("cuda")
    mm, groups = 4, 6
    rows = []
    # (H*W, heads, m's layout, the cotangent's): the cuDNN mapping's hidden
    # block (g as the output block's mapping backward hands it over) and
    # output block (g from the sigmoid, pixel-major), K2's hidden block
    for hw, nh, layout, glayout in (
            (6400, 3, "cudnn", "cudnn"), (6400, 1, "cudnn", "pixel"),
            (6400, 3, "pixel", "pixel"), (400, 3, "cudnn", "cudnn"),
            (400, 1, "cudnn", "pixel")):
        b = 32
        m, a, adj = _k1_inputs(nh, b, hw, layout, 50 + nh, dev)
        cot = _k1_inputs(nh, b, hw, glayout, 5, dev)[0]
        with torch.no_grad():
            out, att0, att, pos = k1._launch_fwd(m, a, adj, alpha)
        plan = k1._cluster_plan(nh, b, hw, mm * groups, backward=True)
        before = k1.bwd_launch_count
        got = k1._launch_bwd(m, cot, a, adj, att0, att, pos, alpha)
        again = k1._launch_bwd(m, cot, a, adj, att0, att, pos, alpha)
        check(k1.bwd_launch_count - before == 2, "K1 backward launches")
        inputs = [t.clone().requires_grad_() for t in (k1._rows(m), a, adj)]
        w1, w2 = k1._group_rows(inputs[1], hw)
        plain = k1.reference_impl(inputs[0], w1, w2, inputs[2][:, None],
                                  alpha, hw)[0]
        want = torch.autograd.grad(plain, inputs, k1._rows(cot),
                                   retain_graph=True)
        torch.cuda.synchronize()
        err = 0.0
        for name, g_, r_, w_ in zip(("d_m", "d_a", "d_adj"),
                                    (k1._rows(got[0]), *got[1:]),
                                    (k1._rows(again[0]), *again[1:]), want):
            check(torch.equal(g_, r_), f"K1 backward {name} differs between "
                  f"two runs at heads={nh} B={b} P={groups * hw}")
            gap = (g_ - w_).abs().max().item() / w_.abs().max().item()
            check(gap <= K1_BWD_TOL, f"K1 backward {name} differs from "
                  f"autograd of reference_impl by {gap:.3e} of its largest "
                  f"entry at heads={nh} B={b} P={groups * hw}")
            err = max(err, (g_ - w_).abs().max().item())
        kms = time_ms(lambda: k1._launch_bwd(m, cot, a, adj, att0, att, pos,
                                             alpha))
        rows_m, rows_out, rows_cot = k1._rows(m), k1._rows(out), k1._rows(cot)
        pms = time_ms(lambda: k1.reference_backward(
            rows_m, a, adj, rows_out, att0, att, pos, rows_cot, alpha, hw))
        ams = time_ms(lambda: torch.autograd.grad(
            plain, inputs, rows_cot, retain_graph=True), per_group=2)
        n = nh * b * mm * groups * hw
        # read m and g, write d_m; the residuals and the (NH, M*M + 2G)
        # sums are small
        nbytes = 4 * (3 * n + 4 * nh * b * mm * mm + nh * (2 * groups + mm * mm)
                      + nh * (mm * mm + 2 * groups))
        # an element: o (M FMAs), d0, d_att (M FMAs), its plane sum, d_m
        # (M FMAs and two more)
        flops = n * (6 * mm + 7)
        bound, by = _bound(nbytes, flops)
        rows.append(dict(heads=nh, batch=b, P=groups * hw, layout=layout,
                         g_layout=glayout,
                         cluster=plan[0], chunk=plan[2], npix=plan[1],
                         max_abs_err=err, kernel_ms=kms, plain_ms=pms,
                         autograd_ms=ams, bound_ms=bound, bound_by=by))
        print(f"[kernel] gat_attention_bwd heads={nh} B={b} P={groups * hw:6d}"
              f" m {layout} g {glayout}, C={plan[0]} npix={plan[1]} "
              f"chunk={plan[2]}: "
              f"max_abs_err={err:.3e} kernel={kms:.4f} ms "
              f"reference_backward={pms:.4f} ms autograd of reference_impl="
              f"{ams:.4f} ms bound={bound:.4f} ms ({by}; twice, "
              f"bit-identical)")
    return rows


# K3's tolerance, per output element: 4 * sqrt(9 + CK) units of f32
# roundoff (2^-24) times the sum of the absolute values of the terms that
# element adds up (the plain version run on |x|, |dw|, |dwb|, |pw|, |pwb|).
# An output sums 9 taps and then up to 2,048 products in another order than
# the plain version, so their roundoff differs by about sqrt(terms) units of
# the terms' scale; an indexing fault is off by the terms themselves.
DSC_TOL_UNITS = 4 * 2.0**-24
# K3's backward, per gradient entry, against the plain autograd in
# float64: DSC_BWD_TOL_UNITS times the entry's scale, the plain autograd
# run on |inputs| and |g| (the sum of the absolute values of the terms the
# entry adds up). No sqrt(terms) factor: the scale already grows with the
# terms, and on terms of either sign the roundoff of an f32 sum stays
# within a few units of it (sequential sums about 0.6 units rms, the
# kernel's blocked sums far less), while a dropped share of the terms or
# an operand rounded to TF32 moves the entry by more.
DSC_BWD_TOL_UNITS = 8 * 2.0**-24
# the tiled TPU kernel's shape: _fits_vmem (dsconv.py:277-293) is false here
DSC_TILED_SHAPE = (8, 80, 80, 128, 256, 64)
# the 18 DSCs of final_smaatunet in forward order
DSC_NAMES = [f"{block} dsc{i}" for block in ("inc", "down1", "down2", "down3",
                                             "down4", "up1", "up2", "up3",
                                             "up4") for i in (0, 1)]
# Training, kernel path against plain path, exact f32, the same weights and
# batches. The two differ only in the kernels' summation order, which
# train-mode BatchNorm over few samples amplifies (the SmaAt-UNet), and Adam
# turns a gradient that is zero up to roundoff into a step of lr either way.
# So the gradients (and the SGD updates) are held to 10x what roundoff alone
# does to them, measured in the same run by perturbing the plain path's
# input by one part in 1e7, or to 1e-4 of the largest entry if that is more.
TRAIN_LR = 1e-3
TRAIN_LOSS_TOL = 1e-4  # per-step losses, relative
TRAIN_GRAD_FLOOR, TRAIN_SENS_FACTOR = 1e-4, 10
ADAM_NEAR, ADAM_NEAR_SHARE = 1e-5, 0.99  # GAT3D, Adam: share of entries
# K2's tolerance, per output element: K2_TOL_UNITS * sqrt(terms) times the
# sum of the absolute values of the terms the element adds up, bounded by
# the plain version (and its autograd) run on |inputs| and |cotangent|. A
# forward output sums 9 * F = 666 products in its last layer, a weight
# gradient one per pixel of every image, dx 9 * F a head; two summation
# orders part by about sqrt(terms) roundoff units of that scale.
K2_TOL_UNITS = 8 * 2.0**-24
K2_F, K2_C = 74, 4  # GAT3D's conv hidden width and T
# (where, (NH, B, V, H)): the forward's shapes; the backward runs the first
# two, the hidden block without dx (it reads the model input), the output
# block with it
K2_SHAPES = [("final_temp_conv hidden block", (3, 32, 6, 80)),
             ("final_temp_conv output block", (1, 32, 6, 80)),
             ("serve batch 1 hidden block", (3, 1, 6, 80)),
             ("local_temporal_conv hidden block", (3, 32, 6, 20))]


def _bound(nbytes, flops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations"


def dsc_bound(n, h, w, c, ck, cout):
    """(bound_ms, bound_by): each input read once, the output written once;
    2 * N*H*W * CK * (9 + Cout) f32 operations."""
    nbytes = 4 * (n * h * w * (c + cout) + 10 * ck + ck * cout + cout)
    return _bound(nbytes, 2 * n * h * w * ck * (9 + cout))


def dsc_bwd_bounds(n, h, w, c, ck, cout, need_dx):
    """((bound_ms, bound_by) of the backward kernel, of the whole backward).
    The kernel reads gd, x and dw and writes dx and ddw, ddwb: 9 FMAs a gd
    entry for ddw and 9 for dx. The whole backward adds gd = g pw^T and dpw
    = d^T g (2 * M * CK * Cout operations each) and dpwb; its bytes are g,
    x, d, gd twice (written, then read), dx and the weights and their
    gradients."""
    m = n * h * w
    kernel = _bound(4 * (m * ck + m * c * (1 + need_dx) + 19 * ck),
                    2 * m * ck * 9 * (1 + need_dx))
    whole = _bound(4 * (m * cout + m * c * (1 + need_dx) + 3 * m * ck
                        + 2 * (10 * ck + ck * cout + cout)),
                   2 * m * ck * (9 * (1 + need_dx) + 2 * cout) + m * cout)
    return kernel, whole


def dsc_inputs(shape, seed):
    import math

    import torch

    n, h, w, c, ck, cout = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(n, h, w, c, device="cuda", generator=gen),
            torch.randn(3, 3, ck, device="cuda", generator=gen) / 3,
            torch.randn(ck, device="cuda", generator=gen),
            torch.randn(ck, cout, device="cuda", generator=gen)
            / math.sqrt(ck),
            torch.randn(cout, device="cuda", generator=gen))


def _no_plain_depthwise(*args):
    raise SmokeFailure("the K3 path ran the plain depthwise (reference_dsc)")


def phase_dsconv():
    """K3 against reference_dsc and its autograd at the 18 DSC shapes of a
    final_smaatunet batch-32 forward and, forward only, at the tiled TPU
    kernel's shape. Each check runs twice and must be bit-identical; the
    K3 path runs with the plain depthwise replaced by a function that
    fails. The forward runs at its split plan and with CK unsplit; times
    of both, of the backward kernel,
    its two matrix products and the whole backward, of the plain versions
    and, as a yardstick only, of cuDNN's pair of convs and its autograd
    (exact f32, as the kernels are)."""
    import math

    import torch
    import torch.nn.functional as F

    from extended_gan_torch.models.smaat_unet import dsc_shapes
    from extended_gan_torch.ops import dsconv as k3

    shapes = dsc_shapes()  # final_smaatunet's 18 at batch 32
    check(len(shapes) == 18, f"{len(shapes)} DSC launches a forward, not 18")
    rows, worst, bwd_worst = [], 0.0, 0.0
    plain_depthwise = k3._depthwise
    for i, shape in enumerate(shapes + [DSC_TILED_SHAPE]):
        n, h, w, c, ck, cout = shape
        where = DSC_NAMES[i] if i < 18 else "tiled-variant shape"
        args = dsc_inputs(shape, i)
        x, dw, dwb, pw, pwb = args
        ks = k3._split_plan(*shape)
        unsplit = -(-ck // 32) * 32
        with torch.no_grad():
            want = k3.reference_dsc(*args)
            scale = k3.reference_dsc(*(t.abs() for t in args))
            tol = DSC_TOL_UNITS * math.sqrt(9 + ck) * scale
            k3._depthwise = _no_plain_depthwise
            try:
                outs = {p: [k3._launch(*args, ks=p)[0] for _ in range(2)]
                        for p in (ks, unsplit)}
                fused = k3.fused_dsconv(*args)
            finally:
                k3._depthwise = plain_depthwise
        torch.cuda.synchronize()
        check(torch.equal(fused, outs[ks][0]),
              f"K3 at {where}: fused_dsconv and its plan differ")
        ratio = err_max = 0.0
        for plan, (got, again) in outs.items():  # plan: channels a slice
            check(got.shape == want.shape, f"K3 shape {got.shape} at {shape}")
            check(torch.equal(got, again), f"K3 forward at {where}, slices "
                                           f"of {plan}: two runs differ")
            err = (got - want).abs()
            check(bool((err <= tol).all()),
                  f"K3 disagrees with reference_dsc at {where} {shape}, "
                  f"slices of {plan}: max abs err {err.max().item():.3e}, worst "
                  f"err/tol {(err / tol).max().item():.3f}")
            err_max = max(err_max, err.max().item())
            ratio = max(ratio, (err / tol).max().item())
        worst = max(worst, err_max)
        xc = x.permute(0, 3, 1, 2)  # NCHW view, channels-last memory
        wd = dw.permute(2, 0, 1)[:, None].contiguous()  # (CK, 1, 3, 3)
        wp = pw.t()[:, :, None, None].contiguous()  # (Cout, CK, 1, 1)

        def pair(xc, wd, dwb, wp, pwb):
            return F.conv2d(F.conv2d(xc, wd, dwb, padding=1, groups=c), wp,
                            pwb)
        with torch.no_grad(), torch.backends.cudnn.flags(enabled=True,
                                                         allow_tf32=False):
            kms = time_ms(lambda: k3._launch(*args, ks=ks))
            dms = time_ms(lambda: k3._launch(*args, ks=ks, keep_d=True))
            unsplit_ms = time_ms(lambda: k3._launch(*args, ks=unsplit))
            pms = time_ms(lambda: k3.reference_dsc(*args))
            cms = time_ms(lambda: pair(xc, wd, dwb, wp, pwb))
        with torch.no_grad(), torch.backends.cudnn.flags(enabled=True,
                                                         allow_tf32=True):
            cms_tf32 = time_ms(lambda: pair(xc, wd, dwb, wp, pwb))
        bound, by = dsc_bound(*shape)
        row = dict(shape=shape, where=where, slices=-(-ck // ks),
                   max_abs_err=err_max, kernel_ms=kms, with_d_ms=dms,
                   unsplit_ms=unsplit_ms, plain_ms=pms,
                   cudnn_pair_ms=cms, cudnn_pair_tf32_ms=cms_tf32,
                   bound_ms=bound, bound_by=by,
                   gflop=2 * n * h * w * ck * (9 + cout) / 1e9)
        print(f"[kernel] dsconv_fwd {where} N={n} {h}x{w} C={c} CK={ck} "
              f"Cout={cout}, S={row['slices']}: worst err/tol {ratio:.3f} "
              f"(these slices and CK unsplit), two runs bit-identical; "
              f"kernel={kms:.4f} ms (writing d {dms:.4f}) unsplit="
              f"{unsplit_ms:.4f} ms plain={pms:.4f} ms "
              f"bound={bound:.4f} ms ({by}) cuDNN pair={cms:.4f} ms (TF32 "
              f"{cms_tf32:.4f})")
        if i < 18:
            row.update(_dsconv_backward(k3, where, shape, args, pair,
                                        (xc, wd, dwb, wp, pwb), i))
            bwd_worst = max(bwd_worst, row["bwd_max_abs_err"])
        rows.append(row)
    main = rows[:18]

    def total(key):
        return sum(r[key] for r in main)
    print(f"[kernel] dsconv_fwd over one final_smaatunet b=32 forward (18 "
          f"launches): kernel {total('kernel_ms'):.4f} ms (writing d "
          f"{total('with_d_ms'):.4f}), CK unsplit "
          f"{total('unsplit_ms'):.4f} ms, plain "
          f"{total('plain_ms'):.4f} ms, bound {total('bound_ms'):.4f} ms, "
          f"cuDNN pair {total('cudnn_pair_ms'):.4f} ms (TF32 "
          f"{total('cudnn_pair_tf32_ms'):.4f}), {total('gflop'):.2f} GFLOP")
    print(f"[kernel] dsconv_bwd over one final_smaatunet b=32 backward (18 "
          f"launches, 17 with dx): kernel {total('bwd_kernel_ms'):.4f} ms "
          f"(bound {total('bwd_kernel_bound_ms'):.4f}), two matrix products "
          f"and the bias sum {total('bwd_matmul_ms'):.4f} ms, whole K3 "
          f"backward {total('bwd_ms'):.4f} ms (bound "
          f"{total('bwd_bound_ms'):.4f}), library convolution_backward "
          f"{total('bwd_library_ms'):.4f} ms, plain autograd "
          f"{total('bwd_plain_ms'):.4f} ms, cuDNN pair autograd "
          f"{total('bwd_cudnn_pair_ms'):.4f} ms (TF32 "
          f"{total('bwd_cudnn_pair_tf32_ms'):.4f})")
    ratios = {k: max(r["bwd_ratios"].get(k, 0.0) for r in main)
              for k in main[1]["bwd_ratios"]}
    print("[kernel] dsconv_bwd against float64 over the 18: worst err/tol "
          + ", ".join(f"{k} {v:.3e}" for k, v in ratios.items())
          + "; planted faults, least err/tol over the 18: one block's "
          f"partial dropped {min(r['bwd_fault_dropped'] for r in main):.3e}, "
          f"gd in TF32 {min(r['bwd_fault_tf32'] for r in main):.3e}")
    return rows, worst, bwd_worst


def _dsconv_backward(k3, where, shape, args, pair, pair_args, seed):
    """K3's backward at one final_smaatunet shape: the first DSC's input
    needs no gradient (no dx), the others' do. Each gradient is held to the
    plain autograd in float64 at DSC_BWD_TOL_UNITS times its scale; two
    faults planted in ddw and ddwb (one block's partial dropped, gd made in
    TF32) show what that limit can see."""
    import torch

    n, h, w, c, ck, cout = shape
    need_dx = seed > 0
    g = torch.randn(n, h, w, cout, device="cuda",
                    generator=torch.Generator(device="cuda")
                    .manual_seed(100 + seed))

    def grads(fn, inputs, cot):
        inputs = [t.clone().requires_grad_(j > 0 or need_dx)
                  for j, t in enumerate(inputs)]
        wrt = inputs if need_dx else inputs[1:]
        return torch.autograd.grad(fn(*inputs), wrt, cot)
    plain_depthwise = k3._depthwise
    k3._depthwise = _no_plain_depthwise
    launches = k3.bwd_launch_count
    try:
        got = grads(k3.fused_dsconv, args, g)
        again = grads(k3.fused_dsconv, args, g)
    finally:
        k3._depthwise = plain_depthwise
    check(k3.bwd_launch_count - launches == 2,
          f"K3 backward at {where}: {k3.bwd_launch_count - launches} "
          "dsconv_bwd launches for 2 backwards")
    args64 = [t.double() for t in args]
    want = grads(k3.reference_dsc, args64, g.double())
    scale = grads(k3.reference_dsc, [t.abs() for t in args64],
                  g.double().abs())
    torch.cuda.synchronize()
    names = ["dx", "ddw", "ddwb", "dpw", "dpwb"][0 if need_dx else 1:]
    want, scale = dict(zip(names, want)), dict(zip(names, scale))

    def err_tol(name, value):
        """(max abs err, worst err/limit) of ``value`` against the float64
        plain gradient ``name``."""
        e = (value.double() - want[name]).abs()
        r = torch.where(e == 0, 0.0, e / (DSC_BWD_TOL_UNITS * scale[name]))
        return e.max().item(), r.max().item()
    err, ratios = 0.0, {}
    for name, g_, a_ in zip(names, got, again):
        check(torch.equal(g_, a_), f"K3 backward at {where}: {name} differs "
                                   "between two runs")
        e, r = err_tol(name, g_)
        check(r <= 1, f"K3 backward {name} at {where} {shape} disagrees with "
                      f"the plain autograd: max abs err {e:.3e}, worst "
                      f"err/tol {r:.3e}")
        err, ratios[name] = max(err, e), r
    got = dict(zip(names, got))
    # planted faults in ddw and ddwb: the middle pixel run's partial
    # dropped (its share of the sums, taken off in float64), and gd = g pw^T
    # made in TF32 before the kernel
    x, dw, dwb, pw, pwb = args
    cc, ppw, blocks = k3._bwd_plan(n, h, w, c, ck)
    run = k3._BWD_WARPS * ppw * (32 // (cc * (ck // c)))
    g2 = g.view(-1, cout)
    keep = torch.zeros(n * h * w, 1, dtype=torch.float64, device="cuda")
    keep[blocks // 2 * run:(blocks // 2 + 1) * run] = 1
    gd64 = (g2.double() @ pw.double().t()) * keep
    _, bdw, bdwb = k3.reference_depthwise_backward(
        gd64.view(n, h, w, ck), args64[0], args64[1], need_dx=False)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        gd_tf32 = (g2 @ pw.t()).view(n, h, w, ck)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    _, tdw, tdwb = k3._launch_bwd(gd_tf32, x, dw, need_dx=False)
    dropped = max(err_tol("ddw", got["ddw"] - bdw)[1],
                  err_tol("ddwb", got["ddwb"] - bdwb)[1])
    tf32 = max(err_tol("ddw", tdw)[1], err_tol("ddwb", tdwb)[1])
    check(dropped > 1, f"K3 backward at {where}: with one block's partial "
                       f"dropped, ddw and ddwb stay within the limit "
                       f"(worst err/tol {dropped:.3e})")
    # times: the kernel alone, the two products and the bias sum, the whole
    # K3 backward, the plain autograd, cuDNN's pair's autograd (exact f32
    # and TF32), and the one library call that computes what the kernel
    # does: convolution_backward of the depthwise conv from gd
    with torch.no_grad():
        d = k3._launch(*args, keep_d=True)[1]
        gd = (g2 @ pw.t()).view(n, h, w, ck)
        kms = time_ms(lambda: k3._launch_bwd(gd, x, dw, need_dx=need_dx))
        mms = time_ms(lambda: (g2 @ pw.t(), d.view(-1, ck).t() @ g2,
                               g2.sum(0)))

        def library():
            return torch.ops.aten.convolution_backward(
                gd.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), pair_args[1],
                [ck], [1, 1], [1, 1], [1, 1], False, [0, 0], c,
                [need_dx, True, True])
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            lib = library()
            lms = time_ms(library)
    lib_ratio = max(err_tol("ddw", lib[1].view(ck, 9).t().view(3, 3, ck))[1],
                    err_tol("ddwb", lib[2])[1],
                    err_tol("dx", lib[0].permute(0, 2, 3, 1))[1]
                    if need_dx else 0.0)
    times = []
    for fn, fn_args, tf32_conv in ((k3.fused_dsconv, args, False),
                                   (k3.reference_dsc, args, False),
                                   (pair, pair_args, False),
                                   (pair, pair_args, True)):
        inputs = [t.clone().requires_grad_(j > 0 or need_dx)
                  for j, t in enumerate(fn_args)]
        wrt = inputs if need_dx else inputs[1:]
        cot = g if fn is not pair else g.permute(0, 3, 1, 2)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=tf32_conv):
            out = fn(*inputs)
            times.append(time_ms(lambda: torch.autograd.grad(
                out, wrt, cot, retain_graph=True)))
        if fn is k3.fused_dsconv and where == "up4 dsc0":
            # what one K3 backward launches: two products, the bias sum,
            # the kernel and its partials' sum
            profile_window(lambda: torch.autograd.grad(
                out, wrt, cot, retain_graph=True), f"K3 backward at {where}",
                "backward", top=6)
        del out
    (kb, kby), (wb, wby) = dsc_bwd_bounds(*shape, need_dx)
    print(f"[kernel] dsconv_bwd {where}, dx {'on' if need_dx else 'off'}: "
          f"max_abs_err={err:.3e} against float64, worst err/tol "
          + ", ".join(f"{k} {v:.3e}" for k, v in ratios.items())
          + f"; planted faults: one block's partial dropped {dropped:.3e}, "
          f"gd in TF32 {tf32:.3e}; two runs bit-identical, no plain "
          f"depthwise; kernel={kms:.4f} ms (bound {kb:.4f}, {kby}) "
          f"library convolution_backward={lms:.4f} ms (err/tol "
          f"{lib_ratio:.3e}) matmuls={mms:.4f} ms whole K3 "
          f"backward={times[0]:.4f} ms (bound {wb:.4f}, {wby}) plain "
          f"autograd={times[1]:.4f} ms cuDNN pair autograd={times[2]:.4f} ms "
          f"(TF32 {times[3]:.4f})")
    return dict(need_dx=need_dx, bwd_max_abs_err=err,
                bwd_ratio=max(ratios.values()), bwd_ratios=ratios,
                bwd_fault_dropped=dropped, bwd_fault_tf32=tf32,
                bwd_kernel_ms=kms, bwd_library_ms=lms, bwd_matmul_ms=mms,
                bwd_ms=times[0], bwd_plain_ms=times[1],
                bwd_cudnn_pair_ms=times[2], bwd_cudnn_pair_tf32_ms=times[3],
                bwd_kernel_bound_ms=kb, bwd_kernel_bound_by=kby,
                bwd_bound_ms=wb, bwd_bound_by=wby)


def k2_inputs(nh, b, v, h, seed, gate_safe=False):
    """x (B, H, W, T, V) and stacked weights of ``nh`` heads, on the card.
    ``gate_safe``: every value on a grid that keeps each pre-activation at
    least 2^-11 from 0 (x in quarters, weights in eighths and sixteenths,
    biases half a grid step off it). The backward check takes these: a
    pre-activation within roundoff of 0 takes its ReLU gate one way in the
    kernel and the other in cuDNN, and a gradient through a flipped gate
    differs by a whole term, not by roundoff."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    f, c = K2_F, K2_C
    if gate_safe:
        def q(den, *s):
            return torch.randint(-4, 5, s, device="cuda",
                                 generator=gen).float() / den
        x = torch.randint(0, 4, (b, h, h, c, v), device="cuda",
                          generator=gen).float() / 4
        return (x, q(8, nh, f, c, 3, 3), q(32, nh, f) + 2.0**-6,
                q(16, nh, f, f, 1, 1), q(32, nh, f) + 2.0**-11,
                q(16, nh, c, f, 3, 3), q(32, nh, c))

    def r(scale, *s):
        return scale * torch.randn(*s, device="cuda", generator=gen)
    x = torch.rand(b, h, h, c, v, device="cuda", generator=gen)
    return (x, r((9 * c) ** -0.5, nh, f, c, 3, 3), r(0.1, nh, f),
            r(f ** -0.5, nh, f, f, 1, 1), r(0.1, nh, f),
            r((9 * f) ** -0.5, nh, c, f, 3, 3), r(0.1, nh, c))


def k2_bound(nh, b, v, h, backward=False, need_dx=False):
    """(bound_ms, bound_by, gflop). Operations: the forward's 9*T*F + F*F +
    9*F*T multiply-adds a pixel and head; the backward recomputes h1 and h2
    and adds dh2, dW3, dW2, dh1, dW1 (and dx when asked), as the TPU
    kernel does. Bytes: x, out (or g, and dx), weights and gradients, once."""
    f, c = K2_F, K2_C
    pixels = b * v * h * h
    per_head = 9 * c * f + 2 * f + f * f + 9 * f * c + c
    if backward:  # h1, h2; dh2, dW3; dW2, dh1; dW1; dx
        macs = (9 * c * f + f * f + 9 * f * c * 2 + f * f * 2 + 9 * c * f
                + 9 * f * c * need_dx)
        nbytes = 4 * (pixels * c * (1 + nh + need_dx) + 2 * nh * per_head)
    else:
        macs = 9 * c * f + f * f + 9 * f * c
        nbytes = 4 * (pixels * c * (1 + nh) + nh * per_head)
    flops = 2 * macs * nh * pixels
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", flops / 1e9)


def _k2_check(got, want, scale, terms, label):
    import math

    err = (got - want).abs()
    tol = K2_TOL_UNITS * math.sqrt(terms) * scale
    ratio = (err / tol).max().item()
    check(got.shape == want.shape, f"K2 {label}: shape {tuple(got.shape)} "
                                   f"!= {tuple(want.shape)}")
    check(bool((err <= tol).all()), f"K2 {label} disagrees with the plain "
          f"version: max abs err {err.max().item():.3e}, worst err/tol "
          f"{ratio:.3e}")
    return err.max().item(), ratio


def phase_mapping(build_logs):
    """K2's forward and backward kernels against reference_bottleneck and
    its autograd, each run twice and held to bit-identical results; times
    of both and of the plain composition (cuDNN), and each kernel's share
    of the f32 peak and its build (registers, spills, shared memory)."""
    import torch

    from extended_gan_torch.ops import gat_mapping as k2

    entries = ptxas_entries(build_logs.get("gat_mapping", ""))
    for kind, backward in (("fwd", 0), ("bwd", 1)):
        smem = k2._lib().gat_mapping_smem_bytes(K2_C, K2_F, K2_C, backward)
        builds = {n: e for n, e in entries.items()
                  if f"gat_mapping_{kind}_kernel" in n}
        if not builds:
            print(f"[kernel] gat_mapping_{kind} build: no ptxas report "
                  "(library built before this run)")
        for name, (regs, spills, static) in sorted(builds.items()):
            print(f"[kernel] gat_mapping_{kind} build {name}: {regs} "
                  f"registers a thread, {spills} bytes spilled, {static} "
                  f"bytes static shared memory; {smem} bytes dynamic shared "
                  f"memory a block at Cin = Cout = {K2_C}, F = {K2_F}")

    def exact():
        return torch.backends.cudnn.flags(enabled=True, allow_tf32=False)

    def tf32():
        return torch.backends.cudnn.flags(enabled=True, allow_tf32=True)
    big = dict(groups=10, warmup=2, per_group=2, sleep_cycles=20_000_000)
    fwd_rows, bwd_rows = [], []
    for i, (where, shape) in enumerate(K2_SHAPES):
        args = k2_inputs(*shape, seed=i)
        with torch.no_grad():
            with exact():
                got = k2.fused_conv_bottleneck(*args)
                again = k2.fused_conv_bottleneck(*args)
                want = k2.reference_bottleneck(*args)
                scale = k2.reference_bottleneck(*(t.abs() for t in args))
            torch.cuda.synchronize()
            check(torch.equal(got, again), f"K2 forward at {where}: two runs "
                                           "differ")
            err, ratio = _k2_check(got, want, scale, 9 * K2_F,
                                   f"forward at {where}")
            kms = time_ms(lambda: k2.fused_conv_bottleneck(*args), **big)
            with exact():
                pms = time_ms(lambda: k2.reference_bottleneck(*args), **big)
            with tf32():
                tms = time_ms(lambda: k2.reference_bottleneck(*args), **big)
        bound, by, gflop = k2_bound(*shape)
        peak = 100 * gflop * 1e9 / (kms * 1e-3) / F32_FLOP_PER_S
        fwd_rows.append(dict(where=where, shape=shape, max_abs_err=err,
                             kernel_ms=kms, plain_ms=pms, cudnn_tf32_ms=tms,
                             bound_ms=bound, bound_by=by, gflop=gflop,
                             f32_peak_pct=peak))
        print(f"[kernel] gat_mapping_fwd {where} (NH, B, V, H) = {shape}: "
              f"max_abs_err={err:.3e} (worst err/tol {ratio:.3e}), two runs "
              f"bit-identical; kernel={kms:.4f} ms plain (cuDNN exact)="
              f"{pms:.4f} ms cuDNN TF32={tms:.4f} ms bound={bound:.4f} ms "
              f"({by}, {gflop:.2f} GFLOP), {peak:.1f}% of the f32 peak")
    names = ["dx", "dw1", "db1", "dw2", "db2", "dw3", "db3"]
    for i, (where, shape) in enumerate(K2_SHAPES[:2]):
        nh, b, v, h = shape
        need_dx = nh == 1  # the output block's input needs a gradient
        args = k2_inputs(*shape, seed=10 + i, gate_safe=True)
        cot = torch.randn(nh, b, h, h, K2_C, v, device="cuda",
                          generator=torch.Generator(device="cuda")
                          .manual_seed(20 + i))

        def grads(fn, inputs, g):
            inputs = [t.clone().requires_grad_(j > 0 or need_dx)
                      for j, t in enumerate(inputs)]
            wrt = inputs if need_dx else inputs[1:]
            return torch.autograd.grad(fn(*inputs), wrt, g)
        got = grads(k2.fused_conv_bottleneck, args, cot)
        again = grads(k2.fused_conv_bottleneck, args, cot)
        with exact():
            want = grads(k2.reference_bottleneck, args, cot)
            scale = grads(k2.reference_bottleneck, [t.abs() for t in args],
                          cot.abs())
        torch.cuda.synchronize()
        err = ratio = 0.0
        for name, g_, a_, w_, s_ in zip(names if need_dx else names[1:], got,
                                        again, want, scale):
            check(torch.equal(g_, a_), f"K2 backward at {where}: {name} "
                                       "differs between two runs")
            terms = 9 * K2_F * nh if name == "dx" else b * v * h * h
            e, r = _k2_check(g_, w_, scale=s_, terms=terms,
                             label=f"backward {name} at {where}")
            err, ratio = max(err, e), max(ratio, r)
        kms = time_ms(lambda: k2._launch_bwd(*args, cot, need_dx=need_dx),
                      **big)
        inputs = [t.clone().requires_grad_(j > 0 or need_dx)
                  for j, t in enumerate(args)]
        wrt = inputs if need_dx else inputs[1:]
        times = []
        for flags in (exact, tf32):
            with flags():
                out = k2.reference_bottleneck(*inputs)
                times.append(time_ms(lambda: torch.autograd.grad(
                    out, wrt, cot, retain_graph=True), **big))
            del out
        bound, by, gflop = k2_bound(*shape, backward=True, need_dx=need_dx)
        peak = 100 * gflop * 1e9 / (kms * 1e-3) / F32_FLOP_PER_S
        bwd_rows.append(dict(where=where, shape=shape, need_dx=need_dx,
                             max_abs_err=err, kernel_ms=kms,
                             plain_ms=times[0], cudnn_tf32_ms=times[1],
                             bound_ms=bound, bound_by=by, gflop=gflop,
                             f32_peak_pct=peak))
        print(f"[kernel] gat_mapping_bwd {where} (NH, B, V, H) = {shape}, "
              f"dx {'on' if need_dx else 'off'}: max_abs_err={err:.3e} "
              f"(worst err/tol {ratio:.3e}), two runs bit-identical; kernel="
              f"{kms:.4f} ms plain backward (cuDNN exact)={times[0]:.4f} ms "
              f"cuDNN TF32={times[1]:.4f} ms bound={bound:.4f} ms ({by}, "
              f"{gflop:.2f} GFLOP), {peak:.1f}% of the f32 peak")
    return fwd_rows, bwd_rows


def _post(url, x):
    import numpy as np

    buf = io.BytesIO()
    np.save(buf, x)
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=120) as resp:
        body = resp.read()
    return np.load(io.BytesIO(body), allow_pickle=False), \
        (time.perf_counter() - t0) * 1e3


def serve_experiment(experiment, batches, repeats, per_forward=2):
    """Export ``experiment`` with --init-seed 0, serve it on the card over
    HTTP and check every reply (K1 launched ``per_forward`` times a
    forward). Returns the number of forwards run."""
    import numpy as np
    import torch

    from extended_gan_torch.models.registry import build_model
    from extended_gan_torch.ops import gat_attention as k1
    from extended_gan_torch.serve import make_server
    from extended_gan_torch.serve.__main__ import main as cli
    from extended_gan_torch.serve.export import MODEL_KEYS

    out_dir = os.path.join(REPO, "build", "smoke")
    os.makedirs(out_dir, exist_ok=True)
    artifact = os.path.join(out_dir, f"{os.path.basename(experiment)}.pt")
    cli(["export", os.path.join(REPO, experiment), "--init-seed", "0",
         "--out", artifact])
    server = make_server(artifact, port=0)
    model_server = server.RequestHandlerClass.model
    check(model_server.device.type == "cuda", "server is not on the card")
    served = model_server.artifact
    # the same weights with the plain attention: the comparison's reference
    twin = build_model(**{k: served.spec[k] for k in MODEL_KEYS},
                       use_pallas=False)
    twin.load_state_dict(served.model.state_dict())
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    forwards = 0
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        check(health["platforms"] == ["cuda"], f"healthz: {health}")
        window = served.window_shape
        for b in batches:
            x = np.random.default_rng(b).random((b, *window), np.float32)
            lat = []
            launches0 = k1.launch_count
            for _ in range(repeats):
                y, ms = _post(url + "/predict", x)
                lat.append(ms)
                forwards += 1
            check(k1.launch_count - launches0 == per_forward * repeats,
                  f"{experiment} b={b}: {k1.launch_count - launches0} K1 "
                  f"launches for {repeats} forwards, expected {per_forward} "
                  "per forward")
            check(y.shape == x.shape, f"reply shape {y.shape} != {x.shape}")
            check(bool(np.isfinite(y).all()), "reply has non-finite values")
            check(float(y.min()) >= 0.0 and float(y.max()) <= 1.0,
                  "reply leaves [0, 1]")
            with torch.no_grad():
                ref = twin(torch.from_numpy(x).to(model_server.device)).cpu().numpy()
            err = float(np.abs(y - ref).max())
            check(err <= TOL, f"{experiment} b={b}: reply differs from the "
                              f"plain-attention forward by {err:.3e}")
            print(f"[serve] {experiment} b={b:2d}: HTTP p50 "
                  f"{statistics.median(lat):.2f} ms over {repeats} requests, "
                  f"max |reply - plain| = {err:.3e}")
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        check(health["requests_served"] == forwards, f"healthz: {health}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    return forwards, served, twin


def phase_serve():
    import torch

    from extended_gan_torch.ops import gat_attention as k1
    from extended_gan_torch.ops import gat_mapping as k2

    # The replies are compared with a plain forward at 1e-5: both must run
    # in exact f32, and cuDNN convolutions default to TF32.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # the main path starts here
    k1.launch_count = k1.bwd_launch_count = 0
    k2.fwd_launch_count = k2.bwd_launch_count = 0
    forwards, models = 0, {}
    for name, batches in (("final_temp_conv", (1, 5, 32)),
                          ("local_temporal_conv", (32,))):
        n, served, twin = serve_experiment(
            f"convolutional_gat/experiments/{name}", batches, 10)
        forwards += n
        models[name] = (served, twin)
    launches = k1.launch_count
    check(launches == 2 * forwards,
          f"{launches} K1 launches for {forwards} forwards")
    check(k1.bwd_launch_count == 0,
          f"serving launched K1's backward {k1.bwd_launch_count} times")
    check(k2.fwd_launch_count == k2.bwd_launch_count == 0,
          f"the served models launched K2 ({k2.fwd_launch_count} forward, "
          f"{k2.bwd_launch_count} backward): its switch is off by default")
    print(f"[serve] {forwards} forwards, {launches} K1 launches")
    return launches, models


def phase_forward(models, batch=32):
    """Device time of one served forward (kernel path and plain path), and
    a profile of the kernel path at 80x80: where the forward's time goes."""
    import torch

    for name, (served, twin) in models.items():
        model = served.model
        x = torch.rand(batch, *served.window_shape, device="cuda")
        with torch.inference_mode():
            fused = time_ms(lambda: model(x), per_group=2,
                            sleep_cycles=20_000_000)
            plain = time_ms(lambda: twin(x), per_group=2,
                            sleep_cycles=20_000_000)
            # torch's default, which a server started from the CLI keeps
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
                tf32 = time_ms(lambda: model(x), per_group=2,
                               sleep_cycles=20_000_000)
        print(f"[forward] {name} b={batch}: kernel path {fused:.4f} ms, "
              f"plain attention {plain:.4f} ms, kernel path with cuDNN TF32 "
              f"{tf32:.4f} ms (device time, CUDA events)")
    served, _ = models["final_temp_conv"]
    model = served.model
    x = torch.rand(batch, *served.window_shape, device="cuda")
    with torch.inference_mode():
        profile_window(lambda: model(x), f"final_temp_conv b={batch}",
                       "forward")


def profile_window(fn, label, unit, n=5, top=10, counter=None):
    """Profile ``n`` calls of ``fn`` after one warm-up: device busy time a
    call, its share of the wall-clock window, and the top kernels by
    device time. ``counter``, a (kernel name, count function) pair: the
    kernel's launches as the profiler records them beside the wrapper's
    launch counter over the same window. Returns the busy and wall ms a
    call and the kernels a call, or None when no device time was
    recorded."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        counted = counter[1]() if counter else 0
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        counted = counter[1]() - counted if counter else 0

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    # device-side kernel events only: operator rows repeat their kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in events)
    if not busy:
        print("[profile] the profiler recorded no device time: not measured")
        return None
    print(f"[profile] {label}, {n} {unit}s: device busy "
          f"{busy / n / 1e3:.4f} ms a {unit}, {100 * busy / wall_us:.1f}% of "
          f"{wall_us / n / 1e3:.4f} ms wall, "
          f"{sum(e.count for e in events) // n} kernels a {unit}")
    for e in sorted(events, key=dev_us, reverse=True)[:top]:
        print(f"[profile]   {100 * dev_us(e) / busy:5.1f}%  "
              f"{dev_us(e) / n / 1e3:.4f} ms  x{e.count // n}  {e.key[:90]}")
    if counter:
        recorded = [e for e in events if counter[0] in e.key]
        print(f"[profile] {counter[0]}: the profiler records "
              f"{sum(e.count for e in recorded)} launches over {n} {unit}s "
              f"({len(recorded)} keys, "
              f"{sum(dev_us(e) for e in recorded) / n / 1e3:.4f} ms a {unit}),"
              f" the launch counter counts {counted}")
    return dict(busy_ms=busy / n / 1e3, wall_ms=wall_us / n / 1e3,
                kernels=sum(e.count for e in events) // n)


def host_state():
    """What the host's clock reads in a train step depends on: the load
    average, the CPUs this process may use, their mean clock, and the host
    time of one small kernel launch (2,000 launches, not waited for)."""
    import torch

    mhz = []
    try:
        with open("/proc/cpuinfo") as f:
            mhz = [float(line.split(":")[1]) for line in f
                   if line.startswith("cpu MHz")]
    except OSError:
        pass
    a = torch.zeros(8, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2000):
        a.add_(1)
    launch_us = (time.perf_counter() - t0) / 2000 * 1e6
    torch.cuda.synchronize()
    return (f"load {' '.join(f'{v:.2f}' for v in os.getloadavg())}, "
            f"{len(os.sched_getaffinity(0))} CPUs, "
            + (f"{statistics.mean(mhz):.0f} MHz mean, " if mhz else "")
            + f"{launch_us:.2f} us a launch")


def _finite(values):
    import math

    return all(math.isfinite(v) for v in values)


def model_pair(model_type, mapping_type, hw):
    """The registry's model with its kernels, and its plain twin with the
    same weights."""
    import torch

    from extended_gan_torch.models.registry import build_model

    kw = dict(image_width=hw, image_height=hw, n_vertices=6,
              mapping_type=mapping_type)
    fused = build_model(model_type, generator=torch.Generator().manual_seed(0),
                        **kw)
    plain = build_model(model_type, use_pallas=False, **kw)
    plain.load_state_dict(fused.state_dict())
    return fused, plain


def compare_train_steps(model_type, fused, plain, hw, opt_name, counts,
                        per_step, batch=32, steps=3, rounds=1):
    """One step's gradients and three train steps with the kernels and
    with the plain versions, from the same weights on the same batches
    (exact f32: TF32 off), then the step time of each path and a profile of
    the kernel path's step. ``counts()`` gives the launch counts of the
    kernels under test and ``per_step`` what one train step adds to each.
    ``rounds`` > 1: that many alternating rounds of kernel and plain steps
    (exact f32), each printed, their medians kept, and the plain path's
    step profiled too. Returns the kernel path's launches and the step
    times."""
    import numpy as np
    import torch

    from extended_gan_torch.train.gat_trainer import (
        make_gat_train_step,
        to_device_batch,
    )
    from extended_gan_torch.train.optim import make_optimizer

    dev = torch.device("cuda")
    init = {k: v.clone() for k, v in fused.state_dict().items()}
    pairs = [(m, make_optimizer(opt_name, m.parameters(), TRAIN_LR,
                                weight_decay=0.01)) for m in (fused, plain)]
    step_fns = [make_gat_train_step(m, o) for m, o in pairs]
    rng = np.random.default_rng(0)
    batches = [to_device_batch(rng.random((batch, hw, hw, 4, 6), np.float32),
                               rng.random((batch, hw, hw, 4, 6), np.float32),
                               dev) for _ in range(steps)]
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        # one step's gradients, before any update: the kernel path, the
        # plain path, and the plain path on the input perturbed by one part
        # in 1e7 (about one f32 rounding), which measures how far roundoff
        # alone moves them
        grads = []
        noise = 1 + 1e-7 * torch.randn(
            batches[0][0].shape,
            generator=torch.Generator().manual_seed(1)).to(batches[0][0].device)
        for model, x in ((fused, batches[0][0]), (plain, batches[0][0]),
                         (plain, batches[0][0] * noise)):
            model.train().zero_grad()
            y_hat = model(x)
            ((y_hat - batches[0][1]) ** 2).mean().backward()
            grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
            model.zero_grad()
        for model in (fused, plain):  # undo the BN statistics' updates
            model.load_state_dict(init)
        launches0 = counts()
        losses = [[float(fn(*b)[0]) for fn in step_fns] for b in batches]
        launched = {k: n - launches0[k] for k, n in counts().items()}
    check(launched == {k: n * steps for k, n in per_step.items()},
          f"{model_type}: launches {launched} for {steps} kernel-path steps, "
          f"expected {per_step} a step")
    # one step's gradients: the worst gap of any tensor, in units of the
    # model's largest gradient entry (the per-tensor worst is printed too:
    # train-mode BatchNorm amplifies roundoff in small tensors)
    largest = max(g.abs().max().item() for g in grads[1].values())
    gaps = {n: ((g - grads[1][n]).abs().max().item(),
                grads[1][n].abs().max().item()) for n, g in grads[0].items()}
    grad_err = max(d for d, _ in gaps.values()) / largest
    sens = max((g - grads[1][n]).abs().max().item()
               for n, g in grads[2].items()) / largest
    worst_name = max(gaps, key=lambda n: gaps[n][0] / max(gaps[n][1], 1e-30))
    tensor_err = gaps[worst_name][0] / max(gaps[worst_name][1], 1e-30)
    grad_tol = max(TRAIN_GRAD_FLOOR, TRAIN_SENS_FACTOR * sens)
    check(grad_err <= grad_tol,
          f"{model_type}: one step's gradients, kernel path against plain, "
          f"differ by {grad_err:.3e} of the largest entry (limit "
          f"{grad_tol:.3e}; roundoff alone moves them {sens:.3e})")
    loss_err = max(abs(a - b) / abs(b) for a, b in losses)
    check(_finite(v for pair in losses for v in pair), f"losses {losses}")
    check(loss_err <= TRAIN_LOSS_TOL,
          f"{model_type}: per-step losses {losses} differ by {loss_err:.3e}")
    got, want = fused.state_dict(), plain.state_dict()
    near = total = 0
    param_err = 0.0
    largest_update = max((w - init[n]).abs().max().item()
                         for n, w in want.items()
                         if not n.endswith("num_batches_tracked"))
    for name, w in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        diff = (got[name] - w).abs()
        if opt_name == "sgd":
            param_err = max(param_err, diff.max().item() / largest_update)
        else:
            check(diff.max().item() <= 2 * TRAIN_LR * steps,
                  f"{model_type}: {name} parted by {diff.max().item():.3e}")
            near += int((diff <= ADAM_NEAR).sum())
            total += diff.numel()
    if opt_name == "sgd":
        check(param_err <= grad_tol,
              f"{model_type}: after {steps} SGD steps the parameters differ "
              f"by {param_err:.3e} of the largest update (limit "
              f"{grad_tol:.3e})")
    else:
        check(near >= ADAM_NEAR_SHARE * total,
              f"{model_type}: {near} of {total} entries within {ADAM_NEAR}")

    def step_ms(model, opt, n=8):
        fn = make_gat_train_step(model, opt)
        for b in batches[:2]:
            fn(*b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            fn(*batches[i % steps])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        timed, hosts = [], []
        for _ in range(rounds):
            hosts.append(host_state() if rounds > 1 else None)
            timed.append((step_ms(*pairs[0]), step_ms(*pairs[1])))
    kernel_ms = statistics.median(k for k, _ in timed)
    plain_ms = statistics.median(p for _, p in timed)
    if rounds > 1:
        for r, ((k, p), host) in enumerate(zip(timed, hosts)):
            print(f"[train] {model_type} round {r + 1} of {rounds}: kernel "
                  f"{k:.3f} ms, plain {p:.3f} ms a train step (exact f32); "
                  f"host before it: {host}")
        print(f"[train] {model_type} median of {rounds} rounds: kernel "
              f"{kernel_ms:.3f} ms, plain {plain_ms:.3f} ms a train step")
    # torch's default math: cuDNN convolutions in TF32
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
        tf32_ms = step_ms(*pairs[0])
        plain_tf32_ms = step_ms(*pairs[1])
    profiles = {}
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for path, pair in (("kernel", pairs[0]), ("plain", pairs[1])):
            if path == "plain" and rounds == 1:
                break
            fn = make_gat_train_step(*pair)
            profiles[path] = profile_window(
                lambda: fn(*batches[0]), f"{model_type} {hw}x{hw} b={batch} "
                f"{path} path, exact f32", "train step", n=3)
    print(f"[train] {model_type} {hw}x{hw} b={batch}, {opt_name}: losses "
          f"kernel vs plain {losses}, worst rel {loss_err:.3e}; one step's "
          f"gradients within {grad_err:.3e} of the largest entry, roundoff "
          f"alone {sens:.3e} (worst tensor {worst_name}: {tensor_err:.3e} of "
          f"its own largest); "
          + (f"parameters within {param_err:.3e} of the largest update"
             if opt_name == "sgd" else
             f"{near}/{total} entries within {ADAM_NEAR}")
          + f"; ms per train step (host clock, synchronised): kernel "
          f"{kernel_ms:.3f}, plain {plain_ms:.3f} (exact f32), with cuDNN "
          f"TF32: kernel {tf32_ms:.3f}, plain {plain_tf32_ms:.3f}")
    return dict(launched=launched, kernel_ms=kernel_ms, plain_ms=plain_ms,
                tf32_ms=tf32_ms, plain_tf32_ms=plain_tf32_ms, rounds=timed,
                profiles=profiles)


def train_experiment(name, per_forward, per_step, model_cls, max_batches=3,
                     step_batch=0):
    """``python -m extended_gan_torch.gat generate_experiment`` as a user runs
    it (one epoch, synthetic fallback, outputs in a temporary directory),
    with the kernels' counts set to 0 just before and read just after: each
    kernel launches ``per_forward[kernel]`` times a forward (train steps
    and eval) and ``per_step[kernel]`` a train step (train-mode forward),
    every other kernel none. ``step_batch``: then the ms per train step of
    the trained model at that batch, with the config's optimizer (Adam),
    in process."""
    import shutil
    import tempfile

    import torch

    from extended_gan_torch.gat.__main__ import main as cli
    from extended_gan_torch.ops import dsconv as k3
    from extended_gan_torch.ops import gat_attention as k1
    from extended_gan_torch.ops import gat_mapping as k2

    out = tempfile.mkdtemp(prefix=f"smoke_{name}_")
    exp_dir = os.path.join(REPO, "convolutional_gat", "experiments", name)
    exp_files = sorted(os.listdir(exp_dir))
    forwards = [0, 0]  # all forwards, train-mode forwards

    def count(module, args, output):
        if type(module) is model_cls:
            forwards[0] += 1
            forwards[1] += module.training

    hook = torch.nn.modules.module.register_module_forward_hook(count)
    try:
        # the main path starts here
        k1.launch_count = k1.bwd_launch_count = 0
        k3.launch_count = k3.bwd_launch_count = 0
        k2.fwd_launch_count = k2.bwd_launch_count = 0
        t0 = time.perf_counter()
        model, history = cli(["generate_experiment", "--exp_folder_name", name,
                              "--output-path", out, "--epochs", "1",
                              "--max-batches", str(max_batches)])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {"gat_attention_fwd": k1.launch_count,
                    "gat_attention_bwd": k1.bwd_launch_count,
                    "dsconv_fwd": k3.launch_count,
                    "dsconv_bwd": k3.bwd_launch_count,
                    "gat_mapping_fwd": k2.fwd_launch_count,
                    "gat_mapping_bwd": k2.bwd_launch_count}
    finally:
        hook.remove()
    try:
        check(next(model.parameters()).device.type == "cuda",
              f"{name}: the model is not on the card")
        # the epoch's train loss sums every step's squared error: it is
        # finite exactly when every step's loss was
        check(len(history["train_loss"]) == 1
              and _finite(history["train_loss"]),
              f"{name}: train loss {history['train_loss']}")
        check(all(_finite(history[k]) for k in history if k.startswith("val")),
              f"{name}: val metrics {history}")
        check(all(bool(p.isfinite().all()) for p in model.parameters()),
              f"{name}: non-finite parameters after training")
        for f in ("history.json", "model.pt"):
            check(os.path.isfile(os.path.join(out, f)),
                  f"{name}: {f} was not written to --output-path")
        check(sorted(os.listdir(exp_dir)) == exp_files,
              f"{name}: the run wrote into the experiment directory")
        check(forwards[1] > 0, f"{name}: no train step ran")
        for k, n in launches.items():
            expect = (per_forward.get(k, 0) * forwards[0]
                      + per_step.get(k, 0) * forwards[1])
            check(n == expect, f"{name}: {n} {k} launches for {forwards[0]} "
                               f"forwards ({forwards[1]} train steps), "
                               f"expected {expect}")
    finally:
        shutil.rmtree(out, ignore_errors=True)
    ours = {k: n for k, n in launches.items()
            if k in per_forward or k in per_step}
    step = f", {adam_step_ms(model, step_batch):.3f} ms a train step at b=" \
        f"{step_batch} (Adam, in process)" if step_batch else ""
    print(f"[train] {name} via the CLI: {forwards[0]} forwards ({forwards[1]} "
          f"train steps, the rest eval), launches {ours or launches} "
          f"({per_forward} a forward, {per_step} a train step), train loss "
          f"{history['train_loss'][0]:.6f}, val_loss "
          f"{history['val_loss'][0]:.6f}, {secs:.2f} s with start-up{step}")
    return ours


def adam_step_ms(model, batch, n=8):
    """Host-clock ms of one train step (Adam, as the configs train) of
    ``model`` on uniform-noise batches of its geometry, after two warm-up
    steps, synchronised at the end."""
    import numpy as np
    import torch

    from extended_gan_torch.train.gat_trainer import (
        make_gat_train_step,
        to_device_batch,
    )
    from extended_gan_torch.train.optim import make_optimizer

    rng = np.random.default_rng(0)
    shape = (batch, model.image_width, model.image_height, 4, 6)
    data = [to_device_batch(rng.random(shape, np.float32),
                            rng.random(shape, np.float32),
                            torch.device("cuda")) for _ in range(2)]
    fn = make_gat_train_step(model, make_optimizer(
        "adam", model.parameters(), TRAIN_LR, weight_decay=0.01))
    for b in data:
        fn(*b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        fn(*data[i % 2])
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def unet_dsc_inputs_needing_grad():
    """For each DSC of a train-mode final_smaatunet forward, in order:
    whether its input needs a gradient (whether its backward computes dx)."""
    import torch

    from extended_gan_torch.models.registry import build_model
    from extended_gan_torch.models.smaat_unet import DepthwiseSeparableConv

    model = build_model("unet", image_width=20, image_height=20,
                        n_vertices=6, mapping_type="linear").train()
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].requires_grad))
        for m in model.modules() if isinstance(m, DepthwiseSeparableConv)]
    model(torch.rand(2, 20, 20, 4, 6, device="cuda"))
    for h in hooks:
        h.remove()
    return seen


def phase_train():
    import torch

    from extended_gan_torch.models.gat.gat3d import Model as GatModel
    from extended_gan_torch.models.unet_model import UnetModel
    from extended_gan_torch.ops import dsconv as k3
    from extended_gan_torch.ops import gat_attention as k1

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    launches = {
        **train_experiment("final_smaatunet", {"dsconv_fwd": 18},
                           {"dsconv_bwd": 18}, UnetModel),
        **train_experiment("final_temp_conv", {"gat_attention_fwd": 2},
                           {"gat_attention_bwd": 2}, GatModel),
    }
    # the UNet compared under SGD: Adam's sign-like step would turn its
    # BatchNorm-amplified roundoff into whole steps of lr; its step time in
    # 5 alternating rounds, K3 against the plain DSC
    with_dx = unet_dsc_inputs_needing_grad()
    check(with_dx == [False] + [True] * 17,
          f"UNet train forward: DSC inputs needing a gradient {with_dx}")
    print("[train] unet: 18 DSCs a train step, 17 of whose inputs need a "
          "gradient (dsconv_bwd computes dx at 17 of its 18 launches)")
    unet = compare_train_steps(
        "unet", *model_pair("unet", "linear", 20), 20, "sgd",
        lambda: {"dsconv_fwd": k3.launch_count,
                 "dsconv_bwd": k3.bwd_launch_count},
        {"dsconv_fwd": 18, "dsconv_bwd": 18}, rounds=5)
    launches["unet_train_step"] = unet["launched"]
    gat = compare_train_steps(
        "temporal", *model_pair("temporal", "conv", 80), 80, "adam",
        lambda: {"gat_attention_fwd": k1.launch_count,
                 "gat_attention_bwd": k1.bwd_launch_count},
        {"gat_attention_fwd": 2, "gat_attention_bwd": 2})
    launches["gat_train_step"] = gat["launched"]
    return launches


def phase_mapping_model(batch=32, hw=80):
    """final_temp_conv's Model with use_pallas_mapping=True against False
    (K1 on in both), from the same weights: one batch-32 forward (launches,
    agreement, device time), then three Adam steps, one step's gradients,
    ms per train step and a profile of the switched step."""
    import torch

    from extended_gan_torch.models.gat.gat3d import Model as GatModel
    from extended_gan_torch.ops import gat_attention as k1
    from extended_gan_torch.ops import gat_mapping as k2

    kw = dict(attention_type="temporal", mapping_type="conv", use_pallas=True)
    switched = GatModel(hw, hw, 6, use_pallas_mapping=True,
                        generator=torch.Generator().manual_seed(0), **kw)
    unswitched = GatModel(hw, hw, 6, **kw)
    unswitched.load_state_dict(switched.state_dict())
    switched, unswitched = switched.cuda().eval(), unswitched.cuda().eval()
    x = torch.rand(batch, hw, hw, 4, 6, device="cuda",
                   generator=torch.Generator(device="cuda").manual_seed(0))

    def counts():
        return {"gat_mapping_fwd": k2.fwd_launch_count,
                "gat_mapping_bwd": k2.bwd_launch_count,
                "gat_attention_bwd": k1.bwd_launch_count}
    slow = dict(per_group=2, sleep_cycles=20_000_000)
    with torch.inference_mode(), torch.backends.cudnn.flags(
            enabled=True, allow_tf32=False):
        # the main path starts
        k2.fwd_launch_count = k2.bwd_launch_count = k1.bwd_launch_count = 0
        y = switched(x)
        forward_launches = counts()
        want = unswitched(x)
        torch.cuda.synchronize()
        check(forward_launches == {"gat_mapping_fwd": 2, "gat_mapping_bwd": 0,
                                   "gat_attention_bwd": 0},
              f"one switched forward launched {forward_launches}, expected "
              "2 gat_mapping_fwd")
        err = (y - want).abs().max().item()
        check(err <= TOL, f"switched forward differs from the unswitched one "
                          f"by {err:.3e}")
        on_ms = time_ms(lambda: switched(x), **slow)
        off_ms = time_ms(lambda: unswitched(x), **slow)
    with torch.inference_mode(), torch.backends.cudnn.flags(
            enabled=True, allow_tf32=True):
        off_tf32_ms = time_ms(lambda: unswitched(x), **slow)
    print(f"[forward] final_temp_conv b={batch}, use_pallas_mapping=True: "
          f"{on_ms:.4f} ms, False: {off_ms:.4f} ms exact, {off_tf32_ms:.4f} "
          f"ms with cuDNN TF32 (device time, CUDA events); max |switched - "
          f"unswitched| = {err:.3e}; {forward_launches} a forward")
    with torch.inference_mode():
        profile_window(lambda: switched(x), f"final_temp_conv b={batch} "
                       "use_pallas_mapping=True", "forward",
                       counter=("gat_mapping_fwd_kernel",
                                lambda: k2.fwd_launch_count))
    train = compare_train_steps(
        "temporal use_pallas_mapping=True", switched, unswitched, hw, "adam",
        # K1 runs in both models: 2 of its backward launches a step each
        counts, {"gat_mapping_fwd": 2, "gat_mapping_bwd": 2,
                 "gat_attention_bwd": 4}, batch=batch)
    return dict(forward_launches=forward_launches,
                train_launches=train["launched"], forward_ms=on_ms,
                forward_plain_ms=off_ms, forward_plain_tf32_ms=off_tf32_ms,
                train=train)


def k1_input_is_taken_in_place(model, x):
    """The smaat mapping's output as the model hands it to K1: its layout,
    and a profile of ``attend_temporal`` on it, which must record K1's
    kernel and nothing else (no layout copy in front of it)."""
    import torch

    from extended_gan_torch.models.gat.layers import normalized_adjacency
    from extended_gan_torch.ops import gat_attention as k1

    head = model.hidden_layer.head_0
    seen = []
    hook = head.mapping.register_forward_hook(
        lambda mod, args, out: seen.append(out))
    with torch.inference_mode():
        model(x)
    hook.remove()
    mapped = seen[0]  # (1, B, H, W, T', V)
    nh, b, h, w, t, v = mapped.shape
    layout = k1._layout(mapped.reshape(nh, b, h * w, t, v))
    check(layout == "plane", f"the smaat mapping hands K1 {layout!r} "
                             f"(strides {mapped.stride()}), not plane-major")
    calls = 5  # the profiler can miss a session's first kernel (PERF.md)
    with torch.inference_mode():
        a = head.a_temporal[..., 0]
        adj = normalized_adjacency(head.B_temporal)
        k1.attend_temporal(mapped, a, adj)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                k1.attend_temporal(mapped, a, adj)
            torch.cuda.synchronize()
    kernels = {e.key: e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0)) > 0}
    check(len(kernels) == 1 and "gat_attention_cluster_fwd" in next(
        iter(kernels)), f"{calls} calls of attend_temporal on the smaat "
        f"mapping's output ran {kernels}, expected K1's cluster kernel alone")
    print(f"[family] the smaat mapping hands K1 {tuple(mapped.shape)} "
          f"plane-major (strides {mapped.stride()}); {calls} calls of "
          f"attend_temporal on it record {sum(kernels.values())} kernels, all "
          f"{next(iter(kernels))[:60]}: no layout copy")


def phase_family(batch=32, hw=20):
    """The conv-GAT families of the port's tenth slice: final_temp_smaat
    (GAT3D with the smaat_unet mapping, K1 on) in process against its plain
    twin, five published configs through the CLI, and final_temp_smaat
    served over HTTP."""
    import torch

    from extended_gan_torch.models.gat.baseline import (
        BaselineModel,
        BaselineModel2D,
    )
    from extended_gan_torch.models.gat.gat3d import Model as GatModel
    from extended_gan_torch.models.gat.wrappers import _StackedGAT
    from extended_gan_torch.ops import dsconv as k3
    from extended_gan_torch.ops import gat_attention as k1
    from extended_gan_torch.ops import gat_mapping as k2

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    fused, plain = model_pair("temporal", "smaat_unet", hw)
    x = torch.rand(batch, hw, hw, 4, 6, device="cuda",
                   generator=torch.Generator(device="cuda").manual_seed(0))

    def counts():
        return {"gat_attention_fwd": k1.launch_count,
                "gat_attention_bwd": k1.bwd_launch_count,
                "dsconv_fwd": k3.launch_count, "dsconv_bwd": k3.bwd_launch_count,
                "gat_mapping_fwd": k2.fwd_launch_count,
                "gat_mapping_bwd": k2.bwd_launch_count}
    slow = dict(per_group=2, sleep_cycles=20_000_000)
    with torch.inference_mode():
        # the main path starts
        k1.launch_count = k1.bwd_launch_count = 0
        k3.launch_count = k3.bwd_launch_count = 0
        k2.fwd_launch_count = k2.bwd_launch_count = 0
        y = fused(x)
        forward_launches = counts()
        want = plain(x)
        torch.cuda.synchronize()
        check(forward_launches == {**dict.fromkeys(forward_launches, 0),
                                   "gat_attention_fwd": 4},
              f"one final_temp_smaat forward launched {forward_launches}, "
              "expected 4 gat_attention_fwd (3 + 1 unrolled heads) and no K3")
        err = (y - want).abs().max().item()
        check(bool(y.isfinite().all()) and err <= TOL,
              f"final_temp_smaat: K1 path differs from plain by {err:.3e}")
        fwd_ms = time_ms(lambda: fused(x), **slow)
        plain_fwd_ms = time_ms(lambda: plain(x), **slow)
    print(f"[family] final_temp_smaat b={batch} {hw}x{hw}: forward K1 path "
          f"{fwd_ms:.4f} ms, plain {plain_fwd_ms:.4f} ms (device time, CUDA "
          f"events, exact f32); max |K1 - plain| = {err:.3e}; "
          f"{forward_launches['gat_attention_fwd']} K1 launches a forward")
    k1_input_is_taken_in_place(fused, x)
    with torch.inference_mode():
        fwd_profile = profile_window(lambda: fused(x),
                                     f"final_temp_smaat b={batch}", "forward",
                                     counter=("gat_attention_cluster_fwd",
                                              lambda: k1.launch_count))
    # compared under SGD, as the UNet is: the pre-BatchNorm biases'
    # gradients are roundoff, which Adam would turn into steps of lr
    train = compare_train_steps(
        "temporal smaat_unet", fused, plain, hw, "sgd",
        lambda: {"gat_attention_fwd": k1.launch_count,
                 "gat_attention_bwd": k1.bwd_launch_count},
        {"gat_attention_fwd": 4, "gat_attention_bwd": 4}, batch=batch)
    adam_ms = adam_step_ms(fused, batch)
    print(f"[family] final_temp_smaat b={batch}: {adam_ms:.3f} ms a train "
          "step with Adam (the config's optimizer), K1 path")
    # the five published configs through the CLI (K1 only where JAX runs its
    # kernel: the Model families; the wrappers and baselines run none)
    cli = {
        "final_temp_smaat": train_experiment(
            "final_temp_smaat", {"gat_attention_fwd": 4},
            {"gat_attention_bwd": 4}, GatModel, step_batch=batch),
        "final_temp_conv_4heads": train_experiment(
            "final_temp_conv_4heads", {}, {}, _StackedGAT, step_batch=batch),
        "final_temp_linear_1lay": train_experiment(
            "final_temp_linear_1lay", {}, {}, _StackedGAT, step_batch=batch),
        "final_gat1d": train_experiment(
            "final_gat1d", {}, {}, BaselineModel, step_batch=batch),
        "final_gat2d": train_experiment(
            "final_gat2d", {}, {}, BaselineModel2D, step_batch=batch),
    }
    # served over HTTP at batch 32
    k1.launch_count = k1.bwd_launch_count = 0
    forwards, _, _ = serve_experiment(
        "convolutional_gat/experiments/final_temp_smaat", (batch,), 10,
        per_forward=4)
    served = k1.launch_count
    check(served == 4 * forwards and k1.bwd_launch_count == 0,
          f"serving final_temp_smaat: {served} K1 launches for {forwards} "
          "forwards")
    return dict(forward_launches=forward_launches, forward_ms=fwd_ms,
                plain_forward_ms=plain_fwd_ms, forward_profile=fwd_profile,
                train=train, adam_ms=adam_ms, cli=cli, serve=served)


def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(res.returncode == 0 and res.stdout.strip(),
          f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the GPU",
              file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "extended_gan_torch")):
        print("chip_smoke: run from the root of a checkout of the repo",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    t0 = time.perf_counter()
    try:
        build_logs = phase_build()
        rows, worst, k1_bwd_rows = phase_kernels(build_logs)
        dsc_rows, dsc_worst, dsc_bwd_worst = phase_dsconv()
        k2_fwd_rows, k2_bwd_rows = phase_mapping(build_logs)
        launches, models = phase_serve()
        phase_forward(models)
        train_launches = phase_train()
        k2_model = phase_mapping_model()
        family = phase_family()
        card = card_line()
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    # K1 at the hidden block, batch 32, in the cuDNN mapping's layout (the
    # served path's); the other layouts and the one-block kernel beside it
    k1_main = {r["layout"]: r for r in rows
               if (r["heads"], r["batch"], r["P"]) == (3, 32, 38400)}
    main_row = k1_main["cudnn"]
    one_block = next(r for r in rows if r["cluster"] is None)
    bwd_main = k1_bwd_rows[0]
    # K1 on the new families' paths: final_temp_smaat's forward, in-process
    # train steps, CLI run and server
    k1_family_fwd = {
        "forward final_temp_smaat b=32":
            family["forward_launches"]["gat_attention_fwd"],
        "final_temp_smaat train steps b=32, kernel path":
            family["train"]["launched"]["gat_attention_fwd"],
        "train final_temp_smaat":
            family["cli"]["final_temp_smaat"]["gat_attention_fwd"],
        "serve final_temp_smaat": family["serve"]}
    k1_family_bwd = {
        "final_temp_smaat train steps b=32, kernel path":
            family["train"]["launched"]["gat_attention_bwd"],
        "train final_temp_smaat":
            family["cli"]["final_temp_smaat"]["gat_attention_bwd"]}
    # K3's largest final_smaatunet launch by work: up4's first DSC
    dsc_main = max((r for r in dsc_rows if r["where"] != "tiled-variant shape"),
                   key=lambda r: r["gflop"])
    kernels = [{
        "name": "gat_attention_fwd",
        "route": "cuda",
        "source": "extended_gan_torch/ops/csrc/gat_attention.cu",
        "replaces": "extended_gan_tpu/ops/pallas/gat_attention.py:62",
        "launches": (launches + train_launches["gat_attention_fwd"]
                     + sum(k1_family_fwd.values())),
        "launches_by_path": {
            "serve": launches,
            "train final_temp_conv": train_launches["gat_attention_fwd"],
            **k1_family_fwd},
        "max_abs_err": worst,
        "ms": main_row["kernel_ms"],
        "kernel_ms": main_row["kernel_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
        "cluster": main_row["cluster"],
        "ms_by_layout": {k: r["kernel_ms"] for k, r in k1_main.items()},
        "one_block_kernel": {
            "shape": "heads=1 B=1 M=4 P=240000 (200x200, beyond a cluster)",
            "ms": one_block["kernel_ms"], "plain_ms": one_block["plain_ms"],
            "bound_ms": one_block["bound_ms"],
            "max_abs_err": one_block["max_abs_err"]},
        "shape": "heads=3 B=32 M=4 P=38400 (80x80 hidden layer, batch 32, "
                 "m as the cuDNN mapping hands it over)",
    }, {
        "name": "gat_attention_bwd",
        "route": "cuda",
        "source": "extended_gan_torch/ops/csrc/gat_attention.cu",
        # the JAX _bwd is plain JAX beside the Pallas forward, not a kernel
        "replaces": "extended_gan_tpu/ops/pallas/gat_attention.py:170",
        "launches": (train_launches["gat_attention_bwd"]
                     + train_launches["gat_train_step"]["gat_attention_bwd"]
                     + k2_model["train_launches"]["gat_attention_bwd"]
                     + sum(k1_family_bwd.values())),
        "launches_by_path": {
            "train final_temp_conv": train_launches["gat_attention_bwd"],
            "temporal train steps b=32, kernel path":
                train_launches["gat_train_step"]["gat_attention_bwd"],
            "train steps b=32, use_pallas_mapping=True":
                k2_model["train_launches"]["gat_attention_bwd"],
            **k1_family_bwd},
        "max_abs_err": max(r["max_abs_err"] for r in k1_bwd_rows),
        "ms": bwd_main["kernel_ms"],
        "kernel_ms": bwd_main["kernel_ms"],
        "plain_ms": bwd_main["plain_ms"],
        "autograd_of_plain_forward_ms": bwd_main["autograd_ms"],
        "bound_ms": bwd_main["bound_ms"],
        "bound_by": bwd_main["bound_by"],
        "library_ms": None,
        "cluster": bwd_main["cluster"],
        "shape": "heads=3 B=32 M=4 P=38400 (80x80 hidden layer, batch 32)",
    }, {
        "name": "dsconv_fwd",
        "route": "cuda",
        "source": "extended_gan_torch/ops/csrc/dsconv.cu",
        "replaces": "extended_gan_tpu/ops/pallas/dsconv.py:66",
        "launches": train_launches["dsconv_fwd"],
        "launches_by_path": {
            "train final_smaatunet": train_launches["dsconv_fwd"],
            "unet train steps b=32, kernel path":
                train_launches["unet_train_step"]["dsconv_fwd"]},
        "max_abs_err": dsc_worst,
        "ms": dsc_main["kernel_ms"],
        "kernel_ms": dsc_main["kernel_ms"],
        "plain_ms": dsc_main["plain_ms"],
        "bound_ms": dsc_main["bound_ms"],
        "bound_by": dsc_main["bound_by"],
        "library_ms": None,
        "cudnn_pair_ms": dsc_main["cudnn_pair_ms"],
        "cudnn_pair_tf32_ms": dsc_main["cudnn_pair_tf32_ms"],
        "total_18_ms": sum(r["kernel_ms"] for r in dsc_rows[:18]),
        "shape": "N=%d %dx%d C=%d CK=%d Cout=%d (final_smaatunet b=32, "
                 "up4 dsc0)" % dsc_main["shape"],
    }, {
        "name": "dsconv_bwd",
        "route": "cuda",
        "source": "extended_gan_torch/ops/csrc/dsconv.cu",
        # the JAX _bwd is jax.vjp of _reference_dsc, not a Pallas kernel
        "replaces": "extended_gan_tpu/ops/pallas/dsconv.py:324",
        "launches": train_launches["dsconv_bwd"],
        "launches_by_path": {
            "train final_smaatunet": train_launches["dsconv_bwd"],
            "unet train steps b=32, kernel path":
                train_launches["unet_train_step"]["dsconv_bwd"]},
        "max_abs_err": dsc_bwd_worst,
        "ms": dsc_main["bwd_kernel_ms"],
        "kernel_ms": dsc_main["bwd_kernel_ms"],
        "plain_ms": dsc_main["bwd_plain_ms"],
        "bound_ms": dsc_main["bwd_kernel_bound_ms"],
        "bound_by": dsc_main["bwd_kernel_bound_by"],
        # aten.convolution_backward of the depthwise conv from gd (cuDNN,
        # exact f32): dx, ddw and ddwb in one call
        "library_ms": dsc_main["bwd_library_ms"],
        "library_total_18_ms": sum(r["bwd_library_ms"]
                                   for r in dsc_rows[:18]),
        "whole_backward_ms": dsc_main["bwd_ms"],
        "whole_backward_bound_ms": dsc_main["bwd_bound_ms"],
        "cudnn_pair_backward_ms": dsc_main["bwd_cudnn_pair_ms"],
        "cudnn_pair_backward_tf32_ms": dsc_main["bwd_cudnn_pair_tf32_ms"],
        "total_18_ms": sum(r["bwd_kernel_ms"] for r in dsc_rows[:18]),
        "shape": "N=%d %dx%d C=%d CK=%d Cout=%d (final_smaatunet b=32, "
                 "up4 dsc0)" % dsc_main["shape"],
    }]
    # K2 at final_temp_conv's hidden block, batch 32: the largest launch
    for name, line, rows in (("gat_mapping_fwd", 107, k2_fwd_rows),
                             ("gat_mapping_bwd", 127, k2_bwd_rows)):
        main_k2 = rows[0]
        by_path = {"forward b=32, use_pallas_mapping=True":
                   k2_model["forward_launches"][name],
                   "train final_temp_conv b=32, 3 Adam steps":
                   k2_model["train_launches"][name],
                   "serve and CLI train runs (switch off)": 0}
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "extended_gan_torch/ops/csrc/gat_mapping.cu",
            "replaces": f"extended_gan_tpu/ops/pallas/gat_mapping.py:{line}",
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main_k2["kernel_ms"],
            "kernel_ms": main_k2["kernel_ms"],
            "plain_ms": main_k2["plain_ms"],
            "bound_ms": main_k2["bound_ms"],
            "bound_by": main_k2["bound_by"],
            "library_ms": None,
            "f32_peak_pct": main_k2["f32_peak_pct"],
            "cudnn_ms": main_k2["plain_ms"],
            "cudnn_tf32_ms": main_k2["cudnn_tf32_ms"],
            "shape": "NH={} B={} V={} {}x{} (final_temp_conv hidden block, "
                     "batch 32)".format(*main_k2["shape"],
                                        main_k2["shape"][3]),
        })
    print(f"[smoke] all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
