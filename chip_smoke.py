#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``extended_gan_torch``) on one GPU.

  python3 chip_smoke.py      # from the root of a checkout, one NVIDIA H100

Phases, each fatal on failure (non-zero exit, no result line):

1. build   - compile every kernel in ``extended_gan_torch/ops/csrc/`` with
             nvcc (one process per source, all at once) into build/kernels/,
             and the host's C++ batch core with g++ into build/native/.
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
8. dcgan   - the published DCGAN (nc 4, ndf 64, 64x64, b=32) through
             ``python -m extended_gan_torch.dcgan`` for an epoch of 6
             batches, checkpointed (--save-epoch 1) into a temporary
             directory; in process, the card's exact f32 forwards, step,
             gradients and running statistics against float64 on the CPU;
             the train and eval steps' times. No kernel of the port.
9. serve_extras - serving what the port trains: the generator of that
             checkpoint exported (``python -m extended_gan_torch.serve
             export --workload dcgan --check``) as f32, w8, w8a8 and a
             3-step rollout, each served over HTTP at b = 1, 5 and 32
             (p50) and held against the same artifact on the CPU (1e-5,
             w8a8 5e-3), its b=32 forward timed; the w8a8 layers' int32
             accumulators on the card equal to the CPU's float64 product
             on the same int8 inputs, and the card's int8 activations
             equal to the CPU's from the same input; w8 within 5e-3 and
             w8a8 within 3e-2 of f32; final_temp_conv and final_smaatunet
             exported as w8 from --init-seed 0 and served at b=32 (gap to
             f32, byte ratio, K1 2 and K3 18 launches a forward, as on the
             f32 path); ``serve predict`` over final_temp_conv's synthetic
             test split (17 windows: one batch) and 4 batches of its train
             split (samples/s, K1 2 launches a batch).
10. megastep - K = 8 train steps a CUDA graph and the archive resident on
             the card: a synthetic KNMI archive at the published geometry
             (20 train files of 96 frames of 80x80x6, 295 MB resident, 2
             test files); ``python -m extended_gan_torch.gat train`` of
             final_temp_conv's model with ``--resident --megastep 8
             --max-batches 16`` (2 programs, launches by the replay rule);
             in process, graph against eager over 3 programs (final state
             and, apart, ``*_nd`` logs, each tensor within MEGA_LIMIT of
             its scale, cuDNN deterministic on both sides; each
             replayed program from the graph's own state before it), ms a
             step eager against graph, one replay
             profiled (busy time, kernels, the port's kernels by name equal
             to the launch counters) and the graph pool's bytes, for
             final_temp_conv resident (K1 2 + 2 a step in the graph), the
             same with use_pallas_mapping=True (K2 2 + 2 too),
             final_smaatunet (K3 18 + 18), final_temp_smaat (K1 4 + 4, K =
             2 steps a graph) and the published DCGAN resident with
             dropout 0; with dropout 0.01, two replays from one state
             differ; ``python -m extended_gan_torch.dcgan --resident
             --megastep 8`` on a 1,024-frame archive; both CLIs with
             ``--megastep 8`` streaming (not resident) for one epoch whose
             tail group is shorter and whose ragged batches are padded
             (2 graphs captured), against the same epoch with the K steps
             run eagerly.
11. robustness - state and robustness (``core/precision.py``,
             ``core/prng.py``, ``train/preempt.py``, the resume half of
             ``train/checkpoint.py``, remat), at full width: a child process
             (this script with ``--robustness-child``) runs a driver and
             gets a real SIGTERM after its Nth step or group; it writes a
             snapshot and exits 0; this process resumes it and holds it to
             an uninterrupted run: final_temp_conv's model with K1 and K2
             (80x80, b=32) streaming and ``--resident --megastep 4``, the
             published DCGAN (dropout 0.01) through its CLI, streaming and
             ``--resident --megastep 4``, bit for bit, cuDNN deterministic;
             final_smaatunet (K3) within ``utils/compare.py``'s bound of two
             more uninterrupted runs (a skipped optimizer step must fail
             it); the snapshot's bytes, the time to write it, the signal to
             the exit. bf16 against float32 on the DCGAN, final_temp_conv
             (K2 off and on) and final_smaatunet at b=32: ms a step eager
             and as a K=4 graph, busy time and kernels a step, peak memory,
             the kernels' launches (equal), 4 steps' losses from one state
             (ROBUST_LOSS_REL), float32 parameters and moments. remat on
             final_temp_conv and final_smaatunet: peak memory and ms a step
             with and without, gradients equal (bitwise for GAT3D), each
             forward kernel twice a step.
12. cyclegan - the CycleGAN (two DCGAN generators, two FrameDiscriminators;
             nc 4, ndf 64, 64x64, b=32, cycle lambda 10): ``python -m
             extended_gan_torch.cycle_gan --synthetic --epochs 2
             --max-batches 4 --save-epoch 1 --out-dir``; in process the
             card's exact f32 eval forwards, step losses, gradients and
             running statistics against float64 on the CPU (the dcgan
             phase's bounds); ms a step eager and as a K=8 CUDA graph over
             the resident archive, busy, kernels, peak memory; the graph
             bit for bit against eager steps; a SIGTERM mid-epoch in a
             child and ``--resume``, bitwise against an uninterrupted run,
             streaming and ``--resident --megastep 8``; a bf16 step; ``serve
             export --workload cyclegan`` of both directions, f32 and
             w8a8, checked on the card. K1, K2 and K3 launch 0 times.
13. vanilla_gan - the vanilla MLP GAN (latent 100, 28x28, b=64): the
             default and FusedProp steps in exact f32 against float64 on
             the CPU, ms a step of each, and ``python -m
             extended_gan_torch.vanilla_gan`` for 20 batches with its PNG
             grids. K1, K2 and K3 launch 0 times.
14. host_data - in a process of its own (the first profiler session of
             that process), the KNMI host pipeline and the drivers'
             profiling: the C++ batch core (``data/csrc/egt_native.cpp``,
             built with g++ beside the CUDA kernels in phase 1) and the
             loaders' rates at b=32 over a 20-file archive of 96 frames of
             80x80x6 (numpy, native, global shuffle with pool 4 and 0;
             native against numpy within HOST_ATOL + HOST_RTOL); after a
             2-step warm-up epoch, ``python -m extended_gan_torch.gat
             generate_experiment`` of final_temp_conv's config with
             SHUFFLE_MODE "global", ``--profile --profile-trace-dir``, 12
             steps (the profiling keys in history.json, K1's kernel records
             in the trace equal to its launch counters), and the same epoch
             on the numpy and the native loader: device busy against wall;
             conv_impl chanfirst against cuDNN exact and TF32 and K2 at b=32
             (forward and train-step ms, agreement with exact cuDNN); the
             DCGAN and CycleGAN CLIs with ``--profile --profile-trace-dir``,
             streaming and ``--megastep 2``.
15. gan_variants - the DCGAN's step bodies and packed generator, and the
             UNet's leftovers, run before host_data: the
             published DCGAN (b=32, exact f32) with the default body,
             ``fused_disc``, ``fused_prop``, both, and ``packed_g``: one
             step's gradients and running statistics against the same body
             in float64 on the CPU per tensor (a planted fault, the fake
             rows against label 1, must miss the limits), ms a step eager
             and as a K=8 graph, busy ms and kernels a step, peak MiB, the
             graph against eager; each body through ``python -m
             extended_gan_torch.dcgan`` streaming and ``--resident
             --megastep 8``; the CycleGAN CLI with ``--packed-g`` and
             ``serve export --packed-g --check`` of three generators;
             ``UnetModel(per_vertex_bn=True)`` and the ``bilinear=False``
             SmaAt-UNet at final_smaatunet's width against the plain DSC
             (K3 18 a forward, 18 + 18 a step). K1 and K2 0 launches.
16. moe     - the Switch-MoE SmaAt-UNet (``models/moe.py``; final_smaatunet's
             geometry, 20x20, V 6, b=32, E = 8: 12,437,540 parameters): one
             step on the card against float64 on the CPU per tensor, the
             routing of every token equal, the gate left out of combine
             (a planted fault) failing; ``per_vertex_bn`` (each vertex
             routed apart) one step against the plain DSC; ms a step
             eager and as a K=8 graph in f32 and bf16, busy ms, kernels a
             step, peak MiB, and the UNet without the MoE beside it (the
             MoE's own busy time); the graph against eager; ``python -m
             extended_gan_torch.gat train --model-type unet --moe-experts
             8`` streaming and ``--megastep 8 --resident``; a run cut by
             a SIGTERM in a child process mid-epoch and resumed, against
             uninterrupted runs;
             ``serve export`` f32 and w8 with ``--check``, served over HTTP
             at b = 1 and 5, each reply against a batch-1 forward on the
             CPU. K3 18 + 18 a step (the MoE adds no launch); K1, K2 0.
17. preprocess - the preprocessing tools feeding the card's trainers: a
             synthetic ARAI archive through ``preprocess.arai`` (numpy
             reader) then ``python -m extended_gan_torch.gat train
             --dataset arai`` (K1 2 + 2 a step), a coastal ``.npy`` dump
             through ``preprocess.coastal_sea`` then ``python -m
             extended_gan_torch.cycle_gan``. The KNMI tool reads HDF5 (no
             h5py on the card's machine): held on the CPU only.
18. figures - figures, plots and ``compare_models`` (the card's machine
             has no matplotlib): final_smaatunet and final_temp_conv trained
             for 2 steps through the CLI (each figure not drawn: one line),
             ``python -m extended_gan_torch.compare_models`` over both
             (4,032,548 and 43,936 parameters, metrics equal to the plain
             versions' on the same checkpoints, K3 18 and K1 2 launches a
             forward), the figures' panels against the plain path's,
             ``create_plots``, the DCGAN and CycleGAN CLIs' figures.
19. data_parallel - the conv-GAT trainer's data axis: two gloo ranks on
             the one card (``--dp-child``), final_smaatunet (cross-rank
             BatchNorm, K3 18 + 18 a step) and final_temp_conv (K1 2 + 2)
             with 16 rows each of 3 batches of 32, against the same Adam
             steps in one process in float64, a planted per-rank
             BatchNorm that must miss; ``--multihost`` over a world of one
             (NCCL) against the plain CLI, bit for bit; ``--data-axis 2``
             on one card raises.
20. gan_data_parallel - the DCGAN and CycleGAN over the data axis, and
             graphs under it: two gloo ranks on the one card
             (``--gan-dp-child``) train the published DCGAN (3 Adam steps)
             and CycleGAN (2) with 16 rows each of batches of 32, dropout
             on, against one process in float64; per-rank dropout masks
             and unreduced D gradients planted, each missing by 10x;
             cross-rank BatchNorm alone against float64, a mean rounded to
             float32 planted, missing by 10x; the
             gat (final_smaatunet K3 144 + 144, final_temp_conv K1 16 + 16),
             dcgan and cycle_gan CLIs with ``--megastep 8 --resident`` as
             an NCCL world of one (``--gan-dp-cli-child``) against the
             plain CLI; graphs over gloo on the card raise, naming NCCL.
21. fsdp    - FSDP / ZeRO-3 over the data axis (``parallel/fsdp.py``):
             two gloo ranks on the one card (``--fsdp-child``), every leaf
             of at least 4096 elements and its Adam moments cut in two:
             the published DCGAN (3 Adam steps, default body) and
             final_smaatunet's model (3, K3 18 + 18 a step a rank), 16
             rows each of batches of 32, against the same ranks without
             FSDP (bit for bit) and one process in float64 (the
             data_parallel and gan_data_parallel phases' references); each
             rank's parameter and moment bytes against JAX's rule at D = 2;
             D's weights left stale after its step planted, missing by 10x.
22. report - the total time, the ``kernels`` JSON line, the card's name and
             power limit, and the last line ``{"ok": true, "device":
             {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import itertools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
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
    """Builds every kernel source, and the host's C++ batch core
    (``extended_gan_torch/data/csrc/egt_native.cpp``, g++) beside them;
    returns each kernel source's nvcc log."""
    from extended_gan_torch.data import native
    from extended_gan_torch.ops import build

    t0 = time.perf_counter()
    host = {}

    def build_host():
        try:
            host["lib"] = native.build()
        except RuntimeError as e:
            host["error"] = str(e)
        host["seconds"] = time.perf_counter() - t0
    thread = threading.Thread(target=build_host)
    thread.start()
    try:
        report = build.build()
    finally:
        thread.join()
    secs = time.perf_counter() - t0
    check("error" not in host, f"the host batch core did not build: "
          f"{host.get('error')}")
    print(f"[build] data/csrc/egt_native.cpp: g++ {host['seconds']:.2f} s "
          f"into {host['lib']}")
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
    # device-side kernel events only: operator rows repeat their kernels'
    # time, and a user annotation's device row (the optimizers' step) spans
    # kernels counted on their own
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and dev_us(e) > 0 and not getattr(e, "is_user_annotation",
                                                 False)]
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
                        per_step, batch=32, steps=3, rounds=1,
                        profiled=3):
    """One step's gradients and three train steps with the kernels and
    with the plain versions, from the same weights on the same batches
    (exact f32: TF32 off), then the step time of each path and a profile of
    the kernel path's step. ``counts()`` gives the launch counts of the
    kernels under test and ``per_step`` what one train step adds to each.
    ``rounds`` > 1: that many alternating rounds of kernel and plain steps
    (exact f32), each printed, their medians kept, and the plain path's
    step profiled too; ``profiled``: the steps a profile spans. Returns
    the kernel path's launches and the step times."""
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
                f"{path} path, exact f32", "train step", n=profiled)
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


# The torch operators that move no data: views and allocations. Anything
# else that ``attend_temporal`` dispatches would be a kernel in front of K1's.
K1_NO_COPY_OPS = frozenset((
    "alias", "as_strided", "detach", "empty", "empty_like", "empty_strided",
    "expand", "new_empty", "new_empty_strided", "permute", "select", "slice",
    "squeeze", "t", "transpose", "unsqueeze", "view", "_unsafe_view",
    "reshape"))


def _dispatched_ops(fn):
    """The names of the torch operators that ``fn()`` dispatches, in order;
    a ``reshape`` that copies (its result shares no storage with its
    input) as "reshape (copy)". Unlike the profiler's kernel record, which
    can miss launches (PERF.md §7), this record is exact."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            if name == "reshape" and (
                    out.untyped_storage().data_ptr()
                    != args[0].untyped_storage().data_ptr()):
                name = "reshape (copy)"
            self.ops.append(name)
            return out

    with Record() as record:
        fn()
    return record.ops


def k1_input_is_taken_in_place(model, x):
    """The smaat mapping's output as the model hands it to K1: its layout,
    the cluster kernel's plan for it, the torch operators that
    ``attend_temporal`` on it dispatches, which must move no data (no
    layout copy in front of K1), and a profile of it, which must record no
    kernel but K1's."""
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
    plan = k1._cluster_plan(nh, b, h * w, t * v)
    check(plan is not None, f"no cluster plan for K1 on {tuple(mapped.shape)}"
                            ": the one-block kernel would copy it to rows")
    calls = 20
    with torch.inference_mode():
        a = head.a_temporal[..., 0]
        adj = normalized_adjacency(head.B_temporal)
        k1.attend_temporal(mapped, a, adj)
        torch.cuda.synchronize()
        before = k1.launch_count
        ops = _dispatched_ops(lambda: k1.attend_temporal(mapped, a, adj))
        launched = k1.launch_count - before
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                k1.attend_temporal(mapped, a, adj)
            torch.cuda.synchronize()
    moving = sorted(set(ops) - K1_NO_COPY_OPS)
    check(launched == 1 and not moving,
          f"one call of attend_temporal on the smaat mapping's output "
          f"launched K1 {launched} times and dispatched {moving} beside "
          f"views and allocations ({ops}), expected one launch and no copy")
    kernels = {e.key: e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0)) > 0}
    check(all("gat_attention_cluster_fwd" in k for k in kernels),
          f"{calls} calls of attend_temporal on the smaat mapping's output "
          f"ran {kernels}, expected K1's cluster kernel alone")
    print(f"[family] the smaat mapping hands K1 {tuple(mapped.shape)} "
          f"plane-major (strides {mapped.stride()}); one call of "
          f"attend_temporal on it dispatches {ops}: one K1 launch (cluster "
          f"plan {plan}), no layout copy; the profiler records "
          f"{sum(kernels.values())} of the {calls} launches of {calls} calls, "
          f"and no other kernel")


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
                                     n=2,
                                     counter=("gat_attention_cluster_fwd",
                                              lambda: k1.launch_count))
    # compared under SGD, as the UNet is: the pre-BatchNorm biases'
    # gradients are roundoff, which Adam would turn into steps of lr
    train = compare_train_steps(
        "temporal smaat_unet", fused, plain, hw, "sgd",
        lambda: {"gat_attention_fwd": k1.launch_count,
                 "gat_attention_bwd": k1.bwd_launch_count},
        {"gat_attention_fwd": 4, "gat_attention_bwd": 4}, batch=batch,
        profiled=1)  # 13,935 kernels a step: the trace's handling is slow
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


# The DCGAN phase holds the card's exact-f32 nets (TF32 off) against the
# same nets in float64 on the CPU. f32 rounds every input and intermediate
# by up to u = 2**-24 (6e-8), so a result lands a few u times its condition
# number from float64:
# - the eval forwards are well conditioned (sums of at most 512 * 16 =
#   8,192 products, BatchNorm from running statistics, outputs in [0, 1]):
#   DCGAN_FWD_TOL, absolute, is 170 u; f32 on the CPU lands within one u,
#   and one operand rounded to TF32 (u = 2**-11) moves them by about 1e-4
#   (printed beside it);
# - one step's losses, relative: errG is taken through the discriminators
#   after their Adam step, which moves each entry by about lr times the sign
#   of its gradient, so an entry whose gradient is within roundoff of zero
#   may step either way (on the CPU f32 lands 9e-6 from float64, and one
#   part in 1e7 of input noise moves float64 4e-6); three steps compound it
#   (1.6e-4 and 2.1e-4 on the CPU);
# - gradients and running statistics, per net over its largest entry: the
#   gradient of train-mode BatchNorm subtracts the batch means of g and of
#   g * xhat, so these are ill-conditioned (one part in 1e7 of input noise
#   moves the generator's float64 gradients by 2.2e-3 of the largest): held
#   to DCGAN_SENS_FACTOR times what that noise moves the float64 step's own
#   result in this run, and never under DCGAN_FLOOR, 10x the worst gap of
#   one tensor over its own largest entry that f32 on the CPU shows (FD's
#   statistics, 4.5e-5, whose third update follows the Adam step).
DCGAN_FWD_TOL = 1e-5
DCGAN_LOSS_TOL = 1e-4
DCGAN_LOSSES_TOL = 2e-3
DCGAN_SENS_FACTOR, DCGAN_FLOOR = 10, 5e-4
DCGAN_KEYS = ("train_mse", "pred_mse", "pred_accuracy", "pred_precision",
              "pred_recall", "frame_disc_accuracy", "temp_disc_accuracy",
              "train_fd_accuracy", "train_td_accuracy")


def _tree_state(root, skip=("build", "__pycache__", ".git")):
    """{path: (size, mtime)} of every file under ``root``, what the port
    builds or caches (and the temporary directory, should it lie there)
    left out."""
    import tempfile

    tmp = os.path.realpath(tempfile.gettempdir())
    state = {}
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d not in skip
                   and os.path.realpath(os.path.join(dirpath, d)) != tmp]
        for f in files:
            st = os.stat(os.path.join(dirpath, f))
            state[os.path.join(dirpath, f)] = (st.st_size, st.st_mtime_ns)
    return state


def dcgan_steps(nets, batches, device, dtype):
    """The three nets' weights in fresh nets on ``device`` in ``dtype``,
    dropout off, with Adam as the driver builds it: their eval forwards on
    the first batch, then one train step's losses, gradients and running
    statistics, then the losses of a step on each further batch."""
    import torch

    from extended_gan_torch.models.dcgan import (
        FrameDiscriminator,
        Generator,
        TemporalDiscriminator,
    )
    from extended_gan_torch.train.dcgan_driver import DEFAULT_PARAMS
    from extended_gan_torch.train.dcgan_trainer import make_dcgan_train_step

    nc, ndf = DEFAULT_PARAMS["nc"], DEFAULT_PARAMS["ndf"]
    copies = (Generator(nc, 0.0), FrameDiscriminator(nc, ndf),
              TemporalDiscriminator(nc, ndf, 0.0))
    for c, n in zip(copies, nets):
        c.load_state_dict(n.state_dict())
    nets = tuple(c.to(device, dtype) for c in copies)
    opts = tuple(torch.optim.Adam(n.parameters(), lr=DEFAULT_PARAMS["lr"],
                                  betas=(DEFAULT_PARAMS["beta1"], 0.999),
                                  eps=1e-8) for n in nets)
    step = make_dcgan_train_step(*nets, *opts)
    data = [tuple(torch.from_numpy(a).to(device, dtype) for a in b)
            for b in batches]
    x, y = data[0]
    with torch.no_grad():
        for n in nets:
            n.eval()
        fwd = [nets[0](x), nets[1](y), nets[2](torch.cat([x, y], 1))]
    out = dict(fwd=[t.double().cpu() for t in fwd], losses=[])
    for i, (x, y) in enumerate(data):
        logs = step(x, y)
        out["losses"].append([float(logs[k]) for k in ("errFD", "errTD",
                                                        "errG")])
        if i == 0:
            # copies: the next steps update the statistics in place
            out["grads"] = [[p.grad.to("cpu", torch.float64, copy=True)
                             for p in n.parameters()] for n in nets]
            out["stats"] = [[b.to("cpu", torch.float64, copy=True)
                             for k, b in n.state_dict().items()
                             if "running" in k] for n in nets]
    return out


def _leaf_gaps(got, want):
    """max |got - want| of each tensor of a net, in units of the net's
    largest entry (numpy, one a tensor)."""
    import numpy as np

    largest = max(w.abs().max().item() for w in want)
    return np.array([(g - w).abs().max().item() / largest
                     for g, w in zip(got, want)])


def _net_gap(got, want):
    """max |got - want| over a net's tensors, in units of its largest
    entry."""
    largest = max(w.abs().max().item() for w in want)
    return max((g - w).abs().max().item() for g, w in zip(got, want)) / largest


def phase_dcgan(out, batch=32):
    """The published DCGAN (nc 4, ndf 64, 64x64, batch 32) as a user trains
    it: one CLI epoch on the synthetic archive, checkpointed, outputs in the
    empty temporary directory ``out`` (which the ``serve_extras`` phase
    exports from); then, in process and from seed 0 with dropout off, the
    card's exact-f32 forwards, step, gradients and running statistics
    against float64 on the CPU, and the times of a train and an eval step.
    No CUDA kernel of the port is on this path (as no Pallas kernel is on
    the JAX package's): every launch count stays 0."""
    import numpy as np
    import torch

    from extended_gan_torch import ops
    from extended_gan_torch.data.streaming import get_h5_loaders
    from extended_gan_torch.data.synthetic import ensure_synthetic_h5
    from extended_gan_torch.dcgan.__main__ import main as cli
    from extended_gan_torch.ops import dsconv as k3
    from extended_gan_torch.ops import gat_attention as k1
    from extended_gan_torch.ops import gat_mapping as k2
    from extended_gan_torch.train.dcgan_driver import (
        DEFAULT_PARAMS,
        build_dcgan,
    )
    from extended_gan_torch.train.dcgan_trainer import (
        make_dcgan_eval_step,
        make_dcgan_train_step,
        to_nchw,
    )

    t_phase = time.perf_counter()
    card = card_line()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # 1. the CLI, one epoch of 6 batches, checkpointed
    before = _tree_state(REPO)
    # the main path starts here
    k1.launch_count = k1.bwd_launch_count = 0
    k3.launch_count = k3.bwd_launch_count = 0
    k2.fwd_launch_count = k2.bwd_launch_count = 0
    t0 = time.perf_counter()
    nets, history = cli(["--epochs", "1", "--max-batches", "6",
                         "--synthetic", "--out-dir", out, "--save-epoch", "1"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    written = sorted(os.listdir(out))
    after = _tree_state(REPO)
    check(all(next(n.parameters()).device.type == "cuda" for n in nets),
          "dcgan CLI: the nets are not on the card")
    results = {k: v[0] for k, v in history.history.items()}
    check(sorted(results) == sorted(DCGAN_KEYS),
          f"dcgan CLI: result keys {sorted(results)}")
    check(_finite(results.values()), f"dcgan CLI: results {results}")
    check(all(bool(p.isfinite().all()) for n in nets for p in n.parameters()),
          "dcgan CLI: non-finite parameters after training")
    check(written == ["checkpoints", "history.json"],
          f"dcgan CLI: wrote {written} into --out-dir")
    changed = sorted(set(before.items()) ^ set(after.items()))
    check(not changed, f"dcgan CLI: wrote into the checkout: {changed[:5]}")
    check(not any(launches.values()),
          f"dcgan CLI: CUDA kernel launches {launches}, expected none")
    print(f"[dcgan] python -m extended_gan_torch.dcgan --epochs 1 "
          f"--max-batches 6 --synthetic --out-dir <tmp> "
          f"--save-epoch 1 (nc 4, ndf 64, 64x64, b=32): {cli_s:.2f} s with "
          f"start-up, results {json.dumps(results)}; only history.json and "
          f"checkpoints/ written, under --out-dir; launches {launches}")

    # 2. agreement: the card's exact f32 against float64 on the CPU
    nets, _ = build_dcgan(DEFAULT_PARAMS, seed=0, device="cuda", dropout=0.0)
    folder = ensure_synthetic_h5(None, frames_train=256, frames_test=64,
                                 h=64, w=64)
    loader, _ = get_h5_loaders(folder, batch, 64, crop=64, in_seq_len=4,
                               out_seq_len=4, seed=1)
    batches = [tuple(to_nchw(a) for a in next(loader)) for _ in range(3)]
    check(all(len(b[0]) == batch for b in batches), "short batch")
    noise = np.random.default_rng(99).standard_normal(batches[0][0].shape)
    perturbed = [((batches[0][0] * (1 + 1e-7 * noise)).astype(np.float32),
                  batches[0][1])]
    t0 = time.perf_counter()
    card_run = dcgan_steps(nets, batches, torch.device("cuda"), torch.float32)
    ref = dcgan_steps(nets, batches, torch.device("cpu"), torch.float64)
    # the noise's effect in float64 on the card (its roundoff, 1e-16, is
    # far below it); the reference above stays the CPU's
    moved = dcgan_steps(nets, perturbed, torch.device("cuda"), torch.float64)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
        tf32_fwd = dcgan_steps(nets, batches[:1], torch.device("cuda"),
                               torch.float32)["fwd"]
    ref_s = time.perf_counter() - t0
    fwd_err = max((a - b).abs().max().item()
                  for a, b in zip(card_run["fwd"], ref["fwd"]))
    tf32_err = max((a - b).abs().max().item()
                   for a, b in zip(tf32_fwd, ref["fwd"]))
    check(fwd_err <= DCGAN_FWD_TOL,
          f"dcgan eval forwards: card f32 vs CPU float64 {fwd_err:.3e} "
          f"(limit {DCGAN_FWD_TOL})")
    got, want = np.array(card_run["losses"]), np.array(ref["losses"])
    check(np.isfinite(got).all(), f"dcgan losses {got}")
    rel = np.abs(got - want) / np.abs(want)
    check(rel[0].max() <= DCGAN_LOSS_TOL,
          f"dcgan step 1 losses {got[0]} vs float64 {want[0]}: {rel[0]}")
    check(rel.max() <= DCGAN_LOSSES_TOL,
          f"dcgan 3 steps' losses {got} vs float64 {want}: {rel}")
    lines = []
    for what in ("grads", "stats"):
        for name, g, w, m in zip(("G", "FD", "TD"), card_run[what], ref[what],
                                 moved[what]):
            if not w:
                continue
            gap, sens = _net_gap(g, w), _net_gap(m, w)
            limit = max(DCGAN_FLOOR, DCGAN_SENS_FACTOR * sens)
            check(gap <= limit, f"dcgan {what} of {name}: card f32 vs CPU "
                  f"float64 {gap:.3e} of the largest entry (limit "
                  f"{limit:.3e}; 1e-7 input noise moves float64 {sens:.3e})")
            lines.append(f"{what} {name} {gap:.3e} (limit {limit:.3e}, "
                         f"noise {sens:.3e})")
    print(f"[dcgan] agreement, card exact f32 vs CPU float64, full width "
          f"from seed 0, dropout off, b={batch} ({ref_s:.1f} s): eval "
          f"forwards {fwd_err:.3e} (limit {DCGAN_FWD_TOL}; with TF32 "
          f"{tf32_err:.3e}); step 1 losses {rel[0].max():.3e} relative "
          f"(limit {DCGAN_LOSS_TOL}), 3 steps {rel.max():.3e} (limit "
          f"{DCGAN_LOSSES_TOL}); " + "; ".join(lines))

    # 3. times, from seed 0 with the CLI's dropout
    nets, opts = build_dcgan(DEFAULT_PARAMS, seed=0, device="cuda")
    step = make_dcgan_train_step(*nets, *opts)
    eval_step = make_dcgan_eval_step(*nets)
    data = [tuple(torch.from_numpy(a).cuda() for a in b) for b in batches]

    def step_ms(n=20):
        for b in data:
            step(*b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            step(*data[i % len(data)])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    host = host_state()
    exact_ms = step_ms()
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
        tf32_ms = step_ms()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step(*data[0])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    eval_ms = time_ms(lambda: eval_step(*data[0]), per_group=2,
                      sleep_cycles=20_000_000)
    prof = profile_window(lambda: step(*data[0]), f"dcgan b={batch} exact "
                          "f32", "train step", n=5)
    counted = ops.launch_counts()
    check(not any(counted.values()),
          f"dcgan phase: CUDA kernel launches {counted}, expected none")
    secs = time.perf_counter() - t_phase
    print(f"[dcgan] {card}: b={batch} train step {exact_ms:.3f} ms exact "
          f"f32, {tf32_ms:.3f} ms with TF32 (host clock, synchronised, 20 "
          f"steps; host: {host}); eval step {eval_ms:.4f} ms (device time, "
          f"CUDA events); peak memory of a step "
          f"{peak / 2**20:.1f} MiB; CLI epoch {cli_s:.2f} s; the phase took "
          f"{secs:.1f} s")
    return dict(cli_s=cli_s, results=results, fwd_err=fwd_err,
                loss_rel=float(rel.max()), exact_ms=exact_ms, tf32_ms=tf32_ms,
                eval_ms=eval_ms, peak_bytes=peak, profile=prof, secs=secs)


# card outputs against the same artifact on the CPU (the JAX export's
# --check tolerances: f32 roundoff, and for w8a8 one flipped int8 bin) and
# the quantised artifacts against the f32 one (tests/test_export.py's
# budgets)
EXTRAS_CPU_TOL = {"f32": 1e-5, "w8": 1e-5, "w8a8": 5e-3, "roll3": 6e-5}
EXTRAS_F32_BUDGET = {"w8": 5e-3, "w8a8": 3e-2}


def http_round(path, batches, repeats, check_reply):
    """Serve the artifact at ``path`` on the card over HTTP (port 0) and
    POST ``repeats`` uniform [0, 1) batches of each size; ``check_reply(x,
    y)`` sees the last reply of each size. Then the same batches through
    ``ModelServer.predict`` in process, HTTP left out. Returns {batch: p50
    ms over HTTP}, {batch: p50 ms in process} (host clock)."""
    import numpy as np

    from extended_gan_torch.serve import make_server

    server = make_server(path, port=0)
    served = server.RequestHandlerClass.model
    check(served.device.type == "cuda", f"{path}: server is not on the card")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    p50, inproc = {}, {}
    try:
        for b in batches:
            x = np.random.default_rng(b).random(
                (b, *served.artifact.window_shape), np.float32)
            lat = []
            for _ in range(repeats):
                y, ms = _post(url + "/predict", x)
                lat.append(ms)
            check_reply(x, y)
            p50[b] = statistics.median(lat)
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        check(health["requests_served"] == repeats * len(batches)
              and health["platforms"] == ["cuda"], f"healthz: {health}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    check(not thread.is_alive(), "the HTTP server did not stop")
    for b in batches:
        x = np.random.default_rng(b).random(
            (b, *served.artifact.window_shape), np.float32)
        lat = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            served.predict(x)  # ends in a copy to the host
            lat.append((time.perf_counter() - t0) * 1e3)
        inproc[b] = statistics.median(lat)
    return p50, inproc


def _reply_check(name, cpu_fn, tol, out_shape):
    """A reply's shape, finiteness and range, and its gap to the same
    artifact run on the CPU; the gaps are collected in ``gaps``."""
    import numpy as np
    import torch

    gaps = []

    def checker(x, y):
        check(y.shape == (len(x), *out_shape),
              f"{name}: reply shape {y.shape}")
        check(bool(np.isfinite(y).all()), f"{name}: non-finite reply")
        check(float(y.min()) >= 0.0 and float(y.max()) <= 1.0,
              f"{name}: reply leaves [0, 1]")
        with torch.no_grad():
            want = cpu_fn(torch.from_numpy(x)).numpy()
        gap = float(np.abs(y - want).max())
        check(gap <= tol, f"{name} b={len(x)}: card reply vs the artifact on "
                          f"the CPU {gap:.3e} (limit {tol})")
        gaps.append(gap)

    return checker, gaps


def phase_serve_extras(out, batch=32, repeats=10):
    """Serving what the port trains, as a user runs it: the DCGAN
    generator of the ``dcgan`` phase's checkpoint (in ``out``) exported as
    f32, w8, w8a8 and a 3-step rollout with --check, each served on the card
    over HTTP at b = 1, 5 and 32 against the same artifact on the CPU, its
    forward timed at b=32; the w8a8 chain's int32 accumulators against the
    CPU's plain product on the same int8 inputs, exactly; final_temp_conv
    and final_smaatunet exported as w8 from seed 0 and served at b=32 with
    K1 and K3 launched as on the f32 path; and ``serve predict`` over
    final_temp_conv's synthetic test split and 4 batches of its train
    split."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from extended_gan_torch import ops
    from extended_gan_torch.data.streaming import get_loaders
    from extended_gan_torch.ops import dsconv as k3
    from extended_gan_torch.ops import gat_attention as k1
    from extended_gan_torch.ops import gat_mapping as k2
    from extended_gan_torch.ops import int8_conv
    from extended_gan_torch.serve import load_exported
    from extended_gan_torch.serve.__main__ import main as cli
    from extended_gan_torch.serve.quantize import (
        quantize_activation,
        w8a8_layer,
        w8a8_layers,
    )

    t_phase = time.perf_counter()
    card = card_line()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    art_dir = os.path.join(REPO, "build", "smoke")
    os.makedirs(art_dir, exist_ok=True)
    # the main path starts here
    int8_conv.launch_count = 0
    k1.launch_count = k1.bwd_launch_count = 0
    k3.launch_count = k3.bwd_launch_count = 0
    k2.fwd_launch_count = k2.bwd_launch_count = 0

    # 1. the DCGAN generator: export, serve, time
    arts, lines = {}, []
    for name, extra in (("f32", []), ("w8", ["--quantize", "w8"]),
                        ("w8a8", ["--quantize", "w8a8"]),
                        ("roll3", ["--rollout", "3"])):
        path = os.path.join(art_dir, f"dcgan_generator_{name}.pt")
        t0 = time.perf_counter()
        info = cli(["export", out, "--workload", "dcgan", "--out", path,
                    "--check", *extra])
        arts[name] = dict(path=path, nbytes=info["nbytes"],
                          export_s=time.perf_counter() - t0,
                          card=load_exported(path),
                          cpu=load_exported(path, device="cpu"))
    check(arts["w8"]["nbytes"] < arts["f32"]["nbytes"],
          "the w8 artifact is not smaller than the f32 one")
    check(int8_conv.launch_count == 5 * 2,
          f"export --check of w8a8: {int8_conv.launch_count} int8 products, "
          "expected 5 layers x 2 batches")
    window = (64, 64, 4)
    x = torch.rand(batch, *window, device="cuda",
                   generator=torch.Generator(device="cuda").manual_seed(0))
    for name, a in arts.items():
        out_shape = (3, *window) if name == "roll3" else window
        checker, gaps = _reply_check(name, a["cpu"].fn, EXTRAS_CPU_TOL[name],
                                     out_shape)
        before = int8_conv.launch_count
        a["p50"], a["inproc"] = http_round(a["path"], (1, 5, batch), repeats,
                                           checker)
        products = int8_conv.launch_count - before
        want = 5 * 3 * 2 * repeats if name == "w8a8" else 0
        check(products == want, f"serving {name}: {products} int8 products, "
                                f"expected {want}")
        with torch.inference_mode():
            a["ms"] = time_ms(lambda: a["card"].fn(x), per_group=2,
                              sleep_cycles=20_000_000)
        a["gap"] = max(gaps)
        lines.append(
            f"{name}: {a['nbytes']} bytes, export --check {a['export_s']:.2f} "
            f"s, forward b={batch} {a['ms']:.4f} ms, HTTP p50 "
            + " / ".join(f"{p:.2f}" for p in a["p50"].values())
            + " ms (in process " + " / ".join(
                f"{p:.2f}" for p in a["inproc"].values())
            + f" ms) at b = 1 / 5 / {batch}, card vs CPU {a['gap']:.3e}")
    int8_products = int8_conv.launch_count
    print(f"[serve_extras] {card}: DCGAN generator from the dcgan phase's "
          f"checkpoint, {repeats} requests a batch size, device times by CUDA "
          "events: " + "; ".join(lines))

    # 2. the w8a8 chain on the card: exact int32 accumulators on the same
    # int8 inputs, and the same int8 activations from the same f32 input
    state = torch.load(arts["w8a8"]["path"], map_location="cpu",
                       weights_only=True)["weights"]
    on_card, on_cpu = w8a8_layers(state, "cuda"), w8a8_layers(state, "cpu")
    h, h_cpu, rows = x, x.cpu(), []
    with torch.inference_mode():
        for i, (lc, lh) in enumerate(zip(on_card, on_cpu)):
            xi, acc, h_next = w8a8_layer(h, lc)
            xi_host = xi.cpu()
            check(torch.equal(quantize_activation(h.cpu(), lh[1]), xi_host),
                  f"w8a8 layer {i}: the card's int8 activations differ from "
                  "the CPU's on the same input")
            want = int8_conv.reference_int8_conv(xi_host, lh[0])
            check(acc.dtype == torch.int32 and torch.equal(acc.cpu(), want),
                  f"w8a8 layer {i}: the card's int32 accumulators differ "
                  "from the CPU's plain product")
            xi_cpu, _, h_cpu = w8a8_layer(h_cpu, lh)
            flips = int((xi_cpu != xi_host).sum())
            product_ms = time_ms(lambda: int8_conv.int8_conv2d(xi, lc[0]))
            rows.append(f"layer {i} {tuple(xi.shape)} x {tuple(lc[0].shape)}"
                        f": |acc| <= {int(acc.abs().max())}, "
                        f"{flips} of {xi.numel()} int8 inputs a bin apart "
                        f"from the CPU's own chain, int8 product "
                        f"{product_ms:.4f} ms")
            h = h_next
    print(f"[serve_extras] w8a8 b={batch}: int32 accumulators equal to the "
          "CPU's float64 product on the card's int8 inputs at every layer; "
          + "; ".join(rows))

    # 3. the quantised generators against the f32 one, on the card
    with torch.inference_mode():
        ref = arts["f32"]["card"].fn(x)
        for mode, budget in EXTRAS_F32_BUDGET.items():
            err = float((arts[mode]["card"].fn(x) - ref).abs().max())
            check(err < budget, f"{mode} generator vs f32: {err:.3e} (limit "
                                f"{budget})")
            arts[mode]["vs_f32"] = err
    print("[serve_extras] against the f32 generator at b=%d: w8 %.3e (limit "
          "%g), w8a8 %.3e (limit %g)" % (
              batch, arts["w8"]["vs_f32"], EXTRAS_F32_BUDGET["w8"],
              arts["w8a8"]["vs_f32"], EXTRAS_F32_BUDGET["w8a8"]))

    # 4. the conv-GAT families as w8, served; K1 and K3 as on the f32 path
    gat = {}
    for exp, key, per_forward in (("final_temp_conv", "gat_attention_fwd", 2),
                                  ("final_smaatunet", "dsconv_fwd", 18)):
        paths = {}
        for q in ("f32", "w8"):
            paths[q] = os.path.join(art_dir, f"{exp}_{q}.pt")
            info = cli(["export", os.path.join(REPO, "convolutional_gat",
                                               "experiments", exp),
                        "--init-seed", "0", "--out", paths[q],
                        *(["--quantize", "w8"] if q == "w8" else [])])
            paths[q + "_bytes"] = info["nbytes"]
        f32 = load_exported(paths["f32"])
        counts = ops.launch_counts()[key]
        replies = []
        p50, inproc = http_round(paths["w8"], (batch,), repeats,
                                 lambda xx, y: replies.append((xx, y)))
        w8_launches = ops.launch_counts()[key] - counts
        xx, y = replies[0]
        counts = ops.launch_counts()[key]
        with torch.inference_mode():
            want = f32.fn(torch.from_numpy(xx).cuda()).cpu().numpy()
        f32_launches = ops.launch_counts()[key] - counts
        check(w8_launches == per_forward * 2 * repeats
              and f32_launches == per_forward,
              f"{exp}: {key} launched {w8_launches} times in {2 * repeats} "
              f"w8 forwards and {f32_launches} in one f32 forward, expected "
              f"{per_forward} a forward")
        check(bool(np.isfinite(y).all()), f"{exp} w8: non-finite reply")
        gap = float(np.abs(y - want).max())
        ratio = paths["w8_bytes"] / paths["f32_bytes"]
        gat[exp] = dict(p50=p50[batch], gap=gap, ratio=ratio,
                        launches=w8_launches + f32_launches)
        print(f"[serve_extras] {exp} w8 from --init-seed 0, b={batch}: HTTP "
              f"p50 {p50[batch]:.2f} ms (in process {inproc[batch]:.2f} ms), "
              f"max |w8 - f32| {gap:.3e}, bytes "
              f"{paths['w8_bytes']} / {paths['f32_bytes']} = {ratio:.4f}; "
              f"{key} {per_forward} a forward, as on the f32 path")

    # 5. serve predict over final_temp_conv's synthetic test split
    exp_dir = tempfile.mkdtemp(prefix="smoke_predict_")
    try:
        shutil.copy(os.path.join(REPO, "convolutional_gat", "experiments",
                                 "final_temp_conv", "config.py"), exp_dir)
        ftc = load_exported(os.path.join(art_dir, "final_temp_conv_f32.pt"))
        torch.save(ftc.model.state_dict(), os.path.join(exp_dir, "model.pt"))
        runs = {}
        for split, index in (("test", 2), ("train", 0)):
            loader = get_loaders(batch, batch, "", dataset="synthetic",
                                 downsample_size=(80, 80),
                                 shuffle=False)[index]
            n_batches = sum(1 for _, _ in zip(range(4), loader))
            before = k1.launch_count
            summary = cli(["predict", exp_dir, "--split", split,
                           "--batch-size", str(batch), "--max-batches", "4",
                           "--downsample-size", "80", "80", "--out",
                           os.path.join(exp_dir, f"{split}.npz")])
            runs[split] = (summary, n_batches, k1.launch_count - before)
    finally:
        shutil.rmtree(exp_dir, ignore_errors=True)
    predict_launches = 0
    for split, (summary, n_batches, launched) in runs.items():
        check(_finite([summary["mse"]]) and summary["samples"] > 0,
              f"predict {split}: {summary}")
        check(launched == 2 * n_batches, f"predict {split}: {launched} K1 "
                                         f"launches for {n_batches} batches")
        predict_launches += launched
        print(f"[serve_extras] serve predict final_temp_conv (80x80, "
              f"synthetic {split} split, b={batch}, --max-batches 4: "
              f"{n_batches} batches): {summary['samples']} samples, "
              f"{summary['samples_per_sec']} samples/s (host clock, loader "
              f"and first calls included), mse {summary['mse']:.6f}, K1 "
              f"{launched} launches")
    secs = time.perf_counter() - t_phase
    print(f"[serve_extras] the phase took {secs:.1f} s")
    return dict(arts={k: {f: v for f, v in a.items() if f not in ("card",
                                                                   "cpu")}
                      for k, a in arts.items()},
                gat=gat, int8_products=int8_products,
                k1_launches=gat["final_temp_conv"]["launches"]
                + predict_launches,
                k3_launches=gat["final_smaatunet"]["launches"],
                predict={k: v[0] for k, v in runs.items()}, secs=secs)


MEGA_K = 8
# the megastep phase's timing: one graph and one eager run of one program
# (the moe phase keeps its two programs in four turns), and final_temp_smaat
# (about 0.4 s an eager step) at K = 2 steps a graph
MEGA_TIMING = dict(rounds=("graph", "eager"), timed_programs=1)
SMAAT_K = 2
# graph against eager over the same programs: the same kernels in the same
# order, so the gap should be 0; the limit, relative to each tensor's
# largest entry
MEGA_LIMIT = 1e-6


# the port's kernels by their profiler names, one main kernel a launch
KERNEL_NAMES = {
    "gat_attention_fwd": ("gat_attention_cluster_fwd_kernel",
                          "gat_attention_fwd_kernel",
                          "gat_attention_fwd_any_kernel"),
    "gat_attention_bwd": ("gat_attention_cluster_bwd_kernel",),
    "dsconv_fwd": ("dsconv_fwd_kernel",),
    "dsconv_bwd": ("dsconv_bwd_kernel",),
    "gat_mapping_fwd": ("gat_mapping_fwd_kernel",),
    "gat_mapping_bwd": ("gat_mapping_bwd_kernel",),
}


def _reset_launches():
    from extended_gan_torch import ops

    ops.add_launches(ops.launch_counts(), -1)


def _full_weights(nets, opts):
    """The nets' parameters, then their optimizers' state tensors, in the
    order ``parameters()`` and ``opt.state`` give them; an FSDP block
    (``parallel/fsdp.py``) and its moments gathered into the full leaf, and
    then a tensor parallelism block (``parallel/tensor.py``), so a run with
    either and one without give the same list (a collective under them:
    every rank calls it)."""
    import torch

    from extended_gan_torch.parallel import fsdp, tensor

    leaves = {p: leaf for net in nets
              for p, leaf in fsdp.fsdp_shards(net).items()}
    cut = {id(leaf.registered): leaf for net in nets
           if tensor.tp_net(net) is not None
           for leaf in tensor.tp_net(net).leaves}

    def full(t, p):
        if p in leaves and t.dim():
            t = fsdp.gather_full(t, leaves[p])
        return cut[id(p)].gather(t) if id(p) in cut and t.dim() else t

    out = [full(p, p) for net in nets for p in net.parameters()]
    return out + [full(v, p) for opt in opts for p, st in opt.state.items()
                  for v in st.values() if torch.is_tensor(v)]


_REFS = {}


def _cached(fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, run once a process: the one-process
    references that two phases hold their ranks to."""
    key = (fn.__name__, args, tuple(sorted(kwargs.items())))
    if key not in _REFS:
        _REFS[key] = fn(*args, **kwargs)
    return _REFS[key]


def _train_state(modules, opts):
    """Every tensor a train step writes: parameters, buffers (BatchNorm's
    statistics) and the optimizers' state."""
    import torch

    ts = [t for m in modules
          for t in itertools.chain(m.parameters(), m.buffers())]
    return ts + [v for o in opts for st in o.state.values()
                 for v in st.values() if torch.is_tensor(v)]


def _shapes(inputs):
    return tuple(tuple(x.shape) for x in inputs)


def _profile_call(fn, steps):
    """One call of ``fn`` under the profiler: device busy ms a step, kernels
    in the call, and how many of each of the port's kernels it recorded."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and dev_us(e) > 0 and not getattr(e, "is_user_annotation",
                                                 False)]
    launches = {k: sum(e.count for e in events
                       if any(re.search(rf"\b{n}[<(]", e.key) for n in names))
                for k, names in KERNEL_NAMES.items()}
    return dict(busy_ms=sum(dev_us(e) for e in events) / 1e3 / steps,
                wall_ms=wall_ms, kernels=sum(e.count for e in events),
                launches={k: n for k, n in launches.items() if n})


def _graph_kernels(graph):
    """How many nodes of each of the port's kernels a CUDA graph (captured
    with ``keep_graph``) holds (its Graphviz dump, each node's body searched
    for the kernel's name, mangled or not), and one kernel node's text."""
    import tempfile

    fd, path = tempfile.mkstemp(suffix=".dot")
    os.close(fd)
    try:
        graph.debug_dump(path)
        with open(path, errors="replace") as f:
            text = f.read()
    finally:
        os.unlink(path)
    nodes = re.findall(r'"graph_\d+_node_\d+"\s*\[(.*?)\];', text, re.S)
    counts = {key: sum(any(n in body for n in names) for body in nodes)
              for key, names in KERNEL_NAMES.items()}
    sample = next((b for b in nodes if "KERNEL" in b.upper()), text[:400])
    return {key: c for key, c in counts.items() if c}, len(nodes), sample


def _pool_bytes(pool):
    """Bytes of the allocator's segments in a graph's private pool, or None
    where the snapshot does not say which pool a segment is in."""
    import torch

    segs = [s for s in torch.cuda.memory_snapshot() if "segment_pool_id" in s]
    if not segs:
        return None
    return sum(s["total_size"] for s in segs
               if tuple(s["segment_pool_id"]) == tuple(pool))


def graph_against_eager(label, make, programs, card, *, profile_eager=True,
                        rounds=("eager", "graph", "graph", "eager"),
                        timed_programs=2):
    """``make()`` -> (megastep, modules, optimizers), fresh from one seed.

    The same programs through a megastep (the first eager, the second
    captured and replayed, the rest replayed) and, each replayed program,
    through K eager steps on a twin from the state the megastep had before
    it, cuDNN deterministic. After each program the parameters, buffers
    and optimizer state, and apart from them the program's ``*_nd`` logs,
    are held by ``utils.compare.held_to_reference`` to MEGA_LIMIT, each
    tensor in units of its scale. Then, on a fresh
    copy captured under the default flags (exact f32): the ms a step
    eager against graph (``timed_programs`` programs at a time, in the
    turns ``rounds``), one replay and (with ``profile_eager``) one eager
    program profiled (busy time, kernels, the port's kernels by name), the
    port's kernels among the graph's own nodes held equal to the launch
    counters and the profiler's records to at most them, and the graph
    pool's bytes."""
    import torch

    from extended_gan_torch import ops
    from extended_gan_torch.utils.compare import held_to_reference

    k = programs[0][0].shape[0]
    t_call = time.perf_counter()

    def nd_logs(logs):
        return [logs[n] for n in logs if n.endswith("_nd")]

    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False,
                                    deterministic=True):
        mega, mods, opts = make()
        before = ops.launch_counts()
        after, logs_g = [], []  # the state after each program, its logs
        for p in programs:
            logs_g.append(nd_logs(mega(*p)))
            after.append([t.detach().clone()
                          for t in _train_state(mods, opts)])
        torch.cuda.synchronize()
        launched = {n: c - before[n] for n, c in ops.launch_counts().items()
                    if c != before[n]}
        check(mega.captures == 1 and mega.replays == len(programs) - 1,
              f"{label}: {mega.captures} captures and {mega.replays} "
              f"replays for {len(programs)} programs")
        del mega, mods, opts

        def eager_from(maker, n_programs):
            """Each program from the 2nd on, as K eager steps on a twin
            from the state the graph's run had before it: (state, logs)
            after each."""
            twin, tmods, topts = maker()
            twin.eager(*programs[0])  # builds the optimizers' state
            out = []
            for i in range(1, n_programs):
                with torch.no_grad():
                    for t, s in zip(_train_state(tmods, topts),
                                    after[i - 1]):
                        t.copy_(s)
                logs = nd_logs(twin.eager(*programs[i]))
                out.append(([t.detach().clone()
                             for t in _train_state(tmods, topts)], logs))
            return out

        want = eager_from(make, len(programs))
        verdicts = [[held_to_reference(g, w, limit=MEGA_LIMIT)
                     for g, w in zip((after[i + 1], logs_g[i + 1]), wi)]
                    for i, wi in enumerate(want)]
    check(all(bool(t.isfinite().all()) for t in after[-1]),
          f"{label}: non-finite state after the graph's steps")
    check(all(v["ok"] for pair in verdicts for v in pair),
          f"{label}: graph against eager, each replayed program from the "
          f"same state: {verdicts} (state, logs; worst: the largest gap "
          f"over its bound; limit {MEGA_LIMIT:.0e})")
    st = {key: max(pair[0][key] for pair in verdicts)
          for key in ("gap", "worst")}
    same = all(v["bitwise"] for pair in verdicts for v in pair)
    gap = st["gap"]
    log_gap = max(pair[1]["gap"] for pair in verdicts)
    del after, want
    times = {"eager": [], "graph": []}
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        mega, _, _ = make()
        mega.keep_graphs = True  # for the graph's Graphviz dump
        torch.cuda.reset_peak_memory_stats()
        mega(*programs[0])  # eager
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mega(*programs[1])  # captured and replayed
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        for kind in rounds:
            fn = mega.eager if kind == "eager" else mega
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for p in programs[:timed_programs]:
                fn(*p)
            torch.cuda.synchronize()
            times[kind].append((time.perf_counter() - t0) * 1e3
                               / (timed_programs * k))
        entry = mega.graphs[_shapes(programs[0])]
        per_replay = dict(entry.launches)
        before = ops.launch_counts()
        prof_g = _profile_call(lambda: mega(*programs[0]), k)
        counted = {n: c - before[n] for n, c in ops.launch_counts().items()
                   if c != before[n]}
        # the profiler now and then drops a kernel's record (PERF.md §7: 9
        # of 10 K2 forwards over 5 eager forwards; in a process that has
        # profiled for minutes, 15 of 16 K2 forwards, 142 of 144 K3
        # forwards, 2,403 of 2,418 kernels of 8 eager steps, on an NVIDIA
        # H100 80GB HBM3 at 700 W): where a session records fewer
        # launches than the counters, a replay is profiled again, at most
        # twice. The graph's own node list is held to the counters exactly;
        # the profiler's most in any session must see every kernel of the
        # port, and never more than the counters
        sessions = [prof_g["launches"]]
        while len(sessions) < 3 and any(
                max(s.get(n, 0) for s in sessions) < c
                for n, c in per_replay.items()):
            sessions.append(
                _profile_call(lambda: mega(*programs[0]), k)["launches"])
        recorded = {n: max(s.get(n, 0) for s in sessions)
                    for n in set().union(*sessions)}
        prof_e = (_profile_call(lambda: mega.eager(*programs[0]), k)
                  if profile_eager else None)
    check(counted == per_replay,
          f"{label}: a replay moved the launch counters by {counted}, the "
          f"capture recorded {per_replay}")
    in_graph, n_nodes, sample = _graph_kernels(entry.graph)
    check(in_graph == per_replay,
          f"{label}: the graph holds {in_graph} of the port's kernels in "
          f"{n_nodes} nodes, the launch counters {per_replay} a replay; a "
          f"kernel node reads:\n{sample[:600]}")
    check(set(recorded) == set(per_replay)
          and all(0 < recorded[n] <= c for n, c in per_replay.items()),
          f"{label}: the profiler records {sessions} of the port's kernels "
          f"in {len(sessions)} replays, the launch counters {per_replay} a "
          "replay")
    pool = _pool_bytes(mega._pool)
    eager_ms = statistics.mean(times["eager"])
    graph_ms = statistics.mean(times["graph"])
    print(f"[megastep] {label}, K={k}: graph against eager over "
          f"{len(programs)} programs: state {gap:.3e}, logs {log_gap:.3e} "
          f"(limit {MEGA_LIMIT:.0e}; bitwise equal: "
          f"{'yes' if same else 'no'}); ms a step eager "
          f"{eager_ms:.3f} ({', '.join(f'{t:.3f}' for t in times['eager'])}),"
          f" graph {graph_ms:.3f} ("
          f"{', '.join(f'{t:.3f}' for t in times['graph'])}); device busy "
          f"{prof_g['busy_ms']:.4f} ms "
          f"a step in a replay ("
          + (f"{prof_e['busy_ms']:.4f}" if prof_e else "not profiled")
          + f" eager), {prof_g['kernels']} kernels a replay ("
          + (f"{prof_e['kernels']}" if prof_e else "not profiled")
          + f" in {k} eager steps); the port's kernels in the graph "
          f"({n_nodes} nodes) {in_graph or 'none'} = the launch counters, "
          f"recorded by the profiler {recorded or 'none'}"
          + (f" (the most of {len(sessions)} sessions: {sessions})"
             if len(sessions) > 1 else "") + "; graph "
          f"pool {'not measured' if pool is None else f'{pool / 2**20:.1f} MiB'}"
          f", peak allocated {peak / 2**20:.1f} MiB; capture and first "
          f"replay {capture_s:.2f} s; {time.perf_counter() - t_call:.1f} s "
          f"in all; {card}")
    return dict(launched=launched, in_graph=in_graph,
                profiled=recorded, gap=gap, log_gap=log_gap,
                bitwise=same, worst=st["worst"],
                eager_ms=eager_ms,
                graph_ms=graph_ms, busy_ms=prof_g["busy_ms"],
                kernels=prof_g["kernels"], per_replay=per_replay,
                pool_bytes=pool, peak_bytes=peak, capture_s=capture_s)


def phase_megastep(tmp, batch=32, hw=80):
    """K train steps a CUDA graph and the archive resident on the card
    (``train/megastep.py``, ``data/resident.py``), K = 8, full width:

    - a synthetic KNMI archive at the published geometry (20 train files
      of 96 frames of 80x80x6, 2 test files), resident on the card;
    - ``python -m extended_gan_torch.gat train`` of final_temp_conv's model
      with ``--resident --megastep 8 --max-batches 16`` (2 programs: the
      first eager, the second captured and replayed; launch counts from
      the launch rule);
    - in process, graph against eager (:func:`graph_against_eager`) for
      final_temp_conv resident (K1 in the graph), the same with
      ``use_pallas_mapping=True`` (K1 and K2), final_smaatunet and
      final_temp_smaat (K = 4) from staged batches (K3 18 + 18 a step;
      K1 4 + 4) and the published DCGAN resident with dropout 0;
    - ``python -m extended_gan_torch.dcgan --resident --megastep 8
      --max-batches 16`` on a 1,024-frame archive, and the DCGAN with
      dropout 0.01: two replays from the same state and inputs draw
      different masks (the generator advances across replays)."""
    import torch

    from extended_gan_torch import ops
    from extended_gan_torch.data.resident import (
        ResidentVideos,
        make_dcgan_resident_megastep,
        make_gat_resident_megastep,
    )
    from extended_gan_torch.data.synthetic import (
        ensure_synthetic_h5,
        make_kmni_dataset,
    )
    from extended_gan_torch.dcgan.__main__ import main as dcgan_cli
    from extended_gan_torch.gat.__main__ import main as gat_cli
    from extended_gan_torch.models.gat.gat3d import Model as GatModel
    from extended_gan_torch.models.registry import build_model
    from extended_gan_torch.train.dcgan_driver import (
        DEFAULT_PARAMS,
        build_dcgan,
    )
    from extended_gan_torch.train.gat_trainer import make_gat_megastep
    from extended_gan_torch.train.optim import make_optimizer
    from extended_gan_torch.utils.compare import held_to_reference

    t_phase = time.perf_counter()
    card = card_line()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    k = MEGA_K
    t0 = time.perf_counter()
    knmi = make_kmni_dataset(os.path.join(tmp, "knmi"), n_train_files=20,
                             n_test_files=2, frames_per_file=96, hw=hw)
    print(f"[megastep] synthetic KNMI archive, 20 + 2 files of 96 frames of "
          f"{hw}x{hw}x6: {time.perf_counter() - t0:.1f} s")

    # 1. the CLI: final_temp_conv's model, resident, 2 programs of 8 steps
    out = io.StringIO()
    _reset_launches()  # the main path starts here
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        model, history = gat_cli([
            "train", "--model-type", "temporal", "--mapping-type", "conv",
            "--dataset", "kmni", "--preprocessed-folder", knmi,
            "--downsample-size", str(hw), str(hw), "--train-batch-size",
            str(batch), "--test-batch-size", "64", "--epochs", "1",
            "--resident", "--megastep", str(k), "--max-batches",
            str(2 * k)])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    cli_launches = ops.launch_counts()
    text = out.getvalue()
    resident_line = next((ln for ln in text.splitlines()
                          if ln.startswith("[resident]")), "")
    print(f"[megastep] CLI: {resident_line}")
    check(resident_line and "MB live in device memory" in resident_line,
          f"the resident CLI printed no [resident] line:\n{text[-2000:]}")
    check(len(history["train_loss"]) == 1 and _finite(history["train_loss"])
          and all(_finite(history[n]) for n in history if n.startswith("val")),
          f"resident CLI: history {history}")
    check(all(bool(p.isfinite().all()) for p in model.parameters()),
          "resident CLI: non-finite parameters")
    val = ResidentVideos.from_kmni(os.path.join(knmi, "test"), "cuda",
                                   crop=hw)
    eval_rows = val.eval_programs(k, 64)[0].shape[0] * k
    steps = 2 * k
    want = {"gat_attention_fwd": 2 * (steps + eval_rows),
            "gat_attention_bwd": 2 * steps}
    got = {n: c for n, c in cli_launches.items() if c}
    check(got == want, f"resident CLI: launches {got}, expected {want} "
                       f"({steps} train steps, {eval_rows} eval batches)")
    print(f"[megastep] python -m extended_gan_torch.gat train --resident "
          f"--megastep {k} --max-batches {2 * k}: {steps} steps, "
          f"{eval_rows} eval batches, launches {got}, train loss "
          f"{history['train_loss'][0]:.6f}, val_loss "
          f"{history['val_loss'][0]:.6f}, {cli_s:.2f} s")

    # 2. in process: the same archive resident, graph against eager
    store = ResidentVideos.from_kmni(os.path.join(knmi, "train"), "cuda",
                                     crop=hw)
    print(f"[megastep] resident train split: {store.n_windows} windows, "
          f"{store.nbytes} bytes on the card "
          f"({tuple(store.video.shape)} float32 + starts)")
    progs = store.epoch_programs(7, k, batch)
    gat_progs = [(progs[i],) for i in range(3)]
    results = {}

    def gat_maker(switched):
        def make():
            kw = dict(attention_type="temporal", mapping_type="conv",
                      use_pallas=True)
            model = GatModel(hw, hw, 6, use_pallas_mapping=switched,
                             generator=torch.Generator().manual_seed(0),
                             **kw).cuda()
            opt = make_optimizer("adam", model.parameters(), 1e-3,
                                 weight_decay=0.01, capturable=True)
            return (make_gat_resident_megastep(model, opt, store), (model,),
                    (opt,))
        return make

    _reset_launches()
    results["final_temp_conv"] = graph_against_eager(
        f"final_temp_conv resident b={batch}", gat_maker(False), gat_progs,
        card, **MEGA_TIMING)
    _reset_launches()
    results["final_temp_conv switched"] = graph_against_eager(
        f"final_temp_conv resident b={batch} use_pallas_mapping=True",
        gat_maker(True), gat_progs, card, **MEGA_TIMING)
    check(results["final_temp_conv"]["per_replay"] == {
        "gat_attention_fwd": 2 * k, "gat_attention_bwd": 2 * k},
          f"final_temp_conv replay: {results['final_temp_conv']['per_replay']}")
    check(results["final_temp_conv switched"]["per_replay"] == {
        "gat_attention_fwd": 2 * k, "gat_attention_bwd": 2 * k,
        "gat_mapping_fwd": 2 * k, "gat_mapping_bwd": 2 * k},
          "final_temp_conv switched replay: "
          f"{results['final_temp_conv switched']['per_replay']}")

    # final_smaatunet: K3 in the graph, from staged batches
    uhw = 20
    gen = torch.Generator(device="cuda").manual_seed(3)
    unet_progs = [tuple(torch.rand((k, batch, uhw, uhw, 4, 6), device="cuda",
                                   generator=gen) for _ in range(2))
                  + (torch.ones((k, batch), device="cuda"),)
                  for _ in range(3)]

    def unet_maker(optimizer):
        def make():
            model = build_model("unet", image_width=uhw, image_height=uhw,
                                n_vertices=6, mapping_type="linear",
                                generator=torch.Generator().manual_seed(0))
            opt = make_optimizer(optimizer, model.parameters(), 1e-3,
                                 weight_decay=0.01, capturable=True)
            return make_gat_megastep(model, opt), (model,), (opt,)
        return make

    _reset_launches()
    results["final_smaatunet"] = graph_against_eager(
        f"final_smaatunet b={batch}", unet_maker("adam"), unet_progs, card,
        profile_eager=False, **MEGA_TIMING)
    check(results["final_smaatunet"]["per_replay"] == {
        "dsconv_fwd": 18 * k, "dsconv_bwd": 18 * k},
          f"final_smaatunet replay: {results['final_smaatunet']['per_replay']}")

    # final_temp_smaat: the most host-bound published path (about 15,000
    # kernels a step), K1 once a head (4 + 4 a step), UNets in its mapping;
    # K = 2 and no profile of its eager steps keep the phase short (a
    # profile of 120,000 kernels takes about a minute)
    def smaat_maker(optimizer):
        def make():
            model = build_model("temporal", image_width=uhw, image_height=uhw,
                                n_vertices=6, mapping_type="smaat_unet",
                                generator=torch.Generator().manual_seed(0))
            opt = make_optimizer(optimizer, model.parameters(), 1e-3,
                                 weight_decay=0.01, capturable=True)
            return make_gat_megastep(model, opt), (model,), (opt,)
        return make

    _reset_launches()
    results["final_temp_smaat"] = graph_against_eager(
        f"final_temp_smaat b={batch}", smaat_maker("adam"),
        [tuple(t[:SMAAT_K] for t in p) for p in unet_progs], card,
        profile_eager=False, **MEGA_TIMING)
    check(results["final_temp_smaat"]["per_replay"] == {
        "gat_attention_fwd": 4 * SMAAT_K, "gat_attention_bwd": 4 * SMAAT_K},
          "final_temp_smaat replay: "
          f"{results['final_temp_smaat']['per_replay']}")

    # the published DCGAN, resident, dropout 0
    h5 = ensure_synthetic_h5(os.path.join(tmp, "h5"), frames_train=1024,
                             frames_test=64, h=64, w=64)
    frames = ResidentVideos.from_h5(os.path.join(h5, "train"), "cuda")
    dprogs = frames.epoch_programs(5, k, batch)
    dc_progs = [(dprogs[i],) for i in range(3)]

    def dcgan_maker(dropout):
        def make():
            nets, opts = build_dcgan(DEFAULT_PARAMS, seed=0, device="cuda",
                                     dropout=dropout, capturable=True)
            gens = (nets[0].ConvBlock_0.dropout_generator,)
            return (make_dcgan_resident_megastep(*nets, *opts, frames,
                                                 generators=gens),
                    nets, opts)
        return make

    _reset_launches()
    results["dcgan"] = graph_against_eager(
        f"DCGAN resident b={batch}, dropout 0", dcgan_maker(0.0), dc_progs,
        card, profile_eager=False, **MEGA_TIMING)
    check(results["dcgan"]["per_replay"] == {},
          f"DCGAN replay launched the port's kernels "
          f"{results['dcgan']['per_replay']}")

    # dropout 0.01: two replays from the same state and inputs
    mega, nets, opts = dcgan_maker(0.01)()
    for p in dc_progs[:2]:
        mega(*p)  # eager, then captured and replayed
    state = _train_state(nets, opts)
    saved = [t.clone() for t in state]
    draws = []
    for _ in range(2):
        with torch.no_grad():
            for t, s in zip(state, saved):
                t.copy_(s)
        mega(*dc_progs[2])
        draws.append([t.clone() for t in state])
    torch.cuda.synchronize()
    drop = held_to_reference(draws[0], draws[1])
    drop_gap, drop_same = drop["gap"], drop["bitwise"]
    check(not drop_same and drop_gap > 0,
          "DCGAN dropout 0.01: two replays from the same state drew the same "
          "masks")
    print(f"[megastep] DCGAN dropout 0.01: two replays from the same state "
          f"and inputs differ by {drop_gap:.3e} (the dropout generator "
          f"advances across replays; with dropout 0 the graph equals eager "
          f"{'bitwise' if results['dcgan']['bitwise'] else 'within the limit'})")

    # the DCGAN CLI, resident: 2 programs
    _reset_launches()
    t0 = time.perf_counter()
    dc_out = os.path.join(tmp, "dcgan_run")
    with contextlib.redirect_stdout(out):
        nets, dc_hist = dcgan_cli([
            "--data-location", h5, "--epochs", "1", "--resident",
            "--megastep", str(k), "--max-batches", str(2 * k), "--out-dir",
            dc_out, "--save-epoch", "1"])
    torch.cuda.synchronize()
    dc_s = time.perf_counter() - t0
    # the checkpoint holds the dropout generator's state after its replays
    check(sorted(os.listdir(dc_out)) == ["checkpoints", "history.json"]
          and any(f.startswith("step_") for f in
                  os.listdir(os.path.join(dc_out, "checkpoints"))),
          f"resident DCGAN CLI wrote {sorted(os.listdir(dc_out))}")
    dc_launches = {n: c for n, c in ops.launch_counts().items() if c}
    dc_line = [ln for ln in out.getvalue().splitlines()
               if ln.startswith("[resident]")][-1]
    row = dc_hist.history
    check(all(_finite(v) for v in row.values()),
          f"resident DCGAN CLI: {row}")
    check(not dc_launches, f"resident DCGAN CLI launched {dc_launches}")
    print(f"[megastep] python -m extended_gan_torch.dcgan --resident "
          f"--megastep {k} --max-batches {2 * k}, checkpointed: {dc_line}; "
          f"train_mse "
          f"{row['train_mse'][0]:.6f}, pred_mse {row['pred_mse'][0]:.6f}, "
          f"{dc_s:.2f} s")
    stream = _streaming_megastep(tmp, k, batch, hw)
    print(f"[megastep] phase {time.perf_counter() - t_phase:.1f} s; {card}")
    return dict(cli_launches=got, results=results, stream=stream)


def _streaming_megastep(tmp, k, batch, hw):
    """Both CLIs with ``--megastep K``, streaming (not resident), for one
    epoch: the feed's thread pins and copies the next group while a graph
    is captured, the epoch's shorter tail group captures a second graph
    into the same pool, and padded ragged batches go through both. 7 KNMI
    files give 21 batches (32, 32 and 25 rows a file): groups of 8, 8 and
    5; a 630-frame archive gives the DCGAN 20 batches (the last of 9 rows):
    groups of 8, 8 and 4. Each epoch runs again with the megastep's K steps
    eager, on the card, and the two are held to MEGA_LIMIT (the final
    weights and BatchNorm statistics), their histories equal, and their
    launch counts (by the replay rule) equal. Returns the graph runs'
    launches."""
    import torch

    from extended_gan_torch import ops
    from extended_gan_torch.data.synthetic import (
        ensure_synthetic_h5,
        make_kmni_dataset,
    )
    from extended_gan_torch.dcgan.__main__ import main as dcgan_cli
    from extended_gan_torch.gat.__main__ import main as gat_cli
    from extended_gan_torch.utils.compare import held_to_reference

    knmi7 = make_kmni_dataset(os.path.join(tmp, "knmi7"), n_train_files=7,
                              n_test_files=2, frames_per_file=96, hw=hw)
    h5s = ensure_synthetic_h5(os.path.join(tmp, "h5s"), frames_train=630,
                              frames_test=64, h=64, w=64)
    runs = {
        "gat": (gat_cli, [
            "train", "--model-type", "temporal", "--mapping-type", "conv",
            "--dataset", "kmni", "--preprocessed-folder", knmi7,
            "--downsample-size", str(hw), str(hw), "--train-batch-size",
            str(batch), "--test-batch-size", "64", "--epochs", "1",
            "--megastep", str(k)], (k, 5)),
        "dcgan": (dcgan_cli, ["--data-location", h5s, "--epochs", "1",
                              "--megastep", str(k)], (k, 4))}
    stream = {}
    for name, (cli, argv, ks) in runs.items():
        outcome = {}
        for mode in ("graph", "eager"):
            _reset_launches()
            t0 = time.perf_counter()
            with _megastep_watch(eager=mode == "eager") as captured, \
                    torch.backends.cudnn.flags(enabled=True, allow_tf32=False,
                                               deterministic=True), \
                    contextlib.redirect_stdout(io.StringIO()):
                trained, hist = cli(argv)
            torch.cuda.synchronize()
            mods = trained if isinstance(trained, tuple) else (trained,)
            outcome[mode] = dict(
                state=[t.detach().clone() for m in mods
                       for t in itertools.chain(m.parameters(), m.buffers())],
                hist=getattr(hist, "history", hist), captured=list(captured),
                launches={n: c for n, c in ops.launch_counts().items() if c},
                s=time.perf_counter() - t0)
        g, e = outcome["graph"], outcome["eager"]
        verdict = held_to_reference(g["state"], e["state"], limit=MEGA_LIMIT)
        check([c[0][0] for c in g["captured"]] == list(ks)
              and all(c[0][1] == batch for c in g["captured"])
              and not e["captured"],
              f"streaming {name} --megastep {k}: captured {g['captured']} "
              f"(eager run {e['captured']}), expected K = {ks}, {batch} rows")
        check(verdict["ok"] and g["hist"] == e["hist"]
              and all(_finite(v) for v in g["hist"].values()),
              f"streaming {name} --megastep {k}: graph against eager "
              f"{verdict}; history {g['hist']} against {e['hist']}")
        check(g["launches"] == e["launches"],
              f"streaming {name}: launches {g['launches']} with graphs (by "
              f"the replay rule), {e['launches']} eager")
        stream[name] = g["launches"]
        print(f"[megastep] python -m extended_gan_torch."
              f"{'gat train' if name == 'gat' else 'dcgan'} --megastep {k}, "
              f"streaming, one epoch: graphs captured for "
              f"{[c[0][:2] for c in g['captured']]} (K, rows); graph against "
              f"the same groups eager: state gap {verdict['gap']:.3e} "
              f"(bitwise: {'yes' if verdict['bitwise'] else 'no'}), history "
              f"equal; launches {g['launches'] or 'none'} (by the replay "
              f"rule) = eager's; {g['s']:.2f} s with graphs, {e['s']:.2f} s "
              "eager")
    return stream


@contextlib.contextmanager
def _megastep_watch(*, eager=False):
    """Records the input shapes of every graph any megastep captures; with
    ``eager`` a megastep runs its K steps eagerly instead (on the card
    too), for comparison."""
    from extended_gan_torch.train.megastep import Megastep

    captured = []
    call, capture = Megastep.__call__, Megastep._capture

    def watched(self, inputs):
        captured.append(_shapes(inputs))
        return capture(self, inputs)
    Megastep._capture = watched
    if eager:
        Megastep.__call__ = Megastep.eager
    try:
        yield captured
    finally:
        Megastep.__call__, Megastep._capture = call, capture


ROBUST_K = 4
# bf16 against float32 over ROBUST_LOSS_STEPS train steps from one state
# (predicted before the first card run): each step's loss within this
# share of the float32 step's, or within ROBUST_LOSS_ABS
ROBUST_LOSS_REL = 0.05
ROBUST_LOSS_ABS = 2e-3
ROBUST_LOSS_STEPS = 4
# the bf16 and remat timings: eager steps, then K-step graph replays
ROBUST_TIMING = dict(eager_steps=4, graph_groups=2)


def robustness_child(spec_json):
    """One run that a SIGTERM cuts, for :func:`phase_robustness`: the
    driver as a user runs it, in this process, with cuDNN deterministic.
    Prints ``[child] step`` after each train step or group of K (before the
    driver reads its shutdown flag), ``[child] caught <t>`` when the signal
    lands, ``[child] save <step> <bytes> <ms>`` for each snapshot, its
    launch counts and ``[child] exit <t>`` (``time.monotonic``, which the
    parent's clock shares)."""
    import torch

    sys.path.insert(0, REPO)
    from extended_gan_torch import ops
    from extended_gan_torch.train import (
        checkpoint,
        cyclegan_driver,
        dcgan_driver,
        gat_driver,
        preempt,
    )

    spec = json.loads(spec_json)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    signalled = threading.Event()
    steps = [0]

    def stepped(items):
        for item in items:
            yield item
            steps[0] += 1
            print("[child] step", flush=True)
            if steps[0] == spec["stop_after"]:
                # the parent sends SIGTERM on this line: let it land before
                # the next step, whose dispatch (a graph replay) could
                # otherwise run ahead of it to the epoch's end
                signalled.wait(timeout=60)

    real_gat, real_dcgan, real_cyclegan = (
        gat_driver.train_single_epoch, dcgan_driver.train_single_epoch,
        cyclegan_driver.train_single_epoch)
    gat_driver.train_single_epoch = lambda **kw: real_gat(
        **{**kw, "train_steps": stepped(kw["train_steps"])})
    dcgan_driver.train_single_epoch = lambda logs, **kw: real_dcgan(
        stepped(logs), **kw)
    cyclegan_driver.train_single_epoch = lambda logs, **kw: real_cyclegan(
        stepped(logs), **kw)
    handler = preempt.GracefulShutdown._handler

    def caught(self, signum, frame):
        print(f"[child] caught {time.monotonic():.6f}", flush=True)
        handler(self, signum, frame)
        signalled.set()
    preempt.GracefulShutdown._handler = caught
    save = checkpoint.CheckpointManager.save

    def timed_save(self, step, state):
        t0 = time.monotonic()
        save(self, step, state)
        ms = (time.monotonic() - t0) * 1e3
        size = os.path.getsize(self._path(step))
        print(f"[child] save {step} {size} {ms:.3f}", flush=True)
    checkpoint.CheckpointManager.save = timed_save
    if spec.get("switched"):
        gat_driver.build_model = _switched_build_model()
    if spec["kind"] == "gat":
        gat_driver.train(**spec["kwargs"])
    elif spec["kind"] == "experiment":
        from extended_gan_torch.gat.generate_experiment import (
            generate_experiment,
        )
        generate_experiment(spec["name"], **spec["kwargs"])
    elif spec["kind"] == "cyclegan":
        from extended_gan_torch.cycle_gan.__main__ import main as cyclegan_cli
        cyclegan_cli(spec["argv"])
    else:
        from extended_gan_torch.dcgan.__main__ import main as dcgan_cli
        dcgan_cli(spec["argv"])
    torch.cuda.synchronize()
    print("[child] launches " + json.dumps(ops.launch_counts()), flush=True)
    print(f"[child] exit {time.monotonic():.6f}", flush=True)
    return 0


def _switched_build_model():
    """``build_model`` for the conv-GAT driver that turns K2 on: the GAT3D
    ``Model`` with ``use_pallas_mapping=True`` (a constructor switch only,
    as in JAX, so no config or CLI flag reaches it)."""
    from extended_gan_torch.models.gat.gat3d import Model as GatModel

    def build(model_type, *, image_width, image_height, n_vertices,
              mapping_type, time_steps, use_pallas, device, generator,
              dtype, conv_impl, moe_experts=0):
        return GatModel(image_width, image_height, n_vertices, model_type,
                        mapping_type, time_steps, use_pallas=True,
                        generator=generator, use_pallas_mapping=True,
                        dtype=dtype, conv_impl=conv_impl).to(device).eval()
    return build


class _Child:
    """A :func:`robustness_child` process, watched from a thread that sends
    it SIGTERM once it has printed ``stop_after`` steps."""

    def __init__(self, label, spec, stop_after):
        import signal

        self.label, self.stop_after = label, stop_after
        self.steps, self.t_signal, self.t_eof = 0, None, None
        self.caught = self.exited = None
        self.saves, self.launches, self.tail = [], {}, []
        self.proc = subprocess.Popen(
            [sys.executable, "-u", os.path.abspath(__file__),
             "--robustness-child",
             json.dumps({**spec, "stop_after": stop_after})], cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

        def watch():
            for line in self.proc.stdout:
                self.tail = (self.tail + [line])[-60:]
                if line.startswith("[child] step"):
                    self.steps += 1
                    if self.steps == stop_after:
                        self.t_signal = time.monotonic()
                        self.proc.send_signal(signal.SIGTERM)
                elif line.startswith("[child] caught "):
                    self.caught = float(line.split()[2])
                elif line.startswith("[child] save "):
                    _, _, step, size, ms = line.split()
                    self.saves.append((int(step), int(size), float(ms)))
                elif line.startswith("[child] launches "):
                    self.launches = json.loads(line.split(" ", 2)[2])
                elif line.startswith("[child] exit "):
                    self.exited = float(line.split()[2])
            self.t_eof = time.monotonic()
        self.thread = threading.Thread(target=watch, daemon=True)
        self.thread.start()

    def finish(self, timeout=300):
        """Waits for the child; fails unless it exited 0 after a SIGTERM
        and a mid-epoch or epoch-boundary snapshot. Returns its numbers."""
        try:
            rc = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
            raise SmokeFailure(f"{self.label}: the child outlived {timeout} s")
        self.thread.join(timeout=30)
        text = "".join(self.tail)
        check(rc == 0, f"{self.label}: the child exited {rc}:\n{text}")
        check(self.t_signal is not None and self.caught is not None,
              f"{self.label}: the child ended before its step "
              f"{self.stop_after} or never saw the SIGTERM:\n{text}")
        check(self.saves and "[preempt] stopped" in text
              and "WITHOUT a snapshot" not in text,
              f"{self.label}: no resumable snapshot after the SIGTERM:\n"
              f"{text}")
        step, size, ms = self.saves[-1]
        return dict(steps_seen=self.steps, snapshot_step=step,
                    snapshot_bytes=size, save_ms=ms,
                    signal_to_caught_ms=(self.caught - self.t_signal) * 1e3,
                    signal_to_exit_ms=(self.exited - self.t_signal) * 1e3,
                    signal_to_process_end_ms=(self.t_eof - self.t_signal)
                    * 1e3, launches=self.launches)


def _checkpoint_tree(out_dir):
    """(the newest step, its tree) under ``<out_dir>/checkpoints``."""
    import torch

    from extended_gan_torch.train.checkpoint import CheckpointManager

    mgr = CheckpointManager(os.path.join(out_dir, "checkpoints"))
    step = mgr.latest_step()
    return step, torch.load(os.path.join(out_dir, "checkpoints",
                                         f"step_{step}.pt"),
                            weights_only=True)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree, key=str) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _same_run(ref, run, label):
    """Fails unless two runs' newest checkpoints (weights, BatchNorm
    statistics, optimizer and scheduler state, key stream, epoch, mid) and
    history.json are equal bit for bit."""
    import torch

    (s_ref, t_ref), (s_run, t_run) = _checkpoint_tree(ref), \
        _checkpoint_tree(run)
    a, b = _leaves(t_ref), _leaves(t_run)
    diff = [i for i, (x, y) in enumerate(zip(a, b))
            if not (torch.equal(x, y) if torch.is_tensor(x) else x == y)]
    with open(os.path.join(ref, "history.json")) as f, \
            open(os.path.join(run, "history.json")) as g:
        same_hist = json.load(f) == json.load(g)
    check(s_ref == s_run and len(a) == len(b) and not diff and same_hist,
          f"{label}: the resumed run differs from the uninterrupted one "
          f"(steps {s_ref}/{s_run}, {len(diff)} of {len(a)} leaves differ, "
          f"history equal: {same_hist})")
    return len(a)


def _float_leaves(out_dir):
    import torch

    _, tree = _checkpoint_tree(out_dir)
    return [t.double() for t in _leaves(tree)
            if torch.is_tensor(t) and t.is_floating_point()]


def _robust_gat_path(tmp, label, knmi, extra, stop_after, hw=80, batch=32):
    """final_temp_conv's model with K1 and K2 on, through the conv-GAT
    driver: starts the cut run in a child and returns the rest, the
    uninterrupted run here, the resume here; bitwise."""
    kw = dict(model_type="temporal", mapping_type="conv", dataset="kmni",
              preprocessed_folder=knmi, downsample_size=(hw, hw),
              train_batch_size=batch, test_batch_size=64, epochs=2,
              checkpoint_every=10, seed=369, **extra)
    ref, run = os.path.join(tmp, label + "_ref"), os.path.join(tmp, label)
    child = _Child(label, {"kind": "gat", "switched": True,
                           "kwargs": {**kw, "output_path": run}}, stop_after)
    return lambda: _robust_gat_finish(label, kw, ref, run, child)


def _robust_gat_finish(label, kw, ref, run, child):
    import torch

    from extended_gan_torch import ops
    from extended_gan_torch.train import gat_driver

    real_build = gat_driver.build_model
    gat_driver.build_model = _switched_build_model()
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False,
                                        deterministic=True), \
                contextlib.redirect_stdout(io.StringIO()):
            t0 = time.perf_counter()
            gat_driver.train(output_path=ref, **kw)
            torch.cuda.synchronize()
            ref_s = time.perf_counter() - t0
            cut = child.finish()
            before = ops.launch_counts()
            t0 = time.perf_counter()
            gat_driver.train(output_path=run, resume=True, **kw)
            torch.cuda.synchronize()
            resume_s = time.perf_counter() - t0
            launched = {n: c - before[n] for n, c in
                        ops.launch_counts().items() if c != before[n]}
    finally:
        gat_driver.build_model = real_build
    leaves = _same_run(ref, run, label)
    for name in ("gat_attention_fwd", "gat_attention_bwd", "gat_mapping_fwd",
                 "gat_mapping_bwd"):
        check(launched.get(name, 0) > 0 and cut["launches"].get(name, 0) > 0,
              f"{label}: {name} launched {launched.get(name, 0)} times in "
              f"the resumed run, {cut['launches'].get(name, 0)} in the cut "
              "one")
    return dict(cut, launched=launched, leaves=leaves, ref_s=ref_s,
                resume_s=resume_s)


def _robust_dcgan_path(tmp, label, h5, extra, stop_after):
    """The published DCGAN through ``python -m extended_gan_torch.dcgan``
    (dropout 0.01): starts the cut run in a child and returns the rest,
    uninterrupted here, ``--resume`` here; bitwise."""
    # --save-epoch past the last epoch: a snapshot at the end and at a
    # SIGTERM only
    argv = ["--data-location", h5, "--epochs", "2", "--save-epoch", "10",
            *extra]
    ref, run = os.path.join(tmp, label + "_ref"), os.path.join(tmp, label)
    child = _Child(label, {"kind": "dcgan",
                           "argv": argv + ["--out-dir", run]}, stop_after)
    return lambda: _robust_dcgan_finish(label, argv, ref, run, child)


def _robust_dcgan_finish(label, argv, ref, run, child):
    import torch

    from extended_gan_torch.dcgan.__main__ import main as dcgan_cli

    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False,
                                    deterministic=True), \
            contextlib.redirect_stdout(io.StringIO()):
        dcgan_cli(argv + ["--out-dir", ref])
        cut = child.finish()
        dcgan_cli(argv + ["--out-dir", run, "--resume"])
        torch.cuda.synchronize()
    return dict(cut, leaves=_same_run(ref, run, label))


def _robust_smaat(tmp, stop_after):
    """final_smaatunet (K3) through ``generate_experiment``: starts the cut
    run in a child and returns the rest: two uninterrupted runs here
    (their gap is the run-to-run floor), the resume here, cuDNN
    deterministic as in the child; held by
    ``utils.compare.held_to_reference``, with a twin whose one optimizer
    step is skipped shown to fail it."""
    kw = dict(epochs=2, max_batches=8, checkpoint_every=10)
    outs = {k: os.path.join(tmp, "smaat_" + k)
            for k in ("ref", "twin", "twin2", "run", "fault")}
    child = _Child("final_smaatunet", {
        "kind": "experiment", "name": "final_smaatunet",
        "kwargs": {**kw, "output_path": outs["run"]}}, stop_after)
    return lambda: _robust_smaat_finish(kw, outs, child)


def _robust_smaat_finish(kw, outs, child):
    import torch

    from extended_gan_torch import ops
    from extended_gan_torch.gat.generate_experiment import generate_experiment
    from extended_gan_torch.utils.compare import (
        drift,
        held_to_reference,
        widest,
    )

    with contextlib.redirect_stdout(io.StringIO()), \
            torch.backends.cudnn.flags(enabled=True, allow_tf32=False,
                                       deterministic=True):
        for k in ("ref", "twin", "twin2"):
            generate_experiment("final_smaatunet", output_path=outs[k], **kw)
        cut = child.finish()
        before = ops.launch_counts()
        generate_experiment("final_smaatunet", output_path=outs["run"],
                            resume=True, **kw)
        torch.cuda.synchronize()
        launched = {n: c - before[n] for n, c in
                    ops.launch_counts().items() if c != before[n]}
        real_step = torch.optim.Adam.step
        calls = [0]

        def skip_one(self, *a, **k):
            calls[0] += 1
            return None if calls[0] == 5 else real_step(self, *a, **k)
        torch.optim.Adam.step = skip_one
        try:
            generate_experiment("final_smaatunet", output_path=outs["fault"],
                                **kw)
        finally:
            torch.optim.Adam.step = real_step
    want = _float_leaves(outs["ref"])
    floor = widest(drift(_float_leaves(outs[k]), want)
                   for k in ("twin", "twin2"))
    verdict = held_to_reference(_float_leaves(outs["run"]), want, floor)
    fault = held_to_reference(_float_leaves(outs["fault"]), want, floor)
    check(verdict["ok"] and not fault["ok"],
          f"final_smaatunet: resumed against uninterrupted {verdict}; a "
          f"skipped optimizer step {fault}")
    check(launched.get("dsconv_fwd", 0) > 0
          and launched.get("dsconv_bwd", 0) > 0,
          f"final_smaatunet: K3 launches in the resumed run {launched}")
    return dict(cut, launched=launched, verdict=verdict, fault=fault)


def _bf16_case(name, batch, hw):
    """(make(dtype) -> (modules, step(inputs) -> losses, megastep,
    optimizers), a batch's inputs) for one of the bf16 measurements."""
    import torch

    from extended_gan_torch.models.gat.gat3d import Model as GatModel
    from extended_gan_torch.models.registry import build_model
    from extended_gan_torch.train.dcgan_driver import (
        DEFAULT_PARAMS,
        build_dcgan,
    )
    from extended_gan_torch.train.dcgan_trainer import (
        make_dcgan_megastep,
        make_dcgan_train_step,
    )
    from extended_gan_torch.train.gat_trainer import (
        make_gat_megastep,
        make_gat_train_step,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    if name == "DCGAN":
        inputs = (torch.rand(batch, 4, 64, 64, device=dev, generator=gen),
                  torch.rand(batch, 4, 64, 64, device=dev, generator=gen),
                  torch.ones(batch, device=dev))

        def make(dtype, remat=False):
            nets, opts = build_dcgan(DEFAULT_PARAMS, seed=369, device=dev,
                                     capturable=True,
                                     precision="bf16" if dtype
                                     == torch.bfloat16 else "f32")
            step = make_dcgan_train_step(*nets, *opts)
            gens = (nets[0].ConvBlock_0.dropout_generator,)

            def losses(*a):  # one step, its three losses
                logs = step(*a)
                return [logs[k] for k in ("errFD", "errTD", "errG")]
            return (nets, losses,
                    make_dcgan_megastep(*nets, *opts, generators=gens), opts)
        return make, inputs
    v = 6
    inputs = (torch.rand(batch, hw, hw, 4, v, device=dev, generator=gen),
              torch.rand(batch, hw, hw, 4, v, device=dev, generator=gen),
              torch.ones(batch, device=dev))

    def make(dtype, remat=False):
        g = torch.Generator().manual_seed(369)
        if name == "final_smaatunet":
            model = build_model("unet", image_width=hw, image_height=hw,
                                n_vertices=v, mapping_type="linear",
                                device=dev, generator=g, dtype=dtype)
        else:
            model = GatModel(hw, hw, v, "temporal", "conv", use_pallas=True,
                             generator=g, dtype=dtype,
                             use_pallas_mapping=name.endswith("on")).to(dev)
        opt = torch.optim.Adam(model.parameters(), lr=1e-3,
                               weight_decay=0.01, capturable=True)
        step = make_gat_train_step(model, opt, remat=remat)
        return ((model,), lambda *a: [step(*a)[0]],
                make_gat_megastep(model, opt, remat=remat), (opt,))
    return make, inputs


def _step_numbers(make, inputs, dtype, *, remat=False, k=ROBUST_K,
                  eager_steps=8, graph_groups=3):
    """Eager ms a step (``eager_steps`` steps after 2), peak MiB of an
    eager step, the port's kernels launched by one eager step, and ms a
    step as K = k steps a CUDA graph (``graph_groups`` replays after the
    eager warm-up group and the capture), its busy ms and kernels a step
    (one replay profiled) and the port's kernels in the graph."""
    import torch

    from extended_gan_torch import ops

    mods, step, mega, _ = make(dtype, remat)
    for _ in range(2):
        step(*inputs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    before = ops.launch_counts()
    step(*inputs)
    torch.cuda.synchronize()
    per_step = {n: c - before[n] for n, c in ops.launch_counts().items()
                if c != before[n]}
    peak = torch.cuda.max_memory_allocated() / 2**20
    above = peak - base / 2**20
    t0 = time.perf_counter()
    for _ in range(eager_steps):
        step(*inputs)
    torch.cuda.synchronize()
    out = dict(eager_ms=(time.perf_counter() - t0) * 1e3 / eager_steps,
               peak_mib=peak, peak_step_mib=above, launches_a_step=per_step)
    staged = tuple(torch.stack([t] * k) for t in inputs)
    mega(*staged)  # the warm-up group, eager
    mega(*staged)  # captured, then replayed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(graph_groups):
        mega(*staged)
    torch.cuda.synchronize()
    out["graph_ms"] = (time.perf_counter() - t0) * 1e3 / (graph_groups * k)
    prof = _profile_call(lambda: mega(*staged), k)
    (entry,) = mega.graphs.values()
    out.update(busy_ms=prof["busy_ms"], kernels_a_step=prof["kernels"] / k,
               graph_launches=dict(entry.launches), mods=mods)
    return out


def _bf16_losses(make, inputs, n=ROBUST_LOSS_STEPS):
    """n train steps in float32 and in bf16 from the same state: (float32
    losses, bf16 losses, whether every bf16 parameter stayed float32)."""
    import torch

    runs = {}
    for dtype in (torch.float32, torch.bfloat16):
        mods, step, _, opts = make(dtype)
        runs[dtype] = [float(v) for _ in range(n) for v in step(*inputs)]
    params_f32 = all(p.dtype == torch.float32 for m in mods
                     for p in m.parameters()) and all(
        v.dtype == torch.float32 for o in opts for s in o.state.values()
        for v in s.values() if torch.is_tensor(v) and v.is_floating_point())
    return runs[torch.float32], runs[torch.bfloat16], params_f32


def _grads(mods):
    return [p.grad.detach().clone() for m in mods for p in m.parameters()]


def _remat_case(make, inputs, name):
    """One train step with and without remat from one state: gradients
    bit for bit, and the forward kernels launched twice as often with
    remat."""
    import torch

    from extended_gan_torch import ops

    grads, launches = {}, {}
    for label, remat in (("plain", False), ("remat", True)):
        mods, step, _, _ = make(torch.float32, remat)
        before = ops.launch_counts()
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False,
                                        deterministic=True):
            step(*inputs)
        torch.cuda.synchronize()
        launches[label] = {n: c - before[n] for n, c in
                           ops.launch_counts().items() if c != before[n]}
        grads[label] = _grads(mods)
    verdict = all(torch.equal(a, b) for a, b in zip(grads["remat"],
                                                    grads["plain"]))
    twice = {n: (2 * c if n.endswith("fwd") else c)
             for n, c in launches["plain"].items()}
    check(verdict and launches["remat"] == twice and twice,
          f"remat {name}: gradients {verdict}; launches {launches['remat']} "
          f"with remat, {launches['plain']} without")
    return verdict, launches["remat"]


def phase_robustness(tmp, batch=32):
    """State and robustness on the card (``core/precision.py``,
    ``core/prng.py``, ``train/preempt.py``, the resume half of
    ``train/checkpoint.py``, remat), at full width:

    - preempt and resume: a child process runs the driver and gets a real
      SIGTERM after its Nth step (or group of K); it writes a snapshot and
      exits 0; this process resumes and is held to an uninterrupted run:
      final_temp_conv's model with K1 and K2 (``use_pallas_mapping=True``,
      80x80, b=32) streaming and ``--resident --megastep 8``, and the
      published DCGAN through its CLI (dropout 0.01) streaming and
      ``--resident --megastep 8``, bit for bit (cuDNN deterministic);
      final_smaatunet (K3) within ``utils/compare.py``'s bound. The
      snapshot's bytes, the time to write it and the signal to the exit;
    - bf16 against float32 on the DCGAN, final_temp_conv (K2 off and on)
      and final_smaatunet at b=32: ms a step eager and as a K=8 graph,
      busy time and kernels a step, peak memory of a step, the kernels'
      launch counts (equal), 8 bf16 steps' losses against float32's from
      the same state (ROBUST_LOSS_REL), parameters float32;
    - remat on final_temp_conv (K2 off) and final_smaatunet: peak memory
      and ms a step with and without, gradients equal (bitwise for GAT3D,
      the drift bound for the UNet), forward kernels twice a step."""
    import torch

    from extended_gan_torch import ops
    from extended_gan_torch.data.synthetic import (
        ensure_synthetic_h5,
        ensure_synthetic_kmni,
        make_kmni_dataset,
    )

    t_phase = time.perf_counter()
    card = card_line()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    knmi = make_kmni_dataset(os.path.join(tmp, "knmi"), n_train_files=10,
                             n_test_files=1, frames_per_file=96, hw=80)
    h5 = ensure_synthetic_h5(os.path.join(tmp, "h5"), frames_train=1024,
                             frames_test=64, h=64, w=64)
    ensure_synthetic_kmni()  # final_smaatunet's fallback, before any child
    _reset_launches()  # the main path starts here: every launch below
    # 6 streaming steps an epoch: the SIGTERM after epoch 1 and 2 more;
    # resident, 2 programs of 4 an epoch: sent after 2 programs, seen after
    # the 3rd (a child's next program runs while the signal lands);
    # final_smaatunet's synthetic archive: 3 steps an epoch, after 4.
    # Every child starts first, so their start-ups overlap
    starts = {
        "gat streaming": lambda: _robust_gat_path(
            tmp, "gat_stream", knmi, dict(max_batches=6), 8),
        "gat resident": lambda: _robust_gat_path(
            tmp, "gat_resident", knmi, dict(max_batches=2 * ROBUST_K,
                                            resident=True,
                                            megastep=ROBUST_K), 2),
        "dcgan streaming": lambda: _robust_dcgan_path(
            tmp, "dcgan_stream", h5, ["--max-batches", "6"], 8),
        "dcgan resident": lambda: _robust_dcgan_path(
            tmp, "dcgan_resident", h5, ["--max-batches", str(2 * ROBUST_K),
                                        "--resident", "--megastep",
                                        str(ROBUST_K)], 2),
        "final_smaatunet": lambda: _robust_smaat(tmp, 4),
    }
    t0 = time.perf_counter()
    finishes = {label: start() for label, start in starts.items()}
    results = {}
    for label, finish in finishes.items():
        r = results[label] = finish()
        r["seconds"] = time.perf_counter() - t0  # since the children began
        print(f"[robustness] {label} (done {r['seconds']:.1f} s after the "
              "children began): SIGTERM after "
              f"step {r['steps_seen']} "
              f"seen, snapshot step {r['snapshot_step']} of "
              f"{r['snapshot_bytes']} bytes written in {r['save_ms']:.3f} "
              f"ms, signal to handler {r['signal_to_caught_ms']:.3f} ms, to "
              f"the driver's return {r['signal_to_exit_ms']:.3f} ms, to the "
              f"process's end {r['signal_to_process_end_ms']:.3f} ms; "
              + (f"resumed run equal bit for bit ({r['leaves']} leaves)"
                 if "leaves" in r else
                 f"resumed run held: gap {r['verdict']['gap']:.3e} "
                 f"(worst {r['verdict']['worst']:.3f} of its bound), a "
                 f"skipped step {r['fault']['worst']:.1f} of it")
              + f"; the cut run's launches {r['launches']}; {card}")

    bf16 = {}
    for name, hw in (("DCGAN", 64), ("final_temp_conv switch off", 80),
                     ("final_temp_conv switch on", 80),
                     ("final_smaatunet", 20)):
        make, inputs = _bf16_case(name, batch, hw)
        row = {}
        for dtype in (torch.float32, torch.bfloat16):
            row[str(dtype).split(".")[-1]] = _step_numbers(
                make, inputs, dtype, **ROBUST_TIMING)
        l32, l16, params_f32 = _bf16_losses(make, inputs)
        f32, b16 = row["float32"], row["bfloat16"]
        gaps = [abs(a - b) for a, b in zip(l16, l32)]
        check(all(math.isfinite(v) for v in l16) and params_f32 and all(
            g <= max(ROBUST_LOSS_REL * abs(a), ROBUST_LOSS_ABS)
            for g, a in zip(gaps, l32)),
            f"bf16 {name}: losses {l16} against float32's {l32}; parameters "
            f"and moments float32: {params_f32}")
        check(b16["launches_a_step"] == f32["launches_a_step"],
              f"bf16 {name}: launches {b16['launches_a_step']} a step, "
              f"float32 {f32['launches_a_step']}")
        for r in (f32, b16):
            r.pop("mods")
        bf16[name] = dict(row, loss_gap=max(gaps), losses_f32=l32,
                          losses_bf16=l16)
        print(f"[robustness] {name} b={batch}: ms a step eager f32 "
              f"{f32['eager_ms']:.3f} / bf16 {b16['eager_ms']:.3f}, as a "
              f"K={ROBUST_K} graph f32 {f32['graph_ms']:.3f} / bf16 "
              f"{b16['graph_ms']:.3f}; busy a step {f32['busy_ms']:.4f} / "
              f"{b16['busy_ms']:.4f}; kernels a step "
              f"{f32['kernels_a_step']:.1f} / {b16['kernels_a_step']:.1f}; "
              f"peak MiB {f32['peak_mib']:.1f} / {b16['peak_mib']:.1f} "
              f"(a step's own {f32['peak_step_mib']:.1f} / "
              f"{b16['peak_step_mib']:.1f}); the port's kernels a step "
              f"{b16['launches_a_step'] or 'none'} (= f32's); "
              f"{ROBUST_LOSS_STEPS} steps' "
              f"largest loss gap {max(gaps):.3e} (bound "
              f"{ROBUST_LOSS_REL} of the loss); {card}")

    remat = {}
    for name, hw in (("final_temp_conv switch off", 80),
                     ("final_smaatunet", 20)):
        make, inputs = _bf16_case(name, batch, hw)
        verdict, launched = _remat_case(make, inputs, name)
        rows = {flag: _step_numbers(make, inputs, torch.float32, remat=flag,
                                    **ROBUST_TIMING)
                for flag in (False, True)}
        in_graph = rows[True]["graph_launches"]
        check(in_graph == {n: ROBUST_K * c for n, c in launched.items()},
              f"remat {name}: a K={ROBUST_K} graph holds {in_graph}, a remat "
              f"step launches {launched}")
        for r in rows.values():
            r.pop("mods")
        remat[name] = dict(plain=rows[False], remat=rows[True],
                           launches=launched, grads=verdict)
        print(f"[robustness] remat {name} b={batch}: peak MiB "
              f"{rows[False]['peak_mib']:.1f} plain / "
              f"{rows[True]['peak_mib']:.1f} remat (a step's own "
              f"{rows[False]['peak_step_mib']:.1f} / "
              f"{rows[True]['peak_step_mib']:.1f}); ms a step eager "
              f"{rows[False]['eager_ms']:.3f} / {rows[True]['eager_ms']:.3f},"
              f" as a K={ROBUST_K} graph {rows[False]['graph_ms']:.3f} / "
              f"{rows[True]['graph_ms']:.3f}; gradients bitwise; launches a "
              f"remat step {launched}, in its graph {in_graph}; {card}")
    main_path = {n: c for n, c in ops.launch_counts().items() if c}
    for name in ("gat_attention_fwd", "gat_attention_bwd", "dsconv_fwd",
                 "dsconv_bwd", "gat_mapping_fwd", "gat_mapping_bwd"):
        check(main_path.get(name, 0) > 0,
              f"robustness: {name} never launched in this phase")
    seconds = time.perf_counter() - t_phase
    print(f"[robustness] launches in this process {main_path}; phase "
          f"{seconds:.1f} s")
    return dict(results=results, main_path=main_path, bf16=bf16,
                remat=remat, seconds=seconds)


CYCLEGAN_K = 8
CYCLEGAN_KEYS = ("train_mse", "pred_mse", "cycle_l1")
LOSS_NAMES = ("g_loss", "adv_loss", "cycle_loss", "d_x_loss", "d_y_loss")


def cyclegan_steps(nets, batches, device, dtype):
    """The CycleGAN's four nets' weights in fresh nets on ``device`` in
    ``dtype``, dropout off, with Adam as the driver builds it: the eval
    forwards on the first batch (G_xy(x), then G_yx on it), then one train
    step's five losses, gradients and running statistics, then the losses
    of a step on each further batch."""
    import torch

    from extended_gan_torch.train.cyclegan_driver import build_cyclegan
    from extended_gan_torch.train.cyclegan_trainer import (
        make_cyclegan_eval_step,
        make_cyclegan_train_step,
    )

    copies, opts = build_cyclegan(seed=0, device="cpu", dropout=0.0)
    for c, n in zip(copies, nets):
        c.load_state_dict(n.state_dict())
    nets = tuple(c.to(device, dtype) for c in copies)
    opts = tuple(torch.optim.Adam(n.parameters(), lr=2e-4,
                                  betas=(0.5, 0.999), eps=1e-8)
                 for n in nets)
    step = make_cyclegan_train_step(*nets, *opts)
    data = [tuple(torch.from_numpy(a).to(device, dtype) for a in b)
            for b in batches]
    fake, _ = make_cyclegan_eval_step(nets[0], nets[1])(*data[0])
    with torch.no_grad():
        cyc = nets[1](fake)
    out = dict(fwd=[t.double().cpu() for t in (fake, cyc)], losses=[])
    for i, (x, y) in enumerate(data):
        logs = step(x, y)
        out["losses"].append([float(logs[k]) for k in LOSS_NAMES])
        if i == 0:
            out["grads"] = [[p.grad.to("cpu", torch.float64, copy=True)
                             for p in n.parameters()] for n in nets]
            out["stats"] = [[b.to("cpu", torch.float64, copy=True)
                             for k, b in n.state_dict().items()
                             if "running" in k] for n in nets]
    return out


def _robust_cyclegan_path(tmp, label, data, extra, stop_after):
    """The published CycleGAN through ``python -m
    extended_gan_torch.cycle_gan`` (dropout 0.01): cut in a child by a
    SIGTERM, which starts now; the returned ``finish()`` runs it
    uninterrupted here, waits for the child, runs ``--resume`` here and
    holds the two bit for bit."""
    import torch

    from extended_gan_torch.cycle_gan.__main__ import main as cyclegan_cli

    argv = ["--data-location", data, "--epochs", "2", "--save-epoch", "10",
            *extra]
    ref, run = os.path.join(tmp, label + "_ref"), os.path.join(tmp, label)
    child = _Child(label, {"kind": "cyclegan",
                           "argv": argv + ["--out-dir", run]}, stop_after)

    def finish():
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False,
                                        deterministic=True), \
                contextlib.redirect_stdout(io.StringIO()):
            t0 = time.perf_counter()
            cyclegan_cli(argv + ["--out-dir", ref])
            torch.cuda.synchronize()
            ref_s = time.perf_counter() - t0
            cut = child.finish()
            cyclegan_cli(argv + ["--out-dir", run, "--resume"])
            torch.cuda.synchronize()
        return dict(cut, leaves=_same_run(ref, run, label), ref_s=ref_s)

    return finish


def phase_cyclegan(tmp, batch=32):
    """The CycleGAN at the published width (nc 4, ndf 64, 64x64, b=32,
    cycle lambda 10) as a user trains it, outputs under ``tmp``:

    - ``python -m extended_gan_torch.cycle_gan --synthetic --epochs 2
      --max-batches 4 --save-epoch 1 --out-dir``: finite results under the
      JAX driver's keys, only history.json and checkpoints/ written;
    - in process from seed 0, dropout off: the card's exact-f32 eval
      forwards, step losses, gradients and running statistics against
      float64 on the CPU (the ``dcgan`` phase's bounds, each tensor held
      to 10x what noise on both halves of the batch moves it), and a TF32
      step that these limits must refuse;
    - ms a step eager and as a K=8 CUDA graph over the resident archive,
      busy time and kernels a step in the graph, peak memory of a step;
      the graph bit for bit against eager steps (dropout off, cuDNN
      deterministic);
    - a SIGTERM mid-epoch in a child and ``--resume``, bit for bit against
      an uninterrupted run, streaming and ``--resident --megastep 8``;
    - a bf16 step: finite, float32 parameters;
    - ``serve export --workload cyclegan`` of both directions, f32 and
      w8a8, each with --check on the card.

    No CUDA kernel of the port is on this path (no Pallas kernel is on the
    JAX package's): K1, K2 and K3 launch 0 times."""
    import numpy as np
    import torch

    from extended_gan_torch import ops
    from extended_gan_torch.cycle_gan.__main__ import main as cyclegan_cli
    from extended_gan_torch.data.resident import (
        ResidentVideos,
        make_cyclegan_resident_megastep,
    )
    from extended_gan_torch.data.streaming import get_coastal_loaders
    from extended_gan_torch.data.synthetic import make_coastal_dataset
    from extended_gan_torch.serve.__main__ import main as serve_cli
    from extended_gan_torch.train.cyclegan_driver import build_cyclegan
    from extended_gan_torch.train.cyclegan_trainer import (
        make_cyclegan_train_step,
    )
    from extended_gan_torch.train.dcgan_trainer import to_nchw

    t_phase = time.perf_counter()
    card = card_line()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # a 4-file archive: 20 streaming batches and 3 resident programs an
    # epoch, for the cuts (and the bigger split the children start on)
    data = make_coastal_dataset(os.path.join(tmp, "coastal"),
                                n_train_files=4, n_test_files=1,
                                frames_per_file=136, h=64, w=64)
    _reset_launches()  # the main path starts here: every launch below
    # 1. the CLI, two epochs of 4 batches, checkpointed
    out = os.path.join(tmp, "cli")
    before = _tree_state(REPO)
    t0 = time.perf_counter()
    nets, history = cyclegan_cli(["--synthetic", "--epochs", "2",
                                  "--max-batches", "4", "--save-epoch", "1",
                                  "--out-dir", out])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    written = sorted(os.listdir(out))
    changed = sorted(set(before.items()) ^ set(_tree_state(REPO).items()))
    results = {k: v[-1] for k, v in history.history.items()}
    check(all(next(n.parameters()).device.type == "cuda" for n in nets),
          "cyclegan CLI: the nets are not on the card")
    check(sorted(results) == sorted(CYCLEGAN_KEYS)
          and all(len(v) == 2 for v in history.history.values()),
          f"cyclegan CLI: history {history.history}")
    check(_finite(results.values()), f"cyclegan CLI: results {results}")
    check(written == ["checkpoints", "history.json"],
          f"cyclegan CLI: wrote {written} into --out-dir")
    check(not changed, f"cyclegan CLI: wrote into the checkout: "
          f"{changed[:5]}")
    print(f"[cyclegan] python -m extended_gan_torch.cycle_gan --synthetic "
          f"--epochs 2 --max-batches 4 --save-epoch 1 --out-dir <tmp> (nc 4, "
          f"ndf 64, 64x64, b={batch}): {cli_s:.2f} s with start-up, last "
          f"epoch {json.dumps(results)}; only history.json and checkpoints/ "
          "written, under --out-dir")

    # 2. agreement: the card's exact f32 against float64 on the CPU
    nets, _ = build_cyclegan(seed=0, device="cuda", dropout=0.0)
    loader, _ = get_coastal_loaders(data, batch, 64, seq_len=4, crop=64,
                                    seed=1)
    batches = [tuple(to_nchw(a) for a in next(loader)) for _ in range(3)]
    check(all(len(b[0]) == batch for b in batches), "short batch")
    t0 = time.perf_counter()
    card_run = cyclegan_steps(nets, batches, torch.device("cuda"),
                              torch.float32)
    ref = cyclegan_steps(nets, batches, torch.device("cpu"), torch.float64)
    # roundoff's scale: what 1e-7 noise on both halves of the first batch
    # moves float64, the most of three draws (noise on the context alone
    # leaves D_x's gradients nearly still, far below their roundoff); the
    # draws run in float64 on the card, whose own roundoff (1e-16) is far
    # below the noise's effect

    def noisy(seed):
        rng = np.random.default_rng(seed)
        return [tuple((a * (1 + 1e-7 * rng.standard_normal(a.shape)))
                      .astype(np.float32) for a in batches[0])]

    draws = [cyclegan_steps(nets, noisy(seed), torch.device("cuda"),
                            torch.float64) for seed in range(3)]
    # a lower precision, which the limits below must refuse: TF32
    # convolutions and products on the card
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    tf32_run = cyclegan_steps(nets, batches[:1], torch.device("cuda"),
                              torch.float32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ref_s = time.perf_counter() - t0
    fwd_err = max((a - b).abs().max().item()
                  for a, b in zip(card_run["fwd"], ref["fwd"]))
    check(fwd_err <= DCGAN_FWD_TOL,
          f"cyclegan eval forwards: card f32 vs CPU float64 {fwd_err:.3e} "
          f"(limit {DCGAN_FWD_TOL})")
    got, want = np.array(card_run["losses"]), np.array(ref["losses"])
    check(np.isfinite(got).all(), f"cyclegan losses {got}")
    rel = np.abs(got - want) / np.abs(want)
    check(rel[0].max() <= DCGAN_LOSS_TOL,
          f"cyclegan step 1 losses {got[0]} vs float64 {want[0]}: {rel[0]}")
    check(rel.max() <= DCGAN_LOSSES_TOL,
          f"cyclegan 3 steps' losses {got} vs float64 {want}: {rel}")
    lines, tf32_worst = [], 0.0
    for what in ("grads", "stats"):
        for i, name in enumerate(("G_xy", "G_yx", "D_x", "D_y")):
            # each tensor's gap in units of its net's largest entry, held
            # to the floor or 10x what the noise moves that tensor
            w = ref[what][i]
            gaps = _leaf_gaps(card_run[what][i], w)
            sens = np.max([_leaf_gaps(d[what][i], w) for d in draws], 0)
            limits = np.maximum(DCGAN_FLOOR, DCGAN_SENS_FACTOR * sens)
            worst = int(np.argmax(gaps / limits))
            check((gaps <= limits).all(),
                  f"cyclegan {what} of {name}: card f32 vs CPU float64, "
                  f"tensor {worst} {gaps[worst]:.3e} of the net's largest "
                  f"entry (limit {limits[worst]:.3e}; 1e-7 noise moves "
                  f"float64 {sens[worst]:.3e})")
            tf32 = _leaf_gaps(tf32_run[what][i], w) / limits
            tf32_worst = max(tf32_worst, float(tf32.max()))
            lines.append(f"{what} {name} {gaps.max():.3e} (at most "
                         f"{(gaps / limits).max():.3f} of its tensor's "
                         f"limit; TF32 {tf32.max():.3f})")
    check(tf32_worst > 1.0,
          f"cyclegan agreement: TF32 on the card passes the exact-f32 "
          f"limits (at most {tf32_worst:.3f} of a limit), so they cannot "
          "tell a lower precision from roundoff")
    print(f"[cyclegan] agreement, card exact f32 vs CPU float64, full width "
          f"from seed 0, dropout off, b={batch} ({ref_s:.1f} s): eval "
          f"forwards {fwd_err:.3e} (limit {DCGAN_FWD_TOL}); step 1 losses "
          f"{rel[0].max():.3e} relative (limit {DCGAN_LOSS_TOL}), 3 steps "
          f"{rel.max():.3e} (limit {DCGAN_LOSSES_TOL}); " + "; ".join(lines))

    # 3. times: eager, and K=8 steps a graph over the resident archive
    store = ResidentVideos.from_pt_frames(os.path.join(data, "train"),
                                          "cuda")
    prog = store.epoch_programs(0, CYCLEGAN_K, batch)[0]
    nets, opts = build_cyclegan(seed=0, device="cuda", capturable=True)
    step = make_cyclegan_train_step(*nets, *opts)
    x, y = (torch.from_numpy(a).cuda() for a in batches[0])
    for _ in range(2):
        step(x, y)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step(x, y)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**20
    t0 = time.perf_counter()
    for _ in range(20):
        step(x, y)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3 / 20
    eager_prof = _profile_call(lambda: step(x, y), 1)
    mega = make_cyclegan_resident_megastep(
        *nets, *opts, store, generators=(
            nets[0].ConvBlock_0.dropout_generator,))
    mega(prog)  # the warm-up group, eager
    mega(prog)  # captured, then replayed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        mega(prog)
    torch.cuda.synchronize()
    graph_ms = (time.perf_counter() - t0) * 1e3 / (5 * CYCLEGAN_K)
    prof = _profile_call(lambda: mega(prog), CYCLEGAN_K)
    # the graph against eager steps from the same seed, dropout off
    runs = []
    for graphs in (True, False):
        tw, tw_opts = build_cyclegan(seed=0, device="cuda", dropout=0.0,
                                     capturable=True)
        m = make_cyclegan_resident_megastep(*tw, *tw_opts, store)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False,
                                        deterministic=True):
            logs = [(m if graphs else m.eager)(p) for p in
                    store.epoch_programs(3, CYCLEGAN_K, batch)]
        torch.cuda.synchronize()
        runs.append(_train_state(tw, tw_opts)
                    + [v for g in logs for v in g.values()])
        if graphs:
            check((m.captures, m.replays) == (1, 2),
                  f"cyclegan graph: {m.captures} captures, {m.replays} "
                  "replays")
    same = all(torch.equal(a, b) for a, b in zip(*runs, strict=True))
    check(same, "cyclegan: the replayed graphs differ from eager steps")
    print(f"[cyclegan] {card}: b={batch} train step eager {eager_ms:.3f} ms "
          f"(host clock, synchronised, 20 steps; busy {eager_prof['busy_ms']:.4f} "
          f"ms, {eager_prof['kernels']} kernels), as a K={CYCLEGAN_K} CUDA "
          f"graph over the resident archive {graph_ms:.3f} ms a step (busy "
          f"{prof['busy_ms']:.4f} ms, {prof['kernels'] / CYCLEGAN_K:.1f} "
          f"kernels a step); peak memory of a step {peak:.1f} MiB; 3 "
          f"programs as graphs equal eager steps bit for bit")

    # 4. preempt and resume, bitwise
    # streaming: 12 steps an epoch, the SIGTERM after epoch 1 and 4 more;
    # resident: 3 programs of 8 an epoch, after 4 programs
    # both children start at once
    cuts = {
        "streaming": _robust_cyclegan_path(
            tmp, "cg_stream", data, ["--max-batches", "12"], 16),
        "resident": _robust_cyclegan_path(
            tmp, "cg_resident", data, ["--max-batches", "24", "--resident",
                                       "--megastep", str(CYCLEGAN_K)], 4),
    }
    cuts = {label: finish() for label, finish in cuts.items()}
    for label, r in cuts.items():
        print(f"[cyclegan] preempt {label}: SIGTERM after step "
              f"{r['steps_seen']} seen, snapshot step {r['snapshot_step']} "
              f"of {r['snapshot_bytes']} bytes in {r['save_ms']:.3f} ms, "
              f"signal to the driver's return {r['signal_to_exit_ms']:.3f} "
              f"ms; resumed run equal bit for bit ({r['leaves']} leaves); "
              f"uninterrupted run {r['ref_s']:.2f} s")

    # 5. bf16
    nets16, opts16 = build_cyclegan(seed=0, device="cuda", precision="bf16")
    step16 = make_cyclegan_train_step(*nets16, *opts16)
    losses16 = [float(v) for _ in range(3) for k, v in step16(x, y).items()
                if k in LOSS_NAMES]
    f32_params = all(p.dtype == torch.float32 for n in nets16
                     for p in n.parameters())
    check(_finite(losses16) and f32_params,
          f"cyclegan bf16: losses {losses16}, float32 parameters "
          f"{f32_params}")

    # 6. export both generators, f32 and w8a8, checked on the card
    exports = {}
    for direction in ("xy", "yx"):
        for q in ("", "w8a8"):
            path = os.path.join(tmp, f"g_{direction}{q}.pt")
            with contextlib.redirect_stdout(io.StringIO()) as text:
                info = serve_cli(["export", out, "--workload", "cyclegan",
                                  "--direction", direction, "--out", path,
                                  "--check", *(["--quantize", q] if q
                                               else [])])
            checks = re.findall(r"max\|serve - live\| = (\S+)",
                                text.getvalue())
            check(info["model_type"] == f"cyclegan_generator_{direction}"
                  and len(checks) == 2 and "check OK" in text.getvalue(),
                  f"cyclegan export {direction} {q}: {text.getvalue()}")
            exports[f"{direction} {q or 'f32'}"] = (info["nbytes"], checks)
    launched = {n: c for n, c in ops.launch_counts().items() if c}
    check(not launched, f"cyclegan phase: CUDA kernel launches {launched}, "
          "expected none")
    secs = time.perf_counter() - t_phase
    print(f"[cyclegan] bf16: 3 steps finite ({losses16[-5:]}), parameters "
          f"float32; export --check on the card: "
          + "; ".join(f"{k} {b} bytes, |serve - live| {' / '.join(c)}"
                      for k, (b, c) in exports.items())
          + f"; K1, K2, K3 launches 0; the phase took {secs:.1f} s")
    return dict(cli_s=cli_s, results=results, fwd_err=fwd_err,
                loss_rel=float(rel.max()), eager_ms=eager_ms,
                graph_ms=graph_ms, busy_ms=prof["busy_ms"], peak_mib=peak,
                cuts=cuts, exports=exports, secs=secs,
                launches=ops.launch_counts())


def vanilla_steps(nets, real, z, device, dtype, fused):
    """One vanilla GAN step from ``nets``' weights in fresh nets on
    ``device`` in ``dtype``, with the CLI's Adam, on ``real`` with latents
    ``z``: the losses, each net's gradients and the generator's running
    statistics after it."""
    import torch

    from extended_gan_torch.models.vanilla_gan import (
        MLPDiscriminator,
        MLPGenerator,
    )
    from extended_gan_torch.train.adversarial import make_vanilla_gan_step

    copies = (MLPGenerator(), MLPDiscriminator())
    for c, n in zip(copies, nets):
        c.load_state_dict(n.state_dict())
    g, d = (c.to(device, dtype) for c in copies)
    opts = [torch.optim.Adam(n.parameters(), lr=2e-4, betas=(0.5, 0.999),
                             eps=1e-8) for n in (g, d)]
    step = make_vanilla_gan_step(g, d, *opts, latent_dim=100,
                                 fused_prop=fused)
    logs = step(torch.from_numpy(real).to(device, dtype),
                torch.from_numpy(z).to(device, dtype))
    return dict(losses=[float(logs[k]) for k in ("g_loss", "d_loss")],
                grads=[[p.grad.to("cpu", torch.float64, copy=True)
                        for p in n.parameters()] for n in (g, d)],
                stats=[[b.to("cpu", torch.float64, copy=True)
                        for k, b in g.state_dict().items()
                        if "running" in k]])


def phase_vanilla_gan(tmp, batch=64):
    """The vanilla MLP GAN at the published width (latent 100, 28x28,
    b=64): the default and FusedProp steps in exact f32 on the card against
    float64 on the CPU from seed 0 (losses, gradients, the generator's
    running statistics; the ``dcgan`` phase's bounds), ms a step of each,
    and ``python -m extended_gan_torch.vanilla_gan --n_epochs 1
    --max_batches 20 --data_root "" --sample_interval 10 --out_dir`` with
    its PNG grids. K1, K2 and K3 launch 0 times (dense layers only)."""
    import numpy as np
    import torch

    from extended_gan_torch import ops
    from extended_gan_torch.models.vanilla_gan import (
        MLPDiscriminator,
        MLPGenerator,
    )
    from extended_gan_torch.train.adversarial import make_vanilla_gan_step
    from extended_gan_torch.vanilla_gan.__main__ import main as vanilla_cli

    t_phase = time.perf_counter()
    card = card_line()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _reset_launches()  # the main path starts here
    init = torch.Generator().manual_seed(0)
    nets = (MLPGenerator(generator=init), MLPDiscriminator(generator=init))
    rng = np.random.default_rng(0)
    real = rng.uniform(-1, 1, (batch, 1, 28, 28)).astype(np.float32)
    z = rng.standard_normal((batch, 100)).astype(np.float32)
    noisy = (real * (1 + 1e-7 * rng.standard_normal(real.shape))).astype(
        np.float32)
    lines, times = [], {}
    for fused in (False, True):
        label = "FusedProp" if fused else "default"
        got = vanilla_steps(nets, real, z, torch.device("cuda"),
                            torch.float32, fused)
        want = vanilla_steps(nets, real, z, torch.device("cpu"),
                             torch.float64, fused)
        moved = vanilla_steps(nets, noisy, z, torch.device("cpu"),
                              torch.float64, fused)
        rel = max(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                       want["losses"]))
        check(_finite(got["losses"]) and rel <= DCGAN_LOSS_TOL,
              f"vanilla {label}: losses {got['losses']} vs float64 "
              f"{want['losses']}")
        parts = [f"losses {rel:.3e} relative (limit {DCGAN_LOSS_TOL})"]
        for what in ("grads", "stats"):
            for name, g, w, m in zip(("G", "D"), got[what], want[what],
                                     moved[what]):
                gap, sens = _net_gap(g, w), _net_gap(m, w)
                limit = max(DCGAN_FLOOR, DCGAN_SENS_FACTOR * sens)
                check(gap <= limit, f"vanilla {label} {what} of {name}: "
                      f"{gap:.3e} (limit {limit:.3e})")
                parts.append(f"{what} {name} {gap:.3e} (limit {limit:.3e})")
        g, d = (n.cuda() for n in (MLPGenerator(generator=torch.Generator()
                                                .manual_seed(0)),
                                   MLPDiscriminator()))
        opts = [torch.optim.Adam(n.parameters(), lr=2e-4, betas=(0.5, 0.999))
                for n in (g, d)]
        step = make_vanilla_gan_step(
            g, d, *opts, latent_dim=100, fused_prop=fused,
            generator=torch.Generator("cuda").manual_seed(0))
        r = torch.from_numpy(real).cuda()
        for _ in range(3):
            step(r)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            step(r)
        torch.cuda.synchronize()
        times[label] = (time.perf_counter() - t0) * 1e3 / 50
        busy = _profile_call(lambda: step(r), 1)
        lines.append(f"{label}: {times[label]:.3f} ms a step (host clock, "
                     f"50 steps; busy {busy['busy_ms']:.4f} ms, "
                     f"{busy['kernels']} kernels); " + ", ".join(parts))
    print(f"[vanilla_gan] {card}, b={batch}, card exact f32 vs CPU float64 "
          "from seed 0: " + "; ".join(lines))
    out = os.path.join(tmp, "images")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as text:
        g, _ = vanilla_cli(["--n_epochs", "1", "--max_batches", "20",
                            "--data_root", "", "--sample_interval", "10",
                            "--out_dir", out])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    pngs = sorted(os.listdir(out))
    losses = re.findall(r"\[D loss: (\S+)\] \[G loss: (\S+)\]",
                        text.getvalue())
    check(next(g.parameters()).device.type == "cuda",
          "vanilla CLI: the generator is not on the card")
    check(pngs == ["0.png", "10.png"] and all(
        open(os.path.join(out, p), "rb").read(8) == b"\x89PNG\r\n\x1a\n"
        for p in pngs), f"vanilla CLI: wrote {pngs}")
    check(len(losses) == 20 and _finite(float(v) for pair in losses
                                        for v in pair),
          f"vanilla CLI: {len(losses)} loss lines, last {losses[-1:]}")
    launched = {n: c for n, c in ops.launch_counts().items() if c}
    check(not launched, f"vanilla phase: CUDA kernel launches {launched}")
    secs = time.perf_counter() - t_phase
    print(f"[vanilla_gan] python -m extended_gan_torch.vanilla_gan --n_epochs "
          f"1 --max_batches 20 --data_root '' --sample_interval 10: "
          f"{cli_s:.2f} s (8,192 synthetic digits made first), grids {pngs}, "
          f"last losses D {losses[-1][0]} G {losses[-1][1]}; K1, K2, K3 "
          f"launches 0; the phase took {secs:.1f} s")
    return dict(times=times, cli_s=cli_s, secs=secs,
                launches=ops.launch_counts())


# the native batches against the numpy path's (tests/test_native.py:27-28)
HOST_RTOL, HOST_ATOL = 1e-5, 1e-6
# chanfirst against the exact-f32 cuDNN mapping from the same weights: the
# forward within the CPU tests' 2e-5 bar of its largest entry, each
# gradient within 1e-5 of the model's largest gradient entry (the output
# block's adjacency B has a gradient that cancels to roundoff: its entries
# start equal and tie in the min-max normalisation)
CHANFIRST_FWD_TOL, CHANFIRST_GRAD_TOL = 2e-5, 1e-5
# the DCGAN step bodies and the generator's layout: the body's
# options and whether G is packed
VARIANT_BODIES = {
    "default": ({}, False),
    "fused_disc": ({"fused_disc": True}, False),
    "fused_prop": ({"fused_prop": True}, False),
    "fused_disc+fused_prop": ({"fused_disc": True, "fused_prop": True},
                              False),
    "packed_g": ({}, True),
}


def _variant_flags(body, packed):
    """The DCGAN CLI's flags for a body and layout."""
    return ([f"--{k.replace('_', '-')}" for k in body]
            + (["--packed-g"] if packed else []))


@contextlib.contextmanager
def _fake_rows_against_1():
    """The planted fault: every BCE against label 0 (the discriminators'
    fake rows) taken against 1."""
    from extended_gan_torch.train import dcgan_trainer

    real = dcgan_trainer.bce

    def swapped(p, target, *, mask=None):
        return real(p, 1.0 if target == 0.0 else target, mask=mask)

    dcgan_trainer.bce = swapped
    try:
        yield
    finally:
        dcgan_trainer.bce = real


def variant_step(states, batch, device, dtype, body, packed):
    """One Adam step of a DCGAN body (dropout off) from ``states`` (the
    three nets' state_dicts) on ``batch`` (numpy x, y), in ``dtype`` on
    ``device``: its losses, each net's gradients and running statistics
    (float64, on the CPU)."""
    import torch

    from extended_gan_torch.models.dcgan import (
        FrameDiscriminator,
        Generator,
        TemporalDiscriminator,
    )
    from extended_gan_torch.train.dcgan_driver import DEFAULT_PARAMS
    from extended_gan_torch.train.dcgan_trainer import make_dcgan_train_step

    nc, ndf = DEFAULT_PARAMS["nc"], DEFAULT_PARAMS["ndf"]
    nets = (Generator(nc, 0.0, packed=packed), FrameDiscriminator(nc, ndf),
            TemporalDiscriminator(nc, ndf, 0.0))
    for net, sd in zip(nets, states):
        net.load_state_dict(sd)
    nets = tuple(n.to(device, dtype) for n in nets)
    opts = tuple(torch.optim.Adam(n.parameters(), lr=DEFAULT_PARAMS["lr"],
                                  betas=(DEFAULT_PARAMS["beta1"], 0.999),
                                  eps=1e-8) for n in nets)
    x, y = (torch.from_numpy(a).to(device, dtype) for a in batch)
    logs = make_dcgan_train_step(*nets, *opts, **body)(x, y)

    def cpu(t):
        return t.to("cpu", torch.float64, copy=True)

    return dict(
        losses=[float(logs[k]) for k in ("errFD", "errTD", "errG")],
        grads=[[cpu(p.grad) for p in n.parameters()] for n in nets],
        stats=[[cpu(b) for k, b in n.state_dict().items() if "running" in k]
               for n in nets])


def _variant_make(body, packed, dropout):
    """make(dtype, remat) for ``_step_numbers``: the published DCGAN with
    this body, from seed 369, capturable Adam."""
    import torch

    from extended_gan_torch.train.dcgan_driver import (
        DEFAULT_PARAMS,
        build_dcgan,
    )
    from extended_gan_torch.train.dcgan_trainer import (
        make_dcgan_megastep,
        make_dcgan_train_step,
    )

    def make(dtype=torch.float32, remat=False):
        nets, opts = build_dcgan(DEFAULT_PARAMS, seed=369, device="cuda",
                                 capturable=True, dropout=dropout,
                                 packed_g=packed)
        step = make_dcgan_train_step(*nets, *opts, **body)
        gens = (nets[0].ConvBlock_0.dropout_generator,)

        def losses(*a):
            logs = step(*a)
            return [logs[k] for k in ("errFD", "errTD", "errG")]
        return (nets, losses,
                make_dcgan_megastep(*nets, *opts, generators=gens, **body),
                opts)
    return make


def _variant_graph_vs_eager(body, packed, inputs, k=MEGA_K):
    """2K steps of a body (dropout off, cuDNN deterministic) as K eager
    steps then one captured and replayed graph of K, against 2K eager
    steps from the same state: the worst gap of any state tensor in units
    of its largest entry."""
    import torch

    from extended_gan_torch.train.dcgan_trainer import make_dcgan_train_step

    make = _variant_make(body, packed, 0.0)
    staged = tuple(torch.stack([t] * k) for t in inputs)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False,
                                    deterministic=True):
        nets, _, mega, opts = make()
        mega(*staged)
        mega(*staged)
        # the eager twin: the same seed, the same state
        nets_e, _, _, opts_e = make()
        step = make_dcgan_train_step(*nets_e, *opts_e, **body)
        for _ in range(2 * k):
            step(*inputs)
        torch.cuda.synchronize()
    worst, bitwise = 0.0, True
    for a, b in zip(_train_state(nets, opts), _train_state(nets_e, opts_e)):
        if not a.is_floating_point():
            bitwise &= bool(torch.equal(a, b))
            continue
        bitwise &= bool(torch.equal(a, b))
        scale = max(b.abs().max().item(), 1e-30)
        worst = max(worst, (a - b).abs().max().item() / scale)
    return worst, bitwise, mega.replays


def _unet_variant_pair(kind):
    """(kernel model, plain twin) at final_smaatunet's width (base 64, kpl
    2, 20x20, V 6) from seed 0: ``per_vertex_bn`` is ``UnetModel(...,
    per_vertex_bn=True)``; ``bilinear=False`` a UnetModel whose SmaAt-UNet
    has the transposed-conv decoder."""
    import torch

    from extended_gan_torch.models.smaat_unet import SmaAt_UNet
    from extended_gan_torch.models.unet_model import UnetModel

    def build(use_pallas):
        g = torch.Generator().manual_seed(0)
        if kind == "per_vertex_bn":
            return UnetModel(20, 20, 6, mapping_type="linear",
                             per_vertex_bn=True, use_pallas=use_pallas,
                             generator=g)
        model = UnetModel(20, 20, 6, mapping_type="linear",
                          use_pallas=use_pallas, generator=g)
        model.unet = SmaAt_UNet(4, 4, kernels_per_layer=2,
                                use_pallas=use_pallas, generator=g,
                                bilinear=False)
        return model

    fused, plain = build(True).cuda(), build(False).cuda()
    plain.load_state_dict(fused.state_dict())
    return fused, plain


def phase_gan_variants(tmp, batch=32):
    """The DCGAN's step bodies and packed generator, and the UNet's
    leftovers, on the card, outputs under ``tmp``:

    - the published DCGAN (nc 4, ndf 64, 64x64, b=32, exact f32) with each
      body: default, ``fused_disc``, ``fused_prop``, both, and the default
      body with ``packed_g``: one step's gradients and running statistics
      on the card against the same body in float64 on the CPU, each tensor
      within DCGAN_FLOOR or 10x roundoff's scale: what 1e-7 noise on the
      batch moves float64, or what another row order of the batch (three
      orders) moves the card's own float32 result (G's first block under
      ``fused_disc``: about 8e-4 of G's largest gradient entry, where the
      noise moves float64 9e-5); the fake rows taken against label 1 (a
      planted fault) must miss those limits 10x, and the same step in TF32
      (a lower precision) must miss them; ms a step eager and as a K=8 CUDA
      graph (dropout 0.01), busy ms and kernels a step in a replay, peak
      MiB of an eager step; 16 steps as eager + graph against 16 eager
      steps (dropout off, cuDNN deterministic);
    - each body through ``python -m extended_gan_torch.dcgan`` streaming
      and ``--resident --megastep 8``; the CycleGAN CLI with
      ``--packed-g``; ``serve export --packed-g --check`` of the packed
      DCGAN generator and of both CycleGAN generators (``layout``
      ``packed2``);
    - ``UnetModel(per_vertex_bn=True)`` and the ``bilinear=False``
      SmaAt-UNet at final_smaatunet's width (V 6, b=32): an eval forward
      and one step's gradients, three SGD steps, against the plain DSC,
      K3 18 launches a forward and 18 + 18 a step, as its counters say.

    K1 and K2 launch 0 times; K3 only in the UNets. Returns the launches
    by path and the rows."""
    import numpy as np
    import torch

    from extended_gan_torch import ops
    from extended_gan_torch.cycle_gan.__main__ import main as cyclegan_cli
    from extended_gan_torch.data.streaming import get_h5_loaders
    from extended_gan_torch.data.synthetic import ensure_synthetic_h5
    from extended_gan_torch.dcgan.__main__ import main as dcgan_cli
    from extended_gan_torch.ops import dsconv as k3
    from extended_gan_torch.serve.__main__ import main as serve_cli
    from extended_gan_torch.train.dcgan_driver import (
        DEFAULT_PARAMS,
        build_dcgan,
    )
    from extended_gan_torch.train.dcgan_trainer import to_nchw

    t_phase = time.perf_counter()
    card = card_line()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    by_path = {}

    # 1. each body: agreement with float64, a planted fault, graph vs eager
    folder = ensure_synthetic_h5(None, frames_train=256, frames_test=64,
                                 h=64, w=64)
    loader, _ = get_h5_loaders(folder, batch, 64, crop=64, in_seq_len=4,
                               out_seq_len=4, seed=1)
    real = tuple(to_nchw(a) for a in next(loader))
    check(len(real[0]) == batch, "short batch")
    nets, _ = build_dcgan(DEFAULT_PARAMS, seed=0, device="cpu", dropout=0.0)
    states = [n.state_dict() for n in nets]
    gen = torch.Generator(device=dev).manual_seed(7)
    inputs = (torch.rand(batch, 4, 64, 64, device=dev, generator=gen),
              torch.rand(batch, 4, 64, 64, device=dev, generator=gen),
              torch.ones(batch, device=dev))

    def noisy(seed):
        rng = np.random.default_rng(seed)
        return tuple((a * (1 + 1e-7 * rng.standard_normal(a.shape)))
                     .astype(np.float32) for a in real)

    # three row orders: one under-samples the card's roundoff at G's first
    # block (fused_disc: one order moved it 8e-4 of G's largest gradient in
    # one run, 8.7e-5 in another, where the card lay 1.6e-3 from float64)
    orders = [np.random.default_rng(s).permutation(batch) for s in range(3)]
    rows = {}
    for name, (body, packed) in VARIANT_BODIES.items():
        t0 = time.perf_counter()
        _reset_launches()
        card_run = variant_step(states, real, dev, torch.float32, body,
                                packed)
        # the same batch in other row orders: the same step, which the
        # card's float32 reductions round otherwise
        reordered = [variant_step(states, tuple(a[order] for a in real), dev,
                                  torch.float32, body, packed)
                     for order in orders]
        with _fake_rows_against_1():
            fault = variant_step(states, real, dev, torch.float32, body,
                                 packed)
        # a lower precision, which the limits below must refuse: TF32
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = variant_step(states, real, dev, torch.float32, body,
                                packed)
        finally:
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        ref = variant_step(states, real, torch.device("cpu"), torch.float64,
                           body, packed)
        # the noise's effect in float64 on the card
        draws = [variant_step(states, noisy(0), dev, torch.float64, body,
                              packed)]
        ref_s = time.perf_counter() - t0
        rel = np.abs(np.array(card_run["losses"]) - ref["losses"]) / np.abs(
            ref["losses"])
        check(rel.max() <= DCGAN_LOSS_TOL,
              f"gan_variants {name}: losses {card_run['losses']} vs float64 "
              f"{ref['losses']}")
        worst, fault_worst, tf32_worst = 0.0, 0.0, 0.0
        for what in ("grads", "stats"):
            for i, net in enumerate(("G", "FD", "TD")):
                w = ref[what][i]
                if not w:
                    continue
                gaps = _leaf_gaps(card_run[what][i], w)
                # roundoff's scale: what 1e-7 noise moves float64, or what
                # a row order moves the card's own float32 result
                sens = np.max([_leaf_gaps(d[what][i], w) for d in draws]
                              + [_leaf_gaps(r[what][i], card_run[what][i])
                                 for r in reordered], 0)
                limits = np.maximum(DCGAN_FLOOR, DCGAN_SENS_FACTOR * sens)
                at = int(np.argmax(gaps / limits))
                check((gaps <= limits).all(),
                      f"gan_variants {name}: {what} of {net}, card f32 vs "
                      f"CPU float64, tensor {at} {gaps[at]:.3e} of the "
                      f"net's largest entry (limit {limits[at]:.3e})")
                worst = max(worst, float((gaps / limits).max()))
                fault_worst = max(fault_worst, float(
                    (_leaf_gaps(fault[what][i], w) / limits).max()))
                tf32_worst = max(tf32_worst, float(
                    (_leaf_gaps(tf32[what][i], w) / limits).max()))
        check(fault_worst > 10,
              f"gan_variants {name}: the fake rows against label 1 stay "
              f"within {fault_worst:.2f} of the limits")
        check(tf32_worst > 1,
              f"gan_variants {name}: a TF32 step stays within "
              f"{tf32_worst:.3f} of the limits")
        gap_ge, bitwise, replays = _variant_graph_vs_eager(body, packed,
                                                           inputs)
        check(gap_ge <= MEGA_LIMIT and replays == 1,
              f"gan_variants {name}: graph against eager {gap_ge:.3e} "
              f"(limit {MEGA_LIMIT}), {replays} replays")
        rows[name] = dict(loss_rel=float(rel.max()), worst_of_limit=worst,
                          fault_of_limit=fault_worst,
                          tf32_of_limit=tf32_worst, graph_vs_eager=gap_ge,
                          bitwise=bitwise)
        print(f"[gan_variants] DCGAN b={batch} exact f32, body {name}: one "
              f"step vs CPU float64: losses {rel.max():.3e} relative, "
              f"gradients and statistics at most {worst:.3f} of their "
              f"per-tensor limits, the planted fault {fault_worst:.1f}, a "
              f"TF32 step {tf32_worst:.3f}; 16 "
              f"steps eager+graph vs eager {gap_ge:.3e}"
              f"{' (bitwise)' if bitwise else ''} ({ref_s:.1f} s for the "
              f"references)")
        by_path[f"gan_variants: DCGAN {name}, float64 check and graph"] = \
            ops.launch_counts()

    # 2. times, dropout 0.01 (the CLI's): each body eager and as a K=8
    # graph, in 3 alternating rounds (medians kept), then a replay profiled
    runs = {}
    staged = tuple(torch.stack([t] * MEGA_K) for t in inputs)
    for name, (body, packed) in VARIANT_BODIES.items():
        _reset_launches()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()  # the bodies built before
        _, step, mega, _ = _variant_make(body, packed, 0.01)()
        for _ in range(2):
            step(*inputs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step(*inputs)
        torch.cuda.synchronize()
        # this body's own peak: its nets, Adam state and an eager step
        peak = (torch.cuda.max_memory_allocated() - held) / 2**20
        mega(*staged)  # the warm-up group, eager
        mega(*staged)  # captured, then replayed
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        check(not any(launches.values()),
              f"gan_variants {name}: port kernels launched {launches}")
        by_path[f"gan_variants: DCGAN {name}, timing"] = launches
        runs[name] = dict(step=step, mega=mega, peak=peak, eager=[],
                          graph=[])
    host = host_state()
    for _ in range(3):
        for r in runs.values():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(8):
                r["step"](*inputs)
            torch.cuda.synchronize()
            r["eager"].append((time.perf_counter() - t0) * 1e3 / 8)
            t0 = time.perf_counter()
            for _ in range(3):
                r["mega"](*staged)
            torch.cuda.synchronize()
            r["graph"].append((time.perf_counter() - t0) * 1e3 / (3 * MEGA_K))
    for name, r in runs.items():
        prof = _profile_call(lambda: r["mega"](*staged), MEGA_K)
        row = rows[name]
        row.update(eager_ms=statistics.median(r["eager"]),
                   graph_ms=statistics.median(r["graph"]),
                   eager_rounds=r["eager"], graph_rounds=r["graph"],
                   busy_ms=prof["busy_ms"],
                   kernels_a_step=prof["kernels"] / MEGA_K,
                   peak_mib=r["peak"])
        print(f"[gan_variants] {card}: DCGAN b={batch} exact f32, body "
              f"{name}: {row['eager_ms']:.3f} ms a step eager (rounds "
              + ", ".join(f"{v:.3f}" for v in r["eager"])
              + f"), {row['graph_ms']:.3f} ms as a K=8 graph (rounds "
              + ", ".join(f"{v:.3f}" for v in r["graph"])
              + f"; host clock), busy {row['busy_ms']:.4f} ms and "
              f"{row['kernels_a_step']:.1f} kernels a step in a replay, "
              f"peak {row['peak_mib']:.1f} MiB in an eager step")
    print(f"[gan_variants] host during the rounds: {host}")
    del runs

    # 3. the CLIs, each body streaming and resident
    cli_s = {}
    for name, (body, packed) in VARIANT_BODIES.items():
        flags = _variant_flags(body, packed)
        for mode, extra in (("streaming", ["--max-batches", "4"]),
                            ("resident", ["--resident", "--megastep", "8",
                                          "--max-batches", "8"])):
            out = os.path.join(tmp, f"dcgan_{name}_{mode}".replace("+", "_"))
            _reset_launches()
            t0 = time.perf_counter()
            cli_nets, history = dcgan_cli(
                ["--epochs", "1", "--synthetic", "--out-dir", out,
                 "--save-epoch", "1", *extra, *flags])
            torch.cuda.synchronize()
            cli_s[name, mode] = time.perf_counter() - t0
            launches = ops.launch_counts()
            results = {k: v[0] for k, v in history.history.items()}
            check(_finite(results.values())
                  and cli_nets[0].packed == ("--packed-g" in flags)
                  and next(cli_nets[0].parameters()).is_cuda,
                  f"gan_variants: dcgan CLI {flags} {mode}: {results}")
            check(not any(launches.values()),
                  f"gan_variants: dcgan CLI {flags} {mode}: launches "
                  f"{launches}")
            by_path[f"gan_variants: dcgan CLI {name} {mode}"] = launches
    print(f"[gan_variants] python -m extended_gan_torch.dcgan --epochs 1 "
          f"--synthetic with each body's flags, streaming (4 batches) and "
          f"--resident --megastep 8 (8 batches): "
          + ", ".join(f"{n} {m} {s:.2f} s" for (n, m), s in cli_s.items())
          + "; finite results, K1, K2, K3 0 launches")

    # 4. the packed generators through the CycleGAN CLI and serve export
    _reset_launches()
    cg_out = os.path.join(tmp, "cyclegan_packed")
    t0 = time.perf_counter()
    cg_nets, cg_hist = cyclegan_cli(
        ["--synthetic", "--epochs", "1", "--max-batches", "4",
         "--save-epoch", "1", "--out-dir", cg_out, "--packed-g"])
    cg_s = time.perf_counter() - t0
    check(cg_nets[0].packed and cg_nets[1].packed
          and _finite(v[0] for v in cg_hist.history.values()),
          f"gan_variants: cyclegan --packed-g: {cg_hist.history}")
    exports = []
    for src, argv in (
            (os.path.join(tmp, "dcgan_packed_g_streaming"),
             ["--workload", "dcgan"]),
            (cg_out, ["--workload", "cyclegan", "--direction", "xy"]),
            (cg_out, ["--workload", "cyclegan", "--direction", "yx"])):
        path = os.path.join(tmp, f"export_{len(exports)}.pt")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            info = serve_cli(["export", src, *argv, "--packed-g", "--out",
                              path, "--check"])
        text = buf.getvalue()
        errs = [float(e) for e in re.findall(r"= ([0-9.e+-]+)\n", text)]
        check("check OK" in text and info["spec"]["layout"] == "packed2"
              and info["layout"] == "packed2",
              f"gan_variants: serve export {argv} --packed-g: {text[-300:]}")
        exports.append((" ".join(argv[1::2]), info["nbytes"], max(errs)))
    launches = ops.launch_counts()
    check(not any(launches.values()),
          f"gan_variants: cyclegan --packed-g and export: launches {launches}")
    by_path["gan_variants: cyclegan --packed-g and export"] = launches
    print(f"[gan_variants] python -m extended_gan_torch.cycle_gan "
          f"--packed-g, 4 batches: {cg_s:.2f} s, finite; serve export "
          f"--packed-g --check on the card, layout packed2: "
          + "; ".join(f"{w} {n} bytes, |serve - live| {e:.3e}"
                      for w, n, e in exports))

    # 5. the UNet leftovers: K3 inside, against the plain DSC
    counts = lambda: {"dsconv_fwd": k3.launch_count,  # noqa: E731
                      "dsconv_bwd": k3.bwd_launch_count}
    x = torch.rand(batch, 20, 20, 4, 6, device=dev,
                   generator=torch.Generator(device=dev).manual_seed(3))
    unets = {}
    for kind in ("per_vertex_bn", "bilinear=False"):
        _reset_launches()
        fused, plain = _unet_variant_pair(kind)
        with torch.no_grad():
            got = fused.eval()(x)
            fwd = counts()
            want = plain.eval()(x)
        err = (got - want).abs().max().item() / want.abs().max().item()
        check(fwd == {"dsconv_fwd": 18, "dsconv_bwd": 0}
              and err <= TRAIN_GRAD_FLOOR,
              f"gan_variants {kind}: eval forward {err:.3e} of the largest "
              f"output against the plain DSC, K3 launches {fwd}")
        # one step's gradients and three SGD steps against the plain DSC
        # (18 + 18 launches a step, checked there), then its timing runs
        res = compare_train_steps(f"unet {kind}", fused, plain, 20, "sgd",
                                  counts, {"dsconv_fwd": 18,
                                           "dsconv_bwd": 18})
        launched = ops.launch_counts()
        check(launched["dsconv_fwd"] > 0 and launched["dsconv_bwd"] > 0
              and not launched["gat_attention_fwd"]
              and not launched["gat_mapping_fwd"],
              f"gan_variants {kind}: launches {launched}")
        unets[kind] = dict(fwd_err=err, kernel_ms=res["kernel_ms"],
                           plain_ms=res["plain_ms"], launched=res["launched"])
        by_path[f"gan_variants: unet {kind} forward, steps and timing"] = \
            launched
        print(f"[gan_variants] unet {kind} (base 64, kpl 2, 20x20, V 6, "
              f"b={batch}): eval forward within {err:.3e} of the largest "
              f"output of the plain DSC, K3 18 launches; train step "
              f"{res['kernel_ms']:.3f} ms with K3, {res['plain_ms']:.3f} ms "
              f"plain (exact f32)")
    secs = time.perf_counter() - t_phase
    print(f"[gan_variants] the phase took {secs:.1f} s")
    return dict(launches=by_path, rows=rows, unets=unets, secs=secs)


MOE_E = 8
MOE_PARAMS = 12_437_540  # the JAX package's count at E = 8 (probe_moe.py)
MOE_AUX_W = 0.01


def _moe_model(device, *, use_pallas=True, per_vertex=False, seed=0,
               dtype=None, hw=20, v=6):
    """final_smaatunet's model with the Switch-MoE bottleneck (E = 8) from
    ``seed``, on ``device``, in train mode."""
    import torch

    from extended_gan_torch.models.unet_model import UnetModel

    model = UnetModel(hw, hw, v, mapping_type="linear",
                      per_vertex_bn=per_vertex, use_pallas=use_pallas,
                      moe_experts=MOE_E,
                      generator=torch.Generator().manual_seed(seed),
                      dtype=dtype or torch.float32)
    return model.to(device).train()


def _moe_routing(model, x):
    """One train-mode forward of ``model`` on ``x`` under ``sow_moe``, its
    MoE input captured: (expert of each kept token or -1, kept mask, the
    smallest top-1 router margin, tokens dropped, output)."""
    import torch

    from extended_gan_torch.models import moe

    (layer,) = moe.moe_layers(model)
    seen = []
    hook = layer.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].detach()))
    try:
        with torch.no_grad(), moe.sow_moe([layer]) as sown:
            y = model(x)
    finally:
        hook.remove()
    tokens = layer.grouped_tokens(seen[0])
    cap = moe.expert_capacity(tokens.shape[1], MOE_E, layer.capacity_factor)
    d, _, _ = moe.route_top1(tokens, layer.router, cap)
    kept = d.sum(dim=(-2, -1)) > 0
    expert = torch.where(kept, d.sum(-1).argmax(-1), -1)
    probs = torch.softmax(tokens.double() @ layer.router.detach().double(),
                          -1)
    top2 = probs.topk(2, dim=-1).values
    margin = float((top2[..., 0] - top2[..., 1]).min())
    (_, load), = sown
    return (expert.cpu(), kept.cpu(), margin,
            int(tokens.shape[0] * tokens.shape[1] - load.sum().item()), y)


def _moe_step(state, x, y, device, dtype, *, per_vertex=False, fault=False,
              use_pallas=None):
    """One train step (SGD at lr 0, ``moe_aux_weight`` 0.01) of the MoE
    UNet from ``state`` on numpy (x, y), in ``dtype`` on ``device`` (the
    kernels on the card unless ``use_pallas=False``, the plain DSC on the
    CPU): its loss, gradients and running statistics (float64, on the
    CPU), and its routing. ``fault`` plants the gate left out of
    combine."""
    import torch

    from extended_gan_torch.models import moe
    from extended_gan_torch.train.gat_trainer import make_gat_train_step

    if use_pallas is None:
        use_pallas = device.type == "cuda"
    model = _moe_model(device, use_pallas=use_pallas, per_vertex=per_vertex)
    model.load_state_dict(state)
    model = model.to(dtype)
    xt, yt = (torch.from_numpy(a).to(device, dtype) for a in (x, y))
    routing = _moe_routing(model, xt)
    model.load_state_dict(state)  # the routing pass moved the statistics
    opt = torch.optim.SGD(model.parameters(), lr=0.0)
    step = make_gat_train_step(model, opt, moe_aux_weight=MOE_AUX_W)
    real = moe.route_top1
    if fault:
        def gateless(*a):
            d, _, aux = real(*a)
            return d, d, aux
        moe.route_top1 = gateless
    try:
        loss, _ = step(xt, yt, torch.ones(len(x), device=device, dtype=dtype))
    finally:
        moe.route_top1 = real

    def cpu(t):
        return t.to("cpu", torch.float64, copy=True)

    return dict(loss=float(loss),
                grads=[cpu(p.grad) for p in model.parameters()],
                stats=[cpu(b) for k, b in model.state_dict().items()
                       if "running" in k], routing=routing[:4])


def _moe_step_make(*, dense=False):
    """make(dtype, remat) for ``_step_numbers``: the MoE UNet (or, with
    ``dense``, the same UNet without it) from seed 369, capturable Adam."""
    import torch

    from extended_gan_torch.models.registry import build_model
    from extended_gan_torch.train.gat_trainer import (
        make_gat_megastep,
        make_gat_train_step,
    )

    def make(dtype=torch.float32, remat=False):
        model = build_model("unet", image_width=20, image_height=20,
                            n_vertices=6, mapping_type="linear",
                            device="cuda", dtype=dtype,
                            generator=torch.Generator().manual_seed(369),
                            moe_experts=0 if dense else MOE_E)
        opt = torch.optim.Adam(model.parameters(), lr=1e-3,
                               weight_decay=0.01, capturable=True)
        aux = 0.0 if dense else MOE_AUX_W
        step = make_gat_train_step(model, opt, remat=remat,
                                   moe_aux_weight=aux)
        return ((model,), lambda *a: [step(*a)[0]],
                make_gat_megastep(model, opt, remat=remat,
                                  moe_aux_weight=aux), (opt,))
    return make


def _moe_resume(tmp, knmi, stop_after=8):
    """The MoE UNet through the conv-GAT driver (the KNMI archive
    ``knmi``, 20x20, b=32, 2 epochs of 6 batches, checkpoints on): three
    uninterrupted runs here (the two twins' gaps to the first give the
    run-to-run floor), the
    cut run in a :class:`_Child` that gets a real SIGTERM once it has
    printed ``stop_after`` steps (the driver then finishes the step it is
    in: it stops after step ``stop_after + 1``, the 3rd of epoch 2), the
    resume here, and a run whose 5th optimizer step is skipped (must
    fail); held by ``utils.compare.held_to_reference``, the fault's margin
    reported beside the bound."""
    import torch

    from extended_gan_torch import ops
    from extended_gan_torch.train import gat_driver
    from extended_gan_torch.utils.compare import (
        drift,
        held_to_reference,
        widest,
    )

    kw = dict(model_type="unet", mapping_type="linear", dataset="kmni",
              preprocessed_folder=knmi, downsample_size=(20, 20),
              train_batch_size=32, epochs=2, max_batches=6,
              checkpoint_every=10, moe_experts=MOE_E)
    twins = ("twin", "twin2")
    outs = {k: os.path.join(tmp, "moe_" + k)
            for k in ("ref", *twins, "run", "fault")}
    child = _Child("moe resume", {
        "kind": "gat", "kwargs": {**kw, "output_path": outs["run"]}},
        stop_after)
    with contextlib.redirect_stdout(io.StringIO()):
        for k in ("ref", *twins):
            gat_driver.train(output_path=outs[k], **kw)
        cut = child.finish()
        before = ops.launch_counts()
        gat_driver.train(output_path=outs["run"], resume=True, **kw)
        torch.cuda.synchronize()
        launched = {n: c - before[n] for n, c in
                    ops.launch_counts().items() if c != before[n]}
        real_step = torch.optim.Adam.step
        calls = [0]

        def skip_one(self, *a, **k):
            calls[0] += 1
            return None if calls[0] == 5 else real_step(self, *a, **k)
        torch.optim.Adam.step = skip_one
        try:
            gat_driver.train(output_path=outs["fault"], **kw)
        finally:
            torch.optim.Adam.step = real_step
    check("stopped resumably mid-epoch 2" in "".join(child.tail),
          "moe resume: no mid-epoch snapshot:\n" + "".join(child.tail))
    check(cut["launches"].get("dsconv_bwd", 0) == 18 * (stop_after + 1),
          f"moe resume: K3 launches in the cut run {cut['launches']}")
    want = _float_leaves(outs["ref"])
    floor = widest(drift(_float_leaves(outs[k]), want) for k in twins)
    verdict = held_to_reference(_float_leaves(outs["run"]), want, floor)
    fault = held_to_reference(_float_leaves(outs["fault"]), want, floor)
    check(verdict["ok"] and not fault["ok"],
          f"moe resume: resumed against uninterrupted {verdict}; a skipped "
          f"optimizer step {fault}")
    check(launched.get("dsconv_fwd", 0) > 0
          and launched.get("dsconv_bwd", 0) == 18 * (11 - stop_after),
          f"moe resume: K3 launches in the resumed run {launched}")
    return dict(cut, verdict=verdict, fault=fault, launched=launched)


def phase_moe(tmp, batch=32):
    """The Switch-MoE SmaAt-UNet (``models/moe.py``) on the card, at
    final_smaatunet's geometry (20x20, T 4, V 6, b=32) with E = 8 experts,
    capacity factor 2.0, ``moe_aux_weight`` 0.01; outputs under ``tmp``:

    - its parameter count, 12,437,540 (the JAX package's);
    - ms a step eager and as a K=8 CUDA graph, exact f32 and bf16, busy ms
      and kernels a step in a replay, peak MiB, K3's launches (18 + 18 a
      step, by the counters), and the same for the UNet without the MoE,
      whose gap is the MoE's own busy time; tokens dropped a step (the
      ``load`` diagnostic);
    - one step's loss, gradients and running statistics on the card
      against float64 on the CPU, each tensor within TRAIN_GRAD_FLOOR or
      10x what 1e-7 noise on the batch moves the card's own step, the
      routing (expert and kept mask of every token) equal,
      the smallest top-1 margin printed; the gate left out of combine (a
      planted fault) must miss those limits;
    - the graph against eager by ``graph_against_eager``;
    - ``per_vertex_bn=True``: one step with K3 against the plain DSC on
      the card (loss, gradients, routing by vertex);
    - ``python -m extended_gan_torch.gat train --model-type unet
      --moe-experts 8`` on a KNMI archive (4 files of 96 frames at 20x20),
      streaming (4 batches) and ``--megastep 8 --resident`` (16 steps: 2
      programs);
    - a run cut by a real SIGTERM in a child process mid-epoch and
      resumed here, against uninterrupted ones (``_moe_resume``);
    - ``serve export`` of an MoE experiment, f32 and ``--quantize w8``,
      with ``--check``, served over HTTP at b = 1 and 5, each sample's
      reply held against a batch-1 forward of the artifact on the CPU.

    K1 and K2 launch 0 times. Returns the launches by path and the rows."""
    import numpy as np
    import torch

    from extended_gan_torch import ops
    from extended_gan_torch.data.synthetic import make_kmni_dataset
    from extended_gan_torch.gat.__main__ import main as gat_cli
    from extended_gan_torch.serve.__main__ import main as serve_cli
    from extended_gan_torch.serve.export import load_exported
    from extended_gan_torch.train.state import param_count

    t_phase = time.perf_counter()
    card = card_line()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    by_path, rows = {}, {}

    # 1. the model, and one step against float64 on the CPU
    _reset_launches()
    model = _moe_model(dev)
    n_params = param_count(model)
    check(n_params == MOE_PARAMS,
          f"moe: {n_params} parameters, the JAX package counts {MOE_PARAMS}")
    state = {k: v.cpu() for k, v in model.state_dict().items()}
    del model
    rng = np.random.default_rng(11)
    x = rng.random((batch, 20, 20, 4, 6), np.float32)
    y = rng.random((batch, 20, 20, 4, 6), np.float32)
    noisy = (x * (1 + 1e-7 * rng.standard_normal(x.shape))).astype(np.float32)
    t0 = time.perf_counter()
    got = _moe_step(state, x, y, dev, torch.float32)
    got_noisy = _moe_step(state, noisy, y, dev, torch.float32)
    fault = _moe_step(state, x, y, dev, torch.float32, fault=True)
    launched = ops.launch_counts()
    ref = _moe_step(state, x, y, cpu, torch.float64)
    ref_s = time.perf_counter() - t0
    check(launched["dsconv_fwd"] == 3 * 2 * 18
          and launched["dsconv_bwd"] == 3 * 18,
          f"moe: K3 launches {launched} for 3 routing forwards and 3 steps")
    by_path["moe: one step vs float64, 3 steps and their forwards"] = \
        launched
    (e_got, k_got, _, drop_got), (e_ref, k_ref, margin, drop_ref) = \
        got["routing"], ref["routing"]
    check(torch.equal(e_got, e_ref) and torch.equal(k_got, k_ref),
          f"moe: routing on the card differs from float64's at "
          f"{int((e_got != e_ref).sum())} tokens (smallest top-1 margin "
          f"{margin:.3e})")
    loss_rel = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
    check(loss_rel <= TRAIN_LOSS_TOL, f"moe: loss {got['loss']} vs float64 "
          f"{ref['loss']}")
    worst = fault_worst = 0.0
    for what in ("grads", "stats"):
        w = ref[what]
        # roundoff's scale: what 1e-7 noise on the batch moves the card's
        # own float32 step (a float64 draw on the CPU as well cost 20 s)
        sens = _leaf_gaps(got_noisy[what], got[what])
        limits = np.maximum(TRAIN_GRAD_FLOOR, TRAIN_SENS_FACTOR * sens)
        gaps = _leaf_gaps(got[what], w)
        at = int(np.argmax(gaps / limits))
        check((gaps <= limits).all(),
              f"moe: {what}, card f32 vs CPU float64, tensor {at} "
              f"{gaps[at]:.3e} of the largest entry (limit {limits[at]:.3e})")
        worst = max(worst, float((gaps / limits).max()))
        fault_worst = max(fault_worst, float(
            (_leaf_gaps(fault[what], w) / limits).max()))
    check(fault_worst > 10, f"moe: the gate left out of combine stays within "
          f"{fault_worst:.2f} of the limits")
    rows["float64"] = dict(loss_rel=loss_rel, worst_of_limit=worst,
                           fault_of_limit=fault_worst, margin=margin,
                           dropped=drop_got, ref_s=ref_s)
    print(f"[moe] E={MOE_E}, {n_params} parameters, b={batch} exact f32: one "
          f"step vs CPU float64: loss {loss_rel:.3e} relative, gradients and "
          f"statistics at most {worst:.3f} of their per-tensor limits, the "
          f"gate left out of combine {fault_worst:.1f}; routing equal at all "
          f"{len(e_got.view(-1))} tokens (smallest top-1 margin "
          f"{margin:.3e}), {drop_got} dropped ({drop_ref} in float64); "
          f"{ref_s:.1f} s")

    # 2. per_vertex_bn: each vertex routed apart, one step with K3 against
    # the plain DSC on the card (the per-vertex UNet is held to JAX on the
    # CPU; a float64 step here took 17 s of the host)
    _reset_launches()
    pv_state = {k: v.cpu() for k, v in
                _moe_model(dev, per_vertex=True).state_dict().items()}
    pv = _moe_step(pv_state, x, y, dev, torch.float32, per_vertex=True)
    launched = ops.launch_counts()
    pv_ref = _moe_step(pv_state, x, y, dev, torch.float32, per_vertex=True,
                       use_pallas=False)
    pv_noisy = _moe_step(pv_state, noisy, y, dev, torch.float32,
                         per_vertex=True, use_pallas=False)
    pv_rel = abs(pv["loss"] - pv_ref["loss"]) / abs(pv_ref["loss"])
    pv_grad = _net_gap(pv["grads"], pv_ref["grads"])
    # what 1e-7 noise on the batch moves the plain step: roundoff's scale
    pv_tol = max(TRAIN_GRAD_FLOOR, TRAIN_SENS_FACTOR * _net_gap(
        pv_noisy["grads"], pv_ref["grads"]))
    check(pv_rel <= TRAIN_LOSS_TOL and pv_grad <= pv_tol
          and torch.equal(pv["routing"][0], pv_ref["routing"][0])
          and pv["routing"][0].shape == (6, batch)
          and launched["dsconv_bwd"] == 18,
          f"moe per_vertex_bn: loss {pv['loss']} vs the plain DSC's "
          f"{pv_ref['loss']}, gradients {pv_grad:.3e} of the largest entry "
          f"(limit {pv_tol:.3e}), "
          f"routing shape {tuple(pv['routing'][0].shape)} equal "
          f"{torch.equal(pv['routing'][0], pv_ref['routing'][0])} (margin "
          f"{pv_ref['routing'][2]:.3e}), launches {launched}")
    by_path["moe: per_vertex_bn step"] = launched
    rows["per_vertex_bn"] = dict(loss_rel=pv_rel, grad_gap=pv_grad,
                                 dropped=pv["routing"][3],
                                 margin=pv_ref["routing"][2])
    print(f"[moe] per_vertex_bn: 6 groups of {batch} tokens, one step with K3 "
          f"vs the plain DSC on the card (exact f32): loss {pv_rel:.3e} "
          f"relative, gradients {pv_grad:.3e} of the largest entry (limit "
          f"{pv_tol:.3e}), routing "
          f"equal (smallest margin {pv_ref['routing'][2]:.3e}), "
          f"{pv['routing'][3]} dropped; K3 18 + 18")

    # 3. times: f32 and bf16 with the MoE, f32 without; graph vs eager
    gen = torch.Generator(device=dev).manual_seed(7)
    inputs = (torch.rand(batch, 20, 20, 4, 6, device=dev, generator=gen),
              torch.rand(batch, 20, 20, 4, 6, device=dev, generator=gen),
              torch.ones(batch, device=dev))
    _reset_launches()
    for label, make, dtype in (
            ("f32", _moe_step_make(), torch.float32),
            ("bf16", _moe_step_make(), torch.bfloat16),
            ("dense f32", _moe_step_make(dense=True), torch.float32)):
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()  # what the runs before hold
        r = _step_numbers(make, inputs, dtype, k=MEGA_K)
        # this model's own peak: weights, Adam's state and an eager step
        r["own_peak_mib"] = r["peak_mib"] - held / 2**20
        check(r["launches_a_step"] == {"dsconv_fwd": 18, "dsconv_bwd": 18}
              and r["graph_launches"] == {"dsconv_fwd": 18 * MEGA_K,
                                          "dsconv_bwd": 18 * MEGA_K},
              f"moe {label}: K3 launches {r['launches_a_step']} a step, "
              f"{r['graph_launches']} a graph")
        r.pop("mods")
        rows[label] = r
    by_path["moe: step times f32, bf16, dense"] = ops.launch_counts()
    moe_busy = rows["f32"]["busy_ms"] - rows["dense f32"]["busy_ms"]
    rows["moe_busy_ms"] = moe_busy
    for label in ("f32", "bf16", "dense f32"):
        r = rows[label]
        print(f"[moe] {card}: {label} b={batch}: {r['eager_ms']:.3f} ms a "
              f"step eager, {r['graph_ms']:.3f} ms as a K={MEGA_K} graph (host "
              f"clock), busy {r['busy_ms']:.4f} ms and "
              f"{r['kernels_a_step']:.1f} kernels a step in a replay, peak "
              f"{r['own_peak_mib']:.1f} MiB of its own in an eager step "
              f"({r['peak_step_mib']:.1f} above its state); K3 18 + 18 a "
              "step")
    print(f"[moe] the MoE's own busy time: {moe_busy:.4f} ms a step "
          f"({100 * moe_busy / rows['f32']['busy_ms']:.1f}% of the f32 step's "
          f"{rows['f32']['busy_ms']:.4f} ms); {card}")
    staged = [tuple(t + 0.01 * i for t in inputs[:2]) + (inputs[2],)
              for i in range(3)]
    programs = [tuple(torch.stack([t] * MEGA_K) for t in p) for p in staged]

    def make_graph():
        mods, _, mega, opts = _moe_step_make()(torch.float32)
        return mega, mods, opts

    _reset_launches()
    rows["graph"] = graph_against_eager("moe final_smaatunet E=8", make_graph,
                                        programs, card,
                                        profile_eager=False)
    by_path["moe: graph against eager, 3 programs"] = \
        rows["graph"]["launched"]

    # 4. the CLI, streaming and --megastep 8 --resident, on a KNMI archive
    # of 4 train files of 96 frames (89 windows each)
    knmi = make_kmni_dataset(os.path.join(tmp, "knmi"), n_train_files=4,
                             frames_per_file=96, hw=20)
    cli = {}
    for mode, extra in (("streaming", ["--max-batches", "4"]),
                        ("resident", ["--megastep", "8", "--resident",
                                      "--max-batches", "16"])):
        _reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as log:
            cli_model, history = gat_cli([
                "train", "--model-type", "unet", "--mapping-type", "linear",
                "--dataset", "kmni", "--preprocessed-folder", knmi,
                "--downsample-size", "20", "20",
                "--epochs", "1", "--moe-experts", str(MOE_E), *extra])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched = ops.launch_counts()
        # 4 steps; 2 programs of K = 8 (--max-batches counts steps; the
        # second program's padded steps launch too)
        steps = 4 if mode == "streaming" else 2 * MEGA_K
        check(_finite(v[0] for v in history.values())
              and next(cli_model.parameters()).is_cuda
              and param_count(cli_model) == MOE_PARAMS
              and launched["dsconv_bwd"] == 18 * steps
              and launched["dsconv_fwd"] > 18 * steps
              and (mode != "resident" or "[resident]" in log.getvalue())
              and not launched["gat_attention_fwd"],
              f"moe CLI {mode}: {history}, launches {launched}:\n"
              f"{log.getvalue()[-1500:]}")
        by_path[f"moe: gat CLI --moe-experts 8 {mode}"] = launched
        cli[mode] = dict(seconds=secs, launches=launched,
                         train_loss=history["train_loss"][0])
    print("[moe] python -m extended_gan_torch.gat train --model-type unet "
          "--moe-experts 8 on a KNMI archive of 4 x 96 frames at 20x20: "
          + "; ".join(f"{m} {c['seconds']:.2f} s, train loss "
                      f"{c['train_loss']:.5f}, K3 "
                      f"{c['launches']['dsconv_fwd']}"
                      f" + {c['launches']['dsconv_bwd']}"
                      for m, c in cli.items()))

    # 5. preempted and resumed, against uninterrupted runs
    _reset_launches()
    t0 = time.perf_counter()
    resume = _moe_resume(tmp, knmi)
    by_path["moe: resume (6 driver runs here)"] = ops.launch_counts()
    v = resume["verdict"]
    fault = resume["fault"]
    print(f"[moe] a child cut by a SIGTERM after step 9 of 12 (snapshot at "
          f"step {resume['snapshot_step']}, {resume['snapshot_bytes']} "
          f"bytes, signal to exit {resume['signal_to_exit_ms']:.1f} ms) and "
          f"resumed here: against the uninterrupted run {v['gap']:.3e} "
          f"(bitwise: {'yes' if v['bitwise'] else 'no'}), {v['worst']:.3f} "
          f"of its bound (run-to-run floor {v['floor']:.3e}, the wider of "
          f"2 twins); a skipped optimizer step at {fault['worst']:.2f} x "
          f"its bound (gap {fault['gap']:.3e}); "
          f"{time.perf_counter() - t0:.1f} s")

    # 6. serving: export f32 and w8 with --check, HTTP at b = 1 and 5
    exp = os.path.join(tmp, "moe_experiment")
    os.makedirs(exp)
    src = os.path.join(REPO, "convolutional_gat", "experiments",
                       "final_smaatunet", "config.py")
    with open(src) as f, open(os.path.join(exp, "config.py"), "w") as g:
        g.write(f.read() + f"\nMOE_EXPERTS = {MOE_E}\n")
    served = {}
    for quant in ("", "w8"):
        _reset_launches()
        path = os.path.join(tmp, f"moe{quant or '_f32'}.pt")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            info = serve_cli(["export", exp, "--init-seed", "0", "--out", path,
                              "--check"]
                             + (["--quantize", quant] if quant else []))
        text = buf.getvalue()
        check("check OK" in text and info["spec"]["moe_experts"] == MOE_E,
              f"moe export {quant or 'f32'}: {text[-600:]}")
        cpu_art = load_exported(path, device="cpu")
        gaps = []

        def per_sample(xs, ys, cpu_fn=cpu_art.fn, gaps=gaps):
            check(ys.shape == xs.shape and bool(np.isfinite(ys).all()),
                  f"moe serve: reply {ys.shape}")
            with torch.no_grad():
                want = np.concatenate([cpu_fn(torch.from_numpy(
                    xs[i:i + 1])).numpy() for i in range(len(xs))])
            scale = max(1.0, float(np.abs(want).max()))
            gaps.append(float(np.abs(ys - want).max()) / scale)
            check(gaps[-1] <= 1e-5, f"moe serve b={len(xs)}: a reply differs "
                  f"from its batch-1 CPU forward by {gaps[-1]:.3e}")
        p50, _ = http_round(path, (1, 5), 3, per_sample)
        launched = ops.launch_counts()
        check(launched["dsconv_fwd"] > 0 and not launched["dsconv_bwd"],
              f"moe serve {quant or 'f32'}: launches {launched}")
        by_path[f"moe: export --check and serve {quant or 'f32'}"] = launched
        served[quant or "f32"] = dict(p50=p50, gap=max(gaps),
                                      nbytes=info["nbytes"])
    print("[moe] serve export of final_smaatunet + MOE_EXPERTS = 8 "
          "(--init-seed 0, --check on the card), HTTP replies at b = 1 and 5 "
          "against batch-1 forwards on the CPU: "
          + "; ".join(f"{q} {s['nbytes']} bytes, p50 "
                      + ", ".join(f"b={b} {ms:.2f} ms" for b, ms in
                                  s["p50"].items())
                      + f", worst {s['gap']:.3e} of the largest entry"
                      for q, s in served.items()) + f"; {card}")
    secs = time.perf_counter() - t_phase
    print(f"[moe] the phase took {secs:.1f} s")
    return dict(launches=by_path, rows=rows, cli=cli, resume=resume,
                served=served, secs=secs)


def _arai_archive(root, regions=5, hw=40):
    """A synthetic MAI archive: ``root/R<r>/{training,validation}/<day>/
    CRR/<stamp>.nc``, one float32 .npy frame a 15-minute slot, with a gap
    and a run across midnight."""
    import numpy as np

    from extended_gan_torch.preprocess.arai import get_time_range

    grid = get_time_range()
    days = {"training": {"1": range(40, 96), "2": range(0, 30)},
            "validation": {"5": range(10, 40)}}
    rng = np.random.default_rng(4)
    for r in range(1, regions + 1):
        for cond, by_day in days.items():
            for day, slots in by_day.items():
                d = os.path.join(root, f"R{r}", cond, day, "CRR")
                os.makedirs(d)
                for s in slots:
                    name = f"S_NWC_CRR_2021{int(day):04d}T{grid[s]:04d}00Z.nc"
                    with open(os.path.join(d, name), "wb") as f:
                        np.save(f, rng.random((1, hw, hw), np.float32))


def phase_preprocess(tmp):
    """The preprocessing tools' outputs feeding the card's trainers:

    - a synthetic ARAI archive (5 regions, 40x40 frames, 86 + 30 slots)
      through ``preprocess.arai.preprocess`` with a numpy reader, then
      ``python -m extended_gan_torch.gat train --dataset arai`` of
      final_temp_conv's model (K1 2 + 2 a step) for 3 batches at 32x32;
    - a coastal-sea ``thetao`` dump (``.npy``) through
      ``preprocess.coastal_sea.preprocess`` into train and test archives,
      then ``python -m extended_gan_torch.cycle_gan`` on them for 3
      batches.

    KNMI's tool reads HDF5, and this machine has no h5py: it is held
    against the JAX package's on the CPU only
    (``tests/test_torch_port_preprocess.py``)."""
    import numpy as np
    import torch

    from extended_gan_torch import ops
    from extended_gan_torch.cycle_gan.__main__ import main as cyclegan_cli
    from extended_gan_torch.gat.__main__ import main as gat_cli
    from extended_gan_torch.preprocess import arai, coastal_sea

    t_phase = time.perf_counter()
    by_path = {}
    src, out = os.path.join(tmp, "mai"), os.path.join(tmp, "arai")
    _arai_archive(src)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        meta = arai.preprocess(False, src, out, (("CRR", "crr"),),
                               reader=lambda p, v: np.load(p))
    arai_s = time.perf_counter() - t0
    check(meta == {"n_regions": 5, "training": {"length": 86},
                   "validation": {"length": 30}}, f"arai metadata {meta}")
    _reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as log:
        model, history = gat_cli([
            "train", "--model-type", "temporal", "--mapping-type", "conv",
            "--dataset", "arai", "--preprocessed-folder", out,
            "--downsample-size", "32", "32", "--train-batch-size", "16",
            "--test-batch-size", "16", "--epochs", "1", "--max-batches",
            "3"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    k1 = ops.launch_counts()
    check(_finite(v[0] for v in history.values())
          and next(model.parameters()).is_cuda
          and k1["gat_attention_bwd"] == 2 * 3,
          f"preprocess: arai training {history}, launches {k1}:\n"
          f"{log.getvalue()[-1500:]}")
    by_path["preprocess: arai archive -> gat CLI --dataset arai"] = k1

    rng = np.random.default_rng(5)
    data = os.path.join(tmp, "coastal")
    shapes = {}
    t0 = time.perf_counter()
    for sub, frames in (("train", 48), ("test", 24)):
        dump = os.path.join(tmp, f"thetao_{sub}.npy")
        np.save(dump, (rng.standard_normal((frames, 3, 104, 90)) + 12)
                .astype(np.float32))
        os.makedirs(os.path.join(data, sub))
        arr = coastal_sea.preprocess(
            [dump],
            os.path.join(data, sub, "coastal_sea_data_preprocessed.pt"))
        shapes[sub] = arr.shape
    coastal_s = time.perf_counter() - t0
    check(shapes == {"train": (48, 1, 84, 65), "test": (24, 1, 84, 65)},
          f"coastal shapes {shapes}")
    _reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as log:
        nets, cg_hist = cyclegan_cli(["--data-location", data, "--epochs",
                                      "1", "--max-batches", "3"])
    torch.cuda.synchronize()
    cg_s = time.perf_counter() - t0
    launched = ops.launch_counts()
    check(_finite(v[0] for v in cg_hist.history.values())
          and "synthetic" not in log.getvalue()
          and not any(launched.values()),
          f"preprocess: cyclegan on the coastal archive {cg_hist.history}, "
          f"launches {launched}:\n{log.getvalue()[-1500:]}")
    by_path["preprocess: coastal archive -> cycle_gan CLI"] = launched
    secs = time.perf_counter() - t_phase
    print(f"[preprocess] arai.preprocess of 5 regions x 116 slots of 40x40: "
          f"{arai_s:.2f} s, metadata {meta}; python -m extended_gan_torch.gat "
          f"train --dataset arai (final_temp_conv's model, 32x32, 3 batches "
          f"of 16): {train_s:.2f} s, train loss {history['train_loss'][0]:.5f}"
          f", K1 {k1['gat_attention_fwd']} + {k1['gat_attention_bwd']}; "
          f"coastal_sea.preprocess of two .npy "
          f"dumps: {coastal_s:.2f} s, {shapes}; python -m "
          f"extended_gan_torch.cycle_gan on them, 3 batches: {cg_s:.2f} s, "
          f"finite; the KNMI tool needs h5py, absent on this machine: held "
          f"on the CPU only (tests/test_torch_port_preprocess.py); the phase "
          f"took {secs:.1f} s")
    return dict(launches=by_path, secs=secs)


PROFILE_KEYS = ("epoch_wall_s", "profiled_steps", "steps_per_sec",
                "dispatch_mean_s", "dispatch_p90_s")


def _trace_device(trace_dir, detail=None):
    """The one Chrome trace in ``trace_dir``: (records of each of the port's
    kernels, kernel records, device busy ms: the union of every kernel,
    copy and set on the card). ``detail``, a dict, gets each of the port's
    kernels' record start times (ms from the first device record) and the
    runtime's launch calls by name, for a failure's message."""
    paths = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir)
             if f.endswith(".json")]
    check(len(paths) == 1, f"{trace_dir}: {len(paths)} trace files, not 1")
    with open(paths[0]) as f:
        events = json.load(f)["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    kernels = [e["name"] for e in dev if e["cat"] == "kernel"]
    counts = {k: sum(any(re.search(rf"\b{n}[<(]", name) for n in names)
                     for name in kernels)
              for k, names in KERNEL_NAMES.items()}
    if detail is not None and dev:
        t0 = min(float(e["ts"]) for e in dev)
        for k, names in KERNEL_NAMES.items():
            detail[k] = [round((float(e["ts"]) - t0) / 1e3, 3) for e in dev
                         if e["cat"] == "kernel" and any(
                             re.search(rf"\b{n}[<(]", e["name"])
                             for n in names)]
        launches = [e["name"] for e in events
                    if e.get("cat") == "cuda_runtime"
                    and "Launch" in e.get("name", "")]
        detail["runtime launches"] = {n: launches.count(n)
                                      for n in sorted(set(launches))}
    busy, end = 0.0, -math.inf
    for s, t in sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                       for e in dev):
        if t > end:
            busy += t - max(s, end)
            end = t
    return counts, len(kernels), busy / 1e3


def _experiment_dir(tmp, label, knmi, shuffle_mode):
    """final_temp_conv's experiment config, reading ``knmi`` with
    ``shuffle_mode``: later assignments take the place of earlier ones."""
    exp = os.path.join(tmp, f"exp_{label}")
    os.makedirs(exp)
    with open(os.path.join(REPO, "convolutional_gat", "experiments",
                           "final_temp_conv", "config.py")) as f:
        text = f.read()
    with open(os.path.join(exp, "config.py"), "w") as f:
        f.write(text + f"\nPREPROCESSED_FOLDER = {knmi!r}\n"
                       f"SHUFFLE_MODE = {shuffle_mode!r}\n")
    return exp


def _host_epoch(tmp, knmi, label, *, shuffle_mode, use_native, max_batches):
    """``python -m extended_gan_torch.gat generate_experiment`` of
    final_temp_conv on ``knmi`` with ``--profile --profile-trace-dir``, one
    epoch of ``max_batches`` steps, the launch counters set to 0 just
    before: its history, the counters at the traced epoch's end and after
    the run, what the trace holds, and the native core's calls.
    ``use_native=False`` puts the KNMI loaders on their numpy path."""
    import torch

    from extended_gan_torch import ops
    from extended_gan_torch.data import native, streaming
    from extended_gan_torch.gat.__main__ import main as gat_cli
    from extended_gan_torch.utils.profiling import EpochProfiler

    exp = _experiment_dir(tmp, label, knmi, shuffle_mode)
    out = os.path.join(tmp, f"out_{label}")
    trace_dir = os.path.join(tmp, f"trace_{label}")
    at_end = {}
    real_end = EpochProfiler.end_epoch

    def end_epoch(self):
        at_end.update(ops.launch_counts())  # the traced span's launches
        return real_end(self)
    defaults = streaming.KmniLoader.__init__.__kwdefaults__
    native_default = defaults["use_native"]
    EpochProfiler.end_epoch = end_epoch
    defaults["use_native"] = use_native
    text = io.StringIO()
    try:
        _reset_launches()  # the main path starts here
        native.reset_call_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            model, history = gat_cli([
                "generate_experiment", "--exp_folder_name", exp,
                "--output-path", out, "--epochs", "1", "--max-batches",
                str(max_batches), "--profile", "--profile-trace-dir",
                trace_dir])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = ops.launch_counts()
        calls = native.call_counts()
    finally:
        EpochProfiler.end_epoch = real_end
        defaults["use_native"] = native_default
    with open(os.path.join(out, "history.json")) as f:
        saved = json.load(f)
    check(all(len(history.get(k, [])) == 1 and saved.get(k) == history[k]
              for k in PROFILE_KEYS),
          f"{label}: history {sorted(history)} lacks the profiling keys "
          f"{PROFILE_KEYS} (history.json: {sorted(saved)})")
    check(history["profiled_steps"] == [float(max_batches)],
          f"{label}: {history['profiled_steps']} profiled steps, expected "
          f"{max_batches}")
    check(_finite(history["train_loss"]) and _finite(history["val_loss"])
          and all(bool(p.isfinite().all()) for p in model.parameters()),
          f"{label}: history {history}")
    check(f"SHUFFLE_MODE\": \"{shuffle_mode}\"" in text.getvalue(),
          f"{label}: the run did not use SHUFFLE_MODE {shuffle_mode}")
    check(at_end["gat_attention_fwd"] == at_end["gat_attention_bwd"]
          == 2 * max_batches and not any(
              launches[k] for k in ("dsconv_fwd", "dsconv_bwd",
                                    "gat_mapping_fwd", "gat_mapping_bwd")),
          f"{label}: launches {at_end} at the epoch's end, {launches} after "
          f"the run; expected K1 2 + 2 a step, K2 and K3 none")
    used = calls["kmni_make_batch"]
    check((used > 0) == (use_native or shuffle_mode == "global"),
          f"{label}: the native core ran {calls} (use_native {use_native})")
    detail = {}
    recorded, n_kernels, busy_ms = _trace_device(trace_dir, detail)
    for k in ("gat_attention_fwd", "gat_attention_bwd"):
        check(recorded[k] == at_end[k],
              f"{label}: the trace holds {recorded[k]} {k} records, the "
              f"launch counter {at_end[k]}; the records at (ms) "
              f"{detail.get(k)}; the runtime's launch calls "
              f"{detail.get('runtime launches')}")
    wall_ms = history["epoch_wall_s"][0] * 1e3
    row = dict(secs=secs, wall_ms=wall_ms, busy_ms=busy_ms,
               kernels=n_kernels, recorded=recorded, launches=launches,
               native_calls=used,
               prof={k: history[k][0] for k in PROFILE_KEYS})
    print(f"[host_data] {label}: generate_experiment final_temp_conv, "
          f"SHUFFLE_MODE {shuffle_mode}, "
          f"{'native' if use_native or shuffle_mode == 'global' else 'numpy'}"
          f" batches, {max_batches} steps --profile: epoch wall "
          f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%, idle "
          f"{100 * (1 - busy_ms / wall_ms):.1f}%), {n_kernels} kernels "
          f"traced, K1 {recorded['gat_attention_fwd']} + "
          f"{recorded['gat_attention_bwd']} records = the counters; "
          f"dispatch mean {history['dispatch_mean_s'][0] * 1e3:.3f} ms, p90 "
          f"{history['dispatch_p90_s'][0] * 1e3:.3f} ms, "
          f"{history['steps_per_sec'][0]} steps/s; native core calls {used};"
          f" {secs:.2f} s with start-up")
    return row


def _loader_epoch(make, label, nbytes_label=""):
    """One whole epoch of the loader ``make()`` builds, timed from its
    construction: batches, seconds, batches a second, MB a second."""
    t0 = time.perf_counter()
    loader = make()
    n = nbytes = 0
    for x, y in loader:
        n += 1
        nbytes += x.nbytes + y.nbytes
    secs = time.perf_counter() - t0
    row = dict(batches=n, s=secs, batches_per_s=n / secs,
               mb_per_s=nbytes / secs / 1e6,
               n_decodes=getattr(loader, "n_decodes", None),
               files=len(loader.files))
    print(f"[host_data] loader {label}: {n} batches of {nbytes / n / 1e6:.3f}"
          f" MB (x and y) in {secs:.3f} s: {row['batches_per_s']:.2f} "
          f"batches/s, {row['mb_per_s']:.1f} MB/s"
          + (f", {row['n_decodes']} decodes of {row['files']} files"
             if row["n_decodes"] is not None else ""))
    return row


def _chanfirst_ab(batch, hw):
    """final_temp_conv at ``batch``: forward and train-step ms of the
    chanfirst mapping, the cuDNN mapping exact and TF32 and the switched K2
    mapping, from the same weights; chanfirst's forward and gradients
    against the exact-f32 cuDNN mapping's."""
    import numpy as np
    import torch

    from extended_gan_torch.models.gat.gat3d import Model

    def make(**kw):
        return Model(hw, hw, 6, "temporal", "conv", use_pallas=True,
                     generator=torch.Generator().manual_seed(0),
                     **kw).cuda().eval()
    models = {"chanfirst": make(conv_impl="chanfirst"), "cudnn": make(),
              "k2": make(use_pallas_mapping=True)}
    for m in models.values():
        m.load_state_dict(models["cudnn"].state_dict())
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.random((batch, hw, hw, 4, 6), np.float32)).cuda()

    def grads(model):
        model.zero_grad()
        y = model(x)
        ((y - 0.5) ** 2).mean().backward()
        return y.detach(), {n: p.grad.detach().clone()
                            for n, p in model.named_parameters()}
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y_c, g_c = grads(models["chanfirst"])
        y_n, g_n = grads(models["cudnn"])
    fwd_gap = float((y_c - y_n).abs().max() / y_n.abs().max())
    scale = max(float(g.abs().max()) for g in g_n.values())
    grad_gap = max(float((g_c[n] - g_n[n]).abs().max()) for n in g_n) / scale
    check(fwd_gap <= CHANFIRST_FWD_TOL and grad_gap <= CHANFIRST_GRAD_TOL,
          f"chanfirst against the exact-f32 cuDNN mapping: forward "
          f"{fwd_gap:.3e} of the largest output (limit {CHANFIRST_FWD_TOL}),"
          f" gradients {grad_gap:.3e} of the largest gradient entry (limit "
          f"{CHANFIRST_GRAD_TOL})")
    rows = {}
    for name, model, tf32 in (("chanfirst", models["chanfirst"], False),
                              ("cuDNN exact f32", models["cudnn"], False),
                              ("cuDNN TF32", models["cudnn"], True),
                              ("K2 (use_pallas_mapping=True)", models["k2"],
                               False)):
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=tf32), \
                torch.no_grad():
            fwd = time_ms(lambda m=model: m(x), groups=6, warmup=1,
                          per_group=3)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=tf32):
            step = adam_step_ms(model, batch, n=6)
        rows[name] = dict(forward_ms=fwd, step_ms=step)
    peak = torch.cuda.max_memory_allocated() / 2**20
    print(f"[host_data] conv_impl A/B, final_temp_conv b={batch}: "
          + "; ".join(f"{k} forward {r['forward_ms']:.4f} ms, train step "
                      f"{r['step_ms']:.3f} ms" for k, r in rows.items())
          + f"; chanfirst against exact cuDNN: forward {fwd_gap:.3e}, "
          f"gradients {grad_gap:.3e} (limits {CHANFIRST_FWD_TOL}, "
          f"{CHANFIRST_GRAD_TOL}); process peak {peak:.1f} MiB")
    return dict(rows=rows, fwd_gap=fwd_gap, grad_gap=grad_gap)


def _gan_profile_runs(tmp):
    """The DCGAN and CycleGAN CLIs with ``--profile --profile-trace-dir``
    for 4 batches streaming, and as ``--megastep 2`` (whose first epoch
    captures its graph while the profiler records): the keys in the epoch's
    results (the dispatch times where more than the profiler's 2 warm-up
    dispatches ran: the CycleGAN's synthetic archive holds 4 batches, 2
    groups), the trace written and, under ``--megastep``, a graph
    captured. Returns their launch counters."""
    import torch

    from extended_gan_torch import ops
    from extended_gan_torch.cycle_gan.__main__ import main as cyclegan_cli
    from extended_gan_torch.dcgan.__main__ import main as dcgan_cli

    launches = {}
    for name, cli in (("dcgan", dcgan_cli), ("cycle_gan", cyclegan_cli)):
        for extra in (["--max-batches", "4"],
                      ["--max-batches", "8", "--megastep", "2"]):
            label = f"{name} {' '.join(extra)}"
            trace_dir = os.path.join(tmp, f"trace_{name}_{len(extra)}")
            _reset_launches()
            t0 = time.perf_counter()
            with _megastep_watch() as captured, \
                    contextlib.redirect_stdout(io.StringIO()):
                _, hist = cli(["--synthetic", "--epochs", "1", "--profile",
                               "--profile-trace-dir", trace_dir, *extra])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            h = hist.history
            want = PROFILE_KEYS if h.get("profiled_steps") != [2.0] \
                else PROFILE_KEYS[:3]
            check(all(len(h.get(k, [])) == 1 for k in want),
                  f"{label} --profile: results {sorted(h)} lack "
                  f"{PROFILE_KEYS}")
            check(bool(captured) == ("--megastep" in extra),
                  f"{label}: graphs captured {captured}")
            _, n_kernels, busy_ms = _trace_device(trace_dir)
            check(n_kernels > 0, f"{label}: the trace holds no kernel")
            launches[label] = {k: n for k, n in ops.launch_counts().items()
                               if n}
            wall = h["epoch_wall_s"][0] * 1e3
            print(f"[host_data] python -m extended_gan_torch.{name} "
                  f"{' '.join(extra)} --profile --profile-trace-dir: "
                  f"profiled steps {h['profiled_steps'][0]:.0f}, "
                  f"epoch wall {wall:.3f} ms, dispatch mean "
                  f"{h.get('dispatch_mean_s', [math.nan])[0] * 1e3:.3f} ms, "
                  f"trace "
                  f"{n_kernels} kernels, busy {busy_ms:.3f} ms"
                  + (f", graphs captured under the profiler {len(captured)}"
                     if captured else "") + f"; {secs:.2f} s")
    check(not any(launches.values()),
          f"the DCGAN and CycleGAN paths launched the port's kernels: "
          f"{launches}")
    return launches


def phase_host_data(tmp, batch=32, hw=80, max_batches=12):
    """The KNMI host pipeline and the drivers' profiling (slice 16):

    - a synthetic KNMI archive at the published geometry (20 train files
      of 96 frames of 80x80x6, 2 test files); the loaders' rates at b=32,
      in this process, over a whole epoch: the numpy path, the C++ core,
      the global shuffle with shuffle_pool 4 (each file decoded once) and
      0; the native batches against the numpy path's (HOST_RTOL,
      HOST_ATOL);
    - ``python -m extended_gan_torch.gat generate_experiment`` of
      final_temp_conv's config with SHUFFLE_MODE "global", ``--profile
      --profile-trace-dir``, one epoch of ``max_batches`` steps: the five
      profiling keys in history.json, K1's records in the trace equal to
      its launch counters at the traced epoch's end; the same epoch with
      the numpy and the native batch loader, SHUFFLE_MODE batch: device
      busy against wall for each;
    - conv_impl: chanfirst against cuDNN (exact, TF32) and K2 at b=32;
    - the DCGAN and CycleGAN CLIs with ``--profile --profile-trace-dir``.
    """
    import numpy as np
    import torch

    from extended_gan_torch.data import native, streaming
    from extended_gan_torch.data.synthetic import make_kmni_dataset

    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    knmi = make_kmni_dataset(os.path.join(tmp, "knmi"), n_train_files=20,
                             n_test_files=2, frames_per_file=96, hw=hw)
    train = os.path.join(knmi, "train")
    check(native._lib is not None or native.library_path().exists(),
          "the host batch core was not built")
    native.reset_call_counts()
    kw = dict(crop=hw, seed=369)
    loaders = {
        "numpy (use_native=False)": lambda: streaming.KmniLoader(
            batch, train, use_native=False, **kw),
        "native": lambda: streaming.KmniLoader(batch, train, **kw),
        "global, shuffle_pool 4": lambda: streaming.KmniLoader(
            batch, train, shuffle_mode="global", **kw),
        "global, shuffle_pool 0": lambda: streaming.KmniLoader(
            batch, train, shuffle_mode="global", shuffle_pool=0, **kw)}
    rates = {label: _loader_epoch(make, label)
             for label, make in loaders.items()}
    pooled = rates["global, shuffle_pool 4"]
    check(pooled["n_decodes"] == pooled["files"] == 20,
          f"global shuffle, pool 4: {pooled['n_decodes']} decodes of "
          f"{pooled['files']} files")
    check(native._lib is not None and native.call_counts()[
        "kmni_make_batch"] > 0, f"the native core was not loaded or not "
          f"called: {native.call_counts()}")
    worst, n = 0.0, 0
    for (xn, yn), (xp, yp) in zip(loaders["native"](),
                                  loaders["numpy (use_native=False)"](),
                                  strict=True):
        for a, b in ((xn, xp), (yn, yp)):
            check(a.shape == b.shape and np.all(
                np.abs(a - b) <= HOST_ATOL + HOST_RTOL * np.abs(b)),
                f"native batch {n} against numpy: max gap "
                f"{np.abs(a - b).max():.3e}")
            worst = max(worst, float(np.abs(a - b).max()))
        n += 1
    print(f"[host_data] native against numpy batches, the whole epoch ({n} "
          f"batches): max gap {worst:.3e} (limit {HOST_ATOL} + {HOST_RTOL} "
          f"relative)")
    # a short epoch first, so the measured ones start warm (cuDNN's plans,
    # the kernels' modules), as a run's later epochs do
    from extended_gan_torch.gat.__main__ import main as gat_cli

    with contextlib.redirect_stdout(io.StringIO()):
        gat_cli(["generate_experiment", "--exp_folder_name",
                 _experiment_dir(tmp, "warm_up", knmi, "batch"), "--epochs",
                 "1", "--max-batches", "2"])
    epochs = {label: _host_epoch(tmp, knmi, label, shuffle_mode=mode,
                                 use_native=nat, max_batches=max_batches)
              for label, mode, nat in (("global", "global", True),
                                       ("numpy loader", "batch", False),
                                       ("native loader", "batch", True))}
    ab = _chanfirst_ab(batch, hw)
    gan = _gan_profile_runs(tmp)
    secs = time.perf_counter() - t_phase
    print(f"[host_data] phase: {secs:.1f} s; {card_line()}")
    return dict(rates=rates, epochs=epochs, chanfirst=ab, gan=gan, secs=secs,
                launches={
                    f"host_data: generate_experiment final_temp_conv "
                    f"SHUFFLE_MODE {e_mode} --profile, {e_label} (CLI)":
                    epochs[e_label]["launches"]
                    for e_label, e_mode in (("global", "global"),
                                            ("numpy loader", "batch"),
                                            ("native loader", "batch"))})


def host_data_child(tmp):
    """``phase_host_data`` in a process of its own (this script with
    ``--host-data-child``): its first profiler session there, the process's
    CUDA context and the profiler's state fresh, where late in a long
    process the profiler has dropped kernel records (``PERF.md`` §7). The
    result, the launch counts among it, goes back as a JSON line."""
    try:
        result = phase_host_data(tmp)
    except SmokeFailure as e:
        print(f"[host_data] FAIL: {e}", flush=True)
        return 1
    print("[host_data] result " + json.dumps(result), flush=True)
    return 0


def run_host_data(tmp, timeout=600):
    """:func:`host_data_child` in a child process, its output passed on;
    fails unless it exits 0 with its result."""
    proc = subprocess.Popen(
        [sys.executable, "-u", os.path.abspath(__file__), "--host-data-child",
         tmp], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    result, tail = None, []
    try:
        for line in proc.stdout:
            if line.startswith("[host_data] result "):
                result = json.loads(line.split(" ", 2)[2])
                continue
            print(line, end="", flush=True)
            tail = (tail + [line])[-40:]
        rc = proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    check(rc == 0 and result is not None,
          f"the host_data phase's process exited {rc}:\n{''.join(tail)}")
    return result


# the figures phase: compare_models' metrics with K1 and K3 against the same
# checkpoints through the plain versions (only the summation order differs,
# and a thresholded precision or recall can move by one element), each
# within this share of the plain value (or 1e-7); the figures' panels
# computed on the card within this share of each panel's largest entry
FIG_METRIC_RTOL = 1e-4
FIG_PANEL_TOL = 1e-5
FIG_EXPERIMENTS = ("final_smaatunet", "final_temp_conv")
FIG_PARAMS = {"final_smaatunet": 4_032_548, "final_temp_conv": 43_936}


def _not_drawn(text):
    """The paths of the ``[viz] ... not drawn`` lines of ``text``."""
    prefix = "[viz] matplotlib is not installed: "
    return [ln[len(prefix):-len(" not drawn")] for ln in text.splitlines()
            if ln.startswith(prefix) and ln.endswith(" not drawn")]


def _model_forwards(classes):
    """A forward hook counting the forwards of each class in ``classes``:
    (the counts by class, the hook's handle)."""
    import torch

    counts = dict.fromkeys(classes, 0)

    def count(module, args, output):
        if type(module) in counts:
            counts[type(module)] += 1

    return counts, torch.nn.modules.module.register_module_forward_hook(count)


def phase_figures(tmp):
    """Figures, plots and ``compare_models`` on the card (no matplotlib on
    its machine): final_smaatunet and final_temp_conv trained for an epoch
    of 2 steps through ``python -m extended_gan_torch.gat
    generate_experiment`` (each run's ``pred_1.png`` and
    ``history_1.png`` not drawn, one line each), their ``config.py`` and
    ``model.pt`` as experiment directories; ``python -m
    extended_gan_torch.compare_models`` over both (synthetic fallback,
    20x20): ``results.json`` with 4,032,548 and 43,936 parameters, finite
    metrics equal to the same checkpoints' through the plain versions
    (FIG_METRIC_RTOL), K3 18 and K1 2 launches a forward of their model
    (eval passes and figure panels), ``results.html``, and
    ``multi_model_plot.png`` and ``pred_0.png`` not drawn; the panels
    computed on the card against the plain path's (FIG_PANEL_TOL);
    ``create_plots``; the DCGAN and CycleGAN CLIs for a batch with
    ``--out-dir``: one line a figure the JAX package draws, nothing else
    written."""
    import numpy as np
    import torch

    from extended_gan_torch import ops
    from extended_gan_torch.compare_models import __main__ as compare
    from extended_gan_torch.create_plots import create_comparison_plot
    from extended_gan_torch.cycle_gan.__main__ import main as cyclegan_cli
    from extended_gan_torch.dcgan.__main__ import main as dcgan_cli
    from extended_gan_torch.gat.__main__ import main as gat_cli
    from extended_gan_torch.models.gat.gat3d import Model as GatModel
    from extended_gan_torch.models.unet_model import UnetModel
    from extended_gan_torch.train.gat_trainer import (
        make_gat_eval_step,
        predict_batch,
        test,
    )
    from extended_gan_torch.utils.viz import gat_prediction_panels

    t_phase = time.perf_counter()
    card = card_line()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    base = os.path.join(tmp, "experiments")
    launches = {}

    # 1. the conv-GAT CLI: its two figures an epoch
    for name in FIG_EXPERIMENTS:
        run = os.path.join(tmp, "runs", name)
        text = io.StringIO()
        _reset_launches()
        with contextlib.redirect_stdout(text):
            gat_cli(["generate_experiment", "--exp_folder_name", name,
                     "--output-path", run, "--epochs", "1", "--max-batches",
                     "2"])
        launches[f"figures: train {name} (2 steps, eval, figure)"] = \
            ops.launch_counts()
        out = text.getvalue()
        missed = _not_drawn(out)
        want = [os.path.join(run, "history_1.png")]
        if "Raininess threshold too strict" not in out:
            want.insert(0, os.path.join(run, "pred_1.png"))
        check(missed == want and sorted(os.listdir(run)) == [
            "history.json", "model.pt"],
            f"figures: {name} CLI printed {missed} not drawn (expected "
            f"{want}) and wrote {sorted(os.listdir(run))}")
        exp = os.path.join(base, name)
        os.makedirs(exp)
        shutil.copy(os.path.join(REPO, "convolutional_gat", "experiments",
                                 name, "config.py"), exp)
        shutil.copy(os.path.join(run, "model.pt"), exp)

    # 2. compare_models: the main path starts here
    out_path = os.path.join(tmp, "compare")
    forwards, hook = _model_forwards((UnetModel, GatModel))
    text = io.StringIO()
    _reset_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(text):
            entries = compare.main(["--base-folder", base, "--folders",
                                    *FIG_EXPERIMENTS, "--out-path", out_path])
        torch.cuda.synchronize()
    finally:
        hook.remove()
    cmp_s = time.perf_counter() - t0
    got = ops.launch_counts()
    launches["figures: compare_models"] = got
    forwards = {"GAT3D": forwards[GatModel], "UnetModel": forwards[UnetModel]}
    expected = {"gat_attention_fwd": 2 * forwards["GAT3D"],
                "dsconv_fwd": 18 * forwards["UnetModel"]}
    check({n: c for n, c in got.items() if c} == expected
          and all(forwards.values()),
          f"compare_models: launches {got} for {forwards} forwards; "
          f"expected {expected}")
    with open(os.path.join(out_path, "results.json")) as f:
        results = json.load(f)
    check(list(results) == list(FIG_EXPERIMENTS)
          and {n: r["n_parameters"] for n, r in results.items()}
          == FIG_PARAMS
          and all(_finite(r.values()) for r in results.values()),
          f"compare_models: results.json {results}")
    drawn = {os.path.basename(p) for p in _not_drawn(text.getvalue())}
    written = sorted(os.listdir(out_path))
    check(written == ["results.html", "results.json"],
          f"compare_models wrote {written}")

    # 3. the same checkpoints through the plain versions
    shape = dict(image_width=20, image_height=20, n_vertices=6, time_steps=4,
                 device=dev)
    plain = {}
    for name in FIG_EXPERIMENTS:
        m = compare.load_experiment_model(os.path.join(base, name), **shape)
        for mod in m.modules():  # the kernels' switches off
            if hasattr(mod, "use_pallas"):
                mod.use_pallas = False
        plain[name] = m

    def loader(batch):
        return compare.loaders("", "synthetic", (20, 20), 369, batch)[1]

    metric_gap = 0.0
    for name, model in plain.items():
        want = test(make_gat_eval_step(model), loader(100), dev)
        for k, v in want.items():
            got_v = results[name][k]
            gap = abs(got_v - v) / max(abs(v), 1e-7 / FIG_METRIC_RTOL)
            metric_gap = max(metric_gap, gap)
            check(gap <= FIG_METRIC_RTOL,
                  f"compare_models {name} {k}: {got_v} with the kernels, "
                  f"{v} plain")
    # the panels each figure shows, kernels against plain
    panel_gap = 0.0
    figs = {"multi_model_plot.png": [
        compare.multi_model_panels(loader(2), src, dev)
        for src in (entries, plain)]}
    figs["pred_0.png"] = [gat_prediction_panels(
        lambda xb, m=m: predict_batch(m, xb, dev), loader(2))
        for m in (entries["final_smaatunet"], plain["final_smaatunet"])]
    for fig, (a, b) in figs.items():
        check((a is None) == (b is None)
              and (fig in drawn) == (a is not None),
              f"figures: {fig} panels found {a is not None} with the "
              f"kernels, {b is not None} plain; printed not drawn: {drawn}")
        for pa, pb in zip(a or [], b or []):
            gap = float(np.abs(pa - pb).max() / max(np.abs(pb).max(), 1e-30))
            panel_gap = max(panel_gap, gap)
            check(gap <= FIG_PANEL_TOL, f"figures: {fig} panel {gap:.3e} "
                                        "of its largest entry off plain")

    # 4. create_plots
    text = io.StringIO()
    _reset_launches()
    with contextlib.redirect_stdout(text):
        cp = create_comparison_plot(
            [os.path.join(base, n) for n in FIG_EXPERIMENTS],
            out_file=os.path.join(tmp, "comparison_plot.png"))
    launches["figures: create_plots"] = ops.launch_counts()
    check(cp is None and not os.path.exists(os.path.join(
        tmp, "comparison_plot.png")) and _not_drawn(text.getvalue()) == (
        [os.path.join(tmp, "comparison_plot.png")]
        if figs["multi_model_plot.png"][0] is not None else []),
        f"create_plots: returned {cp}, printed {text.getvalue()[-600:]}")

    # 5. the GAN CLIs: their figures not drawn, nothing else written
    gans = {}
    for name, cli, argv in (
            ("dcgan", dcgan_cli, ["--epochs", "1", "--max-batches", "1",
                                  "--synthetic", "--save-epoch", "1"]),
            ("cyclegan", cyclegan_cli, ["--epochs", "1", "--max-batches",
                                        "1", "--synthetic", "--save-epoch",
                                        "1"])):
        out = os.path.join(tmp, name)
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            _, hist = cli(argv + ["--out-dir", out])
        plots = [os.path.join(out, "training_plots",
                              (hist.groups[i] or "metrics") + ".png")
                 for i, g in enumerate(hist.key_groups()) if g]
        want = [os.path.join(out, "imgs", "pred.png")] + plots
        gans[name] = _not_drawn(text.getvalue())
        check(gans[name] == want and sorted(os.listdir(out)) == [
            "checkpoints", "history.json"],
            f"figures: {name} CLI printed {gans[name]} not drawn (expected "
            f"{want}) and wrote {sorted(os.listdir(out))}")
    seconds = time.perf_counter() - t_phase
    print(f"[figures] compare_models over {', '.join(FIG_EXPERIMENTS)} "
          f"(20x20, synthetic): {results}; launches {expected} for forwards "
          f"{forwards}; metrics against the plain versions within "
          f"{metric_gap:.3e} (limit {FIG_METRIC_RTOL:.0e} relative); panels "
          f"within {panel_gap:.3e} of their largest entry (limit "
          f"{FIG_PANEL_TOL:.0e}); not drawn: {sorted(drawn)}, the CLIs' "
          f"{[os.path.basename(p) for g in gans.values() for p in g]}; "
          f"compare_models {cmp_s:.2f} s; phase {seconds:.1f} s; {card}")
    return dict(launches=launches, seconds=seconds, results=results,
                metric_gap=metric_gap, panel_gap=panel_gap,
                compare_s=cmp_s)


# the data_parallel phase: 3 Adam steps, 2 ranks of 16 rows against one
# process of 32; the model's batches from this seed
DP_STEPS = 3
DP_SEED = 11
DP_MODELS = {"final_smaatunet": ("unet", "linear", 20),
             "final_temp_conv": ("temporal", "conv", 80)}


def _dp_run(name, device, axis=None, *, fault=False, permute=False,
            float64=False, moe=0, ep_fault=None, perturb=False, fsdp=None,
            tp=None, tp_fault=False, grads=False):
    """DP_STEPS Adam steps of ``name``'s model from seed 0 on DP_STEPS
    global batches of 32 (this rank's rows on ``axis``; ``permute``: each
    batch's rows in another order; ``fault``: each rank's BatchNorm with
    its own rows' statistics; ``float64``: the plain versions in float64),
    cuDNN exact and deterministic: (the state on the CPU, ``{"weights":
    the parameters and Adam's moments after the last step, "statistics":
    the buffers after it and the losses as one more tensor, "first step":
    the buffers and the loss after the first step}``; the kernels launched
    by each step; the ms of each step and of its collectives, host clock,
    synchronised). ``moe`` E > 0: the model with its Switch-MoE bottleneck
    of E experts (aux weight MOE_AUX_W), its experts sharded over
    ``axis`` (``parallel/expert.py``), the weights holding all E, and
    the clock's ``loads`` each step's tokens kept by each expert
    (``perturb``: each batch under 1e-7 relative noise, a roundoff twin
    that keeps the rows' order, which the routing's queues follow);
    ``ep_fault="reduced"``: the expert shards' gradients also summed in
    the flat all-reduce (a planted fault); the state then also holds the
    ``"first gradients"``, every gradient of the first step. ``fsdp``: the
    model's leaves of at least that many elements and their moments
    sharded over ``axis`` (``parallel/fsdp.py``); the weights hold the
    full leaves, and the clock this rank's ``"bytes"``. ``tp``: the
    model's conv kernels of at least that many output channels cut over
    ``axis.model`` (``parallel/tensor.py``; K3 on each rank's output
    channels), the weights full leaves; ``tp_fault``: the depthwise-
    separable convs' all-reduce of gd over the model axis dropped (a
    planted fault). ``grads``: the state holds the ``"first gradients"``
    as under ``moe``, TP's blocks gathered."""
    import numpy as np
    import torch

    from extended_gan_torch import ops
    from extended_gan_torch.models.moe import moe_layers
    from extended_gan_torch.models.registry import build_model
    from extended_gan_torch.parallel import attach_data_axis
    from extended_gan_torch.parallel import fsdp as fsdp_
    from extended_gan_torch.parallel import tensor
    from extended_gan_torch.parallel.expert import (
        full_state,
        gather_experts,
        shard_tree_moe_ep,
    )
    from extended_gan_torch.train import gat_trainer
    from extended_gan_torch.train.gat_trainer import (
        make_gat_train_step,
        to_device_batch,
    )
    from extended_gan_torch.train.optim import make_optimizer
    from extended_gan_torch.train.state import batchnorms

    model_type, mapping, hw = DP_MODELS[name]
    model = build_model(model_type, image_width=hw, image_height=hw,
                        n_vertices=6, mapping_type=mapping, device=device,
                        generator=torch.Generator().manual_seed(0),
                        use_pallas=not float64, moe_experts=moe)
    dtype = torch.float64 if float64 else torch.float32
    model.to(dtype)
    clock = {"collective_ms": 0.0, "loads": []}
    for layer in moe_layers(model):
        layer.register_forward_hook(
            lambda mod, args, out: clock["loads"].append(
                mod.sown[-1][1].detach().cpu()))
    reduce_gd = tensor._reduce_gd
    if axis is not None:
        attach_data_axis(model, axis)
        axis.broadcast_module(model)
        if tp is not None:
            tensor.shard_module_tp(model, axis, tp)
            if tp_fault:
                tensor._reduce_gd = lambda gd, group: gd
        shard_tree_moe_ep(model, axis)
        if fsdp is not None:
            fsdp_.shard_module_fsdp(model, axis, fsdp)
        if fault:
            for bn in batchnorms(model):
                bn.axis = None
        all_reduce = axis.all_reduce

        def timed_all_reduce(t):  # the wait for the other rank included
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            all_reduce(t)
            torch.cuda.synchronize()
            clock["collective_ms"] += (time.perf_counter() - t0) * 1e3
            return t
        axis.all_reduce = timed_all_reduce
    opt = make_optimizer("adam", model.parameters(), 1e-3,
                         weight_decay=0.01)
    fsdp_.refresh_after(opt, model)
    replicated = gat_trainer.replicated_parameters
    if ep_fault == "reduced":
        gat_trainer.replicated_parameters = lambda m: list(m.parameters())
    try:
        step = make_gat_train_step(model, opt, axis=axis,
                                   moe_aux_weight=MOE_AUX_W if moe else 0.0)
    finally:
        gat_trainer.replicated_parameters = replicated
    rng = np.random.default_rng(DP_SEED)
    losses, per_step, step_ms, collective_ms = [], [], [], []
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False,
                                    deterministic=True):
        for _ in range(DP_STEPS):
            x, y = (rng.random((32, hw, hw, 4, 6), np.float32)
                    for _ in range(2))
            if permute:
                order = np.random.default_rng(5).permutation(32)
                x, y = x[order], y[order]
            if perturb:
                x = x * (1 + 1e-7 * np.random.default_rng(6).standard_normal(
                    x.shape)).astype(np.float32)
            if axis is not None:
                rows = axis.rows(32)
                x, y = x[rows], y[rows]
            batch = tuple(t.to(dtype) for t in to_device_batch(x, y, device))
            torch.cuda.synchronize()
            before, c0 = ops.launch_counts(), clock["collective_ms"]
            t0 = time.perf_counter()
            loss, _ = step(*batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            collective_ms.append(clock["collective_ms"] - c0)
            losses.append(loss)
            if len(losses) == 1:  # before Adam's steps amplify roundoff
                first = [t.detach().cpu().clone()
                         for t in itertools.chain(model.buffers(), [loss])]
                if moe or grads:
                    # every gradient, the experts' and TP's blocks
                    # gathered from their ranks (Adam's update hides a
                    # gradient's scale)
                    named = {n: p.grad for n, p in model.named_parameters()}
                    if axis is not None:
                        named = tensor.full_state_dict(model, gather_experts(
                            named, model, axis))
                    first_grads = [g.detach().cpu().clone()
                                   for g in named.values()]
            per_step.append({n: c - before[n] for n, c in
                             ops.launch_counts().items() if c != before[n]})
    weights = _full_weights([model], [opt])
    clock["bytes"] = fsdp_.persistent_bytes(model, opt)
    if moe:
        # all E experts and their moments, gathered from their ranks
        tree = {"model": dict(model.named_parameters()),
                "optimizer": opt.state_dict()}
        if axis is not None:
            tree = full_state(tree, model, opt, axis)
        weights = list(tree["model"].values()) + [
            v for st in tree["optimizer"]["state"].values()
            for v in st.values() if torch.is_tensor(v) and v.dim()]
    stats = list(model.buffers()) + [torch.stack(losses)]
    tensor._reduce_gd = reduce_gd
    if axis is not None:
        axis.all_reduce = all_reduce
    state = {"weights": [t.detach().cpu().clone() for t in weights],
             "statistics": [t.detach().cpu().clone() for t in stats],
             "first step": first}
    if moe or grads:
        state["first gradients"] = first_grads
    return (state,
            per_step, {"step_ms": step_ms, "collective_ms": collective_ms,
                       "loads": clock["loads"], "bytes": clock["bytes"]})


def dp_child(spec_json):
    """One gloo rank of :func:`phase_data_parallel` on ``cuda:0``: each
    model's DP_STEPS steps on its rows, and the planted fault, saved to
    ``<out>.<rank>``."""
    import torch
    import torch.distributed as dist

    from extended_gan_torch import ops
    from extended_gan_torch.parallel import DataAxis

    spec = json.loads(spec_json)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method="file://" + spec["store"],
                            rank=spec["rank"], world_size=spec["size"])
    try:
        axis = DataAxis(torch.device("cuda", 0), dist.group.WORLD)
        out = {}
        for name in DP_MODELS:
            _reset_launches()  # this rank's main path
            out[name] = _dp_run(name, axis.device, axis)
            out[name] += (ops.launch_counts(),)
        out["final_smaatunet fault"] = _dp_run("final_smaatunet",
                                               axis.device, axis, fault=True)
        torch.save(out, f"{spec['out']}.{spec['rank']}")
    finally:
        dist.destroy_process_group()
    return 0


def dp_cli_child(spec_json):
    """The conv-GAT CLI in this process, cuDNN deterministic: ``argv``,
    then the process group's backend and size (``none`` without one) and
    the kernels' launches as ``[child]`` lines."""
    import torch
    import torch.distributed as dist

    from extended_gan_torch import ops
    from extended_gan_torch.gat.__main__ import main as gat_cli

    spec = json.loads(spec_json)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _reset_launches()
    gat_cli(spec["argv"])
    torch.cuda.synchronize()
    group = (f"{dist.get_backend()} {dist.get_world_size()}"
             if dist.is_initialized() else "none")
    print(f"[child] group {group}", flush=True)
    print(f"[child] launches {json.dumps(ops.launch_counts())}", flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


def _spawn(flag, spec, env=None):
    return subprocess.Popen(
        [sys.executable, "-u", os.path.abspath(__file__), flag,
         json.dumps(spec)], cwd=REPO, env={**os.environ, **(env or {})},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finished(proc, label, timeout=300):
    try:
        text, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise SmokeFailure(f"{label}: the child outlived {timeout} s")
    check(proc.returncode == 0,
          f"{label}: exited {proc.returncode}:\n{text[-3000:]}")
    return text


def phase_data_parallel(tmp):
    """The conv-GAT trainer's data axis on the one card:

    - two ranks over gloo, both on ``cuda:0`` (``chip_smoke.py
      --dp-child``), each with 16 rows of every global batch of 32:
      final_smaatunet (K3, cross-rank BatchNorm, 20x20) and
      final_temp_conv (K1, 80x80), DP_STEPS Adam steps from seed 0,
      held (parameters, buffers, Adam's moments and the losses) to the
      same steps in one process in float64 (the plain versions) by
      ``utils/compare.py``, the weights (and moments) and the statistics
      (and losses) apart, and the statistics and loss of the first step:
      each within 10x the widest distance from it of the one-process
      float32 b=32 run with the kernels and of its twin with each batch's
      rows in another order (float32 roundoff and the reduction order,
      which Adam's steps amplify); the
      ranks end equal; each rank launches K3 18 + 18 and K1
      2 + 2 a step; per-rank BatchNorm statistics (the planted fault) must
      miss the bound;
    - a world of one over NCCL through the CLI: ``--multihost`` under a
      launcher environment of one rank against the same CLI run without
      it (final_temp_conv, 3 steps), history and weights bit for bit;
    - ``--data-axis 2`` with one card raises, naming 2 cards and 1."""
    import torch

    from extended_gan_torch.gat.__main__ import main as gat_cli
    from extended_gan_torch.utils.compare import (
        drift,
        held_to_reference,
        widest,
    )

    t_phase = time.perf_counter()
    card = card_line()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = os.path.join(tmp, "dp")
    ranks = [_spawn("--dp-child", dict(rank=r, size=2, out=out,
                                       store=os.path.join(tmp, "store")))
             for r in range(2)]
    cli_argv = ["generate_experiment", "--exp_folder_name", "final_temp_conv",
                "--epochs", "1", "--max-batches", "3", "--output-path"]
    launcher = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                    MASTER_ADDR="127.0.0.1", MASTER_PORT="0")
    clis = {"plain": _spawn("--dp-cli-child", dict(
                argv=cli_argv + [os.path.join(tmp, "plain")])),
            "multihost": _spawn("--dp-cli-child", dict(
                argv=cli_argv + [os.path.join(tmp, "multihost"),
                                 "--multihost"]), env=launcher)}
    # the one-process runs, while the ranks run: float64, float32 and the
    # float32 twin
    refs = {}
    for name in DP_MODELS:
        want = _cached(_dp_run, name, dev, float64=True)[0]
        one, per_step, one_clock = _cached(_dp_run, name, dev)
        twin = _cached(_dp_run, name, dev, permute=True)[0]
        refs[name] = (want, {g: widest(drift(t[g], want[g])
                                       for t in (one, twin))
                             for g in want}, per_step, one_clock)

    def held(got, name):
        want, floors, _, _ = refs[name]
        return {g: held_to_reference(got[g], want[g], floors[g])
                for g in want}
    for r, p in enumerate(ranks):
        _finished(p, f"data_parallel rank {r}")
    got = [torch.load(f"{out}.{r}", weights_only=False) for r in range(2)]
    verdicts, rank_launches = {}, {}
    times = {}
    for name, (_, _, per_step, one_clock) in refs.items():
        (s0, steps0, clock0, total0), (s1, _, _, total1) = \
            got[0][name], got[1][name]
        # past the first step (the kernels' and cuDNN's first calls)
        times[name] = dict(
            one_ms=statistics.mean(one_clock["step_ms"][1:]),
            two_ms=statistics.mean(clock0["step_ms"][1:]),
            collective_ms=statistics.mean(clock0["collective_ms"][1:]))
        check(all(torch.equal(a, b) for g in s0 for a, b in zip(s0[g], s1[g])),
              f"data_parallel {name}: the two ranks' states differ")
        verdicts[name] = held(s0, name)
        check(all(v["ok"] for v in verdicts[name].values()),
              f"data_parallel {name}: two ranks against one process "
              f"{verdicts[name]}")
        each = {"final_smaatunet": {"dsconv_fwd": 18, "dsconv_bwd": 18},
                "final_temp_conv": {"gat_attention_fwd": 2,
                                    "gat_attention_bwd": 2}}[name]
        check(all(s == each for s in steps0) and per_step[0] == each,
              f"data_parallel {name}: launches a step {steps0} on rank 0, "
              f"{per_step[0]} in one process; expected {each}")
        rank_launches[name] = (total0, total1)
    fault = held(got[0]["final_smaatunet fault"][0], "final_smaatunet")
    check(not fault["first step"]["ok"],
          f"data_parallel: per-rank BatchNorm statistics pass the bound: "
          f"{fault}")
    cli_text = {k: _finished(p, f"data_parallel CLI {k}")
                for k, p in clis.items()}
    groups = {k: next((ln.split(" ", 2)[2] for ln in t.splitlines()
                       if ln.startswith("[child] group ")), "")
              for k, t in cli_text.items()}
    cli_launches = {k: json.loads(next(
        ln.split(" ", 2)[2] for ln in t.splitlines()
        if ln.startswith("[child] launches "))) for k, t in cli_text.items()}
    hists = {}
    for k in clis:
        with open(os.path.join(tmp, k, "history.json")) as f:
            hists[k] = json.load(f)
    weights = {k: torch.load(os.path.join(tmp, k, "model.pt"),
                             weights_only=True) for k in clis}
    check(groups == {"plain": "none", "multihost": "nccl 1"}
          and hists["plain"] == hists["multihost"]
          and all(torch.equal(weights["plain"][n], weights["multihost"][n])
                  for n in weights["plain"])
          and cli_launches["plain"] == cli_launches["multihost"],
          f"data_parallel: --multihost over a world of one ({groups}) "
          f"against the plain CLI: history {hists}, launches {cli_launches}")
    try:
        gat_cli(cli_argv[:-1] + ["--data-axis", "2"])
        raised = ""
    except ValueError as e:
        raised = str(e)
    check(raised == "--data-axis 2 needs 2 cards, have 1",
          f"data_parallel: --data-axis 2 on one card raised {raised!r}")
    seconds = time.perf_counter() - t_phase
    print(f"[data_parallel] two gloo ranks on cuda:0, 16 rows each of "
          f"{DP_STEPS} batches of 32, against one process in float64: "
          + "; ".join(f"{n} {g} gap {v['gap']:.3e}, {v['worst']:.3f} of "
                      f"its bound (floor {v['floor']:.3e})"
                      for n, vs in verdicts.items() for g, v in vs.items())
          + "; ms a step (host clock, synchronised, steps 2 and 3): "
          + "; ".join(f"{n} one process b=32 {t['one_ms']:.3f}, two ranks "
                      f"sharing the card {t['two_ms']:.3f} of which "
                      f"collectives {t['collective_ms']:.3f} (waits "
                      "included)" for n, t in times.items())
          + f"; per-rank BatchNorm statistics at "
          f"{fault['first step']['worst']:.1f}x their bound after the first "
          f"step ({fault['statistics']['worst']:.2f}x after the last, the "
          f"weights {fault['weights']['worst']:.2f}x); launches each rank "
          f"{rank_launches}; --multihost world of "
          f"one ({groups['multihost']}) equals the plain CLI bit for bit, "
          f"launches {cli_launches['plain']}; --data-axis 2: {raised}; "
          f"phase {seconds:.1f} s; {card}")
    return dict(verdicts=verdicts, fault=fault["first step"]["worst"],
                times=times,
                rank_launches=rank_launches, cli_launches=cli_launches,
                seconds=seconds)


# the gan_data_parallel phase: Adam steps of the published GANs, 2 gloo
# ranks of 16 rows against one process of 32; the batches from this seed
GAN_DP_STEPS = {"dcgan": 3, "cyclegan": 2}
GAN_DP_SEED = 13


def _plant_gan_fault(fault, nets, axis):
    """``"dropout"``: each rank draws its own rows' masks; ``"d_unreduced"``:
    the step's first all-reduce (D's) sums its losses alone."""
    from extended_gan_torch.models.dcgan import ConvBlock

    if fault == "dropout":
        for net in nets:
            for m in net.modules():
                if isinstance(m, ConvBlock):
                    m.axis = None
    elif fault == "d_unreduced":
        reduce, calls = axis.all_reduce_grads, []

        def unreduced(params, extra):
            calls.append(1)
            return reduce([] if len(calls) == 1 else params, extra)

        axis.all_reduce_grads = unreduced


# the layer check: cross-rank BatchNorm on a global batch whose mean is
# large against its spread, every value exact in float32 (the grid's step,
# 2**-8, is a whole number of float32 steps at GAN_BN_SHIFT), rank 1's rows
# 0.25 above rank 0's
GAN_BN_SHIFT = 1000.0
GAN_BN_SHAPE = (32, 64, 32, 32)


def _mean_rounded(d, shift, mean, invstd):
    """Cross-rank BatchNorm's x_hat from its mean rounded to float32: a past
    fault, planted to show the layer check sees it."""
    mean32 = mean.to(d.dtype).reshape(1, -1, 1, 1)
    return (d - (mean32 - shift.reshape(1, -1, 1, 1))) \
        * invstd.to(d.dtype).reshape(1, -1, 1, 1)


def _bn_layer(device, axis=None, *, dtype=None, shift=0.0, fault=False):
    """Train-mode BatchNorm (momentum 0.1) forward and backward of the
    layer check's batch less ``shift`` (which moves none of its outputs):
    over ``axis``'s ranks, each with its rows (``fault``: the mean rounded
    to float32), or ``F.batch_norm`` in one process in ``dtype``. Returns
    y, dx, the weight's and bias's gradients and the running statistics,
    all of the global batch, as float64 on the CPU."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from extended_gan_torch.parallel import BatchNorm2d
    from extended_gan_torch.parallel import batch_norm as bn_module

    n, c = GAN_BN_SHAPE[:2]
    rng = np.random.default_rng(GAN_DP_SEED)
    x = (GAN_BN_SHIFT + rng.integers(0, 64, GAN_BN_SHAPE) / 256
         + 0.25 * (np.arange(n) >= n // 2)[:, None, None, None])
    x, dy = (torch.from_numpy(a.astype(np.float32)).to(device)
             for a in (x, rng.standard_normal(GAN_BN_SHAPE)))
    w = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(c).astype(np.float32))
    if axis is None:
        x, dy, w, b = (t.to(device, dtype) for t in (x - shift, dy, w, b))
        x.requires_grad_(True)
        w.requires_grad_(True)
        b.requires_grad_(True)
        rm, rv = torch.zeros_like(w), torch.ones_like(w)
        y = F.batch_norm(x, rm, rv, w, b, True, 0.1, 1e-5)
        y.backward(dy)
        out = [y, x.grad, w.grad, b.grad, rm + 0.1 * shift, rv]
    else:
        bn = BatchNorm2d(c).to(device)
        with torch.no_grad():
            bn.weight.copy_(w)
            bn.bias.copy_(b)
        bn.axis = axis
        normalise = bn_module._normalise
        if fault:
            bn_module._normalise = _mean_rounded
        try:
            xs = axis.shard(x).clone().requires_grad_(True)
            y = bn(xs)
            y.backward(axis.shard(dy))
        finally:
            bn_module._normalise = normalise
        grads = axis.all_reduce(torch.stack([bn.weight.grad, bn.bias.grad]))
        out = [axis.gather_rows(y.detach()).flatten(0, 1),
               axis.gather_rows(xs.grad).flatten(0, 1), grads[0], grads[1],
               bn.running_mean, bn.running_var]
    return [t.detach().double().cpu() for t in out]


def _bn_layer_verdict(got, want, shifted, plain):
    """The worst of each output's gap from float64 (``want``) over 10x the
    plain path's own: ``F.batch_norm`` in float32 on the batch less
    GAN_BN_SHIFT (``shifted``: as precise as float32 can give them, no
    mean's size to lose) for the outputs and gradients, on the batch
    itself (``plain``) for the running statistics."""
    def gap(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    return max(gap(g, w) / (10 * max(gap(t, w), 1e-9))
               for g, w, t in zip(got, want, shifted[:4] + plain[4:]))


def _gan_dp_run(kind, device, axis=None, *, fault=None, float64=False,
                perturb=False, fsdp=None, tp=None, tp_fault=False):
    """GAN_DP_STEPS[kind] Adam steps of the published ``kind`` ("dcgan": nc
    4, ndf 64, 64x64, default body; "cyclegan": nc 4, ndf 64) from seed 0,
    dropout 0.01 from a generator on the card seeded 0, on global batches
    of 32 (this rank's rows on ``axis``; ``perturb``: each batch scaled by
    1 + 1e-7 noise; ``float64``: in float64), cuDNN exact and
    deterministic: ``{"weights": parameters and Adam's moments after the
    last step, "statistics": the buffers after it and the losses, "first
    step": the buffers and the losses after the first step}`` on the CPU,
    and the ms of each step (host clock, synchronised). ``fsdp``: every
    net's leaves of at least that many elements and their moments sharded
    over ``axis`` (``parallel/fsdp.py``; the weights hold the full leaves),
    and a third result, this rank's persistent bytes of each net;
    ``fault="stale_d"`` under it: FD's and TD's working weights not
    gathered after their optimizer's step (a planted fault). ``tp``: the
    discriminators' conv kernels of at least that many output channels
    cut over ``axis.model`` (``parallel/tensor.py``), the weights full
    leaves and the third result as under ``fsdp``; ``tp_fault``: the cut
    convs' all-reduce of dx over the model axis dropped (a planted
    fault)."""
    import numpy as np
    import torch

    from extended_gan_torch.core.prng import KeySeq
    from extended_gan_torch.parallel import join_data_axis
    from extended_gan_torch.train import cyclegan_trainer, dcgan_trainer
    from extended_gan_torch.train.cyclegan_driver import build_cyclegan
    from extended_gan_torch.train.dcgan_driver import (
        DEFAULT_PARAMS,
        build_dcgan,
    )

    from extended_gan_torch.parallel import fsdp as fsdp_
    from extended_gan_torch.parallel import tensor

    def place(nets):
        if fsdp is not None or tp is not None:
            join_data_axis(axis, *nets)
        if tp is not None:
            tensor.place_nets(axis, nets[1 if kind == "dcgan" else 2:], tp)
        if fsdp is not None:
            fsdp_.place_nets(axis, nets, True, fsdp)

    keys = KeySeq(0, device=device)
    if kind == "dcgan":
        nets, opts = build_dcgan(DEFAULT_PARAMS, seed=0, device=device,
                                 keys=keys, place=place)
        loss_keys = ("errFD", "errTD", "errG")
    else:
        nets, opts = build_cyclegan(seed=0, device=device, keys=keys,
                                    place=place)
        loss_keys = cyclegan_trainer.LOSS_KEYS
    for net, opt in zip(nets, opts):
        fsdp_.refresh_after(opt, net)
    dtype = torch.float64 if float64 else torch.float32
    for net in nets:
        net.to(dtype)
    if axis is not None:
        if fsdp is None and tp is None:
            join_data_axis(axis, *nets)
        if fault == "stale_d":
            for net in nets[1:]:
                for hook in fsdp_.fsdp_net(net).hooks:
                    hook.remove()
        elif fault:
            _plant_gan_fault(fault, nets, axis)
    if kind == "dcgan":
        step = dcgan_trainer.make_dcgan_train_step(*nets, *opts, axis=axis)
    else:
        step = cyclegan_trainer.make_cyclegan_train_step(*nets, *opts,
                                                         axis=axis)
    reduce_dx = tensor._reduce_dx
    if tp_fault:
        tensor._reduce_dx = lambda dx, group: dx
    rng = np.random.default_rng(GAN_DP_SEED)
    noise = np.random.default_rng(99)
    losses, step_ms, first = [], [], None
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False,
                                    deterministic=True):
        for _ in range(GAN_DP_STEPS[kind]):
            x, y = (rng.random((32, 4, 64, 64), np.float32)
                    for _ in range(2))
            if perturb:
                x, y = ((a * (1 + 1e-7 * noise.standard_normal(a.shape)))
                        .astype(np.float32) for a in (x, y))
            if axis is not None:
                rows = axis.rows(32)
                x, y = x[rows], y[rows]
            x, y = (torch.from_numpy(a).to(device, dtype) for a in (x, y))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logs = step(x, y) if axis is None else step(x, y, None, 32)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(torch.stack([logs[k] for k in loss_keys]))
            if first is None:  # before Adam's steps amplify roundoff
                first = [t.detach().cpu().clone() for t in itertools.chain(
                    (b for n in nets for b in n.buffers()), [losses[0]])]
    tensor._reduce_dx = reduce_dx
    if axis is not None:
        axis.__dict__.pop("all_reduce_grads", None)
    weights = _full_weights(nets, opts)
    stats = [b for n in nets for b in n.buffers()] + [torch.stack(losses)]
    state = {"weights": [t.detach().cpu().clone() for t in weights],
             "statistics": [t.detach().cpu().clone() for t in stats],
             "first step": first}
    if fsdp is None and tp is None:
        return state, step_ms
    return state, step_ms, [fsdp_.persistent_bytes(net, opt)
                            for net, opt in zip(nets, opts)]


def gan_dp_child(spec_json):
    """One gloo rank of :func:`phase_gan_data_parallel` on ``cuda:0``: the
    DCGAN's and the CycleGAN's steps on its rows, the two planted faults,
    the BatchNorm layer check with and without its planted fault, and the
    driver's answer to ``--megastep 8`` over this gloo group on
    the card; saved to ``<out>.<rank>``."""
    import torch
    import torch.distributed as dist

    from extended_gan_torch.parallel import DataAxis
    from extended_gan_torch.train import dcgan_driver

    spec = json.loads(spec_json)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method="file://" + spec["store"],
                            rank=spec["rank"], world_size=spec["size"])
    try:
        axis = DataAxis(torch.device("cuda", 0), dist.group.WORLD)
        out = {kind: _gan_dp_run(kind, axis.device, axis)
               for kind in GAN_DP_STEPS}
        for fault in ("dropout", "d_unreduced"):
            out[f"dcgan {fault}"] = _gan_dp_run("dcgan", axis.device, axis,
                                                fault=fault)
        out["bn"] = [_bn_layer(axis.device, axis, fault=f)
                     for f in (False, True)]
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                dcgan_driver.train(device="cuda", data_axis=2, megastep=8,
                                   synthetic=True, epochs=1,
                                   max_batches=16, train_batch_size=16)
            out["refusal"] = ""
        except RuntimeError as e:
            out["refusal"] = str(e)
        torch.save(out, f"{spec['out']}.{spec['rank']}")
    finally:
        dist.destroy_process_group()
    return 0


def gan_dp_cli_child(spec_json):
    """A training CLI (``spec["cli"]``: gat, dcgan or cycle_gan) in this
    process, cuDNN deterministic: ``argv``, then the process group's
    backend and size (``none`` without one) and the kernels' launches as
    ``[child]`` lines; the train state it ends with saved to
    ``spec["save"]``."""
    import importlib

    import torch
    import torch.distributed as dist

    from extended_gan_torch import ops

    spec = json.loads(spec_json)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    main = importlib.import_module(
        f"extended_gan_torch.{spec['cli']}.__main__").main
    _reset_launches()
    nets, history = main(spec["argv"])
    torch.cuda.synchronize()
    nets = nets if isinstance(nets, tuple) else (nets,)
    torch.save({"state": [t.detach().cpu() for n in nets
                          for t in n.state_dict().values()],
                "history": history if isinstance(history, dict)
                else history.history}, spec["save"])
    group = (f"{dist.get_backend()} {dist.get_world_size()}"
             if dist.is_initialized() else "none")
    print(f"[child] group {group}", flush=True)
    print(f"[child] launches {json.dumps(ops.launch_counts())}", flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


def phase_gan_data_parallel(tmp):
    """The DCGAN and the CycleGAN over the data axis, and ``--megastep`` with
    ``--resident`` under it, on the one card:

    - (a), (b) two ranks over gloo, both on ``cuda:0`` (``chip_smoke.py
      --gan-dp-child``), each with 16 rows of every global batch of 32:
      the published DCGAN (default body, 3 Adam steps) and CycleGAN (2),
      dropout 0.01 on, held to one process in float64 by
      ``utils/compare.py`` (the weights and Adam's moments, the
      statistics and losses, the first step apart), each within 10x the
      widest distance from it of the one-process float32 run and of its
      twin with every batch under 1e-7 noise (the plain path alone, so a
      fault in the axis's code cannot widen its own bound); the ranks end
      equal, bit for bit; two planted faults, per-rank dropout masks and
      D's gradients left unreduced, must each miss the bound by more than
      10x; and cross-rank BatchNorm alone (64 channels, 16 rows a rank of
      32x32, a mean 1000 against a spread of 0.13), forward and backward,
      within 10x of float32 ``F.batch_norm``'s own distance from float64,
      while its mean rounded to float32 (a past fault) misses by more
      than 10x;
    - (c) the gat (final_smaatunet's and final_temp_conv's models),
      dcgan and cycle_gan CLIs with ``--megastep 8 --resident`` (2
      programs of 8 steps: the first eager, the second captured and
      replayed) as an NCCL world of one (``--multihost`` under a launcher
      environment of one rank), each held to the same CLI run without it
      bit for bit, history and train state; the launches equal, K3's backward 144 + 144 and K1's 16 + 16;
    - (d) ``--megastep 8`` over the two gloo ranks on the card raises,
      naming NCCL.

    One card cannot host two NCCL ranks, so no collective is captured
    here: the four-card run of ``python -m
    extended_gan_torch.parallel.probe --megastep 8`` is that evidence."""
    import torch

    from extended_gan_torch.data.synthetic import make_kmni_dataset
    from extended_gan_torch.utils.compare import (
        drift,
        held_to_reference,
        widest,
    )

    t_phase = time.perf_counter()
    card = card_line()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = os.path.join(tmp, "gan_dp")
    ranks = [_spawn("--gan-dp-child", dict(rank=r, size=2, out=out,
                                           store=os.path.join(tmp, "store")))
             for r in range(2)]
    knmi = make_kmni_dataset(os.path.join(tmp, "knmi"), n_train_files=20,
                             n_test_files=2, frames_per_file=96, hw=80)
    k = 8
    graphs = ["--resident", "--megastep", str(k), "--max-batches",
              str(2 * k)]
    gat = ["train", "--dataset", "kmni", "--preprocessed-folder", knmi,
           "--train-batch-size", "32", "--test-batch-size", "64",
           "--epochs", "1"] + graphs
    gan = ["--synthetic", "--epochs", "1", "--train-batch-size", "16",
           "--save-epoch", "1"] + graphs
    clis = {
        "final_smaatunet": ("gat", gat + [
            "--model-type", "unet", "--mapping-type", "linear",
            "--downsample-size", "20", "20"], "--output-path"),
        "final_temp_conv": ("gat", gat + [
            "--model-type", "temporal", "--mapping-type", "conv",
            "--downsample-size", "80", "80"], "--output-path"),
        "dcgan": ("dcgan", gan, "--out-dir"),
        "cycle_gan": ("cycle_gan", gan, "--out-dir"),
    }
    launcher = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                    MASTER_ADDR="127.0.0.1", MASTER_PORT="0")
    runs = [(name, how) for name in clis for how in ("plain", "multihost")]
    children = {}
    for name, how in runs:
        cli, argv, out_flag = clis[name]
        where = os.path.join(tmp, f"{name} {how}".replace(" ", "_"))
        children[name, how] = _spawn("--gan-dp-cli-child", dict(
            cli=cli, save=where + ".pt", argv=argv + [out_flag, where] + (
                ["--multihost"] if how == "multihost" else [])),
            env=launcher if how == "multihost" else None)
    # the one-process runs, while the children run: float64, float32 and
    # the float32 twin on a perturbed input
    refs = {}
    for kind in GAN_DP_STEPS:
        want = _cached(_gan_dp_run, kind, dev, float64=True)[0]
        one, one_ms = _cached(_gan_dp_run, kind, dev)
        twin = _cached(_gan_dp_run, kind, dev, perturb=True)[0]
        refs[kind] = (want, {g: widest(drift(t[g], want[g])
                                       for t in (one, twin))
                             for g in want}, one_ms)

    def held(got, kind):
        want, floors, _ = refs[kind]
        return {g: held_to_reference(got[g], want[g], floors[g])
                for g in want}

    for r, p in enumerate(ranks):
        _finished(p, f"gan_data_parallel rank {r}")
    got = [torch.load(f"{out}.{r}", weights_only=False) for r in range(2)]
    verdicts, times = {}, {}
    for kind in GAN_DP_STEPS:
        (s0, ms0), (s1, _) = got[0][kind], got[1][kind]
        check(all(torch.equal(a, b) for g in s0 for a, b in zip(s0[g], s1[g])),
              f"gan_data_parallel {kind}: the two ranks' states differ")
        verdicts[kind] = held(s0, kind)
        check(all(v["ok"] for v in verdicts[kind].values()),
              f"gan_data_parallel {kind}: two ranks against one process "
              f"{verdicts[kind]}")
        times[kind] = dict(one_ms=statistics.mean(refs[kind][2][1:]),
                           two_ms=statistics.mean(ms0[1:]))
    faults = {}
    for fault in ("dropout", "d_unreduced"):
        v = held(got[0][f"dcgan {fault}"][0], "dcgan")
        faults[fault] = max(x["worst"] for x in v.values())
        check(faults[fault] > 10.0,
              f"gan_data_parallel: the planted fault {fault} misses the "
              f"bound by only {faults[fault]:.2f}x: {v}")
    bn_refs = [_bn_layer(dev, dtype=torch.float64),
               _bn_layer(dev, dtype=torch.float32, shift=GAN_BN_SHIFT),
               _bn_layer(dev, dtype=torch.float32)]
    bn = [_bn_layer_verdict(g, *bn_refs) for g in got[0]["bn"]]
    faults["bn_mean_f32"] = bn[1]
    check(bn[0] <= 1.0 and bn[1] > 10.0,
          f"gan_data_parallel: cross-rank BatchNorm at {bn[0]:.3f} of its "
          f"bound (at most 1), its mean rounded to float32 at {bn[1]:.3f} "
          f"(over 10)")
    refusals = [g["refusal"] for g in got]
    check(all("needs NCCL" in r and "gloo" in r for r in refusals),
          f"gan_data_parallel: --megastep 8 over gloo on the card: "
          f"{refusals}")
    texts = {key: _finished(p, f"gan_data_parallel CLI {key}")
             for key, p in children.items()}
    groups = {key: next((ln.split(" ", 2)[2] for ln in t.splitlines()
                         if ln.startswith("[child] group ")), "")
              for key, t in texts.items()}
    launches = {key: json.loads(next(
        ln.split(" ", 2)[2] for ln in t.splitlines()
        if ln.startswith("[child] launches "))) for key, t in texts.items()}
    saved = {key: torch.load(os.path.join(
        tmp, f"{key[0]} {key[1]}".replace(" ", "_") + ".pt"),
        weights_only=False) for key in children}
    cli_verdicts = {}
    for name in clis:
        plain, multi = saved[name, "plain"], saved[name, "multihost"]
        check(groups[name, "plain"] == "none"
              and groups[name, "multihost"] == "nccl 1"
              and launches[name, "plain"] == launches[name, "multihost"],
              f"gan_data_parallel CLI {name}: groups "
              f"{groups[name, 'plain']}, {groups[name, 'multihost']}, "
              f"launches {launches[name, 'plain']} and "
              f"{launches[name, 'multihost']}")
        v = cli_verdicts[name] = held_to_reference(multi["state"],
                                                   plain["state"])
        check(v["bitwise"] and multi["history"] == plain["history"],
              f"gan_data_parallel CLI {name}: --multihost world of one "
              f"against the plain CLI: {v}, histories {plain['history']} "
              f"and {multi['history']}")
    per_replay = {"final_smaatunet": ("dsconv_bwd", 18 * k),
                  "final_temp_conv": ("gat_attention_bwd", 2 * k)}
    for name, (kernel, n) in per_replay.items():
        check(launches[name, "multihost"].get(kernel) == 2 * n,
              f"gan_data_parallel CLI {name}: {kernel} launched "
              f"{launches[name, 'multihost'].get(kernel)}, expected {n} "
              f"(eager) + {n} (a replay)")
    seconds = time.perf_counter() - t_phase
    print(f"[gan_data_parallel] two gloo ranks on cuda:0, 16 rows each of "
          f"batches of 32, dropout 0.01, against one process in float64: "
          + "; ".join(f"{n} {g} gap {v['gap']:.3e}, {v['worst']:.3f} of its "
                      f"bound (floor {v['floor']:.3e})"
                      for n, vs in verdicts.items() for g, v in vs.items())
          + "; ms a step (host clock, synchronised, past the first): "
          + "; ".join(f"{n} one process b=32 {t['one_ms']:.3f}, two ranks "
                      f"sharing the card {t['two_ms']:.3f}"
                      for n, t in times.items())
          + f"; planted faults at {faults['dropout']:.1f}x (per-rank "
          f"dropout masks) and {faults['d_unreduced']:.1f}x (D's gradients "
          f"unreduced) their bound; cross-rank BatchNorm alone "
          f"{bn[0]:.3f} of its bound, its mean rounded to float32 "
          f"{bn[1]:.1f}x; --megastep 8 over gloo on the card: "
          f"{refusals[0][:60]!r}...; --megastep 8 --resident as an NCCL "
          f"world of one against the plain CLI: "
          + "; ".join(f"{n} {'bit for bit' if v['bitwise'] else 'within ' + format(v['worst'], '.3f') + ' of its bound'}"
                      for n, v in cli_verdicts.items())
          + f"; launches {({n: launches[n, 'multihost'] for n in clis})}; "
          f"phase {seconds:.1f} s; {card}")
    return dict(verdicts=verdicts, faults=faults, times=times,
                cli_launches={n: launches[n, "multihost"] for n in clis},
                seconds=seconds)


# the expert_parallel phase: the MoE UNet's Adam steps (DP_STEPS of them on
# batches from DP_SEED), 2 gloo ranks of 16 rows against one process of 32
EP_RANKS = 2


def _exchange_collectives(axis):
    """Runs the EP exchange's three collectives (``parallel/expert.py``)
    on CUDA tensors over this rank's process group; a refusal raises, and
    fails the phase. Returns their names."""
    import torch

    from extended_gan_torch.parallel import expert

    t = torch.arange(4.0, device=axis.device).reshape(axis.size, -1) \
        + axis.rank
    for fn in (expert.reduce_scatter, expert.all_gather, expert.all_to_all):
        fn(t, axis)
    torch.cuda.synchronize()
    return ["reduce_scatter", "all_gather", "all_to_all"]


def ep_child(spec_json):
    """One gloo rank of :func:`phase_expert_parallel` on ``cuda:0``: the
    exchange's three collectives on CUDA tensors (a refusal fails), the
    MoE UNet's DP_STEPS steps on its rows with its experts sharded, its
    shards' sizes, the launches, and the planted fault (the expert shards'
    gradients also all-reduced); saved to ``<out>.<rank>``."""
    import torch
    import torch.distributed as dist

    from extended_gan_torch import ops
    from extended_gan_torch.models.moe import moe_layers
    from extended_gan_torch.parallel import DataAxis

    spec = json.loads(spec_json)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method="file://" + spec["store"],
                            rank=spec["rank"], world_size=spec["size"])
    try:
        axis = DataAxis(torch.device("cuda", 0), dist.group.WORLD)
        out = {"collectives": _exchange_collectives(axis)}
        _reset_launches()  # this rank's main path
        out["run"] = _dp_run("final_smaatunet", axis.device, axis,
                             moe=MOE_E)
        out["launches"] = ops.launch_counts()
        out["routes"] = ops.plain_routes()
        from extended_gan_torch.models.registry import build_model
        from extended_gan_torch.parallel.expert import shard_tree_moe_ep

        model = build_model("unet", image_width=20, image_height=20,
                            n_vertices=6, mapping_type="linear",
                            device=axis.device, moe_experts=MOE_E)
        shard_tree_moe_ep(model, axis)
        (layer,) = moe_layers(model)
        out["shards"] = dict(experts=list(layer.experts),
                             w1=list(layer.w1.shape),
                             router=list(layer.router.shape))
        out["fault"] = _dp_run("final_smaatunet", axis.device, axis,
                               moe=MOE_E, ep_fault="reduced")[0]
        torch.save(out, f"{spec['out']}.{spec['rank']}")
    finally:
        dist.destroy_process_group()
    return 0


def phase_expert_parallel(tmp):
    """The Switch-MoE UNet's expert parallelism on the one card:

    - two ranks over gloo, both on ``cuda:0`` (``chip_smoke.py
      --ep-child``), each with 16 rows of every global batch of 32 and 4
      of the 8 experts (and their Adam moments): final_smaatunet's model
      with its MoE (12,437,540 parameters), DP_STEPS Adam steps from seed
      0 with the aux weight MOE_AUX_W, held to the same steps in one
      process in float64 by ``utils/compare.py`` within 10x the widest
      distance from it of the one-process float32 run and of its twin
      with each batch under 1e-7 relative noise (the weights and moments,
      the statistics and losses, the first step's statistics and its
      gradients); the first step's routing (the tokens each expert kept)
      equal to one process's; the ranks' state equal; K3 18 + 18 a step
      on each rank; the expert shards' gradients also all-reduced (the
      planted fault) must miss on the first step's gradients; first, the
      exchange's three collectives on CUDA tensors over gloo (a refusal
      fails the phase);
    - the MoE CLI under ``--multihost``: the conv-GAT CLI with
      ``--moe-experts 8 --megastep 8 --resident`` as an NCCL world of one
      against the same CLI without ``--multihost``, bit for bit, K3's
      backward 144 + 144. On an axis of one the experts are not sharded
      (``shard_tree_moe_ep`` leaves them, ``SwitchMoE`` runs its dense
      path), so this holds the CLI's multihost path and its graphs, not
      the exchange: the exchange captured in CUDA graphs over NCCL is held
      by ``python -m extended_gan_torch.parallel.probe --workload moe
      --check`` on four cards alone."""
    import torch

    from extended_gan_torch.data.synthetic import make_kmni_dataset
    from extended_gan_torch.utils.compare import (
        drift,
        held_to_reference,
        widest,
    )

    t_phase = time.perf_counter()
    card = card_line()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = os.path.join(tmp, "ep")
    ranks = [_spawn("--ep-child", dict(rank=r, size=EP_RANKS, out=out,
                                       store=os.path.join(tmp, "store")))
             for r in range(EP_RANKS)]
    # 8 files of 89 windows: 22 batches of 32, two programs of K = 8
    knmi = make_kmni_dataset(os.path.join(tmp, "knmi"), n_train_files=8,
                             n_test_files=1, frames_per_file=96, hw=20)
    k = 8
    argv = ["train", "--dataset", "kmni", "--preprocessed-folder", knmi,
            "--train-batch-size", "32", "--test-batch-size", "64",
            "--epochs", "1", "--model-type", "unet", "--mapping-type",
            "linear", "--downsample-size", "20", "20", "--moe-experts",
            str(MOE_E), "--resident", "--megastep", str(k),
            "--max-batches", str(2 * k)]
    launcher = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                    MASTER_ADDR="127.0.0.1", MASTER_PORT="0")
    children = {}
    for how in ("plain", "multihost"):
        where = os.path.join(tmp, f"moe_{how}")
        children[how] = _spawn("--gan-dp-cli-child", dict(
            cli="gat", save=where + ".pt", argv=argv + [
                "--output-path", where] + (
                ["--multihost"] if how == "multihost" else [])),
            env=launcher if how == "multihost" else None)
    # the one-process runs, while the children run
    want, _, _ = _dp_run("final_smaatunet", dev, float64=True, moe=MOE_E)
    one, one_steps, one_clock = _dp_run("final_smaatunet", dev, moe=MOE_E)
    twin = _dp_run("final_smaatunet", dev, perturb=True, moe=MOE_E)[0]
    floors = {g: widest(drift(t[g], want[g]) for t in (one, twin))
              for g in want}

    def held(got):
        return {g: held_to_reference(got[g], want[g], floors[g])
                for g in want}

    for r, p in enumerate(ranks):
        _finished(p, f"expert_parallel rank {r}", timeout=400)
    got = [torch.load(f"{out}.{r}", weights_only=False)
           for r in range(EP_RANKS)]
    gloo = got[0]["collectives"]
    (s0, steps0, clock0), (s1, _, _) = got[0]["run"], got[1]["run"]
    check(all(torch.equal(a, b) for g in ("statistics", "first step")
              for a, b in zip(s0[g], s1[g]))
          and all(torch.equal(a, b)
                  for a, b in zip(s0["weights"], s1["weights"])),
          "expert_parallel: the two ranks' states differ")
    verdict = held(s0)
    check(all(v["ok"] for v in verdict.values()),
          f"expert_parallel: two ranks against one process {verdict}")
    # the first step's routing, from the same weights, is one
    # process's; Adam's steps then move the weights apart by roundoff
    # (a tiny gradient's sign sets a step of lr), so a later step's
    # token within that of a tie may route elsewhere
    loads_equal = [bool(torch.equal(a, b)) for a, b in
                   zip(clock0["loads"], one_clock["loads"])]
    check(loads_equal[:1] == [True] and len(loads_equal) == DP_STEPS,
          f"expert_parallel: the tokens each expert kept, two ranks "
          f"{[t.tolist() for t in clock0['loads']]}, one process "
          f"{[t.tolist() for t in one_clock['loads']]}")
    shards = [g["shards"] for g in got]
    per = MOE_E // EP_RANKS
    check([sh["experts"] for sh in shards]
          == [[r * per, (r + 1) * per] for r in range(EP_RANKS)]
          and all(sh["w1"][0] == per and sh["router"][1] == MOE_E
                  for sh in shards),
          f"expert_parallel: the ranks' expert shards {shards}")
    each = {"dsconv_fwd": 18, "dsconv_bwd": 18}
    check(all(s == each for s in steps0) and one_steps[0] == each,
          f"expert_parallel: launches a step {steps0} on rank 0, "
          f"{one_steps[0]} in one process; expected {each}")
    rank_launches = [g["launches"] for g in got]
    check(not any(v for g in got for v in g["routes"].values()),
          f"expert_parallel: plain routes {[g['routes'] for g in got]}")
    fv = held(got[0]["fault"])
    fault = fv["first gradients"]["worst"]
    check(fault > 1.0,
          f"expert_parallel: the expert shards' gradients all-reduced "
          f"too pass the bound ({fault:.2f}x): {fv}")
    texts = {how: _finished(p, f"expert_parallel CLI {how}")
             for how, p in children.items()}
    groups = {how: next((ln.split(" ", 2)[2] for ln in t.splitlines()
                         if ln.startswith("[child] group ")), "")
              for how, t in texts.items()}
    launches = {how: json.loads(next(
        ln.split(" ", 2)[2] for ln in t.splitlines()
        if ln.startswith("[child] launches "))) for how, t in texts.items()}
    saved = {how: torch.load(os.path.join(tmp, f"moe_{how}.pt"),
                             weights_only=False) for how in children}
    cli = held_to_reference(saved["multihost"]["state"],
                            saved["plain"]["state"])
    check(groups == {"plain": "none", "multihost": "nccl 1"}
          and launches["plain"] == launches["multihost"]
          and cli["bitwise"]
          and saved["plain"]["history"] == saved["multihost"]["history"],
          f"expert_parallel CLI: --multihost world of one ({groups}) "
          f"against the plain CLI: {cli}, launches {launches}")
    check(launches["multihost"].get("dsconv_bwd") == 2 * 18 * k,
          f"expert_parallel CLI: dsconv_bwd launched "
          f"{launches['multihost'].get('dsconv_bwd')}, expected {18 * k} "
          f"(eager) + {18 * k} (a replay)")
    seconds = time.perf_counter() - t_phase
    steps_line = (
        "; ".join(f"{g} gap {v['gap']:.3e}, {v['worst']:.3f} of its bound "
                  f"(floor {v['floor']:.3e})" for g, v in verdict.items())
        + f"; routing equal to one process's in step 1 (steps 1 to "
        f"{DP_STEPS}: {loads_equal}; kept a step "
        f"{[int(t.sum()) for t in clock0['loads']]}); shards "
        f"{shards}; ms a step (host clock, steps 2 and 3) one process "
        f"{statistics.mean(one_clock['step_ms'][1:]):.3f}, two ranks "
        f"sharing the card {statistics.mean(clock0['step_ms'][1:]):.3f} of "
        f"which collectives {statistics.mean(clock0['collective_ms'][1:]):.3f}"
        f"; expert gradients all-reduced too at {fault:.1f}x the bound; "
        f"launches each rank {rank_launches}")
    print(f"[expert_parallel] gloo runs {', '.join(gloo)} on CUDA tensors"
          f"; two ranks on cuda:0, 16 rows and {MOE_E // EP_RANKS} "
          f"experts each, {DP_STEPS} Adam steps of batches of 32, against "
          f"one process in float64: {steps_line}; the MoE CLI under "
          f"--multihost (--moe-experts {MOE_E} --megastep {k} --resident, "
          f"an NCCL world of one: the experts unsharded, the dense MoE; the "
          f"exchange in graphs is the four-card probe's) against the plain "
          f"CLI: {'bit for bit' if cli['bitwise'] else cli}, launches "
          f"{launches['multihost']}; phase {seconds:.1f} s; {card}",
          flush=True)
    return dict(verdict=verdict, fault=fault,
                launches={"expert_parallel: gloo rank %d of 2" % r: c
                          for r, c in enumerate(rank_launches)}
                | {"expert_parallel: the MoE CLI --megastep 8 --resident "
                   "under --multihost, NCCL world of one (experts "
                   "unsharded)": launches["multihost"]},
                seconds=seconds)


# shapes past each limit of K3 and K1 (``ops/dsconv.py``,
# ``ops/gat_attention.py``): the forward kernels take them (K3's reading
# its taps unstaged past 333-pixel rows, K1's run-time-M kernel past M = 8),
# the wrappers route the backwards the kernels cannot take to the plain
# versions on the card, as the JAX package's backwards are plain:
# (N, H, W, C, kpl, Cout)
ROUTE_DSC = {"rows past the backward's 257 (kpl 2, C 64)": (2, 288, 288, 64,
                                                             2, 64),
             "rows past the forward's stages, 333 (unstaged; the backward "
             "takes them)": (1, 336, 336, 4, 2, 64),
             "kpl 33, past the backward's 32": (2, 16, 16, 2, 33, 8)}
# (NH, B, M, G, S): M past the instanced 8; M * G past the backward's 128
ROUTE_K1 = {"M = 9": (2, 4, 9, 6, 100), "M * G = 136": (2, 4, 8, 17, 64)}
ROUTE_TOL = 1e-5  # card float32 against float64, of each tensor's largest
ROUTE_UNETS = (288, 336)  # published UNet, one window of 6 vertices
ROUTE_TIMING = dict(groups=8, warmup=3, per_group=5)  # the forwards' times


# the fsdp phase: JAX's per-rank elements at D = 2, min_size 4096 (its
# rule on the CPU: tests/test_torch_port_fsdp.py), each x 4 bytes for the
# parameters and x 12 with Adam's two moments
FSDP_MIN = 4096
FSDP_ELEMENTS = {"dcgan": (9_144, 1_384_192, 1_386_240),
                 "final_smaatunet": (2_037_284,)}
FSDP_FULL = {"dcgan": (13_240, 2_766_592, 2_770_688),
             "final_smaatunet": (4_032_548,)}


def fsdp_child(spec_json):
    """One gloo rank of :func:`phase_fsdp` on ``cuda:0``: the DCGAN's steps
    with FSDP, without it and with the stale-D fault, then
    final_smaatunet's with and without FSDP (this rank's kernel launches
    counted over its FSDP steps alone), saved to ``<out>.<rank>``."""
    import torch
    import torch.distributed as dist

    from extended_gan_torch import ops
    from extended_gan_torch.parallel import DataAxis

    spec = json.loads(spec_json)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method="file://" + spec["store"],
                            rank=spec["rank"], world_size=spec["size"])
    try:
        axis = DataAxis(torch.device("cuda", 0), dist.group.WORLD)
        dev = axis.device
        out = {"dcgan fsdp": _gan_dp_run("dcgan", dev, axis, fsdp=FSDP_MIN),
               "dcgan": _gan_dp_run("dcgan", dev, axis),
               "dcgan stale_d": _gan_dp_run("dcgan", dev, axis,
                                            fsdp=FSDP_MIN, fault="stale_d")}
        _reset_launches()  # this rank's FSDP path
        out["final_smaatunet fsdp"] = _dp_run("final_smaatunet", dev, axis,
                                              fsdp=FSDP_MIN)
        out["launches"] = ops.launch_counts()
        out["final_smaatunet"] = _dp_run("final_smaatunet", dev, axis)
        torch.save(out, f"{spec['out']}.{spec['rank']}")
    finally:
        dist.destroy_process_group()
    return 0


def phase_fsdp(tmp):
    """FSDP / ZeRO-3 over the data axis (``parallel/fsdp.py``) on the one
    card: two ranks over gloo, both on ``cuda:0`` (``chip_smoke.py
    --fsdp-child``; NCCL takes one rank a card), each with 16 rows of every
    global batch of 32, every leaf of at least FSDP_MIN elements and its
    Adam moments cut in two:

    - the published DCGAN (ndf 64, default body, dropout 0.01,
      GAN_DP_STEPS Adam steps) and final_smaatunet's model (DP_STEPS Adam
      steps, K3 18 + 18 a step on each rank): against the same ranks'
      data axis without FSDP (bit for bit at two ranks: one addition a
      sum, whichever collective makes it; Adam acts elementwise) and
      against one process in float64 by ``utils/compare.py``, within 10x
      the widest distance from it of the one-process float32 run and its
      twin (the references of the data_parallel and gan_data_parallel
      phases, computed once);
    - each rank's parameters and Adam's moments in bytes: 12 x JAX's
      per-rank elements at D = 2 (FSDP_ELEMENTS), against 12 x the full
      count without FSDP;
    - FD's and TD's working weights left unrefreshed after their step
      (stage 5 then trains G against the discriminators before it) must
      miss the bound by more than 10x."""
    import torch

    from extended_gan_torch.utils.compare import (
        drift,
        held_to_reference,
        widest,
    )

    t_phase = time.perf_counter()
    card = card_line()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = os.path.join(tmp, "fsdp")
    ranks = [_spawn("--fsdp-child", dict(rank=r, size=2, out=out,
                                         store=os.path.join(tmp, "store")))
             for r in range(2)]
    refs = {}
    for name, run, twin_kw in (("dcgan", _gan_dp_run, dict(perturb=True)),
                               ("final_smaatunet", _dp_run,
                                dict(permute=True))):
        want = _cached(run, name, dev, float64=True)[0]
        one = _cached(run, name, dev)[0]
        twin = _cached(run, name, dev, **twin_kw)[0]
        refs[name] = (want, {g: widest(drift(t[g], want[g])
                                       for t in (one, twin))
                             for g in want})

    def held(got, name):
        want, floors = refs[name]
        return {g: held_to_reference(got[g], want[g], floors[g])
                for g in want}

    for r, p in enumerate(ranks):
        _finished(p, f"fsdp rank {r}")
    got = [torch.load(f"{out}.{r}", weights_only=False) for r in range(2)]
    verdicts, against_dp, nbytes = {}, {}, {}
    for name in FSDP_ELEMENTS:
        fs0, fs1 = got[0][f"{name} fsdp"][0], got[1][f"{name} fsdp"][0]
        check(all(torch.equal(a, b) for g in fs0
                  for a, b in zip(fs0[g], fs1[g])),
              f"fsdp {name}: the two ranks' states differ")
        verdicts[name] = held(fs0, name)
        check(all(v["ok"] for v in verdicts[name].values()),
              f"fsdp {name}: two FSDP ranks against one process in "
              f"float64 {verdicts[name]}")
        dp = got[0][name][0]
        against_dp[name] = all(held_to_reference(fs0[g], dp[g])["bitwise"]
                               for g in fs0)
        if name == "dcgan":
            per_rank = [got[r][f"{name} fsdp"][2] for r in range(2)]
        else:
            per_rank = [[got[r][f"{name} fsdp"][2]["bytes"]]
                        for r in range(2)]
        for r, nets in enumerate(per_rank):
            for b, elements in zip(nets, FSDP_ELEMENTS[name]):
                check(b["params"] + b["moments"] == 12 * elements,
                      f"fsdp {name} rank {r}: {b} bytes, expected "
                      f"{12 * elements} (JAX's {elements} elements at D = 2)")
        nbytes[name] = [b["params"] + b["moments"] for b in per_rank[0]]
    fault = held(got[0]["dcgan stale_d"][0], "dcgan")
    fault_x = max(v["worst"] for v in fault.values())
    check(fault_x > 10.0, f"fsdp: stale D misses the bound by only "
          f"{fault_x:.2f}x: {fault}")
    launches = [got[r]["launches"] for r in range(2)]
    for r, counts in enumerate(launches):
        for kernel in ("dsconv_fwd", "dsconv_bwd"):
            check(counts.get(kernel) == 18 * DP_STEPS,
                  f"fsdp final_smaatunet rank {r}: {kernel} launched "
                  f"{counts.get(kernel)}, expected 18 x {DP_STEPS}")
    ms = {name: statistics.mean(got[0][f"{name} fsdp"][1][1:]
                                if name == "dcgan" else
                                got[0][f"{name} fsdp"][2]["step_ms"][1:])
          for name in FSDP_ELEMENTS}
    dp_ms = {name: statistics.mean(got[0][name][1][1:] if name == "dcgan"
                                   else got[0][name][2]["step_ms"][1:])
             for name in FSDP_ELEMENTS}
    seconds = time.perf_counter() - t_phase
    print(f"[fsdp] two gloo ranks on cuda:0, 16 rows each of batches of 32, "
          f"leaves of at least {FSDP_MIN} elements cut in two, against one "
          f"process in float64: "
          + "; ".join(f"{n} {g} gap {v['gap']:.3e}, {v['worst']:.3f} of its "
                      f"bound (floor {v['floor']:.3e})"
                      for n, vs in verdicts.items() for g, v in vs.items())
          + "; against the data axis without FSDP: "
          + "; ".join(f"{n} {'bit for bit' if b else 'not bit for bit'}"
                      for n, b in against_dp.items())
          + "; rank 0's parameters and Adam moments: "
          + "; ".join(f"{n} {b} bytes against {[12 * e for e in FSDP_FULL[n]]}"
                      for n, b in nbytes.items())
          + f"; stale D (no gather after D's step) at {fault_x:.1f}x the "
          f"bound; K3 a rank {launches[0]}; ms a step (host clock, "
          f"synchronised, past the first, two ranks sharing the card): "
          + "; ".join(f"{n} FSDP {ms[n]:.3f}, data axis {dp_ms[n]:.3f}"
                      for n in ms)
          + f"; phase {seconds:.1f} s; {card}")
    return dict(verdicts=verdicts, against_dp=against_dp, bytes=nbytes,
                fault=fault_x, ms=ms, dp_ms=dp_ms, seconds=seconds,
                launches={f"fsdp: final_smaatunet FSDP {DP_STEPS} Adam "
                          f"steps, gloo rank {r} of 2": c
                          for r, c in enumerate(launches)})


# the tp phase: a model axis of 2 (data 1), JAX's default rule (leaves of
# at least 256 output channels cut); each rank's parameters (JAX's rule on
# the CPU: tests/test_torch_port_tp.py), x 4 bytes and x 12 with Adam's
# two moments
TP_MIN = 256
TP_ELEMENTS = {"dcgan": (13_240, 1_455_872, 1_459_968),
               "final_smaatunet": (2_184_228,)}


def tp_child(spec_json):
    """One gloo rank of :func:`phase_tp` on ``cuda:0``, model index
    ``rank`` of a model axis of 2: the DCGAN's steps with FD's and TD's
    wide convs cut, final_smaatunet's with its 23 wide leaves cut (this
    rank's kernel launches counted over those steps alone), and
    final_smaatunet's with the gd all-reduce dropped and the DCGAN's with
    the dx all-reduce dropped, saved to ``<out>.<rank>``."""
    import torch
    import torch.distributed as dist

    from extended_gan_torch import ops
    from extended_gan_torch.parallel import data_axis_for

    spec = json.loads(spec_json)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method="file://" + spec["store"],
                            rank=spec["rank"], world_size=spec["size"])
    try:
        axis = data_axis_for(1, torch.device("cuda", 0),
                             model_axis=spec["size"])
        dev = axis.device
        out = {"dcgan": _gan_dp_run("dcgan", dev, axis, tp=TP_MIN)}
        _reset_launches()  # this rank's TP path
        out["final_smaatunet"] = _dp_run("final_smaatunet", dev, axis,
                                         tp=TP_MIN, grads=True)
        out["launches"] = ops.launch_counts()
        out["gd dropped"] = _dp_run("final_smaatunet", dev, axis, tp=TP_MIN,
                                    tp_fault=True, grads=True)
        out["dx dropped"] = _gan_dp_run("dcgan", dev, axis, tp=TP_MIN,
                                        tp_fault=True)
        torch.save(out, f"{spec['out']}.{spec['rank']}")
    finally:
        dist.destroy_process_group()
    return 0


def _k3_blocks():
    """K3's forward at each rank's output channels of the final_smaatunet
    shapes whose pointwise leaf a model axis of 2 cuts (Cout >= TP_MIN):
    each block against ``reference_dsc`` on the same block, within the
    dsconv phase's limit, and the two blocks side by side against the
    whole layer's; returns (shapes held, worst abs err, worst err / limit,
    the largest shape's block ms and its whole layer's ms)."""
    import math

    import torch

    from extended_gan_torch.models.smaat_unet import dsc_shapes
    from extended_gan_torch.ops import dsconv as k3

    held, worst, ratio, ms = 0, 0.0, 0.0, None
    shapes = dsc_shapes()
    for i, shape in enumerate(shapes):
        n, h, w, c, ck, cout = shape
        if cout < TP_MIN:
            continue
        x, dw, dwb, pw, pwb = dsc_inputs(shape, i)
        per = cout // 2
        with torch.no_grad():
            whole = k3.reference_dsc(x, dw, dwb, pw, pwb)
            blocks = []
            for r in range(2):
                own = slice(r * per, (r + 1) * per)
                args = (x, dw, dwb, pw[:, own].contiguous(),
                        pwb[own].contiguous())
                got = k3._launch(*args)[0]
                want = k3.reference_dsc(*args)
                scale = k3.reference_dsc(*(t.abs() for t in args))
                tol = DSC_TOL_UNITS * math.sqrt(9 + ck) * scale
                err = (got - want).abs()
                check(bool((err <= tol).all()),
                      f"tp: K3 on rank {r}'s {per} output channels of "
                      f"{shape} disagrees with reference_dsc: max abs err "
                      f"{err.max().item():.3e}")
                worst = max(worst, err.max().item())
                ratio = max(ratio, (err / tol).max().item())
                blocks.append(got)
            side = torch.cat(blocks, -1)
            tol = DSC_TOL_UNITS * math.sqrt(9 + ck) * k3.reference_dsc(
                *(t.abs() for t in (x, dw, dwb, pw, pwb)))
            check(bool(((side - whole).abs() <= tol).all()),
                  f"tp: K3's two blocks of {shape} side by side disagree "
                  "with the whole layer")
        if ms is None or shape[0] * shape[1] * shape[2] * ck * cout > ms[0]:
            block = (x, dw, dwb, pw[:, :per].contiguous(),
                     pwb[:per].contiguous())
            ms = (shape[0] * shape[1] * shape[2] * ck * cout, shape,
                  time_ms(lambda: k3._launch(*block)),
                  time_ms(lambda: k3._launch(x, dw, dwb, pw, pwb)))
        held += 1
    return held, worst, ratio, ms[1:]


def phase_tp(tmp):
    """Tensor parallelism over a model axis (``parallel/tensor.py``) on the
    one card: two ranks over gloo, both on ``cuda:0`` (``chip_smoke.py
    --tp-child``; NCCL takes one rank a card), a model axis of 2 and a data
    axis of 1, each rank with every row of every global batch of 32 and
    its block of output channels of every conv kernel JAX's rule cuts
    (TP_MIN channels and more):

    - the published DCGAN (ndf 64, default body, dropout 0.01,
      GAN_DP_STEPS Adam steps; FD's and TD's Conv_2 and Conv_3 cut) and
      final_smaatunet's model (DP_STEPS Adam steps; 23 depthwise-separable
      leaves cut, K3 18 + 18 a step on each rank, its forward on the
      rank's output channels): against one process in float64 by
      ``utils/compare.py``, within 10x the widest distance from it of the
      one-process float32 run and its twin (the data-parallel phases'
      references, computed once);
    - each rank's parameters and Adam's moments in bytes: 12 x JAX's
      per-rank elements at M = 2 (TP_ELEMENTS);
    - final_smaatunet with the all-reduce of gd over the model axis
      dropped, and the DCGAN with its cut convs' all-reduce of dx
      dropped, must each miss the bound by more than 10x (the UNet's on
      its first step's gradients, which its references hold too);
    - K3's forward at each rank's block of the cut shapes against its
      plain twin (:func:`_k3_blocks`)."""
    import torch

    from extended_gan_torch.utils.compare import (
        drift,
        held_to_reference,
        widest,
    )

    t_phase = time.perf_counter()
    card = card_line()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = os.path.join(tmp, "tp")
    ranks = [_spawn("--tp-child", dict(rank=r, size=2, out=out,
                                       store=os.path.join(tmp, "store")))
             for r in range(2)]
    blocks = _k3_blocks()
    refs = {}
    # final_smaatunet's references also hold the first step's gradients,
    # where the gd fault shows (Adam's steps hide a gradient's scale)
    for name, run, kw, twin_kw in (
            ("dcgan", _gan_dp_run, {}, dict(perturb=True)),
            ("final_smaatunet", _dp_run, dict(grads=True),
             dict(permute=True))):
        want = _cached(run, name, dev, float64=True, **kw)[0]
        one = _cached(run, name, dev, **kw)[0]
        twin = _cached(run, name, dev, **kw, **twin_kw)[0]
        refs[name] = (want, {g: widest(drift(t[g], want[g])
                                       for t in (one, twin))
                             for g in want})

    def held(got, name):
        want, floors = refs[name]
        return {g: held_to_reference(got[g], want[g], floors[g])
                for g in want}

    for r, p in enumerate(ranks):
        _finished(p, f"tp rank {r}")
    got = [torch.load(f"{out}.{r}", weights_only=False) for r in range(2)]
    verdicts, nbytes = {}, {}
    for name in TP_ELEMENTS:
        s0, s1 = got[0][name][0], got[1][name][0]
        check(all(torch.equal(a, b) for g in s0 for a, b in zip(s0[g], s1[g])),
              f"tp {name}: the two ranks' full states differ")
        verdicts[name] = held(s0, name)
        check(all(v["ok"] for v in verdicts[name].values()),
              f"tp {name}: two model ranks against one process in float64 "
              f"{verdicts[name]}")
        per_rank = [got[r][name][2] if name == "dcgan"
                    else [got[r][name][2]["bytes"]] for r in range(2)]
        for r, nets in enumerate(per_rank):
            for b, elements in zip(nets, TP_ELEMENTS[name]):
                check(b["params"] + b["moments"] == 12 * elements,
                      f"tp {name} rank {r}: {b} bytes, expected "
                      f"{12 * elements} (JAX's {elements} elements at M = 2)")
        nbytes[name] = [b["params"] + b["moments"] for b in per_rank[0]]
    faults = {}
    for name, model in (("gd dropped", "final_smaatunet"),
                        ("dx dropped", "dcgan")):
        fault = held(got[0][name][0], model)
        faults[name] = max(v["worst"] for v in fault.values())
        check(faults[name] > 10.0, f"tp {model}: the {name.split()[0]} "
              f"all-reduce dropped misses the bound by only "
              f"{faults[name]:.2f}x: {fault}")
    launches = [got[r]["launches"] for r in range(2)]
    for r, counts in enumerate(launches):
        for kernel in ("dsconv_fwd", "dsconv_bwd"):
            check(counts.get(kernel) == 18 * DP_STEPS,
                  f"tp final_smaatunet rank {r}: {kernel} launched "
                  f"{counts.get(kernel)}, expected 18 x {DP_STEPS}")
    ms = {"dcgan": statistics.mean(got[0]["dcgan"][1][1:]),
          "final_smaatunet": statistics.mean(
              got[0]["final_smaatunet"][2]["step_ms"][1:])}
    n_blocks, k3_err, k3_ratio, (shape, block_ms, whole_ms) = blocks
    seconds = time.perf_counter() - t_phase
    print(f"[tp] two gloo ranks on cuda:0 as a model axis of 2, every row of "
          f"batches of 32, conv kernels of at least {TP_MIN} output channels "
          f"cut, against one process in float64: "
          + "; ".join(f"{n} {g} gap {v['gap']:.3e}, {v['worst']:.3f} of its "
                      f"bound (floor {v['floor']:.3e})"
                      for n, vs in verdicts.items() for g, v in vs.items())
          + "; rank 0's parameters and Adam moments: "
          + "; ".join(f"{n} {b} bytes against "
                      f"{[12 * e for e in FSDP_FULL[n]]}"
                      for n, b in nbytes.items())
          + "; " + ", ".join(f"{n} at {x:.1f}x the bound"
                             for n, x in faults.items())
          + f"; K3 a rank {launches[0]}; K3 forward on each rank's output "
          f"channels at {n_blocks} shapes within {k3_ratio:.3f} of its limit (max abs "
          f"err {k3_err:.3e}), {shape} one block {block_ms:.4f} ms against "
          f"{whole_ms:.4f} ms whole; ms a step (host clock, synchronised, "
          f"past the first, two ranks sharing the card): "
          + "; ".join(f"{n} {v:.3f}" for n, v in ms.items())
          + f"; phase {seconds:.1f} s; {card}")
    return dict(verdicts=verdicts, bytes=nbytes, faults=faults, ms=ms,
                k3_blocks=dict(shapes=n_blocks, max_abs_err=k3_err,
                               of_limit=k3_ratio, shape=shape,
                               block_ms=block_ms, whole_ms=whole_ms),
                seconds=seconds,
                launches={f"tp: final_smaatunet TP {DP_STEPS} Adam steps, "
                          f"gloo rank {r} of a model axis of 2": c
                          for r, c in enumerate(launches)})


def _route_counts():
    from extended_gan_torch import ops

    return {**{f"{n} kernel": c for n, c in ops.launch_counts().items()},
            **{f"{n} plain": c for n, c in ops.plain_routes().items()}}


def _routed(fn, *args):
    """``fn(*args)`` on the card; returns (its result, the kernel launches
    and plain routes it made)."""
    before = _route_counts()
    out = fn(*args)
    import torch

    torch.cuda.synchronize()
    return out, {n: c - before[n] for n, c in _route_counts().items()
                 if c != before[n]}


def _fwd_bwd(fn, inputs, seed):
    """``fn``'s output and the gradients of <output, a seeded cotangent>
    with respect to every input, as float64 on the CPU."""
    import torch

    inputs = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*inputs)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(seed),
                    dtype=torch.float64).to(out.device, out.dtype)
    grads = torch.autograd.grad(out, inputs, g)
    return [t.detach().to("cpu", torch.float64) for t in (out, *grads)]


def _rel_err(got, want):
    return max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
               for a, b in zip(got, want))


def phase_shape_routes():
    """K3 and K1 at shapes past each of their kernels' limits: the
    forwards on their kernels (K3's unstaged taps, K1's run-time-M kernel),
    the backwards the kernels cannot take routed to the plain versions on
    the card (the JAX package's backwards are plain): each call's forward
    and backward against float64 on the CPU within ROUTE_TOL of each
    tensor's largest entry, its routes counted as the rules predict; the
    published UNet (final_smaatunet's model, kpl 2) trains one SGD step at
    288x288 and at 336x336, one window of 6 vertices: its 18 DSC forwards
    on the kernel and its 18 backwards split between the kernel and plain
    routes as ``dsconv.bwd_takes`` predicts from ``dsc_shapes``, its state
    held to the plain twin's float64 step within 10x the plain twin's
    float32-to-float64 distance."""
    import torch

    from extended_gan_torch.models.registry import build_model
    from extended_gan_torch.models.smaat_unet import dsc_shapes
    from extended_gan_torch.ops import dsconv as k3
    from extended_gan_torch.ops import gat_attention as k1
    from extended_gan_torch.train.gat_trainer import make_gat_train_step
    from extended_gan_torch.utils.compare import drift, held_to_reference

    t_phase = time.perf_counter()
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    results, times = {}, {}
    for i, (label, (n, h, w, c, kpl, cout)) in enumerate(ROUTE_DSC.items()):
        gen = torch.Generator().manual_seed(40 + i)
        cpu = [torch.rand(shape, generator=gen, dtype=torch.float64) - 0.5
               for shape in ((n, h, w, c), (3, 3, c * kpl), (c * kpl,),
                             (c * kpl, cout), (cout,))]
        want = _fwd_bwd(k3.fused_dsconv, cpu, i)
        got, routes = _routed(_fwd_bwd, k3.fused_dsconv,
                              [t.float().cuda() for t in cpu], i)
        expect = {"dsconv_fwd kernel": 1,
                  ("dsconv_bwd kernel" if k3.bwd_takes(n, h, w, c, c * kpl)
                   else "dsconv_bwd plain"): 1}
        err = _rel_err(got, want)
        check(routes == expect and err <= ROUTE_TOL,
              f"shape_routes K3 {label}: routes {routes} (expected "
              f"{expect}), error {err:.3e} of the largest entry")
        results[f"K3 {label}"] = (
            routes | {"staged": k3.fwd_stages(w)}, err)
        xs = [t.float().cuda() for t in cpu]
        with torch.no_grad():
            times[f"K3 {label}"] = (
                time_ms(lambda: k3.fused_dsconv(*xs), **ROUTE_TIMING),
                time_ms(lambda: k3.reference_dsc(*xs), **ROUTE_TIMING))
    for i, (label, (nh, b, mm, g, sz)) in enumerate(ROUTE_K1.items()):
        gen = torch.Generator().manual_seed(50 + i)
        m = torch.rand((nh, b, mm, g * sz), generator=gen,
                       dtype=torch.float64) - 0.5
        a = torch.rand((nh, 2 * g), generator=gen, dtype=torch.float64) - 0.5
        adj = torch.softmax(torch.rand((nh, mm, mm), generator=gen,
                                       dtype=torch.float64), -1)

        def attend(m, a, adj):
            return k1.fused_gat_attention(m, a, adj, 0.2, sz)[0]

        want = _fwd_bwd(attend, [m, a, adj], i)
        got, routes = _routed(_fwd_bwd, attend,
                              [t.float().cuda() for t in (m, a, adj)], i)
        expect = {"gat_attention_fwd kernel": 1,
                  ("gat_attention_bwd kernel" if k1.bwd_takes(mm, g)
                   else "gat_attention_bwd plain"): 1}
        err = _rel_err(got, want)
        check(routes == expect and err <= ROUTE_TOL,
              f"shape_routes K1 {label}: routes {routes} (expected "
              f"{expect}), error {err:.3e} of the largest entry")
        results[f"K1 {label}"] = (routes, err)
        m32, a32, adj32 = (t.float().cuda() for t in (m, a, adj))
        w1, w2 = k1._group_rows(a32, sz)
        times[f"K1 {label}"] = (
            time_ms(lambda: attend(m32, a32, adj32), **ROUTE_TIMING),
            time_ms(lambda: k1.reference_impl(m32, w1, w2, adj32[:, None],
                                              0.2, sz), **ROUTE_TIMING))
    unets = {}
    for hw in ROUTE_UNETS:
        shapes = dsc_shapes(batch=1, hw=hw, vertices=6)
        bwd = sum(k3.bwd_takes(*s[:5]) for s in shapes)
        expect = {"dsconv_fwd kernel": 18, "dsconv_bwd kernel": bwd,
                  "dsconv_bwd plain": 18 - bwd}
        gen = torch.Generator().manual_seed(hw)
        x, y = (torch.rand((1, hw, hw, 4, 6), generator=gen)
                for _ in range(2))
        states = {}
        for kind, dtype, pallas in (("kernel", torch.float32, True),
                                    ("plain", torch.float32, False),
                                    ("plain f64", torch.float64, False)):
            model = build_model("unet", image_width=hw, image_height=hw,
                                n_vertices=6, mapping_type="linear",
                                device="cuda", use_pallas=pallas,
                                generator=torch.Generator().manual_seed(0))
            model.to(dtype)
            step = make_gat_train_step(
                model, torch.optim.SGD(model.parameters(), lr=0.01))
            (loss, _), routes = _routed(step, *(
                t.to("cuda", dtype) for t in (x, y, torch.ones(1))))
            check(math.isfinite(float(loss)),
                  f"shape_routes UNet {hw}x{hw} {kind}: loss {loss}")
            if kind == "kernel":
                check({k: v for k, v in expect.items() if v} == routes,
                      f"shape_routes UNet {hw}x{hw}: routes {routes}, "
                      f"expected {expect}")
                unets[hw] = routes
            states[kind] = [t.detach().cpu().clone()
                            for t in model.state_dict().values()
                            if t.is_floating_point()]
            del model, step
        v = held_to_reference(states["kernel"], states["plain f64"],
                              drift(states["plain"], states["plain f64"]))
        check(v["ok"], f"shape_routes UNet {hw}x{hw}: kernel path against "
                       f"the plain float64 step {v}")
        results[f"UNet {hw}x{hw}"] = (unets[hw] | {"unstaged forwards": sum(
            not k3.fwd_stages(sh[2]) for sh in shapes)}, v["worst"])
    seconds = time.perf_counter() - t_phase
    print("[shape_routes] past each limit, on the card, against float64 "
          f"(error of the largest entry, limit {ROUTE_TOL:g}; the UNets' "
          "state of their bound): "
          + "; ".join(f"{k}: {r} {e:.3e}" for k, (r, e) in results.items())
          + "; forward ms (device, median), kernel against the plain "
          "version on the card: "
          + "; ".join(f"{k}: {t[0]:.4f} against {t[1]:.4f}"
                      for k, t in times.items())
          + f"; phase {seconds:.1f} s; {card}", flush=True)
    return dict(results=results, times=times, seconds=seconds)


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
    if sys.argv[1:2] == ["--robustness-child"]:
        return robustness_child(sys.argv[2])
    if sys.argv[1:2] == ["--host-data-child"]:
        return host_data_child(sys.argv[2])
    if sys.argv[1:2] == ["--dp-child"]:
        return dp_child(sys.argv[2])
    if sys.argv[1:2] == ["--dp-cli-child"]:
        return dp_cli_child(sys.argv[2])
    if sys.argv[1:2] == ["--gan-dp-child"]:
        return gan_dp_child(sys.argv[2])
    if sys.argv[1:2] == ["--gan-dp-cli-child"]:
        return gan_dp_cli_child(sys.argv[2])
    if sys.argv[1:2] == ["--ep-child"]:
        return ep_child(sys.argv[2])
    if sys.argv[1:2] == ["--fsdp-child"]:
        return fsdp_child(sys.argv[2])
    if sys.argv[1:2] == ["--tp-child"]:
        return tp_child(sys.argv[2])
    t0 = time.perf_counter()
    try:
        build_logs = phase_build()
        rows, worst, k1_bwd_rows = phase_kernels(build_logs)
        dsc_rows, dsc_worst, dsc_bwd_worst = phase_dsconv()
        routes = phase_shape_routes()
        k2_fwd_rows, k2_bwd_rows = phase_mapping(build_logs)
        launches, models = phase_serve()
        phase_forward(models)
        train_launches = phase_train()
        k2_model = phase_mapping_model()
        family = phase_family()
        dcgan_out = tempfile.mkdtemp(prefix="smoke_dcgan_")
        try:
            phase_dcgan(dcgan_out)
            extras = phase_serve_extras(dcgan_out)
        finally:
            shutil.rmtree(dcgan_out, ignore_errors=True)
        mega_tmp = tempfile.mkdtemp(prefix="smoke_megastep_")
        try:
            mega = phase_megastep(mega_tmp)
        finally:
            shutil.rmtree(mega_tmp, ignore_errors=True)
        robust_tmp = tempfile.mkdtemp(prefix="smoke_robustness_")
        try:
            robust = phase_robustness(robust_tmp)
        finally:
            shutil.rmtree(robust_tmp, ignore_errors=True)
        new_paths = {}
        for name, phase in (("cyclegan", phase_cyclegan),
                            ("vanilla_gan", phase_vanilla_gan)):
            tmp = tempfile.mkdtemp(prefix=f"smoke_{name}_")
            try:
                new_paths[name] = phase(tmp)["launches"]
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
        variants_tmp = tempfile.mkdtemp(prefix="smoke_gan_variants_")
        try:
            variants = phase_gan_variants(variants_tmp)
        finally:
            shutil.rmtree(variants_tmp, ignore_errors=True)
        slice18 = {}
        for name, phase in (("moe", phase_moe),
                            ("preprocess", phase_preprocess)):
            tmp = tempfile.mkdtemp(prefix=f"smoke_{name}_")
            try:
                slice18[name] = phase(tmp)
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
        slice19 = {}
        for name, phase in (("figures", phase_figures),
                            ("data_parallel", phase_data_parallel),
                            ("gan_data_parallel", phase_gan_data_parallel),
                            ("expert_parallel", phase_expert_parallel),
                            ("fsdp", phase_fsdp), ("tp", phase_tp)):
            tmp = tempfile.mkdtemp(prefix=f"smoke_{name}_")
            try:
                slice19[name] = phase(tmp)
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
        host_tmp = tempfile.mkdtemp(prefix="smoke_host_data_")
        try:
            host = run_host_data(host_tmp)
        finally:
            shutil.rmtree(host_tmp, ignore_errors=True)
        # every plain route of this process was a shape_routes call: no
        # published config's path took one
        from extended_gan_torch import ops

        routed = {n: sum(r.get(f"{n} plain", 0)
                         for r, _ in routes["results"].values())
                  for n in ops.plain_routes()}
        check(ops.plain_routes() == routed,
              f"plain routes in this process {ops.plain_routes()}, of "
              f"which the shape_routes phase made {routed}")
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
        "serve final_temp_smaat": family["serve"],
        "serve final_temp_conv w8, and predict": extras["k1_launches"]}
    k1_family_bwd = {
        "final_temp_smaat train steps b=32, kernel path":
            family["train"]["launched"]["gat_attention_bwd"],
        "train final_temp_smaat":
            family["cli"]["final_temp_smaat"]["gat_attention_bwd"]}
    # K1, K2 and K3 inside CUDA graphs: the resident CLI run and the
    # in-process megasteps (3 programs each: eager, captured, replayed)
    graphs = mega["results"]
    for name in ("gat_attention_fwd", "gat_attention_bwd"):
        (k1_family_fwd if name.endswith("fwd") else k1_family_bwd).update({
            "train final_temp_conv --resident --megastep 8 (CLI)":
                mega["cli_launches"][name],
            "train final_temp_conv --megastep 8, streaming (CLI)":
                mega["stream"]["gat"][name],
            "megastep final_temp_conv resident, 3 programs":
                graphs["final_temp_conv"]["launched"][name],
            "megastep final_temp_conv resident use_pallas_mapping=True, "
            "3 programs": graphs["final_temp_conv switched"]["launched"][name],
            "megastep final_temp_smaat, 3 programs":
                graphs["final_temp_smaat"]["launched"][name]})
    # the robustness phase: this process's resumes and uninterrupted runs,
    # bf16 and remat steps (the cut runs' children count their own)
    robust_path = "robustness: resume, bf16, remat (in process)"
    robust_launches = robust["main_path"]
    for name in ("gat_attention_fwd", "gat_attention_bwd"):
        (k1_family_fwd if name.endswith("fwd") else k1_family_bwd)[
            robust_path] = robust_launches.get(name, 0)
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
        "launches": (train_launches["dsconv_fwd"] + extras["k3_launches"]
                     + graphs["final_smaatunet"]["launched"]["dsconv_fwd"]
                     + robust_launches.get("dsconv_fwd", 0)),
        "launches_by_path": {
            "train final_smaatunet": train_launches["dsconv_fwd"],
            "unet train steps b=32, kernel path":
                train_launches["unet_train_step"]["dsconv_fwd"],
            "serve final_smaatunet w8": extras["k3_launches"],
            "megastep final_smaatunet, 3 programs":
                graphs["final_smaatunet"]["launched"]["dsconv_fwd"],
            robust_path: robust_launches.get("dsconv_fwd", 0)},
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
        # one model rank's half of the output channels under TP (the tp
        # phase), against the plain version on the same block
        "tp_block": slice19["tp"]["k3_blocks"],
        "shape": "N=%d %dx%d C=%d CK=%d Cout=%d (final_smaatunet b=32, "
                 "up4 dsc0)" % dsc_main["shape"],
    }, {
        "name": "dsconv_bwd",
        "route": "cuda",
        "source": "extended_gan_torch/ops/csrc/dsconv.cu",
        # the JAX _bwd is jax.vjp of _reference_dsc, not a Pallas kernel
        "replaces": "extended_gan_tpu/ops/pallas/dsconv.py:324",
        "launches": (train_launches["dsconv_bwd"]
                     + graphs["final_smaatunet"]["launched"]["dsconv_bwd"]
                     + robust_launches.get("dsconv_bwd", 0)),
        "launches_by_path": {
            "train final_smaatunet": train_launches["dsconv_bwd"],
            "unet train steps b=32, kernel path":
                train_launches["unet_train_step"]["dsconv_bwd"],
            "megastep final_smaatunet, 3 programs":
                graphs["final_smaatunet"]["launched"]["dsconv_bwd"],
            robust_path: robust_launches.get("dsconv_bwd", 0)},
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
                   "megastep final_temp_conv resident "
                   "use_pallas_mapping=True, 3 programs":
                   graphs["final_temp_conv switched"]["launched"][name],
                   robust_path: robust_launches.get(name, 0),
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
    # the CycleGAN and vanilla GAN paths (slice 15) launch none of them
    for k in kernels:
        k["launches_by_path"].update({
            f"{name} phase (CLI and in process)": counts[k["name"]]
            for name, counts in new_paths.items()})
    # the gan_variants phase: K3 in the per-vertex and
    # transposed-conv UNets; none of them on the DCGAN bodies, the packed
    # generators and their CLIs and exports
    for k in kernels:
        by_path = {path: counts[k["name"]]
                   for path, counts in variants["launches"].items()}
        k["launches_by_path"].update(by_path)
        k["launches"] += sum(by_path.values())
    # the moe phase (K3 18 + 18 a step on the MoE UNet's paths) and the
    # preprocess phase (K1 on the ARAI training run)
    for k in kernels:
        by_path = {path: counts.get(k["name"], 0)
                   for result in slice18.values()
                   for path, counts in result["launches"].items()}
        k["launches_by_path"].update(by_path)
        k["launches"] += sum(by_path.values())
    # the figures phase (K3 and K1 forwards of compare_models' evals and
    # panels, create_plots and the short CLI epochs) and the data_parallel
    # phase (each gloo rank's own steps: K3 18 + 18 and K1 2 + 2 a step; the
    # NCCL world of one through the CLI)
    dp = slice19["data_parallel"]
    for k in kernels:
        by_path = {path: counts.get(k["name"], 0) for path, counts in
                   slice19["figures"]["launches"].items()}
        for name, (r0, r1) in dp["rank_launches"].items():
            by_path[f"data_parallel: {name}, gloo rank 0 of 2"] = \
                r0.get(k["name"], 0)
            by_path[f"data_parallel: {name}, gloo rank 1 of 2"] = \
                r1.get(k["name"], 0)
        by_path["data_parallel: train final_temp_conv --multihost, NCCL "
                "world of one"] = dp["cli_launches"]["multihost"].get(
                    k["name"], 0)
        # the gan_data_parallel phase: the CLIs' --megastep 8 --resident
        # runs as an NCCL world of one (an eager program, a replayed one)
        for name, counts in slice19["gan_data_parallel"][
                "cli_launches"].items():
            by_path[f"gan_data_parallel: {name} --megastep 8 --resident, "
                    "NCCL world of one"] = counts.get(k["name"], 0)
        k["launches_by_path"].update(by_path)
        k["launches"] += sum(by_path.values())
    # the fsdp and tp phases: each gloo rank's final_smaatunet FSDP steps
    # and TP steps (K3 18 + 18 a step; under TP its forward on the rank's
    # output channels)
    for k in kernels:
        by_path = {path: counts.get(k["name"], 0) for phase in ("fsdp", "tp")
                   for path, counts in slice19[phase]["launches"].items()}
        k["launches_by_path"].update(by_path)
        k["launches"] += sum(by_path.values())
    # the expert_parallel phase (each gloo rank's MoE UNet steps, K3 18 +
    # 18 a step; the MoE CLI under --multihost, an NCCL world of one) and the
    # shape_routes phase: its kernel launches, and the calls it routed to
    # the plain versions (the only plain routes of the run)
    for k in kernels:
        by_path = {path: counts.get(k["name"], 0) for path, counts in
                   slice19["expert_parallel"]["launches"].items()}
        by_path["shape_routes: K3 and K1 past each limit, two UNet steps"] = \
            sum(r.get(f"{k['name']} kernel", 0)
                for r, _ in routes["results"].values())
        k["launches_by_path"].update(by_path)
        k["launches"] += sum(by_path.values())
        k["plain_routes"] = routed.get(k["name"], 0)
    # the host_data phase's CLI epochs (slice 16): K1 2 + 2 a step, K2 and
    # K3 none; the DCGAN and CycleGAN --profile runs none
    for k in kernels:
        by_path = {path: counts[k["name"]]
                   for path, counts in host["launches"].items()}
        by_path["host_data: DCGAN and CycleGAN CLIs --profile"] = sum(
            counts.get(k["name"], 0) for counts in host["gan"].values())
        k["launches_by_path"].update(by_path)
        k["launches"] += sum(by_path.values())
    print(f"[smoke] all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
