"""K1, the fused temporal attention, timed on the card through its public
entry points, for one checkout or several in turns.

  python -m extended_gan_torch.ops.k1_probe [--steps] [--trees DIR ...]
  python -m extended_gan_torch.ops.k1_probe --clusters C [C ...]
  python -m extended_gan_torch.ops.k1_probe --variants

Run from the root of a checkout on one GPU. Without ``--trees`` it times
this checkout's K1; with them it times each named checkout (a directory
holding ``extended_gan_torch/``, e.g. a parent commit unpacked by ``git
archive``) in a process of its own, in the order given, so two versions
can be compared in one call (parent, change, change, parent). Only
``fused_gat_attention``, ``attend_temporal`` and the GAT3D ``Model`` are
called, which every version of the port has. CUDA events, the median of
7 rounds of 10 calls each queued behind a device sleep:

- ``fused_gat_attention`` on (NH, B, M, P) contiguous at the twelve shapes
  of ``chip_smoke.py``'s kernel phase (20x20 and 80x80, B = 1, 8, 32, 1
  and 3 heads);
- ``attend_temporal`` at the same shapes, given ``mapped`` in the two
  layouts the conv mapping hands over: pixel-major (NH, B, H, W, T, V)
  contiguous, which K2 writes, and the cuDNN mapping's view of memory
  ordered (B, V, NH, T, H, W): layout copies included;
- the copy ``permute(0, 1, 4, 5, 2, 3).contiguous()`` alone at the two
  80x80 batch-32 blocks;
- the backward of ``attend_temporal`` (autograd, from the cotangent that
  ``mean(dim=0)`` hands over) at the 80x80 and 20x20 batch-32 blocks, in
  both layouts, with its device kernels a call (profiler);
- with ``--steps``: one final_temp_conv Adam train step at batch 32 with
  ``use_pallas_mapping`` on and off, profiled: device busy time, and the
  device time of the kernels launched inside ``attend_temporal`` and
  inside K1's backward node.

``--clusters`` times this checkout's cluster kernels with the cluster size
forced to each C given, forward and backward (m pixel-major), with the
clusters the grid holds, at 80x80 (B = 32, 8, 1;
3 heads and 1) and 20x20, beside the plan's pick.

``--variants`` builds copies of ``csrc/gat_attention.cu`` with one phase
of a cluster kernel left out, or one setting changed (``VARIANTS``: the
lines to edit are found by their text, and
``tests/test_torch_port_k1_probe.py`` holds each anchor against the
committed source) and times each beside the committed build at the hidden
block (80x80, B = 32, 3 heads, m pixel-major) at C = 8 and 16, unchecked:
what a phase costs is the time it takes away.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

SHAPES = [(hw, b, nh) for hw in (400, 6400) for b in (1, 8, 32)
          for nh in (1, 3)]
_OFF = "if (false) "
# variant -> [(anchor, replacement)]: one phase of a cluster kernel left
# out (the anchor's text occurs once in the committed source)
VARIANTS = {
    "fwd_no_sums": [("    plane_sums_add(acc, buf, L.pixel_major, MG, ld, n);",
                     "    " + _OFF + "plane_sums_add(acc, buf, L.pixel_major,"
                     " MG, ld, n);")],
    "fwd_no_cluster": [
        ("    cluster.sync();\n    cluster_sum(cluster, part, smem + kTot, "
         "MG);",
         "    __syncthreads();\n    for (int q = threadIdx.x; q < MG; q += "
         "kCThreads) smem[kTot + q] = part[q];")],
    "fwd_no_algebra": [("    if (threadIdx.x < 32) {\n      const long long "
                        "small = (long long)e * M * M;",
                        "    if (false) {\n      const long long small = "
                        "(long long)e * M * M;")],
    "fwd_no_columns": [("    for_columns(L.pixel_major, G, n, [&](int v, "
                        "int s) {",
                        "    " + _OFF + "for_columns(L.pixel_major, G, n, "
                        "[&](int v, int s) {")],
    "fwd_no_store": [("    store_slice<VEC>(out + base, buf, L, G, MG, ld, "
                      "s0, n);",
                      "    " + _OFF + "store_slice<VEC>(out + base, buf, L, "
                      "G, MG, ld, s0, n);")],
    "bwd_no_pass1": [("    for_columns(pm, G, cn, [&](int v, int s) {\n"
                      "      const int om = buf_off(pm, MG, ld, v, s);\n"
                      "      const int og = buf_off(pg, MG, ld, v, s);\n"
                      "      float x[M];",
                      "    " + _OFF + "for_columns(pm, G, cn, [&](int v, "
                      "int s) {\n      const int om = buf_off(pm, MG, ld, v, "
                      "s);\n      const int og = buf_off(pg, MG, ld, v, s);\n"
                      "      float x[M];")],
    "bwd_no_pass2": [("    for_columns(pm, G, cn, [&](int v, int s) {\n"
                      "      const int om = buf_off(pm, MG, ld, v, s);\n"
                      "      const int og = buf_off(pg, MG, ld, v, s);\n"
                      "      float d0[M];",
                      "    " + _OFF + "for_columns(pm, G, cn, [&](int v, "
                      "int s) {\n      const int om = buf_off(pm, MG, ld, v, "
                      "s);\n      const int og = buf_off(pg, MG, ld, v, s);\n"
                      "      float d0[M];")],
    "bwd_no_cluster": [
        ("  cluster.sync();  // every rank's partials are written\n  float* "
         "tot = smem + kTot;\n  cluster_sum(cluster, part, tot, MG + mm);",
         "  __syncthreads();\n  float* tot = smem + kTot;\n  for (int q = "
         "threadIdx.x; q < MG + mm; q += kCThreads) tot[q] = part[q];")],
    "bwd_no_store": [("    store_slice<VEC>(dm, bufm, Lm, G, MG, ld, cs, "
                      "cn);",
                      "    " + _OFF + "store_slice<VEC>(dm, bufm, Lm, G, MG, "
                      "ld, cs, cn);")],
}
# not knock-outs: 512 threads a block (the backward then one block an SM);
# the exact expm1 in the forward's ELU; the forward at two blocks an SM
VARIANTS["threads_512"] = [
    ("constexpr int kCThreads = 256;", "constexpr int kCThreads = 512;"),
    ("constexpr int kFwdBlocks = 4, kBwdBlocks = 2;",
     "constexpr int kFwdBlocks = 2, kBwdBlocks = 1;")]
VARIANTS["fwd_expm1"] = [("  return x > 0.f ? x : __expf(x) - 1.f;",
                          "  return x > 0.f ? x : expm1f(x);")]
VARIANTS["fwd_two_blocks"] = [("constexpr int kFwdBlocks = 4, kBwdBlocks = 2;",
                               "constexpr int kFwdBlocks = 2, kBwdBlocks = 2;")]
VARIANTS["fwd_copy_only"] = (VARIANTS["fwd_no_sums"]
                              + VARIANTS["fwd_no_cluster"]
                              + VARIANTS["fwd_no_algebra"]
                              + VARIANTS["fwd_no_columns"])
M, V, ALPHA = 4, 6, 0.2


def _ms(fn, reps=10, rounds=7):
    import torch

    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        fn()
        torch.cuda._sleep(5_000_000)  # hide the host's launches
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)[len(times) // 2]


def _inputs(hw, b, nh, layout, seed):
    """mapped (NH, B, H, W, T, V) in ``layout``, a (NH, 2V), adj (NH, T, T)."""
    import torch

    from extended_gan_torch.models.gat.layers import normalized_adjacency

    side = int(round(hw ** 0.5))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if layout == "pixel":
        mapped = torch.randn(nh, b, side, side, M, V, device="cuda",
                             generator=gen)
    else:  # the cuDNN mapping's output: memory ordered (B, V, NH, T, H, W)
        mapped = torch.randn(b, V, nh, M, side, side, device="cuda",
                             generator=gen).permute(2, 0, 4, 5, 3, 1)
    a = torch.randn(nh, 2 * V, device="cuda", generator=gen)
    adj = normalized_adjacency(torch.rand(nh, M, M, device="cuda",
                                          generator=gen))
    return mapped, a, adj


def _kernels_a_call(fn, n=3):
    """Device kernels a call of ``fn`` (profiler), or None when the
    profiler records no device activity."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    count = sum(e.count for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    return count / n if count else None


def forwards():
    import torch

    from extended_gan_torch.ops import gat_attention as k1

    for hw, b, nh in SHAPES:
        mapped, a, adj = _inputs(hw, b, nh, "pixel", 1000 * nh + b)
        m = mapped.permute(0, 1, 4, 5, 2, 3).reshape(nh, b, M, V * hw)
        m = m.contiguous()
        with torch.no_grad():
            api = _ms(lambda: k1.fused_gat_attention(m, a, adj, ALPHA, hw))
            att = {}
            for layout in ("pixel", "plane"):
                x, a_, adj_ = _inputs(hw, b, nh, layout, 1000 * nh + b)
                att[layout] = _ms(lambda: k1.attend_temporal(x, a_, adj_,
                                                             ALPHA))
        print(f"[k1_probe] forward hw={hw} B={b} heads={nh}: "
              f"fused_gat_attention {api:.4f} ms, attend_temporal pixel-major "
              f"{att['pixel']:.4f} ms, cuDNN view {att['plane']:.4f} ms",
              flush=True)


def copies():
    import torch

    for nh in (3, 1):
        for layout in ("pixel", "plane"):
            mapped, _, _ = _inputs(6400, 32, nh, layout, 1)
            with torch.no_grad():
                ms = _ms(lambda: mapped.permute(0, 1, 4, 5, 2, 3).contiguous())
            print(f"[k1_probe] copy permute(0, 1, 4, 5, 2, 3).contiguous() "
                  f"80x80 B=32 heads={nh}, {layout} source: {ms:.4f} ms",
                  flush=True)


def backwards():
    import torch

    from extended_gan_torch.ops import gat_attention as k1

    for hw in (6400, 400):
        for nh in (3, 1):
            for layout in ("pixel", "plane"):
                mapped, a, adj = _inputs(hw, 32, nh, layout, 7 + nh)
                inputs = [t.requires_grad_() for t in (mapped, a, adj)]
                out = k1.attend_temporal(*inputs, ALPHA)
                cot = torch.randn(out.shape[1:], device="cuda")
                g = torch.autograd.grad(out.mean(dim=0), out, cot,
                                        retain_graph=True)[0]

                def bwd():
                    return torch.autograd.grad(out, inputs, g,
                                               retain_graph=True)
                ms = _ms(bwd)
                kernels = _kernels_a_call(bwd)
                print(f"[k1_probe] backward hw={hw} B=32 heads={nh} "
                      f"{layout}: {ms:.4f} ms, "
                      f"{'not measured' if kernels is None else kernels} "
                      f"device kernels a backward (g strides "
                      f"{tuple(g.stride())})", flush=True)


def steps(batch=32, hw=80, n=3):
    import numpy as np
    import torch

    import extended_gan_torch.models.gat.gat3d as gat3d
    from extended_gan_torch.train.gat_trainer import (
        make_gat_train_step,
        to_device_batch,
    )

    from extended_gan_torch.ops import gat_attention as k1

    attend = gat3d.attend_temporal

    def ranged(*args, **kw):
        with torch.profiler.record_function("k1_probe.attend_temporal"):
            return attend(*args, **kw)
    gat3d.attend_temporal = ranged
    launch_bwd = getattr(k1, "_launch_bwd", None)
    seen = set()
    if launch_bwd:  # the layouts the model hands the backward kernel
        def recorded(x, g, *args):
            seen.add((tuple(x.shape), k1._layout(x), k1._layout(g)))
            return launch_bwd(x, g, *args)
        k1._launch_bwd = recorded
    rng = np.random.default_rng(0)
    data = to_device_batch(rng.random((batch, hw, hw, 4, 6), np.float32),
                           rng.random((batch, hw, hw, 4, 6), np.float32),
                           torch.device("cuda"))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for switched in (True, False):
        model = gat3d.Model(hw, hw, 6, attention_type="temporal",
                            mapping_type="conv", use_pallas=True,
                            use_pallas_mapping=switched,
                            generator=torch.Generator().manual_seed(0))
        model = model.cuda().train()
        step = make_gat_train_step(model, torch.optim.Adam(
            model.parameters(), lr=1e-3))
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            step(*data)
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=acts) as prof:
                for _ in range(n):
                    step(*data)
                torch.cuda.synchronize()
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
        fwd = sum(e.device_time_total for e in prof.events()
                  if e.name == "k1_probe.attend_temporal")
        bwd = sum(e.device_time_total for e in prof.events()
                  if "GatAttentionBackward" in e.name
                  and e.name.startswith("autograd::engine"))
        named = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and "gat_attention" in e.key)
        print(f"[k1_probe] train step final_temp_conv b={batch} "
              f"use_pallas_mapping={switched}: device busy "
              f"{busy / n / 1e3:.4f} ms a step; inside attend_temporal "
              f"{fwd / n / 1e3:.4f} ms, inside K1's backward node "
              f"{bwd / n / 1e3:.4f} ms ("
              + (f"{100 * (fwd + bwd) / busy:.1f}%" if busy else "not measured")
              + f" of busy); kernels named gat_attention* "
              f"{named / n / 1e3:.4f} ms",
              flush=True)
        if seen:
            print(f"[k1_probe] backward kernel inputs (x shape, m layout, g "
                  f"layout): {sorted(seen)}", flush=True)
            seen.clear()
    gat3d.attend_temporal = attend
    if launch_bwd:
        k1._launch_bwd = launch_bwd


def sweep(clusters):
    import functools

    import torch

    from extended_gan_torch.ops import gat_attention as k1

    plan = k1._cluster_plan
    shapes = [(6400, b, nh) for b in (32, 8, 1) for nh in (3, 1)]
    shapes += [(400, 32, 3), (400, 32, 1), (400, 1, 3)]
    for hw, b, nh in shapes:
        mapped, a, adj = _inputs(hw, b, nh, "pixel", 3)
        x = mapped.reshape(nh, b, hw, M, V)
        cot = torch.randn(nh, b, hw, M, V, device="cuda")
        picked = (plan(nh, b, hw, M * V),
                  plan(nh, b, hw, M * V, backward=True))
        for c in clusters:
            k1._cluster_plan = functools.partial(plan, cluster=c)
            fwd_plan = k1._cluster_plan(nh, b, hw, M * V)
            bwd_plan = k1._cluster_plan(nh, b, hw, M * V, backward=True)
            with torch.no_grad():
                fwd = (_ms(lambda: k1._launch_fwd(x, a, adj, ALPHA))
                       if fwd_plan else None)
                res = k1._launch_fwd(x, a, adj, ALPHA)
            bwd = (_ms(lambda: k1._launch_bwd(x, cot, a, adj, *res[1:],
                                              ALPHA))
                   if bwd_plan else None)
            k1._cluster_plan = plan
            grids = [k1._clusters(nh * b, M, V, p[0], p[2], 1 + back, back)
                     if p else None
                     for p, back in ((fwd_plan, False), (bwd_plan, True))]
            print(f"[k1_probe] cluster hw={hw} B={b} heads={nh} pixel-major "
                  f"C={c}: forward "
                  + (f"{fwd:.4f} ms {fwd_plan} {grids[0]} clusters"
                     if fwd else "no plan")
                  + ", backward "
                  + (f"{bwd:.4f} ms {bwd_plan} {grids[1]} clusters"
                     if bwd else "no plan")
                  + f" (the plan picks {picked[0]} / {picked[1]})",
                  flush=True)


def variant_sources(src: str) -> dict[str, str]:
    """Each knock-out variant of the kernel source ``src``; raises where an
    anchor does not occur exactly once."""
    out = {}
    for name, edits in VARIANTS.items():
        text = src
        for anchor, new in edits:
            if text.count(anchor) != 1:
                raise ValueError(f"{name}: anchor {anchor!r} occurs "
                                 f"{text.count(anchor)} times")
            text = text.replace(anchor, new)
        out[name] = text
    return out


def variants():
    import ctypes
    import functools
    import re

    import torch

    from extended_gan_torch.ops import build
    from extended_gan_torch.ops import gat_attention as k1

    out_dir = build.BUILD_DIR.parent / "k1_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / "gat_attention.cu").read_text()
    sources = {"committed": src, **variant_sources(src)}
    procs = {}
    for name, text in sources.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        so = out_dir / f"lib{name}.so"
        procs[name] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        libs[name] = k1.bind(ctypes.CDLL(str(so)))
        for chunk in log.split("Compiling entry function '")[1:]:
            kernel = chunk.split("'", 1)[0]
            if "Li4ELi4E" in kernel and "cluster" in kernel:
                regs = re.search(r"Used (\d+) registers", chunk)
                print(f"[k1_probe] {name}: {kernel[:60]}...: "
                      f"{regs.group(1) if regs else '?'} registers")
    plan, lib0 = k1._cluster_plan, k1._lib
    mapped, a, adj = _inputs(6400, 32, 3, "pixel", 3)
    x = mapped.reshape(3, 32, 6400, M, V)
    cot = torch.randn(3, 32, 6400, M, V, device="cuda")
    with torch.no_grad():
        res = k1._launch_fwd(x, a, adj, ALPHA)
    for fwd_c, bwd_c in ((8, 8), (16, 16)):
        for name, lib in libs.items():
            k1._lib = functools.partial(lambda lib: lib, lib)
            k1._clusters.cache_clear()
            k1._cluster_plan = functools.partial(plan, cluster=fwd_c)
            with torch.no_grad():
                fwd = (_ms(lambda: k1._launch_fwd(x, a, adj, ALPHA))
                       if not name.startswith("bwd") else None)
            k1._cluster_plan = functools.partial(plan, cluster=bwd_c)
            bwd = (_ms(lambda: k1._launch_bwd(x, cot, a, adj, *res[1:],
                                              ALPHA))
                   if not name.startswith("fwd") else None)
            print(f"[k1_probe] variant {name}, C = {fwd_c} forward, {bwd_c} "
                  f"backward: forward " + (f"{fwd:.4f} ms" if fwd else "-")
                  + ", backward " + (f"{bwd:.4f} ms" if bwd else "-"),
                  flush=True)
        k1._cluster_plan, k1._lib = plan, lib0
        k1._clusters.cache_clear()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m "
                                     "extended_gan_torch.ops.k1_probe")
    parser.add_argument("--steps", action="store_true",
                        help="also profile final_temp_conv train steps")
    parser.add_argument("--trees", nargs="+", default=None,
                        help="checkouts to time, each in its own process")
    parser.add_argument("--clusters", nargs="+", type=int, default=None,
                        help="cluster sizes to force (this checkout)")
    parser.add_argument("--variants", action="store_true",
                        help="time builds with one phase left out or one setting changed")
    args = parser.parse_args(argv)
    if args.trees:
        rc = 0
        for tree in args.trees:
            print(f"[k1_probe] === {tree}", flush=True)
            env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
            cmd = [sys.executable, os.path.abspath(__file__)]
            rc |= subprocess.run(cmd + (["--steps"] if args.steps else []),
                                 cwd=tree, env=env).returncode
        return rc
    import torch

    if not torch.cuda.is_available():
        print("k1_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.clusters:
        sweep(args.clusters)
    if args.variants:
        variants()
    if args.clusters or args.variants:
        return 0
    forwards()
    copies()
    backwards()
    if args.steps:
        steps()
    return 0


if __name__ == "__main__":
    sys.exit(main())
