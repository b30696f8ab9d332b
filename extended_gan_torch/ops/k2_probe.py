"""Where K2's kernels spend their time, on the card.

  python -m extended_gan_torch.ops.k2_probe [--mode fwd|bwd|all]

Run from the repo root on one GPU. Builds variants of ``csrc/gat_mapping.cu``
with nvcc into ``build/k2_probe/`` and times them at GAT3D's hidden block (3
heads, 80x80, batch 32, V = 6) and, for the backward, also at its output
block (1 head, with dx):

- ``phases`` / ``bwd_phases``: the kernel with ``clock64()`` read after each
  block-wide barrier of its job loop by thread 0: clocks a job for each
  phase, averaged over blocks (the backward's last phase, dW1 and dx
  beside it, ends at the next job's first barrier);
- ``no_<loop>`` / ``bwd_no_<loop>``: the kernel with one phase's main loop
  removed (its output is wrong); the drop in time against the full kernel
  is that loop's share;
- ``ffma`` (forward mode): a register-only FMA stream shaped like a layer
  1-2 tile (6 pixels x 20 channels) in two orders: each pixel value held for
  20 FMAs in a row, or each weight held for 6; the rate of each against the
  f32 peak.

A variant is made by replacing lines of the source
(:func:`variant_sources`, which needs neither nvcc nor a card); a
replacement that no longer matches raises, so the probe follows the kernel
or fails loudly.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys

import torch

from . import build

OUT = build.BUILD_DIR.parent / "k2_probe"
F32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
FMA_PER_CLOCK = 128     # an SM's f32 FMA lanes
SHAPE = (3, 32, 6, 80)  # (NH, B, V, H): final_temp_conv's hidden block
BWD_SHAPES = [("hidden block, no dx", (3, 32, 6, 80), False),
              ("output block, dx", (1, 32, 6, 80), True)]

_STAMP = "{{ long long t_ = clock64(); ph[{i}] += t_ - tp; tp = t_; }}\n"

# The forward: (anchor, text placed after it) for each clock read
PHASES = ["wait for the window, barrier", "layer 1 and store, barrier",
          "layer 2, barrier", "layer 2 store, barrier", "layer 3 (warp 0)"]
_CLOCKS = [
    ("  int buf = 0;\n",
     "  long long ph[5] = {0, 0, 0, 0, 0}, tp = clock64();\n"),
    ("layer 3 is done with hs\n", "    " + _STAMP.format(i=0)),
    ("tile.store<kPx - 1>(hs, d, cg, pg, ty0 - 1, tx0 - 1);\n      }\n    }\n"
     "    __syncthreads();\n", "    " + _STAMP.format(i=1)),
    ("fwd_layer2<kPx - 1>(tile, hs, q, w2s + kCh * cg, F, Fp);\n    }\n"
     "    __syncthreads();\n", "    " + _STAMP.format(i=2)),
    ("tile.store<kPx - 1>(hs, d, cg, pg, ty0 - 1, tx0 - 1);\n    }\n"
     "    __syncthreads();\n", "    " + _STAMP.format(i=3)),
]
_LOOP_END = " + b3s[k];\n      }\n    }\n"
_REPORT = ("    " + _STAMP.format(i=4) + "  }\n  if (threadIdx.x == 0)\n"
           "    for (int i = 0; i < 5; ++i)\n"
           "      out[(blockIdx.y * gridDim.x + blockIdx.x) * 8 + i] = "
           "(float)ph[i];\n}\n")
# phase: (anchor of its main loop, the loop's bound in it)
_LAYER_LOOPS = {
    "layer 1": ("for (int c = 0; c < Cin; ++c) {\n    const float* xc",
                "c < Cin"),
    "layer 2": ("for (int k = 0; k < F; ++k) {\n    float wv[kCh]", "k < F"),
    "layer 3": ("for (int i = 0; i < Fp / kParts; ++i) {", "i < Fp / kParts"),
}

# The backward: each phase ends at a barrier of the job loop, after which a
# clock read adds the phase's clocks: (anchor, index in BWD_PHASES).
BWD_PHASES = ["window loads, barrier", "layer 1, barrier", "layer 2, barrier",
              "dW3 db3, barrier", "da2, barrier", "dW2 db2, barrier",
              "da1, barrier", "dW1 db1 (and dx beside it), next barrier"]
_BWD_DECL = "  for (int j = blockIdx.x; j < d.jobs; j += gridDim.x) {\n"
_BWD_SHARED = "__device__ __noinline__ void bwd_dw3_da2("  # clocks declared before
_BWD_CLOCKS = [
    ("    __syncthreads();  // the weights are in; the last job is done "
     "with smem\n", 7),
    ("load_window(gh, d, Cout, b, v, ty0 - 2, tx0 - 2, gs);\n"
     "    __syncthreads();\n", 0),
    ("    bwd_layer<1>(xs, w1s, b1s, d, ty0 - 1, tx0 - 1, h1);\n"
     "    __syncthreads();\n", 1),
    ("    bwd_layer<2>(h1, w2t, b2s, d, ty0 - 1, tx0 - 1, h2);\n"
     "    __syncthreads();\n", 2),
    ("  __syncthreads();  // dW3 is done with h2\n", 3),
    ("    bwd_dw3_da2(h2, gs, w3b, d, acc + o_dw3, acc + o_db3);\n"
     "    __syncthreads();\n", 4),
    ("    bwd_dw2(h2, h1, d, acc + o_dw2, acc + o_db2);\n"
     "    __syncthreads();\n", 5),
    ("    bwd_da1(h2, w2b, d, h1);\n    __syncthreads();\n", 6),
]
_BWD_END = ("  for (int i = threadIdx.x; i < E; i += blockDim.x) "
            "part[i] = acc[i];\n}\n")
# phase: (anchor of its main loop or of the call that runs it, the text in
# it to replace, the text that runs the loop 0 times)
_BWD_LOOPS = {
    "layer 1": ("      t.layer1(in, w, d, c0);", "t.", "if (0) t."),
    "layer 2": ("      t.product(in, w, d, c0);", "t.", "if (0) t."),
    "dW3": ("for (int m = 0; m < kTT / 4; ++m) {\n        const int p = "
            "kTT / 4 * s + m, py = p / kT, px = p % kT;\n        float gv[4];",
            "m < kTT / 4", "m < 0"),
    "da2": ("for (int co = 0; co < d.Cout; ++co) {\n      const float* gc "
            "= gp", "co < d.Cout", "co < 0"),
    "dW2": ("for (int m = 0; m < kTT / 4; ++m) {\n        const int p = "
            "kTT / 4 * s + m, q", "m < kTT / 4", "m < 0"),
    "da1": ("    t.product(da2, w2b, d, c0);", "t.", "if (0) t."),
    "dW1": ("for (int m = 0; m < kTT / 4; ++m) {\n        const int p = "
            "kTT / 4 * s + m, py = p / kT, px = p % kT;\n        float av[4],",
            "m < kTT / 4", "m < 0"),
    "dx": ("for (int f = lane; f - lane < F; f += 32) {", "f - lane < F",
           "f - lane < 0"),
}


def bwd_fmas(f=74, c=4, need_dx=False):
    """FMAs one 10x10 job of the backward needs at hidden width ``f`` and
    ``c`` channels in and out, by phase (BWD_PHASES order): the recompute on
    the 12x12 neighbourhood Q, the weight gradients over the tile's 100
    pixels, da2 and da1 on Q when dx is wanted and on the tile when not
    (the kernel computes them on Q at both)."""
    q, t = 144, 100
    rn = q if need_dx else t
    dw = 9 * c * f * t  # dW1, dW3 and dx each
    return [0, q * 9 * c * f, q * f * f, dw, rn * 9 * c * f, f * f * t,
            rn * f * f, dw * (1 + need_dx)]


def anchors() -> dict[str, str]:
    """Every text the variants edit, or insert after, by a name; each
    occurs once in ``csrc/gat_mapping.cu``."""
    out = {f"forward clock {i}": a for i, (a, _) in enumerate(_CLOCKS)}
    out["forward job loop's end"] = _LOOP_END
    out |= {f"forward loop {k}": a for k, (a, _) in _LAYER_LOOPS.items()}
    out |= {"backward clocks' declaration": _BWD_SHARED,
            "backward job loop": _BWD_DECL, "backward end": _BWD_END}
    out |= {f"backward clock: {BWD_PHASES[i]}": a for a, i in _BWD_CLOCKS}
    out |= {f"backward loop {k}": a for k, (a, _, _) in _BWD_LOOPS.items()}
    return out


def _edit(source: str, edits) -> str:
    for old, new in edits:
        if source.count(old) != 1:
            raise RuntimeError(f"k2_probe: anchor not found once in the "
                               f"kernel source: {old[:60]!r}")
        source = source.replace(old, new)
    return source


def _without_loop(source: str, anchor: str, bound: str,
                  empty: str | None = None) -> str:
    """The source with the loop at ``anchor`` run 0 times: ``bound``
    replaced by ``empty`` (by default its variable ``< 0``)."""
    empty = empty or bound.split(" < ")[0] + " < 0"
    return _edit(source, [(anchor, anchor.replace(bound, empty))])


def forward_phases(src: str) -> str:
    """The forward with a clock read after each barrier of its job loop and
    the clocks written into ``out`` (8 floats a block)."""
    clocked = _edit(src, [(a, a + t) for a, t in _CLOCKS])
    end = clocked.index(_LOOP_END) + len(_LOOP_END)
    close = "  }\n}\n"
    if not clocked.startswith(close, end):
        raise RuntimeError("k2_probe: the forward's job loop's end moved")
    return clocked[:end] + _REPORT + clocked[end + len(close):]


def backward_phases(src: str) -> str:
    """The backward with a clock read by thread 0 after each barrier of its
    job loop, summed in shared memory at file scope (registers are the backward's scarce resource, and one
    barrier is inside a device function) and written over the first
    entries of each block's partial."""
    n = len(BWD_PHASES)

    def stamp(i):
        return "    if (threadIdx.x == 0) " + _STAMP.format(i=i)
    edits = [(_BWD_SHARED, f"__shared__ long long ph[{n}], tp;\n\n"
              + _BWD_SHARED),
             (_BWD_DECL, f"  if (threadIdx.x == 0) {{\n    for (int i = 0; "
              f"i < {n}; ++i) ph[i] = 0;\n    tp = clock64();\n  }}\n"
              + _BWD_DECL)]
    edits += [(a, a + stamp(i)) for a, i in _BWD_CLOCKS]
    edits += [(_BWD_END, _BWD_END[:-2] + "  __syncthreads();\n"
               f"  if (threadIdx.x == 0)\n    for (int i = 0; i < {n}; ++i) "
               "part[i] = (float)ph[i];\n}\n")]
    return _edit(src, edits)


def variant_sources(src: str, mode: str = "all") -> dict[str, str]:
    """{variant name: CUDA source} for ``mode`` ("fwd", "bwd" or "all"),
    made from ``src``, the text of ``csrc/gat_mapping.cu``."""
    sources = {"full": src}
    if mode in ("fwd", "all"):
        sources["phases"] = forward_phases(src)
        for layer, (anchor, bound) in _LAYER_LOOPS.items():
            sources["no_" + layer.replace(" ", "")] = _without_loop(
                src, anchor, bound)
    if mode in ("bwd", "all"):
        sources["bwd_phases"] = backward_phases(src)
        for phase, loop in _BWD_LOOPS.items():
            sources["bwd_no_" + phase.replace(" ", "")] = _without_loop(
                src, *loop)
    return sources


_FFMA_CU = r"""
#include <cuda_runtime.h>
template <int PIXEL_MAJOR>
__global__ void __launch_bounds__(256, 1) ffma(float* out, int iters) {
  float acc[6][20], a[6], w[20];
  for (int j = 0; j < 6; ++j) a[j] = threadIdx.x * 1e-3f + j;
  for (int c = 0; c < 20; ++c) w[c] = c * 1e-2f + 0.5f;
#pragma unroll
  for (int j = 0; j < 6; ++j)
#pragma unroll
    for (int c = 0; c < 20; ++c) acc[j][c] = 0.f;
  for (int it = 0; it < iters; ++it) {
    if (PIXEL_MAJOR) {
#pragma unroll
      for (int j = 0; j < 6; ++j)
#pragma unroll
        for (int c = 0; c < 20; ++c) acc[j][c] = fmaf(a[j], w[c], acc[j][c]);
    } else {
#pragma unroll
      for (int c = 0; c < 20; ++c)
#pragma unroll
        for (int j = 0; j < 6; ++j) acc[j][c] = fmaf(a[j], w[c], acc[j][c]);
    }
#pragma unroll
    for (int j = 0; j < 6; ++j) a[j] += 1e-7f;
  }
  float t = 0.f;
#pragma unroll
  for (int j = 0; j < 6; ++j)
#pragma unroll
    for (int c = 0; c < 20; ++c) t += acc[j][c];
  out[blockIdx.x * blockDim.x + threadIdx.x] = t;
}
extern "C" int run(int pixel_major, float* out, int blocks, int iters) {
  if (pixel_major) ffma<1><<<blocks, 256>>>(out, iters);
  else ffma<0><<<blocks, 256>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def _build(sources: dict[str, str]) -> dict[str, ctypes.CDLL]:
    """Compiles each named source in parallel; returns the libraries and
    prints ptxas's registers and spills of the full source's kernels."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu, so = OUT / f"{name}.cu", OUT / f"lib{name}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
        if name != "full":
            continue
        for chunk in log.split("Compiling entry function '")[1:]:
            kernel = chunk.split("'", 1)[0]
            regs = re.search(r"Used (\d+) registers", chunk)
            spills = re.findall(r"(\d+) bytes spill", chunk)
            if "gat_mapping" in kernel and regs:
                print(f"[k2_probe] build {kernel}: {regs.group(1)} registers, "
                      f"{sum(map(int, spills))} bytes spilled")
    return libs


def _inputs(nh, b, v, h, f=74, c=4):
    gen = torch.Generator(device="cuda").manual_seed(0)

    def r(scale, *s):
        return scale * torch.randn(*s, device="cuda", generator=gen)
    x = torch.rand(b, h, h, c, v, device="cuda", generator=gen)
    return (x, r((9 * c) ** -0.5, nh, f, c, 3, 3), r(0.1, nh, f),
            r(f ** -0.5, nh, f, f, 1, 1), r(0.1, nh, f),
            r((9 * f) ** -0.5, nh, c, f, 3, 3), r(0.1, nh, c))


def _blocks(nh):
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return max(1, sms // nh)


def _forward(lib, args):
    """A launcher of ``lib``'s forward on ``args``, and its output."""
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.gat_mapping_fwd.argtypes = [vp] * 8 + [i32] * 9 + [vp]
    x, *ws = args
    nh, f = ws[1].shape
    b, h, w, c, v = x.shape
    cout = ws[5].shape[1]
    out = x.new_empty((nh, b, h, w, cout, v))
    blocks = _blocks(nh)

    def go():
        rc = lib.gat_mapping_fwd(
            *(t.data_ptr() for t in args), out.data_ptr(), nh, b, v, h, w, c,
            f, cout, blocks, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"gat_mapping_fwd: CUDA error {rc}")
    return go, out, blocks


def _backward(lib, args, need_dx):
    """A launcher of ``lib``'s backward on ``args`` and a fixed cotangent,
    and its per-block partials (NH, G, E)."""
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.gat_mapping_bwd.argtypes = [vp] * 16 + [i32] * 10 + [vp]
    x, w1, b1, w2, b2, w3, b3 = args
    nh, f = b1.shape
    b, h, w, c, v = x.shape
    cout = b3.shape[1]
    gen = torch.Generator(device="cuda").manual_seed(1)
    g = torch.randn(nh, b, h, w, cout, v, device="cuda", generator=gen)
    blocks = _blocks(nh)
    per_head = f * c * 9 + 2 * f + f * f + cout * f * 9 + cout
    partials = x.new_empty((nh, blocks, per_head))
    dx = torch.empty_like(x)
    dx_heads = x.new_empty((nh,) + x.shape) if need_dx and nh > 1 else dx
    grads = [torch.empty_like(t) for t in (w1, b1, w2, b2, w3, b3)]

    def go():
        rc = lib.gat_mapping_bwd(
            x.data_ptr(), g.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), w3.data_ptr(), dx.data_ptr(),
            dx_heads.data_ptr(), partials.data_ptr(),
            *(t.data_ptr() for t in grads), nh, b, v, h, w, c, f, cout,
            blocks, int(need_dx), torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"gat_mapping_bwd: CUDA error {rc}")
    return go, partials, blocks


def _ms(fn, reps=10, rounds=7):
    """Median device time of one call, CUDA events."""
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        fn()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)[len(times) // 2]


def _probe_forward(libs):
    args = _inputs(*SHAPE)
    nh, b, v, h = SHAPE
    jobs = b * v * ((h + 15) // 16) ** 2  # a head's 16x16 tiles
    go, out, blocks = _forward(libs["full"], args)
    full = _ms(go)
    flops = 2 * nh * b * v * h * h * (9 * 4 * 74 + 74 * 74 + 9 * 74 * 4)
    print(f"[k2_probe] forward {SHAPE}: {full:.4f} ms, "
          f"{100 * flops / (full * 1e-3) / F32_FLOP_PER_S:.1f}% of the f32 "
          f"peak")
    for layer in _LAYER_LOOPS:
        go_l, _, _ = _forward(libs["no_" + layer.replace(" ", "")], args)
        without = _ms(go_l)
        print(f"[k2_probe] without the {layer} loop: {without:.4f} ms "
              f"(the loop's share: {full - without:.4f} ms)")
    go_p, out_p, _ = _forward(libs["phases"], args)
    go_p()
    torch.cuda.synchronize()
    ph = out_p.flatten()[:nh * blocks * 8].view(nh * blocks, 8)[:, :5].double()
    per_job = ph.mean(0) / (jobs / blocks)
    print(f"[k2_probe] clocks a job by phase (thread 0 of each block, "
          f"{jobs / blocks:.1f} jobs a block), total {per_job.sum():.0f}:")
    for name, clk in zip(PHASES, per_job.tolist()):
        print(f"[k2_probe]   {name:>30}: {clk:8.0f}")

    lib = libs["ffma"]
    lib.run.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                        ctypes.c_int]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    buf = torch.empty(sms * 256, device="cuda")
    iters = 20000
    for pixel_major, label in ((1, "each pixel value held for 20 FMAs"),
                               (0, "each weight held for 6 FMAs")):
        ms = _ms(lambda: lib.run(pixel_major, buf.data_ptr(), sms, iters),
                 reps=1, rounds=5)
        rate = 2 * 120 * iters * sms * 256 / (ms * 1e-3)
        print(f"[k2_probe] register FMA stream, {label}: "
              f"{rate / 1e12:.1f} TFLOP/s, {100 * rate / F32_FLOP_PER_S:.1f}% "
              f"of the f32 peak")


def _probe_backward(libs):
    for where, shape, need_dx in BWD_SHAPES:
        args = _inputs(*shape)
        nh, b, v, h = shape
        jobs = b * v * ((h + 9) // 10) ** 2  # a head's 10x10 tiles
        go, _, blocks = _backward(libs["full"], args, need_dx)
        full = _ms(go)
        print(f"[k2_probe] backward {where} {shape}: {full:.4f} ms (the "
              f"kernel and its reductions)")
        for phase in _BWD_LOOPS:
            if phase == "dx" and not need_dx:
                continue
            go_l, _, _ = _backward(libs["bwd_no_" + phase.replace(" ", "")],
                                   args, need_dx)
            without = _ms(go_l)
            print(f"[k2_probe]   without the {phase} loop: {without:.4f} ms "
                  f"(the loop's share: {full - without:.4f} ms)")
        go_p, partials, _ = _backward(libs["bwd_phases"], args, need_dx)
        go_p()
        torch.cuda.synchronize()
        n = len(BWD_PHASES)
        ph = partials.reshape(nh * blocks, -1)[:, :n].double()
        per_job = ph.mean(0) / (jobs / blocks)
        fmas = bwd_fmas(need_dx=need_dx)
        print(f"[k2_probe]   clocks a job by phase (thread 0 of each block, "
              f"{jobs / blocks:.1f} jobs a block), total "
              f"{per_job.sum():.0f}; FMAs a job and their share of "
              f"{FMA_PER_CLOCK} a clock:")
        for name, clk, fma in zip(BWD_PHASES, per_job.tolist(), fmas):
            rate = (f"{fma:8d} FMAs, {100 * fma / FMA_PER_CLOCK / clk:5.1f}%"
                    if fma and clk else "")
            print(f"[k2_probe]   {name:>26}: {clk:8.0f}  {rate}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m "
                                     "extended_gan_torch.ops.k2_probe")
    parser.add_argument("--mode", choices=("fwd", "bwd", "all"),
                        default="all")
    mode = parser.parse_args(argv).mode
    if not torch.cuda.is_available():
        print("k2_probe: no CUDA device; this probe runs on the GPU",
              file=sys.stderr)
        return 1
    sources = variant_sources((build.CSRC / "gat_mapping.cu").read_text(),
                              mode)
    if mode in ("fwd", "all"):
        sources["ffma"] = _FFMA_CU
    libs = _build(sources)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"[k2_probe] card: {card.strip()}")
    if mode in ("fwd", "all"):
        _probe_forward(libs)
    if mode in ("bwd", "all"):
        _probe_backward(libs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
