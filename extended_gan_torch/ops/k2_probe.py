"""Where K2's forward kernel spends its time, on the card.

  python -m extended_gan_torch.ops.k2_probe      # from the repo root, one GPU

Builds variants of ``csrc/gat_mapping.cu`` with nvcc into ``build/k2_probe/``
and times them at GAT3D's hidden block (3 heads, 80x80, batch 32, V = 6):

- ``phases``: the forward with ``clock64()`` read after each block-wide
  barrier by thread 0: clocks a job for each phase, averaged over blocks;
- ``layers``: the forward with one layer's loop removed (its output is
  wrong); the drop in time against the full kernel is that layer's share;
- ``ffma``: a register-only FMA stream shaped like a layer 1-2 tile (6
  pixels x 20 channels) in two orders: each pixel value held for 20 FMAs in
  a row, or each weight held for 6; the rate of each against the f32 peak.

A variant is made by replacing lines of the source; a replacement that no
longer matches raises, so the probe follows the kernel or fails loudly.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from . import build

OUT = build.BUILD_DIR.parent / "k2_probe"
F32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
SHAPE = (3, 32, 6, 80)  # (NH, B, V, H): final_temp_conv's hidden block

_STAMP = "{{ long long t_ = clock64(); ph[{i}] += t_ - tp; tp = t_; }}\n"
PHASES = ["wait for the window, barrier", "layer 1 and store, barrier",
          "layer 2, barrier", "layer 2 store, barrier", "layer 3 (warp 0)"]
# (anchor, text placed after it) for each clock read
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
_LAYER_LOOPS = {
    "layer 1": "for (int c = 0; c < Cin; ++c) {\n    const float* xc",
    "layer 2": "for (int k = 0; k < F; ++k) {\n    float wv[kCh]",
    "layer 3": "for (int i = 0; i < Fp / kParts; ++i) {",
}
_LOOP_BOUNDS = {"layer 1": "c < Cin", "layer 2": "k < F",
                "layer 3": "i < Fp / kParts"}

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


def _edit(source: str, edits) -> str:
    for old, new in edits:
        if source.count(old) != 1:
            raise RuntimeError(f"k2_probe: anchor not found once in the "
                               f"kernel source: {old[:60]!r}")
        source = source.replace(old, new)
    return source


def _build(sources: dict[str, str]) -> dict[str, ctypes.CDLL]:
    """Compiles each named source in parallel; returns the libraries."""
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
    return libs


def _inputs(nh, b, v, h, f=74, c=4):
    gen = torch.Generator(device="cuda").manual_seed(0)

    def r(scale, *s):
        return scale * torch.randn(*s, device="cuda", generator=gen)
    x = torch.rand(b, h, h, c, v, device="cuda", generator=gen)
    return (x, r((9 * c) ** -0.5, nh, f, c, 3, 3), r(0.1, nh, f),
            r(f ** -0.5, nh, f, f, 1, 1), r(0.1, nh, f),
            r((9 * f) ** -0.5, nh, c, f, 3, 3), r(0.1, nh, c))


def _forward(lib, args):
    """A launcher of ``lib``'s forward on ``args``, and its output."""
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.gat_mapping_fwd.argtypes = [vp] * 8 + [i32] * 9 + [vp]
    x, *ws = args
    nh, f = ws[1].shape
    b, h, w, c, v = x.shape
    cout = ws[5].shape[1]
    out = x.new_empty((nh, b, h, w, cout, v))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = max(1, sms // nh)

    def go():
        rc = lib.gat_mapping_fwd(
            *(t.data_ptr() for t in args), out.data_ptr(), nh, b, v, h, w, c,
            f, cout, blocks, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"gat_mapping_fwd: CUDA error {rc}")
    return go, out, blocks


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


def main() -> int:
    if not torch.cuda.is_available():
        print("k2_probe: no CUDA device; this probe runs on the GPU",
              file=sys.stderr)
        return 1
    src = (build.CSRC / "gat_mapping.cu").read_text()
    clocked = _edit(src, [(a, a + t) for a, t in _CLOCKS])
    end = clocked.index(_LOOP_END) + len(_LOOP_END)
    close = "  }\n}\n"
    if not clocked.startswith(close, end):
        raise RuntimeError("k2_probe: the job loop's end moved")
    clocked = clocked[:end] + _REPORT + clocked[end + len(close):]
    sources = {"full": src, "phases": clocked, "ffma": _FFMA_CU}
    for layer, anchor in _LAYER_LOOPS.items():
        bound = _LOOP_BOUNDS[layer]
        sources["no_" + layer.replace(" ", "")] = _edit(
            src, [(anchor, anchor.replace(bound, bound.split(" < ")[0]
                                          + " < 0"))])
    libs = _build(sources)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"[k2_probe] card: {card.strip()}")

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
        print(f"[k2_probe] without the {layer} loop: {_ms(go_l):.4f} ms "
              f"(the loop's share: {full - _ms(go_l):.4f} ms)")
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
