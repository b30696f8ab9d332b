"""K3's kernels, one build against another, on the card.

  python -m extended_gan_torch.ops.k3_probe [SOURCE.cu ...]

Run from the repo root on one GPU. Builds the committed ``csrc/dsconv.cu``
and each further source named (another build of it with the same C entry
points, e.g. an earlier commit's from ``git show``) with nvcc into
``build/k3_probe/``, prints each build's registers and spills, and times
them at the 18 DSC shapes of a final_smaatunet batch-32 forward, in turns
(first build to last, then last to first; the mean of the two), by CUDA
events: the forward at its split plan and with CK unsplit, and the
backward kernel (dx at all but the first DSC, as in
training). Each build's outputs are held to the committed build's at 1e-5
relative to the largest entry, so a variant that computes something else
fails, unless ``--unchecked`` asks for timing alone (a variant with a
phase left out, to weigh that phase).
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

from ..models.smaat_unet import dsc_shapes
from . import build, dsconv

OUT = build.BUILD_DIR.parent / "k3_probe"


def _build(sources: dict[str, Path]) -> dict[str, ctypes.CDLL]:
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        so = OUT / f"lib{name}.so"
        procs[name] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {sources[name]}:\n{log}")
        libs[name] = dsconv.bind(ctypes.CDLL(str(so)))
        for chunk in log.split("Compiling entry function '")[1:]:
            kernel = chunk.split("'", 1)[0]
            regs = re.search(r"Used (\d+) registers", chunk)
            spills = re.findall(r"(\d+) bytes spill", chunk)
            print(f"[k3_probe] {name}: {kernel}: "
                  f"{regs.group(1) if regs else '?'} registers, "
                  f"{sum(map(int, spills))} bytes spilled")
    return libs


def _fwd(lib, x, dw, dwb, pw, pwb, ks):
    """The forward of the build ``lib`` at ``ks`` channels a slice."""
    out, _d, _ws, args = dsconv.fwd_args(x, dw, dwb, pw, pwb, ks=ks)
    dsconv.call(lib.dsconv_fwd, x.device, args)
    return out


def _bwd(lib, gd, x, dw, need_dx):
    """The backward kernel of the build ``lib``: (dx or None, grads)."""
    dx, grads, _part, args = dsconv.bwd_args(gd, x, dw, need_dx=need_dx)
    dsconv.call(lib.dsconv_bwd, x.device, args)
    return dx, grads


def _ms(fn, reps=10, rounds=7):
    """Median device time of one call, CUDA events."""
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


def _close(got, want, what):
    tol = 1e-5 * want.abs().max().item()
    if not torch.allclose(got, want, rtol=0, atol=tol):
        raise RuntimeError(f"{what}: max |diff| "
                           f"{(got - want).abs().max().item():.3e} > {tol:.3e}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m "
                                     "extended_gan_torch.ops.k3_probe")
    parser.add_argument("sources", nargs="*", type=Path,
                        help="further builds of dsconv.cu to time")
    parser.add_argument("--unchecked", action="store_true",
                        help="time builds that compute something else (a "
                        "phase left out) without holding their outputs")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("k3_probe: no CUDA device", file=sys.stderr)
        return 1
    sources = {"committed": build.CSRC / "dsconv.cu"}
    sources.update({f"v{i}_{p.stem}": p for i, p in enumerate(args.sources)})
    libs = _build(sources)
    names = list(libs)
    totals = {n: [0.0, 0.0, 0.0] for n in names}
    for i, shape in enumerate(dsc_shapes()):
        n, h, w, c, ck, cout = shape
        gen = torch.Generator(device="cuda").manual_seed(i)
        x, dw, dwb = (torch.randn(n, h, w, c, device="cuda", generator=gen),
                      torch.randn(3, 3, ck, device="cuda", generator=gen),
                      torch.randn(ck, device="cuda", generator=gen))
        pw = torch.randn(ck, cout, device="cuda", generator=gen) / ck ** 0.5
        pwb = torch.randn(cout, device="cuda", generator=gen)
        gd = torch.randn(n, h, w, ck, device="cuda", generator=gen)
        ks = dsconv._split_plan(*shape)
        unsplit = -(-ck // 32) * 32
        need_dx = i > 0
        calls = {name: (
            lambda lib=lib: _fwd(lib, x, dw, dwb, pw, pwb, ks),
            lambda lib=lib: _fwd(lib, x, dw, dwb, pw, pwb, unsplit),
            lambda lib=lib: _bwd(lib, gd, x, dw, need_dx))
            for name, lib in libs.items()}
        want = [f() for f in calls["committed"]]
        for name in names[1:] if not args.unchecked else ():
            got = [f() for f in calls[name]]
            _close(got[0], want[0], f"{name} forward at {shape}")
            _close(got[1], want[1], f"{name} forward, CK unsplit, at {shape}")
            for g_, w_ in zip(got[2], want[2]):
                if w_ is not None:
                    _close(g_, w_, f"{name} backward at {shape}")
        times = {name: [0.0, 0.0, 0.0] for name in names}
        for order in (names, names[::-1]):
            for name in order:
                for j, f in enumerate(calls[name]):
                    times[name][j] += _ms(f) / 2
        for name in names:
            for j in range(3):
                totals[name][j] += times[name][j]
            print(f"[k3_probe] {shape} S={-(-ck // ks)} "
                  f"{name}: forward {times[name][0]:.4f} ms, CK unsplit "
                  f"{times[name][1]:.4f} ms, backward kernel "
                  f"{times[name][2]:.4f} ms", flush=True)
    for name in names:
        fwd, par, bwd = totals[name]
        print(f"[k3_probe] {name} over the 18 launches: forward {fwd:.4f} ms, "
              f"CK unsplit {par:.4f} ms, backward kernel {bwd:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
