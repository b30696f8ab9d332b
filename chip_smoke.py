#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``extended_gan_torch``) on one GPU.

  python3 chip_smoke.py      # from the root of a checkout, one NVIDIA H100

Phases, each fatal on failure (non-zero exit, no result line):

1. build   - compile every kernel in ``extended_gan_torch/ops/csrc/`` with
             nvcc (one process per source, all at once) into build/kernels/.
2. kernels - hold each kernel against its plain PyTorch version on the card
             at the served shapes, all outputs at atol = rtol = 1e-5 (f32;
             only the summation order over P differs), and time both with
             CUDA events (median of 20 timed groups after warm-up).
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
5. report  - the ``kernels`` JSON line, the card's name and power limit, and
             the last line ``{"ok": true, "device": {...}}``.
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


def phase_build():
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


def phase_kernels():
    """K1 against reference_impl at the served geometry."""
    import torch

    from extended_gan_torch.models.gat.layers import normalized_adjacency
    from extended_gan_torch.ops import gat_attention as k1

    dev = torch.device("cuda")
    mm, groups, alpha = 4, 6, 0.2  # M = T = 4 frames, G = V = 6 vertices
    rows, worst = [], 0.0
    for hw in (400, 6400):  # 20x20 and 80x80: P = 2,400 and 38,400
        p = groups * hw
        for b in (1, 8, 32):
            for nh in (1, 3):
                gen = torch.Generator(device=dev).manual_seed(1000 * nh + b)
                m = torch.randn(nh, b, mm, p, device=dev, generator=gen)
                a = torch.randn(nh, 2 * groups, device=dev, generator=gen)
                adj = normalized_adjacency(
                    torch.rand(nh, mm, mm, device=dev, generator=gen))
                w1 = a[:, :groups].repeat_interleave(hw, 1)[:, None, None, :]
                w2 = a[:, groups:].repeat_interleave(hw, 1)[:, None, None, :]
                adj_b = adj[:, None].contiguous()
                with torch.no_grad():
                    got = k1.fused_gat_attention(m, a, adj, alpha, hw)
                    want = k1.reference_impl(m, w1, w2, adj_b, alpha, hw)
                torch.cuda.synchronize()
                err = 0.0
                for name, g_, w_ in zip(("out", "att0", "att", "pos"), got,
                                        want):
                    check(g_.shape == w_.shape,
                          f"{name} shape {g_.shape} != {w_.shape}")
                    check(torch.allclose(g_, w_, atol=TOL, rtol=TOL),
                          f"K1 {name} disagrees with reference_impl at "
                          f"heads={nh} B={b} P={p}: max abs err "
                          f"{(g_ - w_).abs().max().item():.3e}")
                    err = max(err, (g_ - w_).abs().max().item())
                worst = max(worst, err)
                with torch.no_grad():
                    kms = time_ms(lambda: k1.fused_gat_attention(
                        m, a, adj, alpha, hw))
                    pms = time_ms(lambda: k1.reference_impl(
                        m, w1, w2, adj_b, alpha, hw))
                n = nh * b * mm * p
                nbytes = 4 * (2 * n + nh * 2 * groups + nh * mm * mm
                              + 3 * nh * b * mm * mm)
                # pass 1: two FMAs per element; pass 2: M FMAs + the ELU
                flops = n * (4 + 2 * mm + 1)
                bound = max(nbytes / HBM_BYTES_PER_S,
                            flops / F32_FLOP_PER_S) * 1e3
                rows.append(dict(heads=nh, batch=b, P=p, max_abs_err=err,
                                 kernel_ms=kms, plain_ms=pms, bound_ms=bound,
                                 bound_by="bytes" if nbytes / HBM_BYTES_PER_S
                                 >= flops / F32_FLOP_PER_S else "operations"))
                print(f"[kernel] gat_attention_fwd heads={nh} B={b:2d} "
                      f"P={p:5d}: max_abs_err={err:.3e} kernel={kms:.4f} ms "
                      f"plain={pms:.4f} ms bound={bound:.4f} ms")
    return rows, worst


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


def serve_experiment(experiment, batches, repeats):
    """Export ``experiment`` with --init-seed 0, serve it on the card over
    HTTP and check every reply. Returns the number of forwards run."""
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
            check(k1.launch_count - launches0 == 2 * repeats,
                  f"{experiment} b={b}: {k1.launch_count - launches0} K1 "
                  f"launches for {repeats} forwards, expected 2 per forward")
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

    # The replies are compared with a plain forward at 1e-5: both must run
    # in exact f32, and cuDNN convolutions default to TF32.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    k1.launch_count = 0  # the main path starts here
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
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.inference_mode():
        model(x)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(5):
                model(x)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6

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
        return
    print(f"[profile] final_temp_conv b={batch}, 5 forwards: device busy "
          f"{busy / 5 / 1e3:.4f} ms a forward, {100 * busy / wall_us:.1f}% of "
          f"{wall_us / 5 / 1e3:.4f} ms wall")
    for e in sorted(events, key=dev_us, reverse=True)[:10]:
        print(f"[profile]   {100 * dev_us(e) / busy:5.1f}%  "
              f"{dev_us(e) / 5 / 1e3:.4f} ms  x{e.count // 5}  {e.key[:90]}")


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
    try:
        phase_build()
        rows, worst = phase_kernels()
        launches, models = phase_serve()
        phase_forward(models)
        card = card_line()
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    main_row = next(r for r in rows
                    if (r["heads"], r["batch"], r["P"]) == (3, 32, 38400))
    kernels = [{
        "name": "gat_attention_fwd",
        "route": "cuda",
        "source": "extended_gan_torch/ops/csrc/gat_attention.cu",
        "replaces": "extended_gan_tpu/ops/pallas/gat_attention.py:62",
        "launches": launches,
        "max_abs_err": worst,
        "ms": main_row["kernel_ms"],
        "kernel_ms": main_row["kernel_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
        "shape": "heads=3 B=32 M=4 P=38400 (80x80 hidden layer, batch 32)",
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
