"""Step timing and traces for the training drivers (port of
``extended_gan_tpu/utils/profiling.py``).

- :class:`StepTimer`: per-step wall-clock stats (mean, p50, p90) after a
  warm-up;
- :class:`EpochProfiler` (made by :func:`epoch_profiler`): what a
  driver's ``profile`` and ``profile_trace_dir`` record an epoch: the
  host's dispatch time of each train step and the epoch's wall time, the
  epoch-end fetch that syncs the stream included; with a trace directory,
  the first profiled epoch is also traced;
- :func:`trace`: ``torch.profiler`` around a region, written as a
  Chrome/Perfetto JSON trace into a directory (the JAX package writes an
  XProf trace there);
- :func:`annotate`: a named range in the trace
  (``torch.profiler.record_function``);
- :func:`step_context` and :func:`timed`: the per-step timing context a
  driver wraps each step dispatch in (a graph replay under ``--megastep``
  and a resident program included).
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np


class StepTimer:
    """A context manager timing each ``with`` block; the first ``warmup``
    blocks are counted but not timed."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._times: list[float] = []
        self._t0: float | None = None
        self._seen = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._seen += 1
        if self._seen > self.warmup:
            self._times.append(dt)

    def stats(self) -> dict[str, float]:
        if not self._times:
            return {}
        a = np.asarray(self._times)
        return {
            "steps": len(a),
            "mean_s": float(a.mean()),
            "p50_s": float(np.percentile(a, 50)),
            "p90_s": float(np.percentile(a, 90)),
            "steps_per_sec": float(1.0 / a.mean()),
        }


def _activities():
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


class _Trace:
    """A ``torch.profiler`` session that writes its Chrome trace into a
    directory when it stops."""

    def __init__(self, trace_dir: str):
        import torch

        self.trace_dir = trace_dir
        self._prof = torch.profiler.profile(activities=_activities())
        self._prof.__enter__()

    def stop(self) -> str:
        self._prof.__exit__(None, None, None)
        os.makedirs(self.trace_dir, exist_ok=True)
        path = os.path.join(self.trace_dir,
                            f"trace_{os.getpid()}_{time.time_ns()}.json")
        self._prof.export_chrome_trace(path)
        return path


class EpochProfiler:
    """A training driver's per-epoch profiler (``profile``).

    Two measurements that leave the stream as it is: the host time of each
    train step's dispatch (:class:`StepTimer` around the call; an eager step
    on the card returns once its kernels are queued, so this is enqueue
    time, not device time), and the epoch's wall time up to and including
    the epoch-end fetch, which syncs the stream: ``steps_per_sec`` is the
    pipelined rate. With ``trace_dir`` set, the first profiled epoch is
    traced as well (:func:`trace`)."""

    def __init__(self, trace_dir: str = ""):
        self.trace_dir = trace_dir
        self._epoch_idx = 0
        self._timer = StepTimer(warmup=2)
        self._t0: float | None = None
        self._trace: _Trace | None = None

    def start_epoch(self):
        self._timer = StepTimer(warmup=2)
        self._t0 = time.perf_counter()
        if self.trace_dir and self._epoch_idx == 0:
            self._trace = _Trace(self.trace_dir)

    def step(self) -> StepTimer:
        """Context manager wrapping one train step's dispatch."""
        return self._timer

    def end_epoch(self) -> dict[str, float]:
        wall = time.perf_counter() - self._t0 if self._t0 is not None else 0.0
        if self._trace is not None:
            path = self._trace.stop()
            self._trace = None
            print(f"[profile] torch.profiler trace written to {path}")
        self._epoch_idx += 1
        n = self._timer._seen
        out: dict[str, float] = {
            "epoch_wall_s": round(wall, 6),
            "profiled_steps": float(n),
        }
        if n and wall > 0:
            out["steps_per_sec"] = round(n / wall, 3)
        d = self._timer.stats()
        if d:
            out["dispatch_mean_s"] = round(d["mean_s"], 6)
            out["dispatch_p90_s"] = round(d["p90_s"], 6)
        return out


def epoch_profiler(profile: bool, trace_dir: str) -> EpochProfiler | None:
    """The drivers' profiler: one when ``profile`` or a ``trace_dir`` asks
    for it (a trace implies the step timing), else None."""
    if profile or trace_dir:
        return EpochProfiler(trace_dir=trace_dir)
    return None


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the enclosed region with ``torch.profiler`` (the CPU, and the
    card when there is one) into a Chrome/Perfetto JSON file in
    ``log_dir``."""
    session = _Trace(log_dir)
    try:
        yield
    finally:
        session.stop()


def annotate(name: str):
    """A named range in the profiler's timeline."""
    import torch

    return torch.profiler.record_function(name)


def step_context(profiler: EpochProfiler | None):
    """The per-step timing context factory of the drivers: ``profiler.step``
    when profiling, else a no-op context. Built once an epoch loop and
    called each step."""
    if profiler is not None:
        return profiler.step
    return contextlib.nullcontext


def timed(fn, profiler: EpochProfiler | None):
    """``fn`` with each call inside :func:`step_context` (``fn`` itself
    without a profiler): how the drivers time a step's, a graph replay's or
    a resident program's dispatch."""
    if profiler is None:
        return fn
    step_cm = step_context(profiler)

    def call(*args, **kwargs):
        with step_cm():
            return fn(*args, **kwargs)
    return call
