"""The port's profiling (``extended_gan_torch/utils/profiling.py``) and
terminal renderer (``utils/term.py``) against the JAX package's, on the CPU.

- ``StepTimer`` and ``EpochProfiler`` give JAX's stats, key for key and
  value for value, under the same patched ``time.perf_counter``.
- ``render_image`` and ``term_display`` give JAX's strings.
- With ``profile=True`` each driver reports JAX's five keys where JAX puts
  them: the conv-GAT driver in its history and ``history.json``, the DCGAN
  and CycleGAN drivers in each epoch's results (``tests/test_profiling.py``
  is JAX's side); ``profile_trace_dir`` writes a Chrome trace of the first
  epoch; ``trace`` and ``annotate`` write a named range.
- The CLIs pass ``--profile``, ``--profile-trace-dir`` and the GAT CLI's
  ``--conv-impl`` on to the drivers.
"""

import glob
import json
import os
import time

import numpy as np
import pytest

from extended_gan_tpu.utils import profiling as jax_profiling
from extended_gan_tpu.utils import term as jax_term
from extended_gan_torch.cycle_gan import __main__ as cyclegan_main
from extended_gan_torch.dcgan import __main__ as dcgan_main
from extended_gan_torch.gat import __main__ as gat_main
from extended_gan_torch.gat import generate_experiment as gen_mod
from extended_gan_torch.train import cyclegan_driver, dcgan_driver, gat_driver
from extended_gan_torch.utils import profiling, term
from test_torch_port_gat_family import one_torch_thread  # noqa: F401 - the autouse fixture

KEYS = {"epoch_wall_s", "profiled_steps", "steps_per_sec", "dispatch_mean_s",
        "dispatch_p90_s"}


class FakeClock:
    """``time.perf_counter`` that advances by the next of its steps at each
    read."""

    def __init__(self, steps):
        self.t, self.steps = 100.0, iter(steps)

    def __call__(self):
        self.t += next(self.steps)
        return self.t


def _steps(seed, n=400):
    return np.random.default_rng(seed).uniform(1e-4, 0.05, n).tolist()


@pytest.mark.parametrize("warmup,n", [(2, 7), (1, 4), (0, 1), (3, 3)])
def test_step_timer_matches_jax(monkeypatch, warmup, n):
    out = []
    for module in (profiling, jax_profiling):
        monkeypatch.setattr(time, "perf_counter", FakeClock(_steps(n)))
        timer = module.StepTimer(warmup=warmup)
        for _ in range(n):
            with timer:
                pass
        out.append(timer.stats())
    assert out[0] == out[1]
    assert (out[0] == {}) == (n <= warmup)


@pytest.mark.parametrize("steps_by_epoch", [(6, 3), (1, 2, 0)])
def test_epoch_profiler_matches_jax(monkeypatch, steps_by_epoch):
    out = []
    for module in (profiling, jax_profiling):
        monkeypatch.setattr(time, "perf_counter", FakeClock(_steps(3)))
        prof = module.EpochProfiler()
        stats = []
        for n in steps_by_epoch:
            prof.start_epoch()
            for _ in range(n):
                with prof.step():
                    pass
            stats.append(prof.end_epoch())
        out.append(stats)
    assert out[0] == out[1]
    for n, stats in zip(steps_by_epoch, out[0]):
        # the dispatch times need a step past the 2 warm-up steps
        assert set(stats) == (KEYS if n > 2 else KEYS - {
            "dispatch_mean_s", "dispatch_p90_s"} - ({"steps_per_sec"}
                                                    if not n else set()))


def test_step_context_and_timed():
    assert profiling.step_context(None) is jax_profiling.step_context(None)

    def fn(a, b=1):
        return a + b
    assert profiling.timed(fn, None) is fn
    prof = profiling.EpochProfiler()
    prof.start_epoch()
    wrapped = profiling.timed(fn, prof)
    assert [wrapped(1, b=2) for _ in range(4)] == [3] * 4
    assert prof.end_epoch()["profiled_steps"] == 4.0


def test_trace_and_annotate_write_a_chrome_trace(tmp_path):
    import torch

    with profiling.trace(str(tmp_path)):
        with profiling.annotate("port-unit-region"):
            torch.ones(8).sum()
    (path,) = glob.glob(str(tmp_path / "*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "port-unit-region" for e in events)


@pytest.mark.parametrize("kind", ["ramp", "random", "constant", "wide"])
def test_term_render_matches_jax(kind):
    rng = np.random.default_rng(1)
    img = {"ramp": np.linspace(0, 1, 64).reshape(8, 8),
           "random": rng.random((9, 13)),
           "constant": np.full((6, 6), 0.3),
           "wide": rng.random((12, 170)) * 40 - 3}[kind]
    for width in (8, 40):
        got = term.render_image(img, width=width)
        assert got == jax_term.render_image(img, width=width)
    assert "\x1b[" in got and "▀" in got


def test_term_display_matches_jax(capsys):
    rng = np.random.default_rng(2)
    y, y_hat = rng.random((2, 3, 10, 10)), rng.random((1, 10, 10))
    got = term.term_display(y, y_hat, width=8)
    assert got == jax_term.term_display(y, y_hat, width=8)
    assert "y_hat" in got and capsys.readouterr().out.count("y_hat") == 2


def _trace_files(d):
    paths = glob.glob(os.path.join(d, "*.json"))
    for p in paths:
        with open(p) as f:
            assert json.load(f)["traceEvents"]
    return paths


def test_gat_driver_profile_into_history(tmp_path):
    out = str(tmp_path / "exp")
    _, history = gat_driver.train(
        model_type="temporal", mapping_type="linear", output_path=out,
        train_batch_size=4, test_batch_size=4, epochs=2, max_batches=4,
        downsample_size=(16, 16), dataset="synthetic", device="cpu",
        profile=True)
    with open(os.path.join(out, "history.json")) as f:
        saved = json.load(f)
    for k in KEYS:
        assert len(history[k]) == 2 and saved[k] == history[k], k
    assert history["profiled_steps"] == [4.0, 4.0]
    assert all(v > 0 for v in history["steps_per_sec"])


def test_gat_driver_trace_dir_traces_the_first_epoch(tmp_path):
    trace_dir = str(tmp_path / "trace")
    _, history = gat_driver.train(
        model_type="temporal", mapping_type="conv", train_batch_size=4,
        test_batch_size=4, epochs=2, max_batches=6, downsample_size=(12, 12),
        dataset="synthetic", device="cpu", megastep=2,
        profile_trace_dir=trace_dir)
    assert KEYS <= set(history) and len(_trace_files(trace_dir)) == 1
    # megastep: 6 batches are 3 groups of 2, 3 dispatches
    assert history["profiled_steps"] == [3.0, 3.0]


@pytest.mark.parametrize("resident", [False, True])
def test_dcgan_driver_profile_into_results(tmp_path, resident):
    trace_dir = str(tmp_path / "trace")
    _, history = dcgan_driver.train(
        epochs=1, train_batch_size=4, test_batch_size=4,
        max_batches=8 if resident else 4,
        synthetic=True, out_dir=str(tmp_path / "out"), seed=3,
        params={"ndf": 8, "imsize": 64}, device="cpu", profile=True,
        profile_trace_dir=trace_dir,
        **(dict(resident=True, megastep=2) if resident else {}))
    h = history.history
    assert KEYS <= set(h) and h["steps_per_sec"][-1] > 0
    assert h["profiled_steps"] == [4.0]  # 4 steps, or 4 programs of K = 2
    assert len(_trace_files(trace_dir)) == 1


def test_cyclegan_driver_profile_into_results(tmp_path):
    _, history = cyclegan_driver.train(
        epochs=2, train_batch_size=4, test_batch_size=8, max_batches=3,
        synthetic=True, ndf=8, device="cpu", profile=True)
    h = history.history
    assert KEYS <= set(h) and len(h["epoch_wall_s"]) == 2
    assert h["profiled_steps"] == [3.0, 3.0]
    assert len(h["dispatch_mean_s"]) == 2


def test_the_clis_pass_the_profile_flags(monkeypatch, tmp_path):
    seen = {}

    def capture(**kw):
        seen.clear()
        seen.update(kw)
        return None, None
    for module in (gat_main, dcgan_main, cyclegan_main):
        monkeypatch.setattr(module, "train", capture)
        argv = (["train"] if module is gat_main else []) + [
            "--profile", "--profile-trace-dir", "/t", "--device", "cpu"]
        module.main(argv)
        assert (seen["profile"], seen["profile_trace_dir"]) == (True, "/t")
        module.main(["train"] if module is gat_main else [])
        assert (seen["profile"], seen["profile_trace_dir"]) == (False, "")
    monkeypatch.setattr(gat_main, "train", capture)
    gat_main.main(["train", "--conv-impl", "chanfirst"])
    assert seen["conv_impl"] == "chanfirst"
    gat_main.main(["train"])
    assert seen["conv_impl"] == "auto"
    with pytest.raises(SystemExit):
        gat_main.main(["train", "--conv-impl", "nchw"])
    # generate_experiment passes them as overrides of the config
    monkeypatch.setattr(gen_mod, "train", capture)
    gat_main.main(["generate_experiment", "--exp_folder_name",
                   "final_temp_conv", "--profile", "--profile-trace-dir",
                   "/t", "--conv-impl", "chanfirst"])
    assert (seen["profile"], seen["profile_trace_dir"], seen["conv_impl"],
            seen["downsample_size"]) == (True, "/t", "chanfirst", (80, 80))
    gat_main.main(["generate_experiment", "--exp_folder_name",
                   "final_temp_conv"])
    assert "profile" not in seen and seen["conv_impl"] == "auto"
