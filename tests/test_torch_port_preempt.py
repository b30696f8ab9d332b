"""Step-granular preemption in the port's drivers (the port's side of
``tests/test_preempt.py``), on the CPU.

- ``GracefulShutdown`` turns a real SIGTERM into its flag and puts the old
  handler back; off the main thread it is a no-op.
- A counting shutdown (its flag turns on at the Nth read, as JAX's test
  stand-in does) stops each driver inside epoch 2; the snapshot is the
  mid-epoch step, and the resumed run equals the uninterrupted run bit for
  bit (the last checkpoint's whole tree, ``history.json``), on the
  streaming path, under a megastep of K = 3 (whose epoch ends in a shorter
  group) and on the resident path (K = 2). The conv-GAT's streaming epoch
  holds batches of one sample, which it skips and still counts.
- The port's ``mid`` at a stop holds the JAX driver's for the same batches
  and weights (the JAX init, converted; SGD, whose steps carry roundoff
  no further than the roundoff itself): ``batch`` and ``total`` exactly,
  ``loss`` within 1e-6 relative.
- The CLIs: ``--precision bf16`` and the DCGAN's ``--resume`` reach the
  drivers, and ``generate_experiment`` passes the config keys PRECISION,
  REMAT, CHECKPOINT_EVERY and RESUME.
"""

import os
import signal
import threading

import jax
import numpy as np
import pytest
import torch

from extended_gan_tpu.data import native as jax_native
from extended_gan_tpu.train import gat_driver as jax_gat_driver
from extended_gan_tpu.train import preempt as jax_preempt
from extended_gan_torch.dcgan.__main__ import main as dcgan_cli
from extended_gan_torch.gat import generate_experiment as gen_mod
from extended_gan_torch.gat.__main__ import main as gat_cli
from extended_gan_torch.models.convert import from_flax_params
from extended_gan_torch.train import checkpoint as ckpt
from extended_gan_torch.train import dcgan_driver, gat_driver
from extended_gan_torch.train.preempt import GracefulShutdown
from test_torch_port_gat_family import one_torch_thread  # noqa: F401 - the autouse fixture
from test_torch_port_resume import (
    DCGAN,
    GAT,
    assert_dcgan_runs_equal,
    assert_gat_runs_equal,
    dcgan_params,
    latest,
)

LOSS_RTOL = 1e-6


class CountingShutdown:
    """A ``GracefulShutdown`` stand-in whose flag turns on at the Nth read:
    a preemption at a chosen step, without signal timing."""

    def __init__(self, fire_at_read):
        self.reads, self.fire_at = 0, fire_at_read

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    @property
    def requested(self):
        self.reads += 1
        return self.reads >= self.fire_at


def test_graceful_shutdown_sets_its_flag_and_restores_the_handler():
    before = signal.getsignal(signal.SIGTERM)
    with GracefulShutdown() as s:
        assert not s.requested
        os.kill(os.getpid(), signal.SIGTERM)
        assert s.requested
    assert signal.getsignal(signal.SIGTERM) is before


def test_graceful_shutdown_off_the_main_thread_is_a_no_op():
    before = signal.getsignal(signal.SIGTERM)
    seen = {}

    def run():
        with GracefulShutdown() as s:
            seen["handler"] = signal.getsignal(signal.SIGTERM)
            seen["requested"] = s.requested
    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert seen == {"handler": before, "requested": False}


# (driver, path, the run's keywords, the read the flag turns on at, the
# mid-epoch snapshot's batch). The conv-GAT's 8 streaming batches a
# epoch hold one of one sample (index 4): 8 reads and the epoch's tail
# read, then epoch 2 stops after batch 5, 6 batches in. Under K = 3 its
# groups consume 3, 4 (one dropped) and 1 batches; resident, 4 programs of
# K = 2 (``mid`` counts programs there, loader batches elsewhere; the
# DCGAN's resident ``mid`` counts K a program, as in JAX).
CASES = {
    "gat streaming": ("gat", dict(max_batches=8), 15, 6),
    "gat megastep": ("gat", dict(max_batches=8, megastep=3), 5, 3),
    "gat resident": ("gat", dict(max_batches=7, megastep=2, resident=True),
                     6, 1),
    "dcgan streaming": ("dcgan", dict(max_batches=5), 8, 2),
    "dcgan megastep": ("dcgan", dict(max_batches=7, megastep=3), 5, 3),
    "dcgan resident": ("dcgan", dict(max_batches=6, megastep=2,
                                     resident=True), 5, 2),
}


def _run(driver, out, monkeypatch=None, fire=None, **kw):
    module = gat_driver if driver == "gat" else dcgan_driver
    if fire is not None:
        monkeypatch.setattr(module, "GracefulShutdown",
                            lambda: CountingShutdown(fire))
    if driver == "gat":
        args = {**GAT, **kw}
        result = gat_driver.train(output_path=out, epochs=2,
                                  checkpoint_every=10, **args)
    else:
        args = {**DCGAN, **kw}
        result = dcgan_driver.train(out_dir=out, epochs=2,
                                    params=dcgan_params(10), **args)
    if fire is not None:
        monkeypatch.undo()
    return result


@pytest.mark.parametrize("case", list(CASES))
def test_a_preempted_run_resumes_bit_for_bit(tmp_path, monkeypatch, case):
    driver, kw, fire, batch = CASES[case]
    ref, run = str(tmp_path / "ref"), str(tmp_path / "run")
    _run(driver, ref, **kw)
    _, h_cut = _run(driver, run, monkeypatch, fire, **kw)
    h_cut = h_cut if driver == "gat" else h_cut.history
    assert len(next(iter(h_cut.values()))) == 1  # epoch 2 was cut
    step, saved = latest(run)
    assert step == ckpt.ckpt_step(2, batch)
    assert int(saved["epoch"]) == 2 and int(saved["mid"]["batch"]) == batch
    _run(driver, run, resume=True, **kw)
    if driver == "gat":
        assert_gat_runs_equal(ref, run)
    else:
        assert_dcgan_runs_equal(ref, run)


def test_without_checkpoints_a_preemption_stops_and_says_so(
        monkeypatch, capsys):
    monkeypatch.setattr(gat_driver, "GracefulShutdown",
                        lambda: CountingShutdown(2))
    _, history = gat_driver.train(epochs=2, **GAT)
    assert "train_loss" in history and not history["train_loss"]
    assert "WITHOUT a snapshot" in capsys.readouterr().out


def test_the_mid_at_a_stop_holds_the_jax_drivers(tmp_path, monkeypatch):
    # the JAX loaders on their C++ batch path, as the port's
    assert jax_native.available()
    kw = dict(model_type="temporal", mapping_type="linear", optimizer="sgd",
              train_batch_size=4, test_batch_size=8, epochs=2, max_batches=8,
              downsample_size=(16, 16), dataset="synthetic", seed=31,
              checkpoint_every=10)
    init, mids = {}, {}
    real_init = jax_gat_driver.create_net_state

    def keep_init(*args, **kwargs):
        state = real_init(*args, **kwargs)
        # a copy: the train step donates (deletes) the state it is given
        init["params"] = jax.device_get(state.params)
        return state

    def keep_mid(module, key):
        real = module.train_single_epoch

        def epoch(**kwargs):
            out = real(**kwargs)
            if out[-1] is not None:
                mids[key] = out[-1]
            return out
        monkeypatch.setattr(module, "train_single_epoch", epoch)

    class JaxCounting(CountingShutdown):
        def __enter__(self):
            return self

    monkeypatch.setattr(jax_gat_driver, "create_net_state", keep_init)
    monkeypatch.setattr(jax_preempt, "GracefulShutdown",
                        lambda: JaxCounting(15))
    keep_mid(jax_gat_driver, "jax")
    jax_gat_driver.train(output_path=str(tmp_path / "jax"), plot=False,
                         **kw)

    weights = from_flax_params(init["params"])
    real_build = gat_driver.build_model

    def build_with_jax_init(*args, **kwargs):
        model = real_build(*args, **kwargs)
        model.load_state_dict(weights)
        return model
    monkeypatch.setattr(gat_driver, "build_model", build_with_jax_init)
    monkeypatch.setattr(gat_driver, "GracefulShutdown",
                        lambda: CountingShutdown(15))
    keep_mid(gat_driver, "port")
    gat_driver.train(output_path=str(tmp_path / "port"), device="cpu", **kw)

    got, want = mids["port"], mids["jax"]
    assert int(got["batch"]) == int(want["batch"]) == 6
    assert int(got["total"]) == int(want["total"]) == 20
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=LOSS_RTOL)


def _capture(monkeypatch, module):
    seen = {}

    def train(**kwargs):
        seen.update(kwargs)
        return None, None
    monkeypatch.setattr(module, "train", train)
    return seen


def test_the_clis_pass_precision_and_resume(monkeypatch):
    import extended_gan_torch.dcgan.__main__ as dcgan_main
    import extended_gan_torch.gat.__main__ as gat_main

    seen = _capture(monkeypatch, dcgan_main)
    dcgan_cli(["--precision", "bf16", "--resume", "--out-dir", "/o"])
    assert (seen["precision"], seen["resume"], seen["out_dir"]) == \
        ("bf16", True, "/o")
    dcgan_cli([])
    assert (seen["precision"], seen["resume"]) == ("f32", False)
    seen = _capture(monkeypatch, gat_main)
    gat_cli(["train", "--precision", "bf16"])
    assert seen["precision"] == "bf16"
    gat_cli(["train"])
    assert seen["precision"] == "f32"


def test_generate_experiment_passes_the_four_config_keys(monkeypatch,
                                                         tmp_path):
    seen = _capture(monkeypatch, gen_mod)
    gen_mod.generate_experiment("final_temp_conv",
                                output_path=str(tmp_path))
    assert {k: seen[k] for k in ("precision", "remat", "checkpoint_every",
                                 "resume")} == dict(
        precision="f32", remat=False, checkpoint_every=0, resume=False)
    gat_cli(["generate_experiment", "--exp_folder_name", "final_temp_conv",
             "--precision", "bf16"])
    assert seen["precision"] == "bf16"
    # and the driver takes them: the config keys at their "on" values
    model, history = gat_driver.train(
        **{**GAT, "max_batches": 2}, epochs=1, output_path=str(tmp_path),
        precision="bf16", remat=True, checkpoint_every=1, resume=True)
    assert len(history["val_loss"]) == 1
    assert os.path.exists(os.path.join(tmp_path, "checkpoints",
                                       f"step_{ckpt.ckpt_step(2)}.pt"))
    assert all(p.dtype == torch.float32 for p in model.parameters())
