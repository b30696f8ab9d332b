"""Expert parallelism through the conv-GAT driver, the vanilla GAN over the
data axis, and the data axis's default, on gloo ranks on the CPU.

- ``gat_driver.train(moe_experts=4)`` on a process group of 2
  (``torch_dp_ranks.ep_driver``; the registry's ``unet`` at 16x16):
  each rank holds 2 of the 4 experts as its parameters; ``model.pt`` and
  every checkpoint hold all 4, ``model.pt`` loads into one process's
  model, ``serve export --check`` and ``compare_models`` take it; a run
  cut after its first epoch and resumed under the same axis ends with the
  uninterrupted run's checkpoint and history, bit for bit.
- The CLI: ``python -m extended_gan_torch.gat train ... --moe-experts 4
  --data-axis 2 --device cpu`` trains (the refusal is gone), and so does
  ``--moe-experts 3`` (experts replicated, routing over the axis) with
  its figure.
- The vanilla GAN's step on 2 ranks (rows sharded, z drawn over the
  global batch, G's BatchNorm across the ranks, G's and D's gradients
  summed) against one process on the global batch, default and
  FusedProp, 2 SGD steps: within 10x the one process's own float32
  distance from its float64 run (or VANILLA_TOL where that is more); the
  CLI with ``--data-axis 2`` prints one process's losses.
- The default: an unset ``--data-axis`` is every visible card
  (``launch.default_data_axis``), one under ``--device cpu``, on a named
  card, or without a card; ``start_ranks`` starts that many.
"""

import os
import re
import shutil

import numpy as np
import pytest
import torch

import torch_dp_ranks as ranks
from extended_gan_torch.compare_models.__main__ import main as compare_main
from extended_gan_torch.gat.__main__ import main as gat_main
from extended_gan_torch.models.registry import build_model
from extended_gan_torch.models.vanilla_gan import (
    MLPDiscriminator,
    MLPGenerator,
)
from extended_gan_torch.parallel import launch
from extended_gan_torch.serve.__main__ import main as serve_main
from extended_gan_torch.train.checkpoint import CheckpointManager
from extended_gan_torch.vanilla_gan.__main__ import main as vanilla_main
from test_torch_port_gat_family import one_torch_thread  # noqa: F401 - the autouse fixture

HW, E, EPOCHS = 16, 4, 2
KW = dict(model_type="unet", mapping_type="linear", dataset="synthetic",
          downsample_size=(HW, HW), train_batch_size=4, test_batch_size=64,
          max_batches=2, moe_experts=E, epochs=EPOCHS)
VANILLA_TOL = 1e-6
V_SHAPE, V_LATENT, V_BATCH = (1, 8, 8), 16, 8


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The file's two sets of gloo ranks, started together: the driver's
    runs (their output folder, their ``finish``) and the vanilla GAN's
    steps (the cases, their ``finish``)."""
    out = str(tmp_path_factory.mktemp("ep_driver"))
    cases = {f"fused {f}": _vanilla_payload(f) for f in (False, True)}
    return ((out, ranks.start("ep_driver", 2,
                              tmp_path_factory.mktemp("ranks"),
                              {"out": out, "kw": KW})),
            (cases, ranks.start("vanilla_cases", 2,
                                tmp_path_factory.mktemp("vanilla"), cases)))


@pytest.fixture(scope="module")
def driver(started):
    out, finish = started[0]
    return out, finish()


def _latest(path):
    mgr = CheckpointManager(os.path.join(path, "checkpoints"))
    return torch.load(os.path.join(path, "checkpoints",
                                   f"step_{mgr.latest_step()}.pt"),
                      weights_only=False)


def test_ep_ranks_hold_their_experts(driver):
    _, res = driver
    for r, got in enumerate(res):
        for run in ("whole", "cut"):
            assert got["sizes"][run] == {"w1": (E // 2, 512, 1024),
                                         "experts": (2 * r, 2 * r + 2)}


def test_model_pt_and_checkpoints_hold_all_experts(driver, tmp_path):
    out, _ = driver
    whole = os.path.join(out, "whole")
    state = torch.load(os.path.join(whole, "model.pt"), weights_only=True)
    assert state["unet.moe.w1"].shape == (E, 512, 1024)
    model = build_model("unet", image_width=HW, image_height=HW,
                        n_vertices=6, mapping_type="linear", device="cpu",
                        moe_experts=E)
    model.load_state_dict(state)
    ckpt = _latest(whole)
    assert ckpt["state"]["model"]["unet.moe.w1"].shape == (E, 512, 1024)
    moments = [st for st in ckpt["state"]["optimizer"]["state"].values()
               if st["exp_avg"].shape == (E, 512, 1024)]
    assert len(moments) == 1
    # serve export and compare_models read the run in one process
    exp = tmp_path / "exps" / "ep"
    exp.mkdir(parents=True)
    shutil.copy(os.path.join(whole, "model.pt"), exp / "model.pt")
    (exp / "config.py").write_text(
        'MODEL_TYPE = "unet"\nMAPPING_TYPE = "linear"\n'
        f"DOWNSAMPLE_SIZE = ({HW}, {HW})\nMOE_EXPERTS = {E}\n")
    serve_main(["export", str(exp), "--out", str(tmp_path / "ep.pt"),
                "--check", "--device", "cpu"])
    assert (tmp_path / "ep.pt").exists()
    compare_main(["--base-folder", str(tmp_path / "exps"), "--folders", "ep",
                  "--out-path", str(tmp_path / "cmp"), "--dataset",
                  "synthetic", "--device", "cpu"])
    assert (tmp_path / "cmp" / "results.json").exists()


def test_a_cut_run_resumes_under_the_axis(driver):
    out, res = driver
    whole, cut = (_latest(os.path.join(out, n)) for n in ("whole", "cut"))
    assert whole["epoch"] == cut["epoch"] == EPOCHS
    a, b = whole["state"], cut["state"]
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    for i, st in a["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, b["optimizer"]["state"][i][k]), (i, k)
    assert res[0]["history"]["whole"] == res[0]["history"]["cut"]


@pytest.mark.parametrize("experts", [E, 3])
def test_the_cli_trains_moe_over_the_data_axis(tmp_path, capfd, experts):
    """E = 4 shards 2 experts a rank; E = 3 stays replicated, and its
    routing over the axis still needs both ranks in every forward, the
    figure's included (rank 0 alone there would wait forever)."""
    gat_main(["train", "--model-type", "unet", "--mapping-type", "linear",
              "--dataset", "synthetic", "--downsample-size", str(HW), str(HW),
              "--train-batch-size", "4", "--test-batch-size", "64",
              "--epochs", "1", "--max-batches", "1", "--moe-experts",
              str(experts), "--data-axis", "2", "--device", "cpu",
              "--output-path", str(tmp_path)])
    text = capfd.readouterr().out
    assert (f"[expert parallel] {experts} experts over 2 ranks: 2 on this "
            "rank" in text) is (experts == E)
    assert "[data axis] 2 ranks in sync" in text
    state = torch.load(tmp_path / "model.pt", weights_only=True)
    assert state["unet.moe.b1"].shape[0] == experts


# ------------------------------------------------------- the vanilla GAN
def _vanilla_payload(fused_prop, dtype=torch.float32):
    gen = torch.Generator().manual_seed(1)
    g = MLPGenerator(V_SHAPE, V_LATENT, generator=gen)
    d = MLPDiscriminator(V_SHAPE, generator=gen)
    rng = np.random.default_rng(4)
    return {"img_shape": V_SHAPE, "latent": V_LATENT, "lr": 0.1,
            "fused_prop": fused_prop, "dtype": dtype,
            "states": [g.state_dict(), d.state_dict()],
            "batches": [rng.uniform(-1, 1, (V_BATCH,) + V_SHAPE).astype(
                np.float32) for _ in range(2)]}


@pytest.fixture(scope="module")
def vanilla(started):
    cases, finish = started[1]
    return cases, finish()


def _gap(a, b):
    return max(np.abs(np.asarray(x) - np.asarray(y)).max()
               / max(np.abs(np.asarray(y)).max(), 1e-30)
               for x, y in zip(a, b))


def _flat(res):
    return ([np.array([v for log in res["logs"] for v in log.values()])]
            + [v for net in res["state"] for v in net.values()])


@pytest.mark.parametrize("fused", [False, True])
def test_vanilla_gan_over_the_axis_matches_one_process(vanilla, fused):
    cases, res = vanilla
    case = cases[f"fused {fused}"]
    one = ranks.vanilla_steps(None, case)
    want = ranks.vanilla_steps(None, dict(case, dtype=torch.float64))
    floor = _gap(_flat(one), _flat(want))
    got = [_flat(r[f"fused {fused}"]) for r in res]
    assert all(np.array_equal(a, b) for a, b in zip(*got))
    assert _gap(got[0], _flat(want)) <= max(VANILLA_TOL, 10 * floor)


def test_vanilla_cli_over_the_axis_prints_one_process_losses(tmp_path,
                                                             capfd):
    argv = ["--device", "cpu", "--n_epochs", "1", "--max_batches", "3",
            "--sample_interval", "2", "--data_root", "", "--batch_size",
            "16"]
    losses = {}
    for axis in (1, 2):
        vanilla_main(argv + ["--out_dir", str(tmp_path / str(axis)),
                             "--data-axis", str(axis)])
        losses[axis] = np.array(re.findall(
            r"\[D loss: ([-\d.e]+)\] \[G loss: ([-\d.e]+)\]",
            capfd.readouterr().out), float)
        assert sorted(os.listdir(tmp_path / str(axis))) == ["0.png",
                                                             "2.png"]
    assert losses[1].shape == losses[2].shape == (3, 2)
    np.testing.assert_allclose(losses[2], losses[1], rtol=1e-5)


# ------------------------------------------------------------ the default
def test_the_data_axis_default_is_every_visible_card(monkeypatch):
    assert launch.default_data_axis() == 1  # no card here
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert launch.default_data_axis() == 4
    assert launch.default_data_axis("cuda") == 4
    assert launch.default_data_axis("cuda:1") == 1
    assert launch.default_data_axis("cpu") == 1
    spawned = []
    monkeypatch.setattr(launch, "spawn_ranks",
                        lambda entry, argv, size, device: spawned.append(
                            size))
    assert launch.start_ranks("m:f", [], data_axis=None, multihost=False)
    assert not launch.start_ranks("m:f", [], data_axis=None,
                                  multihost=False, device="cpu")
    assert not launch.start_ranks("m:f", [], data_axis=1, multihost=False)
    assert spawned == [4]
