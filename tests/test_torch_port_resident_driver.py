"""``megastep`` and ``resident`` through the port's drivers and CLIs, on the
CPU (the CUDA graphs are the card's: ``chip_smoke.py``'s ``megastep``
phase and ``tests/test_torch_port_cuda.py``).

- The conv-GAT driver trains with ``megastep=2``, with ``resident=True``
  on a KNMI archive and on an ARAI one, and the DCGAN driver with both:
  finite histories, the artifacts written. GAT3D has no BatchNorm, so its
  megastep epoch (the short tail batch padded and masked) equals the
  single-step epoch.
- The guard rails raise: ``resident`` on any dataset but kmni, synthetic
  and arai; ``spatial`` stays unported. Neither driver's ``_NOT_PORTED``
  lists ``megastep`` or ``resident`` any more.
- ``--megastep`` and ``--resident`` parse in both CLIs and reach the
  drivers, from the command line and from an experiment's config.
"""

import json
import os

import numpy as np
import pytest
import torch

from extended_gan_torch.data import synthetic
from extended_gan_torch.dcgan.__main__ import main as dcgan_cli
from extended_gan_torch.gat.__main__ import main as gat_cli
from extended_gan_torch.train import dcgan_driver, gat_driver
from test_torch_port_gat_family import one_torch_thread  # noqa: F401 - the autouse fixture

GAT = dict(model_type="temporal", mapping_type="conv", train_batch_size=4,
           test_batch_size=4, epochs=2, learning_rate=1e-3,
           downsample_size=(12, 12), device="cpu", seed=7)


@pytest.fixture(scope="module")
def kmni(tmp_path_factory):
    return synthetic.make_kmni_dataset(
        str(tmp_path_factory.mktemp("kmni")), n_train_files=2,
        n_test_files=1, frames_per_file=24, hw=16, seed=5)


def _finite(history):
    return all(np.isfinite(v).all() for v in history.values())


@pytest.mark.parametrize("options", [
    dict(megastep=2), dict(resident=True), dict(resident=True, megastep=3)],
    ids=["megastep", "resident", "resident-megastep"])
def test_gat_driver_trains(kmni, tmp_path, capsys, options):
    out = str(tmp_path / "out")
    model, history = gat_driver.train(
        output_path=out, preprocessed_folder=kmni, dataset="kmni",
        max_batches=5, **GAT, **options)
    assert len(history["train_loss"]) == len(history["val_loss"]) == 2
    assert _finite(history)
    with open(os.path.join(out, "history.json")) as f:
        assert json.load(f)["val_loss"] == history["val_loss"]
    assert os.path.isfile(os.path.join(out, "model.pt"))
    text = capsys.readouterr().out
    if options.get("resident"):
        k = options.get("megastep", 8)
        assert f"K={k} steps per CUDA graph" in text
        assert "MB live in device memory" in text
    else:
        assert "[megastep] 2 steps per CUDA graph" in text


def test_gat_megastep_epoch_equals_the_single_step_epoch(kmni):
    """The loader's seeded batches, the last of each epoch short: padded and
    masked in groups of 2, or fed as they come, the same updates."""
    common = dict(preprocessed_folder=kmni, dataset="kmni", optimizer="sgd",
                  **GAT)
    single, h1 = gat_driver.train(**common)
    mega, h2 = gat_driver.train(megastep=2, **common)
    np.testing.assert_allclose(h2["train_loss"], h1["train_loss"], rtol=1e-6)
    np.testing.assert_allclose(h2["val_loss"], h1["val_loss"], rtol=1e-6)
    for p, q in zip(single.parameters(), mega.parameters()):
        torch.testing.assert_close(q, p, rtol=1e-6, atol=1e-7)


def test_gat_driver_trains_resident_arai(tmp_path):
    data = synthetic.make_arai_dataset(str(tmp_path / "arai"), n_files=2,
                                       frames_per_file=16, n_regions=5, h=12,
                                       w=12)
    _, history = gat_driver.train(
        preprocessed_folder=data, dataset="arai", resident=True, megastep=2,
        **{**GAT, "downsample_size": (8, 8)})
    assert len(history["train_loss"]) == 2 and _finite(history)


@pytest.mark.parametrize("options", [
    dict(megastep=2), dict(resident=True, megastep=2)],
    ids=["megastep", "resident"])
def test_dcgan_driver_trains(tmp_path, options):
    nets, history = dcgan_driver.train(
        epochs=1, train_batch_size=4, test_batch_size=8, max_batches=3,
        synthetic=True, out_dir=str(tmp_path), device="cpu", **options)
    row = history.history
    assert sorted(row) == sorted([
        "train_mse", "train_fd_accuracy", "train_td_accuracy",
        "frame_disc_accuracy", "temp_disc_accuracy", "pred_accuracy",
        "pred_precision", "pred_recall", "pred_mse"])
    assert _finite(row) and len(row["train_mse"]) == 1
    assert os.path.isfile(tmp_path / "history.json")
    assert all(bool(p.isfinite().all()) for n in nets for p in n.parameters())


def test_guard_rails_raise(kmni):
    with pytest.raises(ValueError, match="kmni/synthetic/arai"):
        gat_driver.train(dataset="coastal", resident=True, **GAT)
    with pytest.raises(NotImplementedError, match="item 9"):
        gat_driver.train(dataset="kmni", preprocessed_folder=kmni,
                         resident=True, spatial=True, **GAT)
    with pytest.raises(NotImplementedError, match="item 9"):
        dcgan_driver.train(synthetic=True, resident=True, spatial=True,
                           device="cpu")
    for table in (gat_driver._NOT_PORTED, dcgan_driver._NOT_PORTED):
        assert "megastep" not in table and "resident" not in table


def test_cli_flags_reach_the_drivers(monkeypatch, kmni):
    seen = []

    def record(**kwargs):
        seen.append({k: kwargs.get(k) for k in ("megastep", "resident")})
        return None, None

    monkeypatch.setattr("extended_gan_torch.gat.__main__.train", record)
    monkeypatch.setattr(
        "extended_gan_torch.gat.generate_experiment.train", record)
    monkeypatch.setattr("extended_gan_torch.dcgan.__main__.train", record)
    gat_cli(["train", "--megastep", "4", "--resident"])
    gat_cli(["train"])
    gat_cli(["generate_experiment", "--exp_folder_name", "final_temp_conv",
             "--megastep", "2", "--resident"])
    gat_cli(["generate_experiment", "--exp_folder_name", "final_temp_conv"])
    dcgan_cli(["--megastep", "8", "--resident"])
    dcgan_cli([])
    assert seen == [{"megastep": 4, "resident": True},
                    {"megastep": 0, "resident": False},
                    {"megastep": 2, "resident": True},
                    {"megastep": 0, "resident": False},
                    {"megastep": 8, "resident": True},
                    {"megastep": 0, "resident": False}]


def test_gat_cli_trains_resident_on_the_cpu(kmni, tmp_path):
    model, history = gat_cli([
        "train", "--model-type", "temporal", "--mapping-type", "conv",
        "--dataset", "kmni", "--preprocessed-folder", kmni,
        "--downsample-size", "12", "12", "--train-batch-size", "4",
        "--test-batch-size", "4", "--epochs", "1", "--max-batches", "4",
        "--resident", "--megastep", "2", "--device", "cpu"])
    assert len(history["train_loss"]) == 1 and _finite(history)
