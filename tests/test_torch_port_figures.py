"""The port's figures against the JAX package's, on the CPU.

Each figure function of ``extended_gan_torch/utils/viz.py`` and
``utils/history.py`` draws the same arrays as its JAX counterpart
(``extended_gan_tpu/utils/viz.py``, ``utils/history.py``), and the two
PNGs decode to the same pixels (matplotlib 3.10.8 here; both draw with the
Agg backend). With matplotlib made unimportable (``sys.modules``), each
call prints ``[viz] matplotlib is not installed: <path> not drawn``,
writes nothing and returns None, and a conv-GAT CLI epoch then writes the
same ``history.json`` and weights as with matplotlib, and no figure.
"""

import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from extended_gan_tpu.utils import history as jax_history
from extended_gan_tpu.utils import viz as jax_viz
from extended_gan_torch.gat.__main__ import main as gat_cli
from extended_gan_torch.utils import history, viz

ARGS = ["train", "--model-type", "temporal", "--mapping-type", "conv",
        "--dataset", "synthetic", "--downsample-size", "16", "16",
        "--train-batch-size", "4", "--test-batch-size", "8", "--epochs",
        "1", "--max-batches", "2", "--device", "cpu"]


def pixels(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"))


def same_png(a, b):
    pa, pb = pixels(a), pixels(b)
    return pa.shape == pb.shape and np.array_equal(pa, pb)


def _frames(seed, shape=(2, 4, 8, 8)):
    return np.random.default_rng(seed).random(shape, np.float32)


def _gat_loader(seed=0, rainy_at=(1, 1)):
    """Two (x, y) batches of (2, 8, 8, 4, 3); the sample ``rainy_at``
    (batch, row) the first with raininess >= 0.5."""
    rng = np.random.default_rng(seed)
    batches = []
    for b in range(2):
        x = rng.random((2, 8, 8, 4, 3), np.float32) - 0.8  # ~20% above 0
        y = rng.random((2, 8, 8, 4, 3), np.float32)
        if b == rainy_at[0]:
            x[rainy_at[1]] += 0.8
        batches.append((x, y))
    return batches


def _predict(x):
    return np.sqrt(np.abs(x)) * 0.5


def _history():
    rng = np.random.default_rng(3)
    return {k: list(rng.random(4)) for k in (
        "train_mse", "pred_mse", "frame_disc_accuracy", "temp_disc_accuracy",
        "pred_precision", "train_loss", "val_loss")}


def test_visualize_predictions_draws_jax_pixels(tmp_path):
    x, y, p = _frames(0), _frames(1), _frames(2)
    got = viz.visualize_predictions(x, y, p, 3, str(tmp_path / "port"))
    want = jax_viz.visualize_predictions(x, y, p, 3, str(tmp_path / "jax"))
    assert got == str(tmp_path / "port" / "pred.png")
    assert same_png(got, want)


def test_visualize_gat_predictions_draws_jax_pixels(tmp_path, capsys):
    for root in ("port", "jax"):
        os.makedirs(tmp_path / root)
    kw = dict(epoch=2, raininess_threshold=0.5, power=2.0)
    got = viz.visualize_gat_predictions(_predict, _gat_loader(),
                                        path=str(tmp_path / "port"), **kw)
    want = jax_viz.visualize_gat_predictions(_predict, _gat_loader(),
                                             path=str(tmp_path / "jax"), **kw)
    assert got == str(tmp_path / "port" / "pred_2.png")
    assert same_png(got, want)
    panels = viz.gat_prediction_panels(_predict, _gat_loader(), power=2.0)
    x, y = _gat_loader()[1]
    np.testing.assert_array_equal(panels[2], np.power(_predict(x)[1], 0.5))
    # no sample qualifies: JAX's line and None from both
    capsys.readouterr()
    none = dict(kw, raininess_threshold=1.01)
    assert viz.visualize_gat_predictions(
        _predict, _gat_loader(), path=str(tmp_path), **none) is None
    assert jax_viz.visualize_gat_predictions(
        _predict, _gat_loader(), path=str(tmp_path), **none) is None
    lines = capsys.readouterr().out.splitlines()
    assert lines == ["Raininess threshold too strict, hasn't found "
                     "anything"] * 2


def test_training_history_plot_draws_jax_pixels(tmp_path):
    h = _history()
    history.TrainingHistory(dict(h), save_path=str(tmp_path / "port")).plot()
    jax_history.TrainingHistory(dict(h),
                                save_path=str(tmp_path / "jax")).plot()
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == ["disc.png", "metrics.png", "mse.png"]
    assert sorted(os.listdir(tmp_path / "port")) == names
    for n in names:
        assert same_png(tmp_path / "port" / n, tmp_path / "jax" / n), n
    assert history.TrainingHistory(dict(h)).key_groups() == [
        ["train_mse", "pred_mse"],
        ["frame_disc_accuracy", "temp_disc_accuracy"],
        ["pred_precision", "train_loss", "val_loss"]]


def test_plot_history_draws_jax_pixels(tmp_path):
    h = _history()
    history.plot_history(h, save=True, filename=str(tmp_path / "port.png"))
    jax_history.plot_history(h, save=True, filename=str(tmp_path / "jax.png"))
    assert same_png(tmp_path / "port.png", tmp_path / "jax.png")


@pytest.fixture
def no_matplotlib(monkeypatch):
    """``import matplotlib`` raises ImportError, as on the card's
    machine."""
    for name in list(sys.modules):
        if name == "matplotlib" or name.startswith("matplotlib."):
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)


FIGURES = {
    "visualize_predictions": (
        lambda p: viz.visualize_predictions(_frames(0), _frames(1),
                                            _frames(2), 1, p),
        ["pred.png"]),
    "visualize_gat_predictions": (
        lambda p: viz.visualize_gat_predictions(_predict, _gat_loader(),
                                                epoch=4, path=p),
        ["pred_4.png"]),
    "TrainingHistory.plot": (
        lambda p: history.TrainingHistory(_history(), save_path=p).plot(),
        ["mse.png", "disc.png", "metrics.png"]),
    "plot_history": (
        lambda p: history.plot_history(_history(), save=True,
                                       filename=os.path.join(p, "h.png")),
        ["h.png"]),
}


@pytest.mark.parametrize("name", sorted(FIGURES))
def test_without_matplotlib_a_figure_prints_and_draws_nothing(
        name, tmp_path, capsys, no_matplotlib):
    draw, files = FIGURES[name]
    out = tmp_path / "figs"
    assert draw(str(out)) is None
    assert not out.exists()
    lines = capsys.readouterr().out.splitlines()
    assert lines == [f"[viz] matplotlib is not installed: "
                     f"{os.path.join(out, f)} not drawn" for f in files]


def _run(out):
    model, hist = gat_cli(ARGS + ["--output-path", str(out)])
    return hist, torch.load(out / "model.pt", weights_only=True)


def test_a_gat_cli_epoch_without_matplotlib_keeps_its_numbers(
        tmp_path, capsys, monkeypatch):
    drawn, weights = _run(tmp_path / "with")
    assert sorted(os.listdir(tmp_path / "with")) == [
        "history.json", "history_1.png", "model.pt", "pred_1.png"]
    capsys.readouterr()
    with pytest.MonkeyPatch.context() as mp:
        for name in list(sys.modules):
            if name == "matplotlib" or name.startswith("matplotlib."):
                mp.delitem(sys.modules, name)
        mp.setitem(sys.modules, "matplotlib", None)
        plain, plain_weights = _run(tmp_path / "without")
    out = capsys.readouterr().out
    assert plain == drawn
    assert all(torch.equal(weights[k], plain_weights[k]) for k in weights)
    assert sorted(os.listdir(tmp_path / "without")) == [
        "history.json", "model.pt"]
    for f in ("pred_1.png", "history_1.png"):
        assert (f"[viz] matplotlib is not installed: "
                f"{tmp_path / 'without' / f} not drawn") in out
