"""The conv-GAT helpers no slice ported before: ``utils/metrics.py``'s
``thresholded_metrics``, ``get_metrics``, ``nowcast_scores``,
``accuracy_criterion`` and ``denormalize``, ``gat/utils.py``'s
``model_persistence``, and ``python -m extended_gan_torch.plot_image``,
held against the JAX package's on the CPU in the cases of
``tests/test_nowcast_scores.py``, ``tests/test_metrics.py:59-80`` and
``tests/test_predict.py:62-63`` (the JAX plot_image test is marked slow;
this one trains a 16x16 GAT3D for two steps and runs in seconds), and on
seeded random batches."""

from __future__ import annotations

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convolutional_gat.utils import model_persistence as jax_persistence
from extended_gan_tpu.utils import metrics as jax_metrics
from extended_gan_torch.gat.utils import model_persistence
from extended_gan_torch.utils import metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0, equal_nan=True)


def _random(seed, shape=(4, 8, 8, 4, 3)):
    rng = np.random.default_rng(seed)
    return (rng.random(shape, np.float32), rng.random(shape, np.float32))


NOWCAST_CASES = {
    # the four cases of tests/test_nowcast_scores.py
    "hand computed": (np.array([0.9, 0.8, 0.1, 0.2]),
                      np.array([0.7, 0.3, 0.9, 0.1]), None),
    "perfect": (np.array([[0.9, 0.1], [0.2, 0.8]]),
                np.array([[0.9, 0.1], [0.2, 0.8]]), None),
    "masked": (np.array([[0.9], [0.1]]), np.array([[0.1], [0.9]]),
               np.array([1.0, 0.0])),
    "all dry": (np.zeros((2, 3)), np.zeros((2, 3)), None),
    "random": (*_random(0), None),
    "random masked": (*_random(1), np.array([1.0, 0.0, 1.0, 1.0])),
}


@pytest.mark.parametrize("case", sorted(NOWCAST_CASES))
def test_nowcast_scores_match_jax(case):
    y, p, mask = NOWCAST_CASES[case]
    want = jax_metrics.nowcast_scores(
        jnp.asarray(y, jnp.float32), jnp.asarray(p, jnp.float32), 0.5,
        mask=None if mask is None else jnp.asarray(mask, jnp.float32))
    got = metrics.nowcast_scores(torch.as_tensor(y, dtype=torch.float32),
                                 torch.as_tensor(p, dtype=torch.float32),
                                 0.5, mask=None if mask is None
                                 else torch.as_tensor(mask))
    assert sorted(got) == sorted(want) == ["csi", "f1", "far"]
    for k in want:
        assert got[k].dtype == torch.float32
        _same(got[k], want[k])
    if case == "hand computed":  # TP = FP = FN = 1
        assert abs(float(got["csi"]) - 1 / 3) < 1e-6
        assert float(got["far"]) == 0.5 and float(got["f1"]) == 0.5
    if case == "masked":
        assert float(got["csi"]) == 0.0 and np.isnan(float(got["far"]))


THRESHOLDED = {
    # tests/test_metrics.py::test_thresholded_metrics_scaling
    "scaling": (np.array([[0.1, 0.9], [0.9, 0.1]], np.float32),
                np.array([[0.1, 0.9], [0.1, 0.9]], np.float32), 0.5),
    "jittable": (np.ones((4, 8), np.float32), np.ones((4, 8), np.float32),
                 0.5),
    "no positives": (np.zeros((3, 5), np.float32),
                     np.zeros((3, 5), np.float32), 0.5),
    "random": (*_random(2), 0.3),
}


@pytest.mark.parametrize("case", sorted(THRESHOLDED))
def test_thresholded_metrics_and_get_metrics_match_jax(case):
    y, p, threshold = THRESHOLDED[case]
    want = jax_metrics.thresholded_metrics(jnp.asarray(y), jnp.asarray(p),
                                           threshold)
    got = metrics.thresholded_metrics(torch.from_numpy(y),
                                      torch.from_numpy(p), threshold)
    assert got.shape == (3,) and got.dtype == torch.float32
    _same(got, want)
    _same(metrics.get_metrics(y, p, threshold),
          jax_metrics.get_metrics(y, p, threshold))
    if case == "scaling":
        assert tuple(map(float, metrics.get_metrics(y, p, threshold))) == \
            (1.0, 1.0, 1.0)


@pytest.mark.parametrize("a,b", [
    (np.array([0.4, 0.6, 0.9]), np.array([0.0, 1.0, 1.0])),
    (np.array([0.4, 0.6, 0.2, 0.7]), np.array([1.0, 1.0, 0.0, 0.0]))])
def test_accuracy_criterion_matches_jax(a, b):
    got = metrics.accuracy_criterion(a, b)
    want = jax_metrics.accuracy_criterion(a, b)
    np.testing.assert_array_equal(got.val, want.val)
    assert got.item() == want.item()


def test_denormalize_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.random((3, 4, 4), np.float32)
    mean = rng.random(7, np.float32)
    var = rng.random(7, np.float32)
    _same(metrics.denormalize(torch.from_numpy(x), mean, var),
          jax_metrics.denormalize(jnp.asarray(x), jnp.asarray(mean),
                                  jnp.asarray(var)))


def test_model_persistence_matches_jax():
    x = _random(5, (2, 6, 5, 4, 3))[0]
    got = model_persistence(x)
    np.testing.assert_array_equal(got, jax_persistence(x))
    assert got.shape == x.shape
    np.testing.assert_array_equal(got[:, :, :, 0], x[:, :, :, -1])


def test_plot_image_cli(tmp_path):
    """``python -m extended_gan_torch.plot_image`` on a trained experiment
    directory (``config.py`` and the port's ``model.pt``): the
    ``pred_{epoch}.png`` grid, drawn through ``utils/viz.py`` from the
    model's predictions; a directory without ``model.pt`` is refused."""
    from extended_gan_torch.gat.generate_experiment import generate_experiment
    from extended_gan_torch.plot_image import main

    exp = tmp_path / "synthetic_smoke"
    generate_experiment("synthetic_smoke", output_path=str(exp), epochs=1,
                        max_batches=2, device="cpu")
    shutil.copy(os.path.join(REPO, "convolutional_gat", "experiments",
                             "synthetic_smoke", "config.py"), exp)
    out = main([str(exp), "--dataset", "synthetic", "--raininess", "0.2",
                "--epoch", "3", "--out", str(tmp_path), "--device", "cpu"])
    assert out == str(tmp_path / "pred_3.png")
    assert os.path.getsize(out) > 0
    os.remove(exp / "model.pt")
    with pytest.raises(SystemExit, match="no checkpoint"):
        main([str(exp), "--dataset", "synthetic", "--device", "cpu"])
