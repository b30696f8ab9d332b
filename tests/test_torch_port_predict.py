"""``python -m extended_gan_torch.serve predict`` against the JAX package's
``scripts/predict.py``, on the CPU.

The same experiment (``local_temporal_conv``'s config at 8x8), the same
weights (the JAX side's ``model.msgpack`` written with its own
``save_model``, the port's ``model.pt`` carried over with
``from_flax_params``), the same synthetic fallback: the loaders feed
byte-identical batches in order (``shuffle=False``; both loaders on their
C++ batch path), the predictions agree
within 1e-5, the targets exactly, ``samples`` equal and ``mse`` within 1e-5
relative; both summaries carry the same keys.
"""

import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extended_gan_tpu.data import native as jax_native
from extended_gan_tpu.data import streaming as jax_streaming
from extended_gan_tpu.models.registry import build_model as jax_build_model
from extended_gan_tpu.train.checkpoint import save_model as jax_save_model
from extended_gan_torch.data import streaming
from extended_gan_torch.models.convert import from_flax_params
from extended_gan_torch.serve.__main__ import main as cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPERIMENT = os.path.join(REPO, "convolutional_gat", "experiments",
                          "local_temporal_conv")
TOL = 1e-5
HW, B = 8, 8


@pytest.fixture
def jax_native_loader():
    """The JAX loader's C++ batch path, as the port's: its numpy path
    normalises in another order, a few ulps away, and JAX falls back to it
    without a word when its build fails."""
    assert jax_native.available()


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """An experiment directory holding config.py, JAX's model.msgpack and
    the port's model.pt of the same weights."""
    exp = tmp_path_factory.mktemp("exp")
    shutil.copy(os.path.join(EXPERIMENT, "config.py"), exp / "config.py")
    model = jax_build_model("temporal", image_width=HW, image_height=HW,
                            n_vertices=6, mapping_type="conv", time_steps=4)
    variables = jax.device_get(jax.jit(model.init)(
        jax.random.PRNGKey(2), jnp.zeros((2, HW, HW, 4, 6))))
    jax_save_model(str(exp / "model.msgpack"), variables["params"],
                   variables.get("batch_stats"))
    torch.save(from_flax_params(variables["params"],
                                variables.get("batch_stats")),
               exp / "model.pt")
    return str(exp)


@pytest.mark.parametrize("split", [0, 2])
def test_unshuffled_loaders_feed_identical_batches(jax_native_loader, split):
    kw = dict(dataset="synthetic", downsample_size=(HW, HW), shuffle=False)
    got = streaming.get_loaders(B, B, "", **kw)[split]
    want = jax_streaming.get_loaders(B, B, "", **kw)[split]
    n = 0
    for (xg, yg), (xw, yw) in zip(got, want):
        for a, b in ((xg, xw), (yg, yw)):
            assert a.shape == b.shape and a.dtype == b.dtype == np.float32
            assert a.tobytes() == b.tobytes()
        n += 1
    assert n >= 3


def test_predict_matches_scripts_predict(experiment, tmp_path,
                                         jax_native_loader):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import predict as jax_predict
    finally:
        sys.path.pop(0)
    args = [experiment, "--preprocessed-folder", str(tmp_path / "none"),
            "--downsample-size", str(HW), str(HW), "--batch-size", str(B),
            "--max-batches", "3"]
    want = jax_predict.main([*args, "--out", str(tmp_path / "jax.npz")])
    got = cli(["predict", *args, "--out", str(tmp_path / "torch.npz"),
               "--device", "cpu"])
    assert sorted(got) == sorted(want)
    assert got["samples"] == want["samples"] > 2 * B
    assert got["split"] == want["split"] == "test"
    assert got["mse"] == pytest.approx(want["mse"], rel=TOL)
    g, w = np.load(got["out"]), np.load(want["out"])
    assert sorted(g.files) == sorted(w.files) == ["predictions", "targets"]
    np.testing.assert_array_equal(g["targets"], w["targets"])
    assert g["predictions"].shape == (got["samples"], HW, HW, 4, 6)
    np.testing.assert_allclose(g["predictions"], w["predictions"], rtol=0,
                               atol=TOL)


def test_predict_needs_the_trained_model(tmp_path):
    exp = tmp_path / "exp"
    exp.mkdir()
    shutil.copy(os.path.join(EXPERIMENT, "config.py"), exp / "config.py")
    with pytest.raises(SystemExit, match="model.pt"):
        cli(["predict", str(exp), "--downsample-size", str(HW), str(HW),
             "--batch-size", str(B), "--device", "cpu",
             "--out", str(tmp_path / "p.npz")])
    assert not os.path.exists(tmp_path / "p.npz")


def test_predict_defaults_to_the_card(experiment, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli(["predict", experiment, "--downsample-size", str(HW), str(HW),
             "--out", str(tmp_path / "p.npz")])
