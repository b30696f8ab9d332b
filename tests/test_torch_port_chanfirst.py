"""``conv_impl="chanfirst"``: the port's positions-on-lanes conv mapping
(``models/gat/gat3d.py::chanfirst_bottleneck``) against the JAX package's
(``gat3d.py:69-108``), on the CPU.

- ``_Mapping`` and the whole GAT3D ``Model`` with the conv mapping, JAX's
  ``conv_impl="chanfirst"`` initialisation carried over leaf for leaf
  (``models/convert.py``: the parameters are the same tensors on every
  path): the forward within the 2e-5 bar (``test_e2e_torch_parity.py``),
  the input's and every parameter's gradient within 2e-5 of each
  gradient's largest entry; and both within the same bars of the port's own
  cuDNN path (``conv_impl="nhwc"``) on the same weights.
- The drivers' ``conv_impl``: ``"auto"`` builds the cuDNN mapping, as in
  JAX, ``"chanfirst"`` this one; the registry passes it only to the models
  that take it, with the JAX registry's note for the others; ``--conv-impl
  chanfirst`` trains through the CLI at 12x12 (JAX
  ``tests/test_chanfirst_driver.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extended_gan_tpu.models.gat.gat3d import Model as FlaxModel
from extended_gan_tpu.models.gat.gat3d import _Mapping as FlaxMapping
from extended_gan_torch.gat.__main__ import main as cli
from extended_gan_torch.models.convert import from_flax_params
from extended_gan_torch.models.gat.gat3d import Model, _Mapping
from extended_gan_torch.models.registry import build_model
from extended_gan_torch.train import gat_driver

TOL = 2e-5
B, T, V = 2, 4, 6


def _x(hw, seed=0):
    return np.random.default_rng(seed).random((B, hw, hw, T, V), np.float32)


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= TOL * scale, what


def _torch_mapping(params, impl):
    m = _Mapping(T, T, "conv", nheads=1, conv_impl=impl)
    with torch.no_grad():
        for name in ("conv1", "conv2", "conv3"):
            conv = getattr(m, name)
            conv.weight.copy_(torch.from_numpy(np.asarray(
                params[name]["kernel"]).transpose(3, 2, 0, 1)[None]))
            conv.bias.copy_(torch.from_numpy(np.asarray(
                params[name]["bias"])[None]))
    return m


@pytest.mark.parametrize("hw", [8, 13])
def test_mapping_forward_and_gradients_match_jax(hw):
    x = _x(hw)
    fm = FlaxMapping(T, T, "conv", conv_impl="chanfirst")
    params = fm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    cot = np.random.default_rng(2).standard_normal((B, hw, hw, T, V)).astype(
        np.float32)

    def loss(p, xx):
        y = fm.apply({"params": p}, xx)
        return jnp.sum(y * cot), y
    (_, want), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    outs = {}
    for impl in ("chanfirst", "nhwc"):
        m = _torch_mapping(params, impl)
        xt = torch.from_numpy(x).requires_grad_(True)
        y = m(xt)[0]
        (y * torch.from_numpy(cot)).sum().backward()
        outs[impl] = y.detach().numpy()
        _close(outs[impl], want, f"{impl} forward")
        _close(xt.grad, gx, f"{impl} dx")
        for name in ("conv1", "conv2", "conv3"):
            conv = getattr(m, name)
            _close(conv.weight.grad[0].permute(2, 3, 1, 0),
                   gp[name]["kernel"], f"{impl} {name} kernel")
            _close(conv.bias.grad[0], gp[name]["bias"], f"{impl} {name} bias")
    _close(outs["chanfirst"], outs["nhwc"], "chanfirst against cuDNN")


def test_model_forward_and_gradients_match_jax():
    hw = 12
    x = _x(hw, seed=3)
    fm = FlaxModel(hw, hw, V, "temporal", "conv", conv_impl="chanfirst")
    params = fm.init(jax.random.PRNGKey(4), jnp.asarray(x))["params"]

    def loss(p):
        y = fm.apply({"params": p}, jnp.asarray(x))
        return jnp.mean((y - 0.5) ** 2), y
    (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    grads = from_flax_params(grads)
    outs = {}
    for impl in ("chanfirst", "nhwc"):
        model = Model(hw, hw, V, "temporal", "conv", conv_impl=impl)
        model.load_state_dict(from_flax_params(params))
        y = model(torch.from_numpy(x))
        ((y - 0.5) ** 2).mean().backward()
        outs[impl] = y.detach().numpy()
        _close(outs[impl], want, f"{impl} forward")
        for name, p in model.named_parameters():
            _close(p.grad, grads[name], f"{impl} {name}")
    _close(outs["chanfirst"], outs["nhwc"], "chanfirst against cuDNN")


def test_chanfirst_takes_square_images_and_known_forms():
    m = _Mapping(T, T, "conv", nheads=1, conv_impl="chanfirst")
    with pytest.raises(ValueError, match="square"):
        m(torch.zeros(1, 6, 8, T, V))
    with pytest.raises(ValueError, match="conv_impl"):
        _Mapping(T, T, "conv", conv_impl="nchw")


def test_the_driver_and_registry_pass_conv_impl(monkeypatch, capsys):
    kw = dict(image_width=8, image_height=8, n_vertices=V,
              mapping_type="conv", device="cpu")
    model = build_model("temporal", conv_impl="chanfirst", **kw)
    assert {m.conv_impl for m in model.modules()
            if isinstance(m, _Mapping)} == {"chanfirst"}
    build_model("temporal4h", conv_impl="chanfirst", **kw)
    assert "has no conv_impl switch; ignored" in capsys.readouterr().out
    built = []
    real = gat_driver.build_model

    def keep(*args, **kwargs):
        built.append(kwargs["conv_impl"])
        return real(*args, **kwargs)
    monkeypatch.setattr(gat_driver, "build_model", keep)
    for impl in ("auto", "chanfirst"):
        gat_driver.train(model_type="temporal", mapping_type="conv",
                         dataset="synthetic", downsample_size=(8, 8),
                         train_batch_size=4, epochs=1, max_batches=1,
                         device="cpu", conv_impl=impl)
    assert built == ["nhwc", "chanfirst"]


def test_cli_trains_with_chanfirst(tmp_path):
    _, history = cli(["train", "--model-type", "temporal", "--mapping-type",
                      "conv", "--dataset", "synthetic", "--epochs", "1",
                      "--train-batch-size", "8", "--test-batch-size", "8",
                      "--max-batches", "2", "--downsample-size", "12", "12",
                      "--conv-impl", "chanfirst", "--output-path",
                      str(tmp_path), "--device", "cpu"])
    assert np.isfinite(history["train_loss"][0])
    assert np.isfinite(history["val_loss"][-1])
