"""The port's SmaAt-UNet and UnetModel against the JAX package's flax modules.

A narrow UNet (``base=8``, 16x16, 4 images) is initialised by flax from a
seed and carried across with ``from_flax_params`` (params and batch_stats);
inputs come from ``np.random.default_rng``. Tolerances:

- eval-mode forward: 2e-5; eval-mode gradients: 1e-4 of each gradient's
  largest entry. Both sides compute in exact f32 on the CPU and differ only
  in summation order.
- train-mode forward, BN running statistics and gradients: 1e-3 of the
  largest entry. Train-mode BatchNorm normalises by the statistics of a few
  samples (4 at the 1x1 bottleneck), which amplifies f32 roundoff, and JAX
  and torch round differently. The amplification grows with the map, so
  the sizes here are kept small.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from extended_gan_tpu.models.smaat_unet import SmaAt_UNet as FlaxUNet
from extended_gan_tpu.models.unet_model import UnetModel as FlaxUnetModel
from extended_gan_torch.models.convert import from_flax_params
from extended_gan_torch.models.registry import build_model
from extended_gan_torch.models.smaat_unet import SmaAt_UNet
from extended_gan_torch.models.unet_model import UnetModel

TOL = 2e-5
TRAIN_TOL = 1e-3
N, H, C = 4, 16, 4
GRAD_TOL = 1e-4


class _FlaxNarrowUnetModel(fnn.Module):
    """The JAX UnetModel's vertex fold around a narrow SmaAt-UNet."""

    @fnn.compact
    def __call__(self, x, *, train=True):
        b, h, w, t, v = x.shape
        xb = x.transpose(0, 4, 1, 2, 3).reshape(b * v, h, w, t)
        y = FlaxUNet(n_channels=t, n_classes=t, base=8, name="unet")(
            xb, train=train)
        return y.reshape(b, v, h, w, t).transpose(0, 2, 3, 4, 1)


@pytest.fixture(scope="module")
def narrow():
    """flax narrow UNet, its variables, and the converted torch module."""
    fmodel = FlaxUNet(n_channels=C, n_classes=C, base=8)
    x = np.random.default_rng(0).random((N, H, H, C), np.float32)
    variables = jax.device_get(jax.jit(lambda k, x: fmodel.init(
        k, x, train=False))(jax.random.PRNGKey(0), jnp.asarray(x)))
    model = SmaAt_UNet(n_channels=C, n_classes=C, base=8)
    model.load_state_dict(from_flax_params(variables["params"],
                                           variables["batch_stats"]))
    return fmodel, variables, model, x


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def test_eval_forward_matches_flax(narrow):
    fmodel, variables, model, x = narrow
    want = np.asarray(jax.jit(lambda v, x: fmodel.apply(v, x, train=False))(
        variables, jnp.asarray(x)))
    with torch.no_grad():
        got = model.eval()(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_train_forward_and_bn_statistics_match_flax(narrow):
    fmodel, variables, _, x = narrow
    model = SmaAt_UNet(n_channels=C, n_classes=C, base=8)
    model.load_state_dict(from_flax_params(variables["params"],
                                           variables["batch_stats"]))
    want, upd = jax.jit(lambda v, x: fmodel.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = model.train()(_nchw(x)).permute(0, 2, 3, 1).numpy()
    _close(got, np.asarray(want), TRAIN_TOL)
    stats = from_flax_params({}, jax.device_get(upd["batch_stats"]))
    state = model.state_dict()
    for k, v in stats.items():
        if "running" in k:  # flax 0.9 / 0.99 momentum == torch 0.1 / 0.01
            _close(state[k].numpy(), v.numpy(), TRAIN_TOL)
    # the comparison is not vacuous: both kinds of BN moved off their init
    assert state["cbam1.spatial.bn.running_mean"].abs().item() > 0
    assert state["inc.bn0.running_mean"].abs().max().item() > 0


@pytest.mark.parametrize("train,tol", [(True, TRAIN_TOL), (False, GRAD_TOL)])
def test_gradients_match_flax(narrow, train, tol):
    fmodel, variables, model, x = narrow
    cot = np.random.default_rng(1).standard_normal((N, H, H, C)).astype(
        np.float32)

    def loss(params):
        y, _ = fmodel.apply({"params": params,
                             "batch_stats": variables["batch_stats"]},
                            jnp.asarray(x), train=train,
                            mutable=["batch_stats"])
        return jnp.sum(y * cot)

    want = from_flax_params(jax.device_get(
        jax.jit(jax.grad(loss))(variables["params"])))
    model.load_state_dict(from_flax_params(variables["params"],
                                           variables["batch_stats"]))
    model.train(train).zero_grad()
    (model(_nchw(x)).permute(0, 2, 3, 1) * torch.from_numpy(cot)).sum() \
        .backward()
    grads = dict(model.named_parameters())
    assert sorted(grads) == sorted(want)
    for name, g in want.items():
        if train and name.endswith(("depthwise_bias", "pointwise_bias")):
            # BatchNorm follows every DSC: in train mode a bias added before
            # it shifts a whole channel, which BN subtracts again. Its
            # gradient is zero up to roundoff on both sides.
            assert grads[name].grad.abs().max() < 1e-3 * grads[
                name.replace("bias", "weight")].grad.abs().max()
            continue
        _close(grads[name].grad.numpy(), g.numpy(), tol)


def test_unet_model_folds_vertices_like_flax():
    """UnetModel's (B, H, W, T, V) fold around a narrow UNet, eval mode."""
    b, v = 2, 2
    fmodel = _FlaxNarrowUnetModel()
    x = np.random.default_rng(2).random((b, H, H, C, v), np.float32)
    variables = jax.device_get(jax.jit(lambda k, x: fmodel.init(
        k, x, train=False))(jax.random.PRNGKey(1), jnp.asarray(x)))
    model = UnetModel(H, H, v, time_steps=C)
    model.unet = SmaAt_UNet(n_channels=C, n_classes=C, base=8)
    model.load_state_dict(from_flax_params(variables["params"],
                                           variables["batch_stats"]))
    want = np.asarray(jax.jit(lambda v, x: fmodel.apply(v, x, train=False))(
        variables, jnp.asarray(x)))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_unet_model_parameter_count_is_the_references_4032548():
    model = build_model("unet", image_width=20, image_height=20, n_vertices=6,
                        mapping_type="linear", device="cpu")
    assert sum(p.numel() for p in model.parameters()) == 4_032_548
    assert not model.training  # build_model hands it over in eval mode


def test_unet_model_state_matches_the_flax_tree_leaf_for_leaf():
    fmodel = FlaxUnetModel(image_width=20, image_height=20, n_vertices=6)
    shapes = jax.eval_shape(lambda: fmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 20, 20, 4, 6)), train=False))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   shapes)
    converted = from_flax_params(zeros["params"], zeros["batch_stats"])
    state = build_model("unet", image_width=20, image_height=20, n_vertices=6,
                        mapping_type="linear", device="cpu").state_dict()
    assert sorted(converted) == sorted(state)
    for k, v in converted.items():
        assert v.shape == state[k].shape, k
    # grouped depthwise order carries over as it is: (3,3,1,CK) -> (CK,1,3,3)
    flat = traverse_util.flatten_dict(zeros["params"], sep=".")
    assert flat["unet.inc.dsc0.depthwise_kernel"].shape == (3, 3, 1, 8)
    assert state["unet.inc.dsc0.depthwise_weight"].shape == (8, 1, 3, 3)


@pytest.mark.parametrize("kwargs", [dict(per_vertex_bn=True),
                                    dict(moe_experts=4)])
def test_unported_unet_options_raise(kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        UnetModel(20, 20, 6, **kwargs)
