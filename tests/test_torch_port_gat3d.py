"""The port's GAT3D ``Model`` against the JAX package's flax ``Model``.

Weights are initialised by flax from a seed and carried across with
``from_flax_params``; inputs come from ``np.random.default_rng``. The
whole forward agrees with ``Model.apply(train=False)`` at 2e-5 (both sides
compute in exact f32 on the CPU; only summation orders differ).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from extended_gan_tpu.models.gat import layers as jax_layers
from extended_gan_tpu.models.gat.gat3d import Model as FlaxModel
from extended_gan_torch.models.convert import from_flax_params, load_flax_npz
from extended_gan_torch.models.gat import layers
from extended_gan_torch.models.registry import build_model

TOL = 2e-5
B, H, W, T, V = 2, 8, 8, 4, 6


def _flax(attention_type, mapping_type, use_pallas, seed=0):
    model = FlaxModel(image_width=W, image_height=H, n_vertices=V,
                      attention_type=attention_type,
                      mapping_type=mapping_type, use_pallas=use_pallas)
    params = jax.jit(model.init)(jax.random.PRNGKey(seed),
                                 jnp.zeros((B, H, W, T, V)))["params"]
    return model, jax.device_get(params)


def _x(seed=0):
    return np.random.default_rng(seed).random((B, H, W, T, V), np.float32)


@pytest.mark.parametrize("attention_type,mapping_type,use_pallas", [
    ("temporal", "conv", True),
    ("temporal", "conv", False),
    ("spatial", "conv", False),
    ("multi_stream", "linear", False),
])
def test_model_matches_flax(attention_type, mapping_type, use_pallas):
    fmodel, params = _flax(attention_type, mapping_type, use_pallas)
    x = _x()
    want = np.asarray(jax.jit(lambda p, x: fmodel.apply(
        {"params": p}, x, train=False))(params, jnp.asarray(x)))
    model = build_model(attention_type, image_width=W, image_height=H,
                        n_vertices=V, mapping_type=mapping_type,
                        use_pallas=use_pallas, device="cpu")
    model.load_state_dict(from_flax_params(params))  # strict: same leaves
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_fused_and_plain_attention_agree_on_cpu():
    kw = dict(image_width=W, image_height=H, n_vertices=V, mapping_type="conv",
              device="cpu")
    fused = build_model("temporal", use_pallas=True,
                        generator=torch.Generator().manual_seed(3), **kw)
    plain = build_model("temporal", use_pallas=False, **kw)
    plain.load_state_dict(fused.state_dict())
    x = torch.from_numpy(_x(1))
    with torch.no_grad():
        torch.testing.assert_close(fused(x), plain(x), rtol=TOL, atol=TOL)


def test_parameter_count_is_the_references_43936():
    model = build_model("temporal", image_width=20, image_height=20,
                        n_vertices=6, mapping_type="conv", device="cpu")
    assert sum(p.numel() for p in model.parameters()) == 43_936


def test_parameters_match_the_flax_tree_leaf_for_leaf():
    _, params = _flax("multi_stream", "conv", False)
    model = build_model("multi_stream", image_width=W, image_height=H,
                        n_vertices=V, mapping_type="conv", device="cpu")
    converted = from_flax_params(params)
    state = model.state_dict()
    assert sorted(converted) == sorted(state)
    for k, v in converted.items():
        assert v.shape == state[k].shape, k


def test_load_flax_npz_equals_from_flax_params(tmp_path):
    _, params = _flax("temporal", "conv", False, seed=4)
    path = tmp_path / "params.npz"
    np.savez(path, **traverse_util.flatten_dict(params, sep="/"))
    got, want = load_flax_npz(str(path)), from_flax_params(params)
    assert sorted(got) == sorted(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    # HWIO -> OIHW behind the head axis
    k1 = params["hidden_layer"]["heads"]["mapping"]["conv1"]["kernel"]
    w1 = want["hidden_layer.heads.mapping.conv1.weight"].numpy()
    assert k1.shape == (3, 3, 3, T, 74) and w1.shape == (3, 74, T, 3, 3)
    np.testing.assert_array_equal(w1[2, 5, 1], k1[2, :, :, 1, 5])


def test_seeded_init_is_reproducible_and_flax_scaled():
    kw = dict(image_width=W, image_height=H, n_vertices=V, mapping_type="conv",
              device="cpu")
    a = build_model("temporal", generator=torch.Generator().manual_seed(7), **kw)
    b = build_model("temporal", generator=torch.Generator().manual_seed(7), **kw)
    for (k, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(p, q, rtol=0, atol=0, msg=k)
    heads = a.hidden_layer.heads
    # xavier_gain_1414 on (2V, 1): uniform within sqrt(3 * 1.414^2 / 6.5)
    assert heads.a_temporal.abs().max() <= np.sqrt(3 * 1.414**2 / 6.5)
    torch.testing.assert_close(heads.B_temporal,
                               torch.full((3, T, T), 1e-6))
    # lecun_normal, truncated at 2 std: fan_in = 74 for the 1x1 conv
    w = heads.mapping.conv2.weight
    assert w.abs().max() <= 2 * np.sqrt(1 / 74) / 0.87962566103423978 + 1e-6
    assert abs(w.std().item() - np.sqrt(1 / 74)) < 0.1 * np.sqrt(1 / 74)
    assert not heads.mapping.conv2.bias.any()


def test_layers_match_jax():
    rng = np.random.default_rng(8)
    badj = rng.random((5, 5)).astype(np.float32)
    np.testing.assert_allclose(
        layers.normalized_adjacency(torch.from_numpy(badj)).numpy(),
        np.asarray(jax_layers.normalized_adjacency(jnp.asarray(badj))),
        rtol=1e-6, atol=1e-6)
    stacked = rng.random((3, 5, 5)).astype(np.float32)
    per_head = layers.normalized_adjacency(torch.from_numpy(stacked))
    for i in range(3):
        np.testing.assert_allclose(
            per_head[i].numpy(),
            np.asarray(jax_layers.normalized_adjacency(jnp.asarray(stacked[i]))),
            rtol=1e-6, atol=1e-6)
    wh = rng.standard_normal((2, 4, 6)).astype(np.float32)
    a = rng.standard_normal(12).astype(np.float32)
    np.testing.assert_allclose(
        layers.pairwise_scores(torch.from_numpy(wh), torch.from_numpy(a),
                               0.2).numpy(),
        np.asarray(jax_layers.pairwise_scores(jnp.asarray(wh), jnp.asarray(a),
                                              0.2)),
        rtol=1e-6, atol=1e-6)


# every registry key and mapping of the JAX package is ported
# (test_torch_port_gat_family.py, test_torch_port_gat_smaat*.py): what is
# left to refuse is what the JAX package refuses too
@pytest.mark.parametrize("model_type,mapping_type,error", [
    ("temporal", "bogus", ValueError),
    ("bogus", "conv", KeyError),
])
def test_unported_families_name_their_roadmap_item(model_type, mapping_type,
                                                   error):
    with pytest.raises(error, match="ROADMAP|unknown"):
        build_model(model_type, image_width=W, image_height=H, n_vertices=V,
                    mapping_type=mapping_type, device="cpu")


def test_conv_gat_raises_as_in_jax():
    from extended_gan_tpu.models.gat.wrappers import ConvGAT as FlaxConvGAT
    from extended_gan_torch.models.gat.wrappers import ConvGAT

    x = np.zeros((B, H, W, T, V), np.float32)
    with pytest.raises(NotImplementedError, match="stub"):
        FlaxConvGAT().init(jax.random.PRNGKey(0), jnp.asarray(x))
    with pytest.raises(NotImplementedError, match="stub"):
        ConvGAT()(torch.from_numpy(x))
