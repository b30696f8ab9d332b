"""The port's int8 serving quantisation against the JAX package's, on the CPU.

The same seeded generator weights on both sides (``tests/test_quantize.py``'s
lively tree, carried over with ``from_flax_params``), the same numpy inputs:

- the BN fold: kernels and biases within 1e-6 of each tensor's largest
  entry; ``folded_apply`` within 1e-5 of JAX's in f32, and its bf16 variant
  within JAX's 3e-2 of f32;
- ``quantize_weight_int8``: on the same kernel, q and scales bit-equal to
  JAX's (per channel, per (expert, channel), and an all-zero channel); on
  the two folds, whose rsqrt may differ by an ulp, q equal but for a
  handful of entries a step apart;
- the w8 generator within 1e-5 of JAX's w8; the w8a8 generator's
  activation scales within 1e-6 relative, its first layer's int32
  accumulators equal to JAX's on the same int8 input, its output within
  5e-3 of JAX's (a flipped bin);
- the int8 convolution's plain version against XLA's int32 convolution at
  the generator's five layer shapes: exact;
- ``make_w8_apply`` on GAT3D (conv mapping, 3 hidden heads), a narrow
  UnetModel and a baseline: the dequantised weights equal
  ``from_flax_params`` of JAX's dequantised tree bit for bit, the meta
  dicts equal, the forward within 1e-5 of JAX's w8;
- the error paths: an unknown mode, w8a8 without calibration and the BN
  fold's drift guard.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from torch.func import functional_call

from extended_gan_tpu.serve import quantize as jq
from extended_gan_torch.models.convert import from_flax_params
from extended_gan_torch.models.dcgan import Generator
from extended_gan_torch.models.smaat_unet import SmaAt_UNet
from extended_gan_torch.models.unet_model import UnetModel
from extended_gan_torch.ops import int8_conv
from extended_gan_torch.serve import quantize as q
from test_quantize import _inputs, _lively_variables
from test_torch_port_gat_family import models, one_torch_thread  # noqa: F401
from test_torch_port_smaat_unet import _FlaxNarrowUnetModel

FOLD_TOL = 1e-6
FWD_TOL = 1e-5
BF16_TOL = 3e-2  # JAX's budget for its bf16 folded forward
W8A8_TOL = 5e-3  # one flipped int8 bin, as in the export's --check
_DN = ("NHWC", "HWIO", "NHWC")
# (Cin, Cout) of the generator's five convs at nc = 4
GEN_LAYERS = [(4, 32), (32, 16), (16, 8), (8, 4), (4, 4)]


@pytest.fixture(scope="module")
def gen():
    """(flax model, lively variables, the port's eval Generator, x)."""
    fmodel, variables = _lively_variables()
    variables = jax.device_get(variables)
    g = Generator(4, dropout=0.0).eval()
    g.load_state_dict(from_flax_params(variables["params"],
                                       variables["batch_stats"]))
    return fmodel, variables, g, np.array(_inputs())


def _nhwc(g):
    return lambda x: g(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale


def test_fold_matches_jax(gen):
    _, variables, g, _ = gen
    want = jq.fold_generator_bn(variables)
    got = q.fold_generator_bn(g.state_dict())
    assert [a for _, _, a in got] == [a for _, _, a in want]
    assert [a for _, _, a in got] == ["relu"] * 4 + ["sigmoid"]
    for (k, b, _), (jk, jb, _) in zip(got, want):
        assert k.shape == jk.shape
        _close(k.numpy(), jk, FOLD_TOL)
        _close(b.numpy(), jb, FOLD_TOL)


def test_folded_apply_matches_jax(gen):
    fmodel, variables, g, x = gen
    layers = q.fold_generator_bn(g.state_dict())
    want = np.asarray(jq.folded_apply(jq.fold_generator_bn(variables), x))
    seen = []
    with torch.no_grad():
        got = q.folded_apply(layers, x, on_input=lambda h: seen.append(
            tuple(h.shape))).numpy()
        bf16 = q.folded_apply(layers, x, dtype=torch.bfloat16)
        model = _nhwc(g)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_TOL)
    np.testing.assert_allclose(got, model, rtol=0, atol=FWD_TOL)
    assert bf16.dtype == torch.float32
    assert float((bf16 - torch.from_numpy(got)).abs().max()) < BF16_TOL
    assert len(seen) == 5 and seen[0] == x.shape


@pytest.mark.parametrize("shape,keep_leading", [
    ((4, 4, 16, 8), False), ((3, 3, 1, 12), False), ((5, 7), False),
    ((3, 4, 6), True)])
def test_quantize_weight_int8_bit_equals_jax(shape, keep_leading):
    k = np.random.default_rng(0).normal(0, 0.1, shape).astype(np.float32)
    k[..., 1] = 0.0  # an all-zero channel: scale 1, q 0
    qt, st = q.quantize_weight_int8(torch.from_numpy(k),
                                    keep_leading=keep_leading)
    qj, sj = jq.quantize_weight_int8(jnp.asarray(k),
                                     keep_leading=keep_leading)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    assert st.shape == sj.shape
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert not np.isnan(st.numpy()).any()
    np.testing.assert_array_equal(qt.numpy()[..., 1], 0)


def test_quantized_folds_agree_with_jax(gen):
    """The two folds may differ by an ulp (rsqrt), which can move a kernel
    entry at a .5 boundary into the next bin: a handful at most."""
    _, variables, g, _ = gen
    flipped = 0
    for (k, _, _), (jk, _, _) in zip(q.fold_generator_bn(g.state_dict()),
                                     jq.fold_generator_bn(variables)):
        qt, st = q.quantize_weight_int8(k)
        qj, sj = jq.quantize_weight_int8(jk)
        _close(st.numpy(), sj, FOLD_TOL)
        diff = np.abs(qt.numpy().astype(int) - np.asarray(qj).astype(int))
        assert diff.max() <= 1
        flipped += int(diff.sum())
    assert flipped <= 5


def test_w8_generator_matches_jax(gen):
    _, variables, g, x = gen
    jfwd, jmeta = jq.make_quantized_generator(variables, mode="w8")
    with torch.no_grad():
        fwd, meta = q.make_quantized_generator(g.state_dict(), mode="w8")
        got = fwd(x).numpy()
    assert meta == jmeta == {"quantize": "w8", "n_layers": 5}
    np.testing.assert_allclose(got, np.asarray(jax.jit(jfwd)(x)), rtol=0,
                               atol=FWD_TOL)


def test_w8a8_generator_matches_jax(gen):
    _, variables, g, x = gen
    jfwd, jmeta = jq.make_quantized_generator(variables, mode="w8a8",
                                              calib_x=x)
    with torch.no_grad():
        state, meta = q.quantize_generator(g.state_dict(), "w8a8", x)
        got = q.generator_apply(state)(x).numpy()
        first = q.w8a8_layers(state, "cpu")[0]
        xi, acc, _ = q.w8a8_layer(torch.from_numpy(x), first)
    assert set(meta) == set(jmeta) == {"quantize", "n_layers",
                                       "activation_scales"}
    np.testing.assert_allclose(meta["activation_scales"],
                               jmeta["activation_scales"], rtol=1e-6)
    # JAX's first layer, on the same input: its int8 activations and int32
    # accumulators
    s_a = jmeta["activation_scales"][0]
    jk, _, _ = jq.fold_generator_bn(variables)[0]
    jqk, _ = jq.quantize_weight_int8(jk)
    jxi = jnp.clip(jnp.round(jnp.asarray(x) / s_a), -127, 127).astype(
        jnp.int8)
    jacc = lax.conv_general_dilated(jxi, jqk, (1, 1), "SAME",
                                    dimension_numbers=_DN,
                                    preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(xi.numpy(), np.asarray(jxi))
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    np.testing.assert_allclose(got, np.asarray(jax.jit(jfwd)(x)), rtol=0,
                               atol=W8A8_TOL)


@pytest.mark.parametrize("cin,cout", GEN_LAYERS)
def test_int8_conv_matches_xla(cin, cout):
    rng = np.random.default_rng(cin * 100 + cout)
    x = rng.integers(-127, 128, (2, 12, 12, cin), dtype=np.int8)
    w = rng.integers(-127, 128, (4, 4, cin, cout), dtype=np.int8)
    want = lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w), (1, 1),
                                    "SAME", dimension_numbers=_DN,
                                    preferred_element_type=jnp.int32)
    before = int8_conv.launch_count
    got = int8_conv.int8_conv2d(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int8_conv.launch_count == before  # CPU calls do not count
    with pytest.raises(TypeError, match="int8"):
        int8_conv.int8_conv2d(torch.from_numpy(x).float(), torch.from_numpy(w))


def _jax_w8(fmodel, variables, x):
    """JAX's make_w8_apply: its dequantised tree, meta and output on x."""
    seen = []

    def apply_fn(v, xx):
        seen.append(jax.device_get(v))
        return fmodel.apply(v, xx, train=False)

    fwd, meta = jq.make_w8_apply(apply_fn, variables)
    y = np.asarray(fwd(jnp.asarray(x)))
    return seen[0], meta, y


def _w8_family(kind):
    """(flax model, variables, the port's eval model, x) for one family."""
    rng = np.random.default_rng(3)
    if kind == "unet":
        fmodel = _FlaxNarrowUnetModel()
        x = rng.random((2, 16, 16, 4, 2), np.float32)
        variables = jax.device_get(jax.jit(lambda k, xx: fmodel.init(
            k, xx, train=False))(jax.random.PRNGKey(1), jnp.asarray(x)))
        model = UnetModel(16, 16, 2, time_steps=4)
        model.unet = SmaAt_UNet(n_channels=4, n_classes=4, base=8)
        model.load_state_dict(from_flax_params(variables["params"],
                                               variables["batch_stats"]))
        return fmodel, variables, model.eval(), x
    fmodel, variables, model = models(kind, "conv", 8)
    x = rng.random((2, 8, 8, 4, 3), np.float32)
    return fmodel, variables, model.eval(), x


@pytest.mark.parametrize("kind", ["temporal", "unet", "baseline"])
def test_make_w8_apply_matches_jax(kind):
    fmodel, variables, model, x = _w8_family(kind)
    jdeq, jmeta, want = _jax_w8(fmodel, variables, x)
    state = model.state_dict()
    packed, meta = q.quantize_state_dict_w8(state)
    deq = q.dequantize_state_dict(packed)
    expect = from_flax_params(jdeq["params"], jdeq.get("batch_stats"))
    assert sorted(deq) == sorted(expect)
    for name, v in expect.items():
        torch.testing.assert_close(deq[name], v, rtol=0, atol=0, msg=name)
    assert meta == jmeta
    assert meta["quantized_leaves"] > 0
    if kind == "temporal":  # three hidden heads share each channel's scale
        w = packed["hidden_layer.heads.mapping.conv1.weight"]
        assert w["q"].shape[0] == 3 and w["scale"].shape == (1, 74, 1, 1, 1)
    fwd, fmeta = q.make_w8_apply(
        lambda sd, xx: functional_call(model, sd, (xx,)), state)
    assert fmeta == meta
    with torch.no_grad():
        got = fwd(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_TOL)


def test_w8_keeps_the_leaves_jax_keeps():
    """Only conv and Linear weights and GAT W quantise; BatchNorm, biases,
    a, B and the depthwise-separable kernels stay f32."""
    state = {"c.weight": torch.ones(4, 3, 3, 3), "fc.weight": torch.ones(5, 2),
             "g.W": torch.ones(6, 7), "bn.weight": torch.ones(4),
             "bn.running_var": torch.ones(4), "a": torch.ones(8, 1),
             "B": torch.ones(3, 3), "d.depthwise_weight": torch.ones(8, 1, 3, 3),
             "c.bias": torch.ones(4), "bn.num_batches_tracked": torch.tensor(0)}
    packed, meta = q.quantize_state_dict_w8(state)
    assert sorted(k for k, v in packed.items() if isinstance(v, dict)) == \
        ["c.weight", "fc.weight", "g.W"]
    assert [packed[k]["scale"].shape for k in ("c.weight", "fc.weight",
                                               "g.W")] == \
        [(4, 1, 1, 1), (5, 1), (1, 7)]
    assert meta["quantized_leaves"] == 3


def test_unknown_mode_and_missing_calibration_raise(gen):
    _, _, g, _ = gen
    with pytest.raises(ValueError, match="mode"):
        q.make_quantized_generator(g.state_dict(), mode="int4")
    with pytest.raises(ValueError, match="calib_x"):
        q.make_quantized_generator(g.state_dict(), mode="w8a8")


def test_drift_guard(gen):
    _, _, g, x = gen
    good = _nhwc(g)
    with torch.no_grad():
        fwd, _ = q.make_quantized_generator(g.state_dict(), "w8", x,
                                            reference_apply=good)
        assert fwd is not None
        with pytest.raises(ValueError, match="fold diverges"):
            q.make_quantized_generator(
                g.state_dict(), "w8", x,
                reference_apply=lambda t: good(t) + 0.01)
