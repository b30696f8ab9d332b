"""K2, the fused conv-mapping bottleneck: the port against the JAX package.

On the CPU the port's ``fused_conv_bottleneck`` runs its plain version
(``reference_bottleneck``) and that version's autograd; the JAX side runs
the Pallas kernels in interpret mode, as ``tests/test_pallas_gat_mapping.py``
does. Tolerances: forwards at 2e-5 relative and absolute (both sides sum at
most 666 f32 products per output, in other orders); gradients at 2e-4 of
each gradient's largest entry (they sum over every pixel of every image).
The CUDA kernels themselves are held against the plain version in
``test_torch_port_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extended_gan_tpu.models.gat.gat3d import Model as FlaxModel
from extended_gan_tpu.ops.pallas.gat_mapping import (
    fused_conv_bottleneck as jax_bottleneck,
)
from extended_gan_torch.models.convert import from_flax_params
from extended_gan_torch.models.gat import gat3d
from extended_gan_torch.ops import gat_mapping as k2

TOL = 2e-5
GRAD_TOL = 2e-4


def _jax_args(n, h, f, seed, cin=4, cout=4):
    """x (N, H, H, Cin) and one head's HWIO weights, as numpy."""
    rng = np.random.default_rng(seed)
    r = lambda *s: (rng.standard_normal(s) * 0.3).astype(np.float32)  # noqa: E731
    return (r(n, h, h, cin), r(3, 3, cin, f), r(f), r(1, 1, f, f), r(f),
            r(3, 3, f, cout), r(cout))


def _to_port(heads):
    """Per-head HWIO weights -> the port's stacked OIHW tensors."""
    oihw = lambda k: k.transpose(3, 2, 0, 1)  # noqa: E731
    return [torch.from_numpy(np.stack([fn(h[i]) for h in heads]).copy())
            for i, fn in zip(range(1, 7), (oihw, np.asarray, oihw, np.asarray,
                                           oihw, np.asarray))]


def _close(got, want, tol, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=name)


def _grad_close(got, want, name):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=GRAD_TOL * np.abs(want).max(),
                               err_msg=name)


@pytest.mark.parametrize("n,h", [(6, 20), (3, 10)])
def test_reference_matches_jax_pallas_kernel(n, h):
    args = _jax_args(n, h, 74, seed=n + h)
    want = np.asarray(jax_bottleneck(*map(jnp.asarray, args)))
    x = torch.from_numpy(args[0])
    got = k2.fused_conv_bottleneck(x, *_to_port([args]))
    assert got.shape == (1,) + want.shape
    _close(got[0], want, TOL)
    plain = k2.reference_bottleneck(x, *_to_port([args]))
    assert torch.equal(got, plain)  # the CPU path is the plain one


def test_gradients_match_jax_grad_of_the_pallas_kernel():
    """All seven gradients against ``jax.grad`` through the JAX kernel's
    ``custom_vjp`` (its Pallas backward, in interpret mode)."""
    args = _jax_args(3, 10, 74, seed=1)
    cot = np.random.default_rng(2).standard_normal(
        (3, 10, 10, 4)).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(jax_bottleneck(*a) * cot),
                    argnums=tuple(range(7)))(*map(jnp.asarray, args))
    x = torch.from_numpy(args[0]).requires_grad_()
    ws = [t.requires_grad_() for t in _to_port([args])]
    (k2.fused_conv_bottleneck(x, *ws)[0] * torch.from_numpy(cot)).sum().backward()
    oihw = lambda g: np.asarray(g).transpose(3, 2, 0, 1)  # noqa: E731
    _grad_close(x.grad, want[0], "x")
    for name, t, w, fn in zip(("w1", "b1", "w2", "b2", "w3", "b3"), ws,
                              want[1:], (oihw, np.asarray) * 3):
        _grad_close(t.grad[0], fn(w), name)


def test_stacked_heads_share_x_and_sum_dx():
    """Three heads in one call, x in GAT3D's (B, H, W, T, V) layout, against
    three JAX calls on the (B*V, H, W, T) images; dx is the heads' sum."""
    b, h, v, nh = 2, 8, 3, 3
    heads = [_jax_args(b * v, h, 74, seed=10 + i) for i in range(nh)]
    x5 = np.random.default_rng(3).random((b, h, h, 4, v), np.float32)
    xb = jnp.asarray(x5.transpose(0, 4, 1, 2, 3).reshape(b * v, h, h, 4))
    cot = np.random.default_rng(4).standard_normal(
        (nh, b, h, h, 4, v)).astype(np.float32)
    # per head, JAX's (B*V, H, W, T') cotangent layout
    cot_b = [jnp.asarray(c.transpose(0, 4, 1, 2, 3).reshape(b * v, h, h, 4))
             for c in cot]
    x = torch.from_numpy(x5).requires_grad_()
    got = k2.fused_conv_bottleneck(x, *_to_port(heads))
    assert got.shape == (nh, b, h, h, 4, v)
    dx_want = 0.0
    for i, hd in enumerate(heads):
        w = tuple(map(jnp.asarray, hd[1:]))
        want = np.asarray(jax_bottleneck(xb, *w))
        _close(got[i].permute(0, 4, 1, 2, 3).reshape(b * v, h, h, 4).detach(),
               want, TOL, f"head {i}")
        dx_want = dx_want + jax.grad(
            lambda z: jnp.sum(jax_bottleneck(z, *w) * cot_b[i]))(xb)
    (got * torch.from_numpy(cot)).sum().backward()
    dx_want = np.asarray(dx_want).reshape(b, v, h, h, 4).transpose(0, 2, 3, 4, 1)
    _grad_close(x.grad, dx_want, "dx")


def test_backward_only_for_what_needs_it():
    args = _jax_args(2, 6, 8, seed=5)
    x, ws = torch.from_numpy(args[0]), _to_port([args])
    ws[2].requires_grad_()
    k2.fused_conv_bottleneck(x, *ws).sum().backward()
    assert ws[2].grad is not None and x.grad is None and ws[0].grad is None


def test_cpu_calls_count_no_launches():
    args = _jax_args(2, 6, 8, seed=6)
    before = (k2.fwd_launch_count, k2.bwd_launch_count)
    x = torch.from_numpy(args[0]).requires_grad_()
    k2.fused_conv_bottleneck(x, *_to_port([args])).sum().backward()
    assert (k2.fwd_launch_count, k2.bwd_launch_count) == before


def test_rejects_weights_that_do_not_fit():
    args = _jax_args(2, 6, 8, seed=7)
    x, ws = torch.from_numpy(args[0]), _to_port([args])
    with pytest.raises(ValueError, match="does not fit"):
        k2.fused_conv_bottleneck(x, ws[0][:, :, :3], *ws[1:])  # Cin 3 != 4
    with pytest.raises(ValueError, match="does not fit"):
        k2.fused_conv_bottleneck(x, *ws[:5], ws[5][:, :2])  # b3 != Cout
    with pytest.raises(ValueError, match="want x"):
        k2.fused_conv_bottleneck(x[0], *ws)


HW, T, V = 10, 4, 6


def _flax_model(use_pallas_mapping, x):
    model = FlaxModel(image_width=HW, image_height=HW, n_vertices=V,
                      attention_type="temporal", mapping_type="conv",
                      use_pallas=True, use_pallas_mapping=use_pallas_mapping)
    return model, model.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]


def _port_model(params, use_pallas_mapping=True):
    model = gat3d.Model(HW, HW, V, attention_type="temporal",
                        mapping_type="conv", use_pallas=True,
                        use_pallas_mapping=use_pallas_mapping)
    model.load_state_dict(from_flax_params(jax.device_get(params)))
    return model


def test_model_with_the_switch_matches_flax_forward_and_gradients():
    """The port's ``Model(use_pallas_mapping=True)`` against the flax
    ``Model`` with the same switch (both kernels of the JAX package on, in
    interpret mode), from converted params."""
    rng = np.random.default_rng(8)
    x = rng.random((2, HW, HW, T, V), np.float32)
    y = rng.random((2, HW, HW, T, V), np.float32)
    fmodel, params = _flax_model(True, x)
    want = np.asarray(fmodel.apply({"params": params}, jnp.asarray(x),
                                   train=False))
    model = _port_model(params)
    got = model(torch.from_numpy(x))
    _close(got.detach(), want, TOL)
    g_want = jax.grad(lambda p: jnp.mean(
        (fmodel.apply({"params": p}, jnp.asarray(x)) - y) ** 2))(params)
    ((got - torch.from_numpy(y)) ** 2).mean().backward()
    g_want = from_flax_params(jax.device_get(g_want))
    for name, p in model.named_parameters():
        _grad_close(p.grad, g_want[name].numpy(), name)


def test_the_switch_leaves_the_flax_tree_as_it_is():
    x = np.zeros((1, HW, HW, T, V), np.float32)
    (_, on), (_, off) = _flax_model(True, x), _flax_model(False, x)
    flat_on = jax.tree_util.tree_leaves_with_path(on)
    flat_off = jax.tree_util.tree_leaves_with_path(off)
    assert [p for p, _ in flat_on] == [p for p, _ in flat_off]
    for (path, a), (_, b) in zip(flat_on, flat_off):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=jax.tree_util.keystr(path))
    # so from_flax_params fills both port models, strictly, from either tree
    for switch in (True, False):
        _port_model(on, use_pallas_mapping=switch)


def test_the_switch_takes_the_kernel_only_on_square_images(monkeypatch):
    """As in JAX (``h == w``): a non-square input runs the conv path."""
    calls = []

    def spy(*args):
        calls.append(args[0].shape)
        return k2.fused_conv_bottleneck(*args)

    monkeypatch.setattr(gat3d, "fused_conv_bottleneck", spy)
    rng = np.random.default_rng(9)
    x = rng.random((1, 8, 12, T, V), np.float32)
    fmodel = FlaxModel(image_width=12, image_height=8, n_vertices=V,
                       attention_type="temporal", mapping_type="conv",
                       use_pallas_mapping=True)
    params = fmodel.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    want = np.asarray(fmodel.apply({"params": params}, jnp.asarray(x),
                                   train=False))
    model = gat3d.Model(12, 8, V, attention_type="temporal",
                        mapping_type="conv", use_pallas_mapping=True)
    model.load_state_dict(from_flax_params(jax.device_get(params)))
    with torch.no_grad():
        _close(model(torch.from_numpy(x)), want, TOL)
        assert calls == []
        model(torch.from_numpy(rng.random((1, 8, 8, T, V), np.float32)))
    assert len(calls) == 2  # the hidden and the output block
