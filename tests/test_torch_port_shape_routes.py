"""K1 and K3 at shapes past their CUDA kernels' limits, on the CPU. The
forwards take every shape, as the JAX package's kernels do (K3's forward
reads its taps from device memory past the rows its stages hold, K1's runs
a run-time-M kernel past M = 8); the backwards route by shape to the plain
versions, which is what the JAX package's backwards are at every shape
(K3's is ``jax.vjp`` of ``_reference_dsc``, K1's plain JAX).

- The forwards' choices (``dsconv.fwd_stages``) and the backwards' routing
  rules (``dsconv.bwd_takes``, ``gat_attention.bwd_takes``) on both sides
  of each limit, each rule equal to the kernel's own refusal: the argument
  checks (``bwd_args``, ``_bwd_plan``, ``_cluster_plan``) raise, or find no
  plan, exactly where the rule says the kernel does not take the shape. So
  a shape the kernel takes never reaches the plain version, and one it
  cannot take never reaches the kernel.
- The plain route at a shape past each limit against the JAX package on
  the CPU: K3 through JAX's ``fused_dsconv`` and its ``jax.vjp``, K1
  through its Pallas forward (interpret mode) and plain backward, within
  TOL of each tensor's largest entry (float32 on both sides).
- Every published config's shapes (``convolutional_gat/experiments``)
  take the kernels, the forward's stages included: 0 plain routes and 0
  unstaged forwards; a planted fault, a rule that sends a
  kernel-sized shape to the plain route, fails that check.

The card's counters (``ops.plain_routes``) are held on the card:
``tests/test_torch_port_cuda.py`` and ``chip_smoke.py``'s
``shape_routes`` phase.
"""

import functools
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extended_gan_tpu.ops.pallas import dsconv as jax_dsconv
from extended_gan_tpu.ops.pallas import gat_attention as jax_k1
from extended_gan_torch.models.smaat_unet import dsc_shapes
from extended_gan_torch.ops import dsconv, gat_attention
from extended_gan_torch.utils.config import load_experiment_config

TOL = 2e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ----------------------------------------------------------------- the rules
@pytest.mark.parametrize("w,staged", [(333, True), (334, False)])
def test_k3_forward_takes_every_width(w, staged):
    """Rows up to 333 pixels: the forward's two stages of x fit; wider ones
    read their taps from device memory. The forward's checks pass both."""
    assert dsconv.fwd_stages(w) is staged
    x = torch.zeros((1, 1, w, 2))
    dsconv.fwd_args(x, torch.zeros(3, 3, 4), torch.zeros(4),
                    torch.zeros(4, 3), torch.zeros(3))


# (C, kpl, the widest rows the backward takes)
BWD_LIMITS = [(64, 2, 257), (16, 2, 257), (32, 1, 191), (4, 2, 1033)]


@pytest.mark.parametrize("c,kpl,widest", BWD_LIMITS)
@pytest.mark.parametrize("past", [False, True])
def test_k3_backward_rule_is_the_kernel_check(c, kpl, widest, past):
    w = widest + past
    assert dsconv.bwd_takes(2, 3, w, c, c * kpl) is not past
    if past:
        with pytest.raises(ValueError, match="too wide"):
            dsconv._bwd_plan(2, 3, w, c, c * kpl)
    else:
        dsconv._bwd_plan(2, 3, w, c, c * kpl)


@pytest.mark.parametrize("kpl", [32, 33])
def test_k3_backward_rule_on_kpl(kpl):
    takes = kpl <= 32
    assert dsconv.bwd_takes(1, 4, 4, 2, 2 * kpl) is takes
    x = torch.zeros((1, 4, 4, 2))
    args = (torch.zeros(1, 4, 4, 2 * kpl), x, torch.zeros(3, 3, 2 * kpl))
    if takes:
        dsconv.bwd_args(*args, need_dx=True)
    else:
        with pytest.raises(ValueError, match="at most 32"):
            dsconv.bwd_args(*args, need_dx=True)


@pytest.mark.parametrize("mm,g", [(8, 16), (8, 17), (9, 1), (4, 32),
                                  (4, 33), (1, 128), (1, 129)])
def test_k1_rules_are_the_kernel_checks(mm, g):
    """The backward takes M <= 8 (its instances) and M * G <= 128: where
    its cluster plan finds none."""
    takes = mm <= 8 and mm * g <= 128
    assert gat_attention.bwd_takes(mm, g) is takes
    if mm <= 8:
        plan = gat_attention._cluster_plan(2, 4, 100, mm * g, backward=True)
        assert (plan is not None) is takes


# -------------------------------------------------- the plain route vs JAX
def _k3_case(shape, seed):
    n, h, w, c, kpl, cout = shape
    rng = np.random.default_rng(seed)
    return [(rng.random(s, np.float32) - 0.5) for s in (
        (n, h, w, c), (3, 3, c * kpl), (c * kpl,), (c * kpl, cout), (cout,))]


# past the backward's rows at kpl 2, at C 16 and at C 4, past kpl 32
K3_PAST = [(1, 3, 260, 16, 2, 8), (1, 2, 1034, 4, 2, 4), (1, 5, 5, 2, 33, 4)]


@pytest.mark.parametrize("shape", K3_PAST)
def test_k3_plain_route_matches_jax(shape):
    n, h, w, c, kpl, cout = shape
    assert not dsconv.bwd_takes(n, h, w, c, c * kpl)
    inputs = _k3_case(shape, sum(shape))
    g = np.random.default_rng(1).standard_normal((n, h, w, cout)).astype(
        np.float32)
    out, vjp = jax.vjp(jax_dsconv.fused_dsconv,
                       *(jnp.asarray(a) for a in inputs))
    want = [out, *vjp(jnp.asarray(g))]
    ts = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
    got = dsconv.fused_dsconv(*ts)
    got.backward(torch.from_numpy(g))
    for i, (a, b) in enumerate(zip([got] + [t.grad for t in ts], want)):
        b = np.asarray(b)
        err = np.abs(a.detach().numpy() - b).max() / np.abs(b).max()
        assert err <= TOL, (i, err)


# (NH = 1, B, M, G, S): M past the kernels' 8; M * G past the backward's
K1_PAST = [(3, 9, 4, 16), (2, 8, 17, 8)]


@pytest.mark.parametrize("b,mm,g,s", K1_PAST)
def test_k1_plain_route_matches_jax(b, mm, g, s):
    assert not gat_attention.bwd_takes(mm, g)
    rng = np.random.default_rng(mm * g)
    m = (rng.random((b, mm, g * s), np.float32) - 0.5)
    a = (rng.random((2 * g,), np.float32) - 0.5)
    adj = rng.random((mm, mm)).astype(np.float32)
    adj = adj / adj.sum(-1, keepdims=True)
    cot = rng.standard_normal(m.shape).astype(np.float32)
    w1, w2 = (np.repeat(v, s)[None] for v in (a[:g], a[g:]))

    def jax_fn(m, w1, w2, adj):
        return jax_k1.fused_gat_attention(m, w1, w2, adj, 0.2, s)

    out, vjp = jax.vjp(jax_fn, *(jnp.asarray(v) for v in (m, w1, w2, adj)))
    d_m, d_w1, d_w2, d_adj = (np.asarray(v) for v in vjp(jnp.asarray(cot)))
    d_a = np.concatenate([d_w1.reshape(g, s).sum(-1),
                          d_w2.reshape(g, s).sum(-1)])
    ts = [torch.from_numpy(v[None]).requires_grad_(True)
          for v in (m, a, adj)]
    got = gat_attention.fused_gat_attention(*ts, 0.2, s)[0]
    got.backward(torch.from_numpy(cot[None]))
    for name, x, want in (("out", got.detach()[0], out),
                          ("d_m", ts[0].grad[0], d_m),
                          ("d_a", ts[1].grad[0], d_a),
                          ("d_adj", ts[2].grad[0], d_adj)):
        want = np.asarray(want)
        err = np.abs(x.numpy() - want).max() / np.abs(want).max()
        assert err <= TOL, (name, err)


# ------------------------------------------------ the published configs
@functools.cache
def _published():
    """(DSC shapes of every published UNet config, K1's (M, G) of every
    published GAT3D config with temporal attention)."""
    dsc, k1 = [], []
    for path in sorted(glob.glob(os.path.join(
            REPO, "convolutional_gat", "experiments", "*", "config.py"))):
        cfg = load_experiment_config(os.path.dirname(path))
        if cfg.model_type == "unet":
            dsc += [s for s in dsc_shapes(
                batch=1, hw=cfg.downsample_size[0], vertices=6,
                device="cpu") if s not in dsc]
        else:
            # temporal attention over T = 4 frames of V = 6 vertices
            k1.append((4, 6))
    return dsc, sorted(set(k1))


def published_plain_routes():
    """How many calls of the published configs' shapes the rules route to
    the plain versions (each DSC shape's backward, K1's), and how many
    of their DSC forwards read their taps unstaged."""
    dsc, k1 = _published()
    return (sum(not dsconv.fwd_stages(s[2]) for s in dsc)
            + sum(not dsconv.bwd_takes(*s[:5]) for s in dsc)
            + sum(not gat_attention.bwd_takes(m, g) for m, g in k1))


def test_published_configs_take_the_kernels():
    dsc, k1 = _published()
    assert len(dsc) >= 18 and k1 == [(4, 6)]
    assert published_plain_routes() == 0


def test_a_rule_routing_kernel_shapes_to_plain_fails_the_check(monkeypatch):
    """The planted fault: the backward's rule refuses rows past 16
    pixels, which the kernel takes."""
    monkeypatch.setattr(dsconv, "bwd_takes",
                        lambda n, h, w, c, ck: w <= 16 and ck // c <= 32)
    with pytest.raises(AssertionError):
        test_published_configs_take_the_kernels()
