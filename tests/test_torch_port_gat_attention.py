"""K1, the fused GAT attention: the port's wrapper against the JAX package.

On the CPU the port's ``fused_gat_attention`` runs its plain version
(``reference_impl``); the JAX side runs the Pallas kernel in interpret mode,
as ``tests/test_pallas_gat_attention.py`` does. All four outputs (out and
the att0 / att / pos residuals) agree at 2e-5. The CUDA kernel itself is
held against the plain version in ``test_torch_port_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extended_gan_tpu.models.gat.layers import (
    normalized_adjacency as jax_normalized_adjacency,
)
from extended_gan_tpu.ops.pallas import gat_attention as jax_k1
from extended_gan_torch.models.gat.layers import normalized_adjacency
from extended_gan_torch.ops import gat_attention as k1

TOL = 2e-5


def _inputs(seed, nh=1, b=2, mm=4, g=6, s=64):
    """m (NH, B, M, G*S), a (NH, 2G), B-params (NH, M, M) from one seed."""
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((nh, b, mm, g * s)).astype(np.float32)
    a = rng.standard_normal((nh, 2 * g)).astype(np.float32)
    badj = rng.random((nh, mm, mm)).astype(np.float32)
    return m, a, badj


def _jax_forward(m, a, badj, s):
    """JAX _pallas_forward (interpret mode) for one head."""
    g = a.shape[0] // 2
    w1 = jnp.asarray(np.repeat(a[:g], s))[None, :]
    w2 = jnp.asarray(np.repeat(a[g:], s))[None, :]
    adj = jax_normalized_adjacency(jnp.asarray(badj))
    outs = jax_k1._pallas_forward(jnp.asarray(m), w1, w2, adj, 0.2, s,
                                  interpret=True)
    return [np.asarray(o) for o in outs], (w1, w2, adj)


@pytest.mark.parametrize("seed,mm,s", [(0, 4, 64), (1, 4, 25), (2, 3, 16)])
def test_reference_impl_matches_jax_pallas_forward(seed, mm, s):
    m, a, badj = _inputs(seed, mm=mm, s=s)
    want, (w1, w2, adj) = _jax_forward(m[0], a[0], badj[0], s)
    got = k1.reference_impl(torch.from_numpy(m[0]),
                            torch.from_numpy(np.array(w1)),
                            torch.from_numpy(np.array(w2)),
                            torch.from_numpy(np.array(adj)), 0.2, s)
    for name, g_, w_ in zip(("out", "att0", "att", "pos"), got, want):
        np.testing.assert_allclose(g_.numpy(), w_, rtol=TOL, atol=TOL,
                                   err_msg=name)
    # and the custom_vjp entry point's primal
    out = jax_k1.fused_gat_attention(jnp.asarray(m[0]), w1, w2, adj, 0.2, s)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(out), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("nh", [1, 3])
def test_fused_gat_attention_cpu_matches_jax_per_head(nh):
    s = 36
    m, a, badj = _inputs(10 + nh, nh=nh, s=s)
    adj = normalized_adjacency(torch.from_numpy(badj))
    got = k1.fused_gat_attention(torch.from_numpy(m), torch.from_numpy(a),
                                 adj, 0.2, s)
    assert got[0].shape == m.shape
    assert all(t.shape == (nh, m.shape[1], 4, 4) for t in got[1:])
    for h in range(nh):
        want, _ = _jax_forward(m[h], a[h], badj[h], s)
        for name, g_, w_ in zip(("out", "att0", "att", "pos"), got, want):
            np.testing.assert_allclose(g_[h].numpy(), w_, rtol=TOL, atol=TOL,
                                       err_msg=f"head {h} {name}")


def test_fused_gat_attention_counts_no_cpu_launches():
    m, a, badj = _inputs(3)
    before = k1.launch_count
    k1.fused_gat_attention(torch.from_numpy(m), torch.from_numpy(a),
                           normalized_adjacency(torch.from_numpy(badj)), 0.2,
                           64)
    assert k1.launch_count == before


def test_fused_gat_attention_rejects_bad_shapes():
    m, a, badj = _inputs(4)
    adj = normalized_adjacency(torch.from_numpy(badj))
    with pytest.raises(ValueError, match="group_size"):
        k1.fused_gat_attention(torch.from_numpy(m), torch.from_numpy(a), adj,
                               0.2, 65)
    with pytest.raises(ValueError, match="do not fit"):
        k1.fused_gat_attention(torch.from_numpy(m), torch.from_numpy(a[:, :6]),
                               adj, 0.2, 64)


def test_attend_temporal_matches_jax():
    rng = np.random.default_rng(5)
    b, h, w, t, v = 2, 8, 8, 4, 6
    mapped = rng.standard_normal((b, h, w, t, v)).astype(np.float32)
    a = rng.standard_normal(2 * v).astype(np.float32)
    badj = rng.random((t, t)).astype(np.float32)
    want = jax_k1.attend_temporal_pallas(
        jnp.asarray(mapped), jnp.asarray(a),
        jax_normalized_adjacency(jnp.asarray(badj)), 0.2)
    got = k1.attend_temporal(torch.from_numpy(mapped), torch.from_numpy(a),
                             normalized_adjacency(torch.from_numpy(badj)), 0.2)
    assert got.shape == (b, h, w, t, v)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_attend_temporal_head_axis_equals_each_head():
    rng = np.random.default_rng(6)
    nh, b, h, w, t, v = 3, 2, 4, 4, 4, 6
    mapped = torch.from_numpy(
        rng.standard_normal((nh, b, h, w, t, v)).astype(np.float32))
    a = torch.from_numpy(rng.standard_normal((nh, 2 * v)).astype(np.float32))
    adj = normalized_adjacency(
        torch.from_numpy(rng.random((nh, t, t)).astype(np.float32)))
    stacked = k1.attend_temporal(mapped, a, adj, 0.2)
    assert stacked.shape == mapped.shape
    for i in range(nh):
        torch.testing.assert_close(
            stacked[i], k1.attend_temporal(mapped[i], a[i], adj[i], 0.2),
            rtol=0, atol=0)



# --- the layouts the kernels take in place, and the backward -------------

# The three layouts of ``mapped`` (NH, B, H, W, T, V) on the model's paths:
# K2's output (pixel-major, contiguous), the cuDNN mapping's view of memory
# ordered (B, V, NH, T, H, W) (plane-major), and the linear mapping's einsum
# output, memory ordered (B, H, W, V, NH, T), which neither kernel layout
# takes (one copy to pixel-major).
LAYOUTS = {
    "pixel": ((0, 1, 2, 3, 4, 5), (0, 1, 2, 3, 4, 5)),
    "cudnn": ((1, 5, 0, 4, 2, 3), (2, 0, 4, 5, 3, 1)),
    "einsum": ((1, 2, 3, 5, 0, 4), (4, 0, 1, 2, 5, 3)),
}


def _mapped(rng, nh, b, h, w, t, v, layout):
    """(NH, B, H, W, T, V) float32 in ``layout``: memory in the order given,
    viewed back to the logical axes."""
    order, back = LAYOUTS[layout]
    shape = (nh, b, h, w, t, v)
    base = rng.standard_normal([shape[i] for i in order]).astype(np.float32)
    return torch.from_numpy(base).permute(*back)


def _same_strides(x, y):
    """Strides equal on every axis longer than 1 (a size-1 axis's stride
    is never used)."""
    return all(p == q for n, p, q in zip(x.shape, x.stride(), y.stride())
               if n > 1)


def _jax_attend_vjp(mapped, a, adj, cot):
    """attend_temporal_pallas (interpret mode) and its vjp, one head."""
    out, vjp = jax.vjp(
        lambda x, a_, j: jax_k1.attend_temporal_pallas(x, a_, j, 0.2),
        jnp.asarray(mapped), jnp.asarray(a), jnp.asarray(adj))
    return [np.asarray(out)] + [np.asarray(t) for t in vjp(jnp.asarray(cot))]


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("nh", [1, 3])
def test_attend_temporal_in_each_layout_matches_jax(layout, nh):
    """Outputs and gradients of attend_temporal against the JAX package for
    ``mapped`` in each layout; the output keeps ``mapped``'s strides where
    the kernels take the layout in place. Tolerance: 2e-5 on the output
    (f32, summation order), 1e-4 relative to the largest entry on the
    gradients (sums over B * H * W products)."""
    rng = np.random.default_rng(30 + nh)
    b, h, w, t, v = 2, 6, 5, 4, 6
    mapped = _mapped(rng, nh, b, h, w, t, v, layout).requires_grad_()
    a = torch.from_numpy(rng.standard_normal((nh, 2 * v)).astype(np.float32))
    badj = rng.random((nh, t, t)).astype(np.float32)
    adj = normalized_adjacency(torch.from_numpy(badj)).requires_grad_()
    a.requires_grad_()
    cot = rng.standard_normal((nh, b, h, w, t, v)).astype(np.float32)
    out = k1.attend_temporal(mapped, a, adj, 0.2)
    if layout != "einsum":
        assert _same_strides(out, mapped)
    grads = torch.autograd.grad(out, (mapped, a, adj), torch.from_numpy(cot))
    if layout != "einsum":
        assert _same_strides(grads[0], mapped)
    for i in range(nh):
        want = _jax_attend_vjp(mapped[i].detach().numpy(),
                               a[i].detach().numpy(),
                               adj[i].detach().numpy(), cot[i])
        np.testing.assert_allclose(out[i].detach().numpy(), want[0],
                                   rtol=TOL, atol=TOL)
        for name, g_, w_ in zip(("mapped", "a", "adj"), grads, want[1:]):
            np.testing.assert_allclose(
                g_[i].numpy(), w_, rtol=1e-4,
                atol=1e-4 * float(np.abs(w_).max()), err_msg=name)


@pytest.mark.parametrize("nh,mm,s", [(1, 4, 25), (3, 4, 9), (1, 3, 36),
                                     (3, 3, 25)])
def test_reference_backward_matches_jax_vjp_and_autograd(nh, mm, s):
    """reference_backward against jax.vjp of the JAX fused_gat_attention
    (its custom_vjp _bwd, the Pallas forward in interpret mode) per head,
    and against autograd through reference_impl. Group sizes 25, 9 and 36
    (not all multiples of 4). Tolerance 1e-4 relative to the largest
    entry: the gradients sum over up to B * P products."""
    m, a, badj = _inputs(40 + nh * mm + s, nh=nh, b=3, mm=mm, s=s)
    rng = np.random.default_rng(nh + s)
    cot = rng.standard_normal(m.shape).astype(np.float32)
    adj = normalized_adjacency(torch.from_numpy(badj))
    tm, ta = torch.from_numpy(m), torch.from_numpy(a)
    w1, w2 = k1._group_rows(ta, s)
    out, att0, att, pos = k1.reference_impl(tm, w1, w2, adj[:, None], 0.2, s)
    got = k1.reference_backward(tm, ta, adj, out, att0, att, pos,
                                torch.from_numpy(cot), 0.2, s)
    # autograd through the plain forward
    inputs = [t.clone().requires_grad_() for t in (tm, ta, adj)]
    w1, w2 = k1._group_rows(inputs[1], s)
    plain = k1.reference_impl(inputs[0], w1, w2, inputs[2][:, None], 0.2, s)
    auto = torch.autograd.grad(plain[0], inputs, torch.from_numpy(cot))
    for name, g_, w_ in zip(("d_m", "d_a", "d_adj"), got, auto):
        torch.testing.assert_close(g_, w_, rtol=1e-4,
                                   atol=1e-4 * w_.abs().max().item(),
                                   msg=name)
    g = a.shape[1] // 2
    for h in range(nh):
        jw1 = jnp.asarray(np.repeat(a[h, :g], s))[None, :]
        jw2 = jnp.asarray(np.repeat(a[h, g:], s))[None, :]
        jadj = jnp.asarray(adj[h].numpy())
        _, vjp = jax.vjp(lambda x, u1, u2, j: jax_k1.fused_gat_attention(
            x, u1, u2, j, 0.2, s), jnp.asarray(m[h]), jw1, jw2, jadj)
        d_m, d_w1, d_w2, d_adj = (np.asarray(t) for t in
                                  vjp(jnp.asarray(cot[h])))
        d_a = np.concatenate([d_w1.reshape(g, s).sum(-1),
                              d_w2.reshape(g, s).sum(-1)])
        for name, g_, w_ in zip(("d_m", "d_a", "d_adj"),
                                (got[0][h], got[1][h], got[2][h]),
                                (d_m, d_a, d_adj)):
            np.testing.assert_allclose(g_.numpy(), w_, rtol=1e-4,
                                       atol=1e-4 * float(np.abs(w_).max()),
                                       err_msg=f"head {h} {name}")


# chip_smoke.py's twelve K1 shapes (H*W, B, heads) and one beyond the
# cluster's reach (200x200: a slice of 2,500 pixels at C = 16 needs 240 KB)
PLAN_SHAPES = [(hw, b, nh) for hw in (400, 6400) for b in (1, 8, 32)
               for nh in (1, 3)] + [(40000, 2, 3)]


def _npix(hw, c):
    """Pixels a block at C = c: ceil(S / c), rounded up to a multiple of 4."""
    return (-(-hw // c) + 3) // 4 * 4


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("hw,b,nh", PLAN_SHAPES)
def test_cluster_plan_covers_each_element_in_whole_pixels(hw, b, nh,
                                                          backward):
    mg, bufs = 4 * 6, 2 if backward else 1
    plan = k1._cluster_plan(nh, b, hw, mg, backward=backward)

    def smem(pixels):
        return 4 * (k1._HEADER_FLOATS + bufs * pixels * mg)

    fits = [c for c in k1._CLUSTERS
            if smem(_npix(hw, c)) <= k1._SMEM_LIMIT]
    # the one-block kernel exactly where no cluster holds an element
    if not backward:
        assert (plan is None) == (not fits)
    if plan is None:
        return
    c, npix, chunk = plan
    assert c in k1._CLUSTERS and npix == _npix(hw, c)
    assert npix % 4 == 0 and chunk % 4 == 0 and 4 <= chunk <= npix
    # whole pixels: C slices of npix cover the S pixels, none empty
    assert (c - 1) * npix < hw <= c * npix
    assert smem(chunk) <= k1._SMEM_LIMIT
    assert (chunk == npix) == bool(fits)
    if fits:  # the kernel's blocks an SM where a cluster allows
        blocks = k1._BWD_BLOCKS if backward else k1._FWD_BLOCKS
        shared = [c for c in k1._CLUSTERS
                  if smem(_npix(hw, c)) <= k1._SM_SMEM // blocks - 1024]
        assert c >= (shared or fits)[0]
    if 4 * nh * b * c < k1._SMS:  # as many blocks as the batch allows
        assert c == 16 or (2 * c - 1) * _npix(hw, 2 * c) >= hw


def test_cluster_plan_refuses_what_the_kernels_cannot_take():
    assert k1._cluster_plan(2, 2, 64, k1._MAX_MG + 1) is None
    assert k1._cluster_plan(2, 2, 64, k1._MAX_MG + 1, backward=True) is None
    # a forced cluster whose slice outgrows shared memory: the backward
    # walks it in chunks, the forward has no plan
    assert k1._cluster_plan(1, 1, 6400, 24, cluster=1) is None
    c, npix, chunk = k1._cluster_plan(1, 1, 6400, 24, backward=True,
                                      cluster=1)
    assert (c, npix) == (1, 6400) and chunk < npix
