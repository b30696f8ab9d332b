"""K1, the fused GAT attention: the port's wrapper against the JAX package.

On the CPU the port's ``fused_gat_attention`` runs its plain version
(``reference_impl``); the JAX side runs the Pallas kernel in interpret mode,
as ``tests/test_pallas_gat_attention.py`` does. All four outputs (out and
the att0 / att / pos residuals) agree at 2e-5. The CUDA kernel itself is
held against the plain version in ``test_torch_port_cuda.py``.
"""

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

