"""K3, the fused depthwise-separable conv: the port against the JAX package.

On the CPU the port's ``fused_dsconv`` runs its plain version
(``reference_dsc``); the JAX side runs the Pallas kernels in interpret mode,
as ``tests/test_pallas_ops.py`` and ``tests/test_pallas_tiled.py`` do, and
its unfused ``_reference_dsc``. Tolerance 2e-5 (relative and absolute):
both sides compute in f32 and differ only in summation order over at most
9 taps and 64 depthwise channels at these shapes. Gradients are held
against ``jax.grad`` at 1e-4 relative to each gradient's largest entry:
they sum over every output pixel. The CUDA kernel itself is held against
the plain version in ``test_torch_port_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extended_gan_tpu.ops.pallas import dsconv as jax_k3
from extended_gan_torch.ops import dsconv as k3

TOL = 2e-5
GRAD_TOL = 1e-4


def _inputs(seed, n, h, w, c, kpl, cout):
    rng = np.random.default_rng(seed)
    ck = c * kpl
    return (rng.standard_normal((n, h, w, c), dtype=np.float32),
            rng.standard_normal((3, 3, ck), dtype=np.float32) / 3,
            rng.standard_normal(ck, dtype=np.float32),
            rng.standard_normal((ck, cout), dtype=np.float32)
            / np.float32(np.sqrt(ck)),
            rng.standard_normal(cout, dtype=np.float32))


# (n, h, w, c, kpl, cout): kpl 1 and 2, odd sizes, a 1x1 image
SHAPES = [(2, 8, 8, 4, 2, 16), (1, 5, 7, 3, 1, 5), (3, 6, 6, 8, 1, 12),
          (4, 1, 1, 16, 2, 8)]


@pytest.mark.parametrize("shape", SHAPES)
def test_reference_dsc_matches_jax_pallas_and_reference(shape):
    args = _inputs(sum(shape), *shape)
    jargs = [jnp.asarray(a) for a in args]
    assert jax_k3._fits_vmem(jargs[0], jargs[1], jargs[3])  # the untiled kernel
    want_pallas = np.asarray(jax_k3._pallas_forward(*jargs, interpret=True))
    want_ref = np.asarray(jax_k3._reference_dsc(*jargs))
    got = k3.fused_dsconv(*map(torch.from_numpy, args)).numpy()
    assert got.shape == shape[:3] + (shape[-1],)
    np.testing.assert_allclose(got, want_pallas, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, want_ref, rtol=TOL, atol=TOL)
    plain = k3.reference_dsc(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_array_equal(got, plain)  # the CPU path is the plain one


def test_reference_dsc_matches_jax_tiled_kernel_shape():
    """A shape where the JAX package leaves its whole-channel kernel for the
    channel-tiled one (``_fits_vmem`` false): one CUDA kernel covers both."""
    shape = (1, 80, 80, 128, 2, 64)  # one image of the card run's shape
    args = _inputs(7, *shape)
    jargs = [jnp.asarray(a) for a in args]
    assert not jax_k3._fits_vmem(jargs[0], jargs[1], jargs[3])
    want = np.asarray(jax_k3._pallas_forward_tiled(*jargs, interpret=True))
    got = k3.fused_dsconv(*map(torch.from_numpy, args)).numpy()
    # 256 depthwise channels summed per output
    np.testing.assert_allclose(got, want, rtol=5e-5, atol=5e-5)


@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[1]])
def test_fused_dsconv_gradients_match_jax_grad(shape):
    args = _inputs(100 + sum(shape), *shape)
    cot = np.random.default_rng(1).standard_normal(
        shape[:3] + (shape[-1],), dtype=np.float32)
    want = jax.grad(
        lambda *a: jnp.sum(jax_k3.fused_dsconv(*a) * cot),
        argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, args))
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    (k3.fused_dsconv(*targs) * torch.from_numpy(cot)).sum().backward()
    for name, t, w in zip(("x", "dw", "dwb", "pw", "pwb"), targs, want):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * np.abs(w).max(),
                                   err_msg=name)


def test_fused_dsconv_backward_only_for_what_needs_it():
    args = [torch.from_numpy(a) for a in _inputs(3, *SHAPES[0])]
    args[3].requires_grad_()
    k3.fused_dsconv(*args).sum().backward()
    assert args[3].grad is not None and args[0].grad is None


def test_fused_dsconv_counts_no_cpu_launches():
    before = k3.launch_count
    k3.fused_dsconv(*map(torch.from_numpy, _inputs(4, *SHAPES[0])))
    assert k3.launch_count == before


def test_fused_dsconv_rejects_bad_shapes():
    x, dw, dwb, pw, pwb = map(torch.from_numpy, _inputs(5, *SHAPES[0]))
    with pytest.raises(ValueError, match="do not fit"):
        k3.fused_dsconv(x, dw[:, :, :7], dwb[:7], pw[:7], pwb)  # 7 % 4 != 0
    with pytest.raises(ValueError, match="do not fit"):
        k3.fused_dsconv(x, dw, dwb, pw, pwb[:3])
