"""K3, the fused depthwise-separable conv: the port against the JAX package.

On the CPU the port's ``fused_dsconv`` runs its plain version
(``reference_dsc``); the JAX side runs the Pallas kernels in interpret mode,
as ``tests/test_pallas_ops.py`` and ``tests/test_pallas_tiled.py`` do, and
its unfused ``_reference_dsc``. Tolerance 2e-5 (relative and absolute):
both sides compute in f32 and differ only in summation order over at most
9 taps and 64 depthwise channels at these shapes. Gradients are held
against ``jax.grad`` at 1e-4 relative to each gradient's largest entry:
they sum over every output pixel. The plain backward
(``reference_dsc_backward``, the 9 shifted sums) is held against
``jax.vjp`` of the JAX ``_reference_dsc`` and against float64 autograd of
``reference_dsc`` at BWD_TOL of each gradient's largest entry: f32 sums of
at most a few hundred terms at these shapes. The CUDA kernels themselves
are held against the plain versions in ``test_torch_port_cuda.py``.
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
BWD_TOL = 1e-5


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


@pytest.mark.parametrize("shape", SHAPES)
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
    before = k3.launch_count, k3.bwd_launch_count
    args = [torch.from_numpy(a).requires_grad_() for a in _inputs(4, *SHAPES[0])]
    k3.fused_dsconv(*args).sum().backward()
    assert (k3.launch_count, k3.bwd_launch_count) == before


def test_fused_dsconv_rejects_bad_shapes():
    x, dw, dwb, pw, pwb = map(torch.from_numpy, _inputs(5, *SHAPES[0]))
    with pytest.raises(ValueError, match="do not fit"):
        k3.fused_dsconv(x, dw[:, :, :7], dwb[:7], pw[:7], pwb)  # 7 % 4 != 0
    with pytest.raises(ValueError, match="do not fit"):
        k3.fused_dsconv(x, dw, dwb, pw, pwb[:3])


# (n, h, w, c, kpl, cout): 1x1, 2x2 and 5x5 images, kpl 1 and 2, C = 4
BWD_SHAPES = [(3, 1, 1, 4, 1, 6), (3, 1, 1, 4, 2, 6), (2, 2, 2, 4, 1, 5),
              (2, 2, 2, 4, 2, 5), (2, 5, 5, 4, 1, 8), (2, 5, 5, 4, 2, 8)]


@pytest.mark.parametrize("need_dx", [True, False])
@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_reference_dsc_backward_matches_jax_vjp_and_float64(shape, need_dx):
    x, dw, dwb, pw, pwb = _inputs(200 + sum(shape), *shape)
    g = np.random.default_rng(2).standard_normal(
        shape[:3] + (shape[-1],), dtype=np.float32)
    got = k3.reference_dsc_backward(*map(torch.from_numpy, (x, dw, dwb, pw)),
                                    torch.from_numpy(g), need_dx=need_dx)
    _, vjp = jax.vjp(jax_k3._reference_dsc,
                     *map(jnp.asarray, (x, dw, dwb, pw, pwb)))
    want_jax = vjp(jnp.asarray(g))
    inputs = [torch.from_numpy(a).double().requires_grad_()
              for a in (x, dw, dwb, pw, pwb)]
    want_f64 = torch.autograd.grad(
        k3.reference_dsc(*inputs), inputs, torch.from_numpy(g).double())
    assert (got[0] is None) != need_dx
    for name, t, wj, w64 in zip(("dx", "ddw", "ddwb", "dpw", "dpwb"), got,
                                want_jax, want_f64):
        if t is None:
            continue
        for w in (np.asarray(wj), w64.numpy()):
            assert t.shape == w.shape, name
            np.testing.assert_allclose(t.numpy(), w, rtol=0,
                                       atol=BWD_TOL * np.abs(w).max(),
                                       err_msg=name)


# (N, H, W, C, CK, Cout) of the 18 DSCs of a final_smaatunet batch-32
# forward (192 images of 20x20), and the tiled TPU kernel's shape
UNET_SHAPES = [
    (192, 20, 20, 4, 8, 64), (192, 20, 20, 64, 128, 64),
    (192, 10, 10, 64, 128, 128), (192, 10, 10, 128, 256, 128),
    (192, 5, 5, 128, 256, 256), (192, 5, 5, 256, 512, 256),
    (192, 2, 2, 256, 512, 512), (192, 2, 2, 512, 1024, 512),
    (192, 1, 1, 512, 1024, 512), (192, 1, 1, 512, 1024, 512),
    (192, 2, 2, 1024, 2048, 512), (192, 2, 2, 512, 1024, 256),
    (192, 5, 5, 512, 1024, 256), (192, 5, 5, 256, 512, 128),
    (192, 10, 10, 256, 512, 128), (192, 10, 10, 128, 256, 64),
    (192, 20, 20, 128, 256, 64), (192, 20, 20, 64, 128, 64),
    (8, 80, 80, 128, 256, 64)]


@pytest.mark.parametrize("shape", UNET_SHAPES)
def test_split_plan_covers_ck_in_whole_chunks(shape):
    n, h, w, c, ck, cout = shape
    ks = k3._split_plan(*shape)
    assert ks > 0 and ks % 32 == 0
    slices = [(s, min(s + ks, ck)) for s in range(0, ck, ks)]
    assert slices[0][0] == 0 and slices[-1][1] == ck
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
    blocks = -(-n * h * w // 128) * -(-cout // 64)
    if blocks >= k3._FILL_BLOCKS:  # the grid already fills the card
        assert len(slices) == 1
    elif ck >= 128:  # at least two 32-channel chunks a slice
        assert ks >= 64
        assert ks == 64 or blocks * len(slices) >= k3._FILL_BLOCKS
    if h <= 2:  # the 1x1 and 2x2 launches: 16 to 48 blocks of 128 x 64
        assert len(slices) > 1


@pytest.mark.parametrize("shape", UNET_SHAPES)
def test_bwd_plan_fits_a_warp_and_covers_every_pixel(shape):
    n, h, w, c, ck, _ = shape
    cc, ppw, blocks = k3._bwd_plan(n, h, w, c, ck)
    kpl = ck // c
    assert 1 <= cc <= c and cc * kpl <= 32 and 1 <= ppw <= 64
    run = k3._BWD_WARPS * ppw * (32 // (cc * kpl))
    assert (blocks - 1) * run < n * h * w <= blocks * run


def test_unet_train_forward_needs_dx_at_17_of_18_dscs():
    """The first DSC reads the model input, which needs no gradient: its
    backward launch computes no dx."""
    from extended_gan_torch.models.registry import build_model
    from extended_gan_torch.models.smaat_unet import DepthwiseSeparableConv

    model = build_model("unet", image_width=20, image_height=20,
                        n_vertices=6, mapping_type="linear", device="cpu",
                        generator=torch.Generator().manual_seed(0)).train()
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].requires_grad))
        for m in model.modules() if isinstance(m, DepthwiseSeparableConv)]
    model(torch.rand(1, 20, 20, 4, 6))
    for hk in hooks:
        hk.remove()
    assert len(seen) == 18 and sum(seen) == 17 and not seen[0]


def test_probe_times_the_unet_dscs_and_needs_a_card():
    """``k3_probe`` (and ``chip_smoke.py``) read the 18 shapes off the model
    (here at batch 1: N = 6 images); without a card the probe refuses
    before building anything."""
    from extended_gan_torch.models.smaat_unet import dsc_shapes
    from extended_gan_torch.ops import k3_probe

    shapes = dsc_shapes(1, device="cpu")
    assert [(s[0] * 32,) + s[1:] for s in shapes] == UNET_SHAPES[:18]
    assert k3_probe.main([]) == 1


@pytest.mark.parametrize("w, raises", [(190, False), (400, True)])
def test_kernels_refuse_images_too_wide_for_their_stage(w, raises):
    """Both kernels stage 2W + 2 rows of halo in shared memory: the wrappers
    raise, before any launch, for rows too wide for it."""
    x = torch.zeros(1, 2, w, 64)
    dw, dwb = torch.zeros(3, 3, 64), torch.zeros(64)
    pw, pwb = torch.zeros(64, 8), torch.zeros(8)
    if raises:
        with pytest.raises(ValueError, match="too wide"):
            k3._bwd_plan(1, 2, w, 64, 64)
        with pytest.raises(ValueError, match="too wide"):
            k3._launch(x, dw, dwb, pw, pwb)
    else:
        k3._bwd_plan(1, 2, w, 64, 64)
        assert 2 * (128 + 2 * w + 2) * 32 * 4 <= k3._FWD_SMEM
