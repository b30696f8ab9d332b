"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here is marked ``cuda`` and skips without a card: a CUDA kernel
has no CPU mode. The file imports nothing of JAX, so it also runs where
JAX is not installed (the repository's conftest.py imports JAX, hence
``--noconftest``):

  python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py
"""

import functools

import numpy as np
import pytest
import torch

from extended_gan_torch.models.gat.layers import normalized_adjacency
from extended_gan_torch.models.registry import build_model
from extended_gan_torch.ops import dsconv as k3
from extended_gan_torch.ops import gat_attention as k1
from extended_gan_torch.ops import gat_mapping as k2

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _k1_mapped(rng, nh, b, mm, hw, g, layout, device):
    """m for fused_gat_attention ("api": (NH, B, M, P) contiguous) or
    mapped (NH, B, H, W, T, V) for attend_temporal: pixel-major
    contiguous, or the cuDNN mapping's view of memory ordered
    (B, V, NH, T, H, W)."""
    side = int(round(hw ** 0.5))
    if layout == "api":
        shape = (nh, b, mm, g * hw)
    elif layout == "pixel":
        shape = (nh, b, side, side, mm, g)
    else:
        shape = (b, g, nh, mm, side, side)
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    x = x.to(device)
    return x.permute(2, 0, 4, 5, 3, 1) if layout == "cudnn" else x


def _k1_rows(x, layout, hw):
    """(NH, B, M, P) of an input or output in ``layout``."""
    if layout == "api":
        return x
    nh, b, _, _, t, v = x.shape
    return x.permute(0, 1, 4, 5, 2, 3).reshape(nh, b, t, v * hw)


@pytest.mark.parametrize("layout", ["api", "pixel", "cudnn"])
@pytest.mark.parametrize("nh,b,mm,hw", [
    (1, 1, 4, 400), (3, 8, 4, 400), (3, 2, 4, 6400),
    (1, 3, 4, 25),  # group_size % 4 != 0: scalar copies
    (2, 2, 3, 64), (1, 2, 8, 16),
    (3, 1, 4, 6400),  # served batch 1 at 80x80
    (1, 1, 4, 40000),  # 200x200: no cluster holds it, the first kernel
])
def test_kernel_matches_plain(cuda_device, nh, b, mm, hw, layout):
    rng = np.random.default_rng(20 + nh * b + mm)
    g = 6
    m = _k1_mapped(rng, nh, b, mm, hw, g, layout, cuda_device)
    a = torch.from_numpy(rng.standard_normal((nh, 2 * g),
                                             dtype=np.float32)).to(cuda_device)
    adj = normalized_adjacency(torch.from_numpy(
        rng.random((nh, mm, mm), dtype=np.float32)).to(cuda_device))
    before = k1.launch_count
    with torch.no_grad():
        if layout == "api":
            got = k1.fused_gat_attention(m, a, adj, 0.2, hw)
        else:
            got = (k1.attend_temporal(m, a, adj, 0.2),)
    assert k1.launch_count == before + 1
    clustered = k1._cluster_plan(nh, b, hw, mm * g) is not None
    assert clustered == (hw != 40000)
    if layout != "api" and clustered:  # taken in place, written alike
        assert all(p == q for n, p, q in zip(m.shape, m.stride(),
                                              got[0].stride()) if n > 1)
    rows = _k1_rows(m, layout, hw)
    w1 = a[:, :g].repeat_interleave(hw, 1)[:, None, None, :]
    w2 = a[:, g:].repeat_interleave(hw, 1)[:, None, None, :]
    want = k1.reference_impl(rows, w1, w2, adj[:, None], 0.2, hw)
    torch.cuda.synchronize()
    got = (_k1_rows(got[0], layout, hw),) + tuple(got[1:])
    for name, g_, w_ in zip(("out", "att0", "att", "pos"), got, want):
        torch.testing.assert_close(g_, w_, rtol=1e-5, atol=1e-5, msg=name)


def test_cluster_plan_matches_the_kernels_shared_memory(cuda_device):
    """The plan's shared-memory sizes are the C entry point's."""
    lib = k1._lib()
    for mm, g, pixels, buffers in ((4, 6, 1600, 1), (4, 6, 800, 2),
                                   (8, 16, 36, 1), (3, 5, 44, 2)):
        assert lib.gat_attention_cluster_smem_bytes(mm, g, pixels, buffers) \
            == 4 * (k1._HEADER_FLOATS + buffers * pixels * mm * g)


def test_kernel_refuses_what_it_cannot_take(cuda_device):
    m = torch.zeros(1, 1, 4, 24, device=cuda_device)
    a = torch.zeros(1, 12, device=cuda_device)
    adj = torch.eye(4, device=cuda_device)[None]
    with pytest.raises(ValueError, match="contiguous"):
        k1.fused_gat_attention(m.transpose(-1, -2).contiguous()
                               .transpose(-1, -2), a, adj, 0.2, 4)
    with pytest.raises(TypeError, match="float32"):
        k1.fused_gat_attention(m.double(), a, adj, 0.2, 4)


def test_k1_gradient_through_the_kernel_matches_plain(cuda_device):
    """The autograd wrapper's backward, fed by the kernel's residuals,
    against autograd through the plain version."""
    rng = np.random.default_rng(7)
    nh, b, mm, g, hw = 3, 4, 4, 6, 400
    m = torch.from_numpy(rng.standard_normal(
        (nh, b, mm, g * hw), dtype=np.float32)).to(cuda_device)
    a = torch.from_numpy(rng.standard_normal(
        (nh, 2 * g), dtype=np.float32)).to(cuda_device)
    adj = normalized_adjacency(torch.from_numpy(
        rng.random((nh, mm, mm), dtype=np.float32)).to(cuda_device))
    cot = torch.randn_like(m)
    grads = []
    for fused in (True, False):
        inputs = [t.clone().requires_grad_() for t in (m, a, adj)]
        if fused:
            before = k1.launch_count
            out = k1.fused_gat_attention(*inputs, 0.2, hw)[0]
            assert k1.launch_count == before + 1
            before = k1.bwd_launch_count
        else:
            w1 = inputs[1][:, :g].repeat_interleave(hw, 1)[:, None, None, :]
            w2 = inputs[1][:, g:].repeat_interleave(hw, 1)[:, None, None, :]
            out = k1.reference_impl(inputs[0], w1, w2, inputs[2][:, None],
                                    0.2, hw)[0]
        grads.append(torch.autograd.grad((out * cot).sum(), inputs))
        if fused:  # one gat_attention_bwd launch a backward
            assert k1.bwd_launch_count == before + 1
    torch.cuda.synchronize()
    for name, g_, w_ in zip(("m", "a", "adj_norm"), *grads):
        # sums over up to B * P = 9,600 products per entry
        torch.testing.assert_close(g_, w_, rtol=1e-4,
                                   atol=1e-4 * w_.abs().max().item(),
                                   msg=name)


@pytest.mark.parametrize("nh,b,hw,layout,glayout,chunked", [
    (3, 4, 6400, "pixel", "pixel", False),
    (1, 4, 6400, "cudnn", "pixel", False),
    (3, 32, 400, "cudnn", "cudnn", False),
    (1, 32, 400, "pixel", "cudnn", False),
    (3, 2, 6400, "cudnn", "cudnn", True),  # slices walked in chunks
])
def test_k1_backward_matches_plain_and_repeats_bit_for_bit(
        cuda_device, monkeypatch, nh, b, hw, layout, glayout, chunked):
    """gat_attention_bwd against reference_backward from the same
    residuals, twice, bit-identical; the cotangent in its own layout.
    Tolerance as the gradient test above: 1e-4 relative to the largest
    entry (sums over up to B * P products)."""
    if chunked:  # a shared-memory budget of 64-pixel chunks
        plan = functools.partial(k1._cluster_plan,
                                 smem_limit=4 * (k1._HEADER_FLOATS
                                                 + 2 * 64 * 24))
        monkeypatch.setattr(k1, "_cluster_plan", plan)
    rng = np.random.default_rng(70 + nh * b)
    g = 6
    x = _k1_mapped(rng, nh, b, 4, hw, g, layout, cuda_device)
    x = x.reshape(nh, b, hw, 4, g)
    gt = _k1_mapped(rng, nh, b, 4, hw, g, glayout, cuda_device)
    gt = gt.reshape(nh, b, hw, 4, g)
    a = torch.from_numpy(rng.standard_normal((nh, 2 * g),
                                             dtype=np.float32)).to(cuda_device)
    adj = normalized_adjacency(torch.from_numpy(
        rng.random((nh, 4, 4), dtype=np.float32)).to(cuda_device))
    out, att0, att, pos = k1._launch_fwd(x, a, adj, 0.2)
    before = k1.bwd_launch_count
    runs = [k1._launch_bwd(x, gt, a, adj, att0, att, pos, 0.2)
            for _ in range(2)]
    assert k1.bwd_launch_count == before + 2
    _, npix, chunk = k1._cluster_plan(nh, b, hw, 4 * g, backward=True)
    assert (chunk < npix) == chunked
    want = k1.reference_backward(k1._rows(x), a, adj, k1._rows(out), att0,
                                 att, pos, k1._rows(gt), 0.2, hw)
    torch.cuda.synchronize()
    for first, again in zip(*runs):
        assert torch.equal(first, again)
    got = (k1._rows(runs[0][0]),) + tuple(runs[0][1:])
    for name, g_, w_ in zip(("d_m", "d_a", "d_adj"), got, want):
        torch.testing.assert_close(g_, w_, rtol=1e-4,
                                   atol=1e-4 * w_.abs().max().item(),
                                   msg=name)


# (N, H, W, C, kpl, Cout): kpl 1 and 2, ragged tiles of pixels and output
# channels, 1x1 images, and a CK that is not a multiple of the 32-channel
# chunk
K3_SHAPES = [(4, 20, 20, 4, 2, 64), (3, 5, 7, 3, 1, 5), (192, 1, 1, 64, 2, 96),
             (2, 10, 10, 40, 1, 130), (1, 33, 17, 16, 2, 64)]


def _k3_inputs(shape, device, seed):
    n, h, w, c, kpl, cout = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    ck = c * kpl
    return (torch.randn(n, h, w, c, device=device, generator=gen),
            torch.randn(3, 3, ck, device=device, generator=gen) / 3,
            torch.randn(ck, device=device, generator=gen),
            torch.randn(ck, cout, device=device, generator=gen) / ck ** 0.5,
            torch.randn(cout, device=device, generator=gen))


@pytest.mark.parametrize("shape", K3_SHAPES)
def test_k3_kernel_matches_plain(cuda_device, shape):
    args = _k3_inputs(shape, cuda_device, sum(shape))
    before = k3.launch_count
    with torch.no_grad():
        got = k3.fused_dsconv(*args)
    assert k3.launch_count == before + 1
    want = k3.reference_dsc(*args)
    torch.cuda.synchronize()
    # f32 sums over 9 taps and up to 80 depthwise channels, in another order
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_k3_gradient_launches_nothing_and_matches_plain(cuda_device,
                                                        monkeypatch):
    """The K3 backward launches the backward kernel once (beside two matrix
    products) and runs no plain forward; its gradients match autograd of
    the plain version."""
    args = _k3_inputs(K3_SHAPES[0], cuda_device, 3)
    cot = torch.randn(4, 20, 20, 64, device=cuda_device)
    inputs = [t.clone().requires_grad_() for t in args]
    plain = torch.autograd.grad((k3.reference_dsc(*inputs) * cot).sum(), inputs)

    def no_plain(*a):
        raise AssertionError("the K3 path ran the plain depthwise")
    monkeypatch.setattr(k3, "_depthwise", no_plain)
    inputs = [t.clone().requires_grad_() for t in args]
    out = k3.fused_dsconv(*inputs)
    before = k3.launch_count, k3.bwd_launch_count
    got = torch.autograd.grad((out * cot).sum(), inputs)
    assert (k3.launch_count, k3.bwd_launch_count) == (before[0],
                                                      before[1] + 1)
    for name, g_, w_ in zip(("x", "dw", "dwb", "pw", "pwb"), got, plain):
        torch.testing.assert_close(g_, w_, rtol=1e-4,
                                   atol=1e-4 * w_.abs().max().item(),
                                   msg=name)


# (N, H, W, C, kpl, Cout): a 20x20, a 2x2 and a 1x1 final_smaatunet-like
# shape at a smaller batch, kpl 1 with a ragged channel group, up4 dsc0 of
# final_smaatunet at batch 32 (about 30 pixels a lane, as in training), and
# two shapes whose warps have idle lanes (kpl 3: 30 of 32 lanes; C = 20 at
# kpl 1: 20 of 32) with a staged run wider than the block's 10 x 512-float
# floor of shared memory
K3_BWD_SHAPES = [(8, 20, 20, 64, 2, 64), (48, 2, 2, 256, 2, 512),
                 (64, 1, 1, 512, 2, 512), (3, 5, 7, 40, 1, 20),
                 (192, 20, 20, 64, 2, 64), (8, 40, 40, 10, 3, 8),
                 (8, 40, 40, 20, 1, 16)]


@pytest.mark.parametrize("need_dx", [True, False])
@pytest.mark.parametrize("shape", K3_BWD_SHAPES)
def test_k3_backward_matches_plain_and_repeats_bit_for_bit(cuda_device, shape,
                                                          need_dx):
    n, h, w, c, kpl, cout = shape
    x, dw, dwb, pw, pwb = _k3_inputs(shape, cuda_device, sum(shape))
    g = torch.randn(n, h, w, cout, device=cuda_device,
                    generator=torch.Generator(device=cuda_device)
                    .manual_seed(5))
    needs = (need_dx, True, True, True, True)
    d = k3._launch(x, dw, dwb, pw, pwb, keep_d=True)[1]
    before = k3.bwd_launch_count
    got = k3._backward_cuda(x, dw, pw, d, g, needs)
    again = k3._backward_cuda(x, dw, pw, d, g, needs)
    assert k3.bwd_launch_count == before + 2
    want = k3.reference_dsc_backward(x, dw, dwb, pw, g, need_dx=need_dx)
    torch.cuda.synchronize()
    assert (got[0] is None) != need_dx
    for name, g_, a_, w_ in zip(("dx", "ddw", "ddwb", "dpw", "dpwb"), got,
                                again, want):
        if g_ is None:
            continue
        assert torch.equal(g_, a_), name
        # f32 sums over up to N*H*W = 76,800 pixels in another order
        torch.testing.assert_close(g_, w_, rtol=1e-4,
                                   atol=1e-4 * w_.abs().max().item(),
                                   msg=name)


# channels a slice of CK: unsplit, the plan's, and slices of one and three
# 32-channel chunks
@pytest.mark.parametrize("ks", [None, 0, 32, 96])
@pytest.mark.parametrize("shape", [K3_SHAPES[0], K3_SHAPES[2], K3_SHAPES[3]])
def test_k3_split_and_unsplit_forwards_match_plain(cuda_device, shape, ks):
    args = _k3_inputs(shape, cuda_device, 11)
    ck = args[1].shape[-1]
    ks = -(-ck // 32) * 32 if ks is None else ks or None
    with torch.no_grad():
        got, d = k3._launch(*args, keep_d=True, ks=ks)
        again, _ = k3._launch(*args, ks=ks)
        want = k3.reference_dsc(*args)
        want_d = k3._depthwise(*args[:3])
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(d, want_d, rtol=1e-5, atol=1e-5)


def test_k3_refuses_what_it_cannot_take(cuda_device):
    x, dw, dwb, pw, pwb = _k3_inputs(K3_SHAPES[0], cuda_device, 4)
    with pytest.raises(ValueError, match="contiguous"):
        k3.fused_dsconv(x.transpose(1, 2).contiguous().transpose(1, 2), dw,
                        dwb, pw, pwb)
    with pytest.raises(TypeError, match="float32"):
        k3.fused_dsconv(x.double(), dw, dwb, pw, pwb)


def test_unet_forward_launches_k3_18_times_and_matches_plain(cuda_device):
    kw = dict(image_width=20, image_height=20, n_vertices=6,
              mapping_type="linear", device=cuda_device)
    fused = build_model("unet", generator=torch.Generator().manual_seed(0),
                        **kw)
    plain = build_model("unet", use_pallas=False, **kw)
    plain.load_state_dict(fused.state_dict())
    x = torch.rand(2, 20, 20, 4, 6, device=cuda_device)
    before = k3.launch_count
    with torch.inference_mode(), torch.backends.cudnn.flags(
            enabled=True, allow_tf32=False):
        y = fused(x)
        want = plain(x)
    assert k3.launch_count == before + 18
    torch.testing.assert_close(y, want, rtol=1e-4, atol=1e-4)


def test_model_forward_launches_twice_and_matches_plain(cuda_device):
    kw = dict(image_width=8, image_height=8, n_vertices=6, mapping_type="conv",
              device=cuda_device)
    fused = build_model("temporal", generator=torch.Generator().manual_seed(0),
                        **kw)
    plain = build_model("temporal", use_pallas=False, **kw)
    plain.load_state_dict(fused.state_dict())
    x = torch.rand(4, 8, 8, 4, 6, device=cuda_device)
    before = k1.launch_count
    # exact f32 convolutions: cuDNN defaults to TF32
    with torch.inference_mode(), torch.backends.cudnn.flags(
            enabled=True, allow_tf32=False):
        y = fused(x)
        want = plain(x)
    assert k1.launch_count == before + 2
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)


# K2 shapes (NH, B, V, H): the final_temp_conv hidden and output blocks at
# batch 32, serving batch 1, and local_temporal_conv (20x20) at batch 32
K2_SHAPES = [(3, 32, 6, 80), (1, 32, 6, 80), (3, 1, 6, 80), (3, 32, 6, 20)]
# Tolerance per output: K2_TOL_UNITS * sqrt(terms) times the sum of the
# absolute values of the terms the output adds up, bounded by the plain
# version (and its autograd) run on |inputs| and |cotangent|: an output of
# the forward sums 9 * F products in its last layer, a weight gradient one
# per pixel of every image, so the two orders of summation part by about
# sqrt(terms) roundoff units of that scale.
K2_TOL_UNITS = 8 * 2.0**-24


def _k2_inputs(nh, b, v, h, device, seed, f=74, c=4):
    gen = torch.Generator(device=device).manual_seed(seed)
    r = lambda *s, scale=1.0: scale * torch.randn(  # noqa: E731
        *s, device=device, generator=gen)
    x = torch.rand(b, h, h, c, v, device=device, generator=gen)
    return (x, r(nh, f, c, 3, 3, scale=(9 * c) ** -0.5), r(nh, f, scale=0.1),
            r(nh, f, f, 1, 1, scale=f ** -0.5), r(nh, f, scale=0.1),
            r(nh, c, f, 3, 3, scale=(9 * f) ** -0.5), r(nh, c, scale=0.1))


def _k2_gate_safe_inputs(nh, b, v, h, device, seed, f=74, c=4):
    """Inputs on a grid that keeps every pre-activation at least 2^-11 from
    0: x in quarters, weights in eighths and sixteenths, biases half a grid
    step off it. A pre-activation within roundoff of 0 would take its ReLU
    gate one way in the kernel and the other in the plain version, and a
    gradient through a flipped gate differs by a whole term, not by
    roundoff."""
    gen = torch.Generator(device=device).manual_seed(seed)
    q = lambda den, *s: torch.randint(  # noqa: E731
        -4, 5, s, device=device, generator=gen).float() / den
    x = torch.randint(0, 4, (b, h, h, c, v), device=device,
                      generator=gen).float() / 4
    return (x, q(8, nh, f, c, 3, 3), q(32, nh, f) + 2.0**-6,
            q(16, nh, f, f, 1, 1), q(32, nh, f) + 2.0**-11,
            q(16, nh, c, f, 3, 3), q(32, nh, c))


def _within(got, want, scale, terms, name):
    tol = K2_TOL_UNITS * terms ** 0.5 * scale
    err = (got - want).abs()
    assert bool((err <= tol).all()), (
        f"{name}: max abs err {err.max().item():.3e}, worst err/tol "
        f"{(err / tol).max().item():.3f}")


@pytest.mark.parametrize("shape", K2_SHAPES + [
    (3, 2, 3, 17),  # a side the forward's 16x16 tile does not divide
    (2, 2, 3, 5),   # a side smaller than one tile
    (3, 2, 3, 13),  # the backward test's ragged shape
])
def test_k2_forward_matches_plain(cuda_device, shape):
    args = _k2_inputs(*shape, cuda_device, sum(shape))
    before = k2.fwd_launch_count
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True,
                                                     allow_tf32=False):
        got = k2.fused_conv_bottleneck(*args)
        again = k2.fused_conv_bottleneck(*args)
        want = k2.reference_bottleneck(*args)
        scale = k2.reference_bottleneck(*(t.abs() for t in args))
    assert k2.fwd_launch_count == before + 2
    assert got.shape == want.shape and got.is_contiguous()
    assert torch.equal(got, again), "two runs differ"
    _within(got, want, scale, 9 * 74, "out")


def _k2_grads(fn, args, cot, need_dx):
    inputs = [t.clone().requires_grad_(i > 0 or need_dx)
              for i, t in enumerate(args)]
    out = fn(*inputs)
    return torch.autograd.grad(out, inputs if need_dx else inputs[1:], cot)


@pytest.mark.parametrize("shape,need_dx,f", [
    ((3, 32, 6, 80), False, 74), ((1, 32, 6, 80), True, 74),
    ((3, 2, 3, 13), True, 74),  # heads summed into dx; ragged 10x10 tiles
    ((3, 2, 3, 20), False, 74),  # local_temporal_conv's side
    ((1, 2, 3, 7), True, 74),   # a side smaller than one tile
    # a hidden width that the backward's 8-channel register tiles and its
    # 8 x 8 dW2 tiles do not divide
    ((2, 2, 3, 13), True, 37),
])
def test_k2_backward_matches_plain_and_repeats_bit_for_bit(cuda_device, shape,
                                                           need_dx, f):
    nh, b, v, h = shape
    args = _k2_gate_safe_inputs(*shape, cuda_device, 7 + h, f=f)
    cot = torch.randn(nh, b, h, h, 4, v, device=cuda_device,
                      generator=torch.Generator(device=cuda_device).manual_seed(1))
    before = k2.bwd_launch_count
    got = _k2_grads(k2.fused_conv_bottleneck, args, cot, need_dx)
    again = _k2_grads(k2.fused_conv_bottleneck, args, cot, need_dx)
    assert k2.bwd_launch_count == before + 2
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        want = _k2_grads(k2.reference_bottleneck, args, cot, need_dx)
        scale = _k2_grads(k2.reference_bottleneck, [t.abs() for t in args],
                          cot.abs(), need_dx)
    names = (["dx"] if need_dx else []) + ["dw1", "db1", "dw2", "db2", "dw3",
                                           "db3"]
    pixels = b * v * h * h
    for name, g_, a_, w_, s_ in zip(names, got, again, want, scale):
        assert torch.equal(g_, a_), f"{name} differs between two runs"
        terms = 9 * f * nh if name == "dx" else pixels
        _within(g_, w_, s_, terms, name)


def test_k2_refuses_what_it_cannot_take(cuda_device):
    x, *ws = _k2_inputs(1, 2, 3, 10, cuda_device, 5)
    with pytest.raises(ValueError, match="contiguous"):
        k2.fused_conv_bottleneck(x.transpose(1, 2), *ws)
    with pytest.raises(TypeError, match="float32"):
        k2.fused_conv_bottleneck(x.double(), *ws)
    with pytest.raises(TypeError, match="float32"):
        k2.fused_conv_bottleneck(x, ws[0].half(), *ws[1:])
    with pytest.raises(ValueError, match="does not fit"):
        k2.fused_conv_bottleneck(x, *ws[:2], ws[2][:, :, :70], *ws[3:])
    wide = _k2_inputs(1, 2, 3, 10, cuda_device, 6, f=81)
    with pytest.raises(ValueError, match="hidden width of at most 80"):
        k2.fused_conv_bottleneck(*wide)


def _gat_pair(hw, device, seed=0):
    from extended_gan_torch.models.gat.gat3d import Model

    kw = dict(attention_type="temporal", mapping_type="conv", use_pallas=True)
    fused = Model(hw, hw, 6, use_pallas_mapping=True,
                  generator=torch.Generator().manual_seed(seed), **kw)
    plain = Model(hw, hw, 6, **kw)
    plain.load_state_dict(fused.state_dict())
    return fused.to(device), plain.to(device)


def test_k2_model_launches_two_a_forward_and_two_a_backward(cuda_device):
    fused, plain = _gat_pair(20, cuda_device)
    x = torch.rand(4, 20, 20, 4, 6, device=cuda_device)
    before = (k2.fwd_launch_count, k2.bwd_launch_count)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = fused(x)
        assert (k2.fwd_launch_count, k2.bwd_launch_count) == (
            before[0] + 2, before[1])
        y.square().mean().backward()
        assert (k2.fwd_launch_count, k2.bwd_launch_count) == (
            before[0] + 2, before[1] + 2)
        torch.testing.assert_close(y.detach(), plain(x).detach(), rtol=1e-5,
                                   atol=1e-5)


def test_k2_model_train_steps_match_the_plain_path(cuda_device):
    """One step's gradients, then three Adam steps, switch on against off,
    at 80x80 and batch 16. A ReLU gate that roundoff flips (a pre-activation
    within roundoff of 0) moves a weight gradient by one pixel's term, a
    share of the largest entry that shrinks with the number of pixels: at
    20x20 and batch 8 one flip exceeded the 1e-4 this test allows."""
    from extended_gan_torch.train.gat_trainer import make_gat_train_step

    fused, plain = _gat_pair(80, cuda_device, seed=3)
    rng = np.random.default_rng(0)
    batches = [[torch.from_numpy(rng.random((16, 80, 80, 4, 6), np.float32))
                .to(cuda_device) for _ in range(2)] for _ in range(3)]
    mask = torch.ones(16, device=cuda_device)
    x0, y0 = batches[0]
    # about one f32 rounding of the input: how far roundoff alone (and the
    # ReLU gates it flips) moves the plain path's gradients
    noise = 1 + 1e-7 * torch.randn(
        x0.shape, generator=torch.Generator().manual_seed(1)).to(cuda_device)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        grads = []
        for model, x in ((fused, x0), (plain, x0), (plain, x0 * noise)):
            model.train().zero_grad()
            ((model(x) - y0) ** 2).mean().backward()
            grads.append([p.grad.clone() for p in model.parameters()])
        largest = max(g.abs().max().item() for g in grads[1])
        gap, sens = (max((g_ - w_).abs().max().item()
                         for g_, w_ in zip(grads[i], grads[1])) / largest
                     for i in (0, 2))
        # chip_smoke.py's rule: 10x what roundoff alone does, or 1e-4
        assert gap <= max(1e-4, 10 * sens), (gap, sens)
        steps = [make_gat_train_step(m, torch.optim.Adam(m.parameters(), 1e-3))
                 for m in (fused, plain)]
        for x, y in batches:
            losses = [float(step(x, y, mask)[0]) for step in steps]
            assert abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[1])
    # Adam moves every entry by about lr a step whatever its gradient's
    # size, and one whose gradient is zero up to roundoff either way
    for p, q in zip(fused.parameters(), plain.parameters()):
        assert (p - q).abs().max().item() <= 2 * 1e-3 * 3
