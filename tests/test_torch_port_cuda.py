"""The port's CUDA kernels against their plain PyTorch versions, on a GPU,
and the megastep's CUDA graphs (``train/megastep.py``) against eager steps:
K1, K2 and K3 captured, the dropout generator across replays, a changed
learning rate, Adam's step count and the launch counters under replay; the
CycleGAN's graph against eager steps, and the vanilla GAN's FusedProp step
against its default step.

Every test here is marked ``cuda`` and skips without a card: a CUDA kernel
has no CPU mode. The file imports nothing of JAX, so it also runs where
JAX is not installed (the repository's conftest.py imports JAX, hence
``--noconftest``):

  python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py
"""

import functools
import os

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


def _counts():
    from extended_gan_torch import ops

    return {**{f"{n} kernel": c for n, c in ops.launch_counts().items()},
            **{f"{n} plain": c for n, c in ops.plain_routes().items()}}


def _delta(before):
    return {n: c - before[n] for n, c in _counts().items() if c != before[n]}


# (N, H, W, C, kpl, Cout) past each K3 limit: the backward's rows, the
# forward's stages (the forward reads its taps unstaged, the backward takes
# the rows), the backward's kpl; the routes
ROUTED_K3 = [((2, 8, 288, 64, 2, 16), ("kernel", "plain")),
             ((1, 4, 336, 4, 2, 8), ("kernel", "kernel")),
             ((2, 6, 6, 2, 33, 8), ("kernel", "plain"))]


@pytest.mark.parametrize("shape,routes", ROUTED_K3)
def test_k3_routes_shapes_past_each_limit_to_the_plain_version(
        cuda_device, shape, routes):
    """Each call goes where the shape rule says, counted (the forward
    always to its kernel, staged or not); the plain routes give the plain
    version's values bit for bit, the kernels its values within their
    tolerance."""
    n, h, w, c, kpl, cout = shape
    assert routes == (
        "kernel", "kernel" if k3.bwd_takes(n, h, w, c, c * kpl) else "plain")
    gen = torch.Generator().manual_seed(sum(shape))
    inputs = [(torch.rand(s, generator=gen) - 0.5).to(cuda_device)
              for s in ((n, h, w, c), (3, 3, c * kpl), (c * kpl,),
                        (c * kpl, cout), (cout,))]
    g = torch.randn((n, h, w, cout), generator=gen).to(cuda_device)
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    before = _counts()
    out = k3.fused_dsconv(*leaves)
    out.backward(g)
    torch.cuda.synchronize()
    assert _delta(before) == {f"dsconv_fwd {routes[0]}": 1,
                              f"dsconv_bwd {routes[1]}": 1}
    want = k3.reference_dsc(*inputs)
    grads = k3.reference_dsc_backward(*inputs[:4], g)
    got = [out.detach()] + [t.grad for t in leaves]
    for i, (a, b) in enumerate(zip(got, [want, *grads])):
        if routes[min(i, 1)] == "plain":
            assert torch.equal(a, b), i
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-4 * float(b.abs().max()))


# (NH, B, M, G, S) past each K1 limit, and the routes: M past the
# instances (the forward's run-time-M kernel), M * G past the backward's
ROUTED_K1 = [((2, 3, 9, 6, 64), ("kernel", "plain")),
             ((2, 3, 8, 17, 16), ("kernel", "plain"))]


@pytest.mark.parametrize("shape,routes", ROUTED_K1)
def test_k1_routes_shapes_past_each_limit_to_the_plain_version(
        cuda_device, shape, routes):
    nh, b, mm, g, s = shape
    assert routes == ("kernel", "kernel" if k1.bwd_takes(mm, g) else "plain")
    gen = torch.Generator().manual_seed(mm * g)
    m = (torch.rand((nh, b, mm, g * s), generator=gen) - 0.5).to(cuda_device)
    a = (torch.rand((nh, 2 * g), generator=gen) - 0.5).to(cuda_device)
    adj = torch.softmax(torch.rand((nh, mm, mm), generator=gen), -1).to(
        cuda_device)
    cot = torch.randn(m.shape, generator=gen).to(cuda_device)
    leaves = [t.clone().requires_grad_(True) for t in (m, a, adj)]
    before = _counts()
    out = k1.fused_gat_attention(*leaves, 0.2, s)[0]
    out.backward(cot)
    torch.cuda.synchronize()
    assert _delta(before) == {f"gat_attention_fwd {routes[0]}": 1,
                              f"gat_attention_bwd {routes[1]}": 1}
    # the plain versions, on the card
    plain = [t.clone().requires_grad_(True) for t in (m, a, adj)]
    w1, w2 = k1._group_rows(plain[1], s)
    want = k1.reference_impl(plain[0], w1, w2, plain[2][:, None], 0.2, s)[0]
    want.backward(cot)
    for x, y in zip([out.detach()] + [t.grad for t in leaves],
                    [want.detach()] + [t.grad for t in plain]):
        torch.testing.assert_close(x, y, rtol=1e-4,
                                   atol=1e-4 * float(y.abs().max()))


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


def test_dcgan_train_step_on_the_card_matches_the_cpu(cuda_device):
    """One DCGAN train step (nc 4, ndf 16, 64x64, batch 8, dropout off) on
    the card, exact f32, against the same step on the CPU from the same
    weights. The DCGAN path runs no kernel of the port: this holds cuDNN's
    convolutions and the trainer's device code. Losses within 1e-4
    relative (the discriminators' Adam step, which moves an entry whose
    gradient is within roundoff of zero either way, lies before errG); each
    net's gradients within 2e-2 of its largest entry: train-mode BatchNorm
    cancels in its gradient (the generator's move by 2e-3 under one part in
    1e7 of input noise, in float64, at full width)."""
    from extended_gan_torch.ops import launch_counts
    from extended_gan_torch.train.dcgan_driver import DEFAULT_PARAMS, build_dcgan
    from extended_gan_torch.train.dcgan_trainer import make_dcgan_train_step

    params = {**DEFAULT_PARAMS, "ndf": 16}
    rng = np.random.default_rng(0)
    x, y = (torch.from_numpy(rng.random((8, 4, 64, 64), np.float32))
            for _ in range(2))
    runs = []
    before = launch_counts()
    for dev in (torch.device("cpu"), cuda_device):
        nets, opts = build_dcgan(params, seed=0, device=dev, dropout=0.0)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            logs = make_dcgan_train_step(*nets, *opts)(x.to(dev), y.to(dev))
        runs.append(([float(logs[k]) for k in ("errFD", "errTD", "errG")],
                     [[p.grad.cpu() for p in n.parameters()] for n in nets]))
    assert launch_counts() == before
    (cpu_loss, cpu_grads), (card_loss, card_grads) = runs
    np.testing.assert_allclose(card_loss, cpu_loss, rtol=1e-4)
    for got, want in zip(card_grads, cpu_grads):
        largest = max(w.abs().max().item() for w in want)
        gap = max((g - w).abs().max().item() for g, w in zip(got, want))
        assert gap <= 2e-2 * largest, (gap, largest)


# (Cin, Cout) of the DCGAN generator's five convs at nc = 4
GEN_LAYERS = [(4, 32), (32, 16), (16, 8), (8, 4), (4, 4)]


@pytest.mark.parametrize("cin,cout", GEN_LAYERS)
def test_int8_conv_on_the_card_equals_its_plain_version(cuda_device, cin,
                                                        cout):
    """The w8a8 product at the generator's layer shapes, b=32, 64x64:
    int8 in, int32 out, exactly the plain version's accumulators (the last
    two layers' Cout = 4 padded to 8 for ``_int_mm``)."""
    from extended_gan_torch.ops import int8_conv

    gen = torch.Generator(device=cuda_device).manual_seed(cin * 100 + cout)
    x = torch.randint(-127, 128, (32, 64, 64, cin), dtype=torch.int8,
                      device=cuda_device, generator=gen)
    w = torch.randint(-127, 128, (4, 4, cin, cout), dtype=torch.int8,
                      device=cuda_device, generator=gen)
    before = int8_conv.launch_count
    got = int8_conv.int8_conv2d(x, w)
    assert int8_conv.launch_count == before + 1
    assert got.dtype == torch.int32 and got.device.type == "cuda"
    want = int8_conv.reference_int8_conv(x.cpu(), w.cpu())
    assert torch.equal(got.cpu(), want)


def test_w8_gat3d_forward_launches_k1_as_the_f32_one(cuda_device):
    """A w8 GAT3D artifact dequantises into the model at load: its forward
    launches K1 twice, as the f32 forward does, and stays within the
    weights' rounding of it."""
    from extended_gan_torch.serve.export import build_forward
    from extended_gan_torch.serve.quantize import quantize_state_dict_w8

    spec = dict(workload="gat", model_type="temporal", mapping_type="conv",
                image_width=8, image_height=8, n_vertices=6, time_steps=4)
    f32 = build_model("temporal", image_width=8, image_height=8,
                      n_vertices=6, mapping_type="conv", device=cuda_device,
                      generator=torch.Generator().manual_seed(0))
    packed, _ = quantize_state_dict_w8(f32.state_dict())
    w8, _ = build_forward({**spec, "quantize": "w8"}, packed, cuda_device)
    x = torch.rand(4, 8, 8, 4, 6, device=cuda_device)
    with torch.inference_mode(), torch.backends.cudnn.flags(
            enabled=True, allow_tf32=False):
        before = k1.launch_count
        want = f32(x)
        assert k1.launch_count == before + 2
        got = w8(x)
        assert k1.launch_count == before + 4
    assert 0 < (got - want).abs().max().item() < 5e-2


# ---------------------------------------------------------------- megastep


def _params(*modules):
    return [t.detach().clone() for m in modules
            for t in list(m.parameters()) + list(m.buffers())]


def _gat_megastep(model, lr, optimizer="sgd"):
    from extended_gan_torch.train.gat_trainer import make_gat_megastep
    from extended_gan_torch.train.optim import make_optimizer

    opt = make_optimizer(optimizer, model.parameters(), lr,
                         capturable=True)
    return make_gat_megastep(model, opt), opt


def _batches(device, k, b, hw, n, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [(torch.rand(k, b, hw, hw, 4, 6, device=device, generator=gen),
             torch.rand(k, b, hw, hw, 4, 6, device=device, generator=gen),
             torch.ones(k, b, device=device)) for _ in range(n)]


@pytest.mark.parametrize("kernels", ["k1", "k1+k2", "k3"])
def test_captured_train_steps_equal_eager_steps(cuda_device, kernels):
    """K = 3 steps a graph (the first group eager, the second captured and
    replayed, the third replayed); each replayed group against 3 eager
    steps on a twin from the state the graph had before it, SGD, cuDNN
    deterministic: K1 (GAT3D), K1 and K2 (use_pallas_mapping=True) bit for
    bit; K3 (the SmaAt-UNet) by ``utils.compare.held_to_reference``: the
    weights and buffers, and apart from them the logs, each tensor within
    1e-6 of its scale or 10x the widest drift of four more twins (its own,
    or the whole state's); a twin whose last optimizer step is skipped
    fails that test."""
    from extended_gan_torch import ops
    from extended_gan_torch.models.gat.gat3d import Model as GatModel
    from extended_gan_torch.utils.compare import (
        drift,
        held_to_reference,
        widest,
    )

    hw = 16 if kernels != "k3" else 20

    def make():
        if kernels == "k3":
            return build_model("unet", image_width=hw, image_height=hw,
                               n_vertices=6, mapping_type="linear",
                               device=cuda_device,
                               generator=torch.Generator().manual_seed(0))
        return GatModel(hw, hw, 6, attention_type="temporal",
                        mapping_type="conv", use_pallas=True,
                        use_pallas_mapping=kernels == "k1+k2",
                        generator=torch.Generator().manual_seed(0)).to(
                            cuda_device)

    def twin(skip_step=0):
        """Each replayed group as eager steps from the graph's state before
        it: (weights and buffers, running_nd) after each."""
        model = make()
        eager, opt = _gat_megastep(model, 1e-2)
        steps, opt_step = [0], opt.step

        def step(*args, **kw):
            steps[0] += 1
            return None if steps[0] == skip_step else opt_step(*args, **kw)
        opt.step = step
        eager.eager(*data[0])
        out = []
        for before, d in zip(after, data[1:]):
            with torch.no_grad():
                for t, s in zip(list(model.parameters())
                                + list(model.buffers()), before):
                    t.copy_(s)
            logs = [eager.eager(*d)["running_nd"]]
            out.append((_params(model), logs))
        return out

    data = _batches(cuda_device, 3, 4, hw, 3)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False,
                                    deterministic=True):
        graph_model = make()
        mega, _ = _gat_megastep(graph_model, 1e-2)
        before = ops.launch_counts()
        after, got = [], []
        for d in data:
            got.append([mega(*d)["running_nd"]])
            after.append(_params(graph_model))
        counted = {n: c - before[n] for n, c in ops.launch_counts().items()
                   if c != before[n]}
        want = twin()
        floors = (None, None)
        if kernels == "k3":  # the widest drift of 4 twins, 2 groups each
            runs = [twin() for _ in range(4)]
            floors = tuple(widest(drift(run[i][j], want[i][j])
                                  for run in runs for i in range(2))
                           for j in (0, 1))
            skipped = twin(skip_step=6)
        torch.cuda.synchronize()
    assert (mega.captures, mega.replays) == (1, 2)
    (shapes, entry), = mega.graphs.items()
    assert shapes == tuple(tuple(x.shape) for x in data[0])
    expect = {"k1": {"gat_attention_fwd": 6, "gat_attention_bwd": 6},
              "k1+k2": {"gat_attention_fwd": 6, "gat_attention_bwd": 6,
                        "gat_mapping_fwd": 6, "gat_mapping_bwd": 6},
              "k3": {"dsconv_fwd": 54, "dsconv_bwd": 54}}[kernels]
    assert entry.launches == expect
    # an eager group, a replay right after its capture, a replay
    assert counted == {n: 3 * c for n, c in expect.items()}
    for i, (w_state, w_logs) in enumerate(want):
        g_state, g_logs = after[i + 1], got[i + 1]
        if kernels == "k3":
            state = held_to_reference(g_state, w_state, floors[0])
            log = held_to_reference(g_logs, w_logs, floors[1])
            assert state["ok"] and log["ok"], (i, state, log)
        else:
            assert all(torch.equal(a, b) for a, b in zip(
                g_state + g_logs, w_state + w_logs)), i
    if kernels == "k3":
        fault = held_to_reference(skipped[0][0], want[0][0], floors[0])
        assert not fault["ok"], fault


def test_dropout_generator_advances_across_replays(cuda_device):
    """Two replays of a DCGAN graph from the same state and inputs draw
    different channel-dropout masks (so their updates differ); with dropout
    0 they are equal bit for bit."""
    from extended_gan_torch.data.resident import (
        ResidentVideos,
        make_dcgan_resident_megastep,
    )
    from extended_gan_torch.train.dcgan_driver import (
        DEFAULT_PARAMS,
        build_dcgan,
    )

    rng = np.random.default_rng(0)
    store = ResidentVideos(rng.uniform(0, 1, (40, 64, 64)).astype(np.float32),
                           np.arange(33), 8, cuda_device)
    progs = store.epoch_programs(0, 2, 4)
    outcomes = {}
    for dropout in (0.0, 0.01):
        nets, opts = build_dcgan({**DEFAULT_PARAMS, "ndf": 8}, seed=0,
                                 device=cuda_device, dropout=dropout,
                                 capturable=True)
        mega = make_dcgan_resident_megastep(
            *nets, *opts, store,
            generators=(nets[0].ConvBlock_0.dropout_generator,))
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False,
                                        deterministic=True):
            mega(progs[0])
            mega(progs[1])
            state = [t for n in nets for t in
                     list(n.parameters()) + list(n.buffers())] + [
                v for o in opts for s in o.state.values() for v in s.values()]
            saved = [t.detach().clone() for t in state]
            draws = []
            for _ in range(2):
                with torch.no_grad():
                    for t, s in zip(state, saved):
                        t.copy_(s)
                mega(progs[2])
                draws.append(_params(*nets))
        assert mega.replays == 3
        outcomes[dropout] = all(torch.equal(a, b) for a, b in zip(*draws))
    assert outcomes == {0.0: True, 0.01: False}


def test_a_changed_learning_rate_reaches_the_graph(cuda_device):
    """Epoch 2's groups use epoch 2's learning rate: the graph captured at
    the first rate is dropped, the next group captures anew, and the
    updates equal eager steps at each rate (GAT3D with K1, SGD)."""
    from extended_gan_torch.models.gat.gat3d import Model as GatModel

    def make():
        return GatModel(16, 16, 6, attention_type="temporal",
                        mapping_type="conv", use_pallas=True,
                        generator=torch.Generator().manual_seed(0)).to(
                            cuda_device)

    data = _batches(cuda_device, 2, 4, 16, 5, seed=1)
    graph_model, eager_model = make(), make()
    mega, opt = _gat_megastep(graph_model, 1e-2)
    eager, eager_opt = _gat_megastep(eager_model, 1e-2)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False,
                                    deterministic=True):
        for i, d in enumerate(data):
            if i == 3:  # the scheduler's step between epochs
                for o in (opt, eager_opt):
                    o.param_groups[0]["lr"] = 1e-3
            mega(*d)
            eager.eager(*d)
        torch.cuda.synchronize()
    assert (mega.captures, mega.replays) == (2, 4)
    for a, b in zip(_params(graph_model), _params(eager_model)):
        assert torch.equal(a, b)


def test_adam_step_count_under_replay(cuda_device):
    """Every step runs once: after an eager group, a captured one and two
    replays (with a shorter tail graph) Adam's on-card step count is the
    number of steps."""
    from extended_gan_torch.models.gat.gat3d import Model as GatModel

    model = GatModel(16, 16, 6, attention_type="temporal",
                     mapping_type="conv", use_pallas=True,
                     generator=torch.Generator().manual_seed(0)).to(
                         cuda_device)
    mega, opt = _gat_megastep(model, 1e-3, "adam")
    for d in _batches(cuda_device, 3, 4, 16, 3) + _batches(cuda_device, 2,
                                                           4, 16, 2):
        mega(*d)
    assert (mega.captures, mega.replays) == (2, 4)
    steps = {s["step"].item() for s in opt.state.values()}
    assert steps == {3 * 3 + 2 * 2}


def test_remat_step_with_the_kernels_equals_the_plain_step(cuda_device):
    """``remat=True`` with K1 and K2 (GAT3D, ``use_pallas_mapping=True``):
    the same loss, gradients and weights after Adam as the plain step, bit
    for bit (cuDNN deterministic), with each forward kernel launched twice
    a step (the forward, then the recompute) and each backward once."""
    from extended_gan_torch import ops
    from extended_gan_torch.models.gat.gat3d import Model as GatModel
    from extended_gan_torch.train.gat_trainer import make_gat_train_step

    def make():
        model = GatModel(16, 16, 6, attention_type="temporal",
                         mapping_type="conv", use_pallas=True,
                         use_pallas_mapping=True,
                         generator=torch.Generator().manual_seed(0))
        model = model.to(cuda_device)
        return model, torch.optim.Adam(model.parameters(), lr=1e-3)

    (plain, o_plain), (remat, o_remat) = make(), make()
    x, y, mask = (t[0] for t in _batches(cuda_device, 1, 4, 16, 1)[0])
    counts = []
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False,
                                    deterministic=True):
        for model, opt, flag in ((plain, o_plain, False),
                                 (remat, o_remat, True)):
            before = ops.launch_counts()
            loss = make_gat_train_step(model, opt, remat=flag)(x, y, mask)[0]
            counts.append({n: c - before[n] for n, c in
                           ops.launch_counts().items() if c != before[n]})
            counts.append(loss)
    assert counts[0] == {"gat_attention_fwd": 2, "gat_attention_bwd": 2,
                         "gat_mapping_fwd": 2, "gat_mapping_bwd": 2}
    assert counts[2] == {**counts[0], "gat_attention_fwd": 4,
                         "gat_mapping_fwd": 4}
    assert torch.equal(counts[1], counts[3])
    for a, b in zip(plain.parameters(), remat.parameters()):
        assert torch.equal(a.grad, b.grad) and torch.equal(a, b)


@pytest.mark.parametrize("family", ["k1", "k1+k2", "k3"])
def test_bf16_forward_with_the_kernels_matches_the_plain_twins(
        cuda_device, family):
    """The bf16 model with the kernels (which take float32 at their
    boundary) against the same bf16 model on the plain versions: the
    root-mean-square gap within 2x the plain bf16 forward's own gap to the
    plain float32 forward (the CPU tests' bound against JAX), and the
    kernels launched as often as in the float32 forward."""
    from extended_gan_torch import ops
    from extended_gan_torch.models.gat.gat3d import Model as GatModel

    hw = 20 if family == "k3" else 16

    def make(dtype, kernels):
        if family == "k3":
            return build_model("unet", image_width=hw, image_height=hw,
                               n_vertices=6, mapping_type="linear",
                               use_pallas=kernels, device=cuda_device,
                               generator=torch.Generator().manual_seed(0),
                               dtype=dtype)
        return GatModel(hw, hw, 6, attention_type="temporal",
                        mapping_type="conv", use_pallas=kernels,
                        use_pallas_mapping=kernels and family == "k1+k2",
                        generator=torch.Generator().manual_seed(0),
                        dtype=dtype).to(cuda_device).eval()

    x = torch.rand(4, hw, hw, 4, 6, device=cuda_device,
                   generator=torch.Generator(device=cuda_device).manual_seed(1))
    outs, launched = {}, {}
    with torch.no_grad(), torch.backends.cudnn.flags(
            enabled=True, allow_tf32=False, deterministic=True):
        for dtype in (torch.float32, torch.bfloat16):
            for kernels in (True, False):
                before = ops.launch_counts()
                outs[dtype, kernels] = make(dtype, kernels)(x).double()
                launched[dtype, kernels] = {
                    n: c - before[n] for n, c in ops.launch_counts().items()
                    if c != before[n]}
    bf16, f32 = torch.bfloat16, torch.float32
    assert all(v.dtype == torch.float64 and torch.isfinite(v).all()
               for v in outs.values())

    def rms(a, b):
        return float(((a - b) ** 2).mean().sqrt())
    own = rms(outs[bf16, False], outs[f32, False])
    assert 0 < rms(outs[bf16, True], outs[bf16, False]) <= 2 * own or \
        torch.equal(outs[bf16, True], outs[bf16, False])
    assert launched[bf16, True] == launched[f32, True] != {}
    assert launched[bf16, False] == launched[f32, False] == {}


def test_resume_in_process_with_k1_and_k2_in_a_graph(cuda_device, tmp_path,
                                                     monkeypatch):
    """The conv-GAT driver with K1 and K2 (``use_pallas_mapping=True``)
    under ``--megastep 2``: a preemption after epoch 2's first group, then
    a resume in the same process (Adam's state restored before the first
    capture), equals the uninterrupted run bit for bit (cuDNN
    deterministic), and the resumed run launches both kernels."""
    from extended_gan_torch import ops
    from extended_gan_torch.models.gat.gat3d import Model as GatModel
    from extended_gan_torch.train import gat_driver

    def switched(model_type, *, image_width, image_height, n_vertices,
                 mapping_type, time_steps, use_pallas, device, generator,
                 dtype, conv_impl, moe_experts=0):
        return GatModel(image_width, image_height, n_vertices, model_type,
                        mapping_type, time_steps, use_pallas=True,
                        generator=generator, use_pallas_mapping=True,
                        dtype=dtype, conv_impl=conv_impl).to(device).eval()

    class Counting:
        reads = 0

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        @property
        def requested(self):
            Counting.reads += 1
            return Counting.reads >= 6  # epoch 1: 4 groups + its tail

    monkeypatch.setattr(gat_driver, "build_model", switched)
    kw = dict(model_type="temporal", mapping_type="conv",
              train_batch_size=4, test_batch_size=8, epochs=2,
              max_batches=8, downsample_size=(16, 16), dataset="synthetic",
              seed=31, checkpoint_every=10, megastep=2)

    def latest(out):
        steps = sorted(int(f[5:-3]) for f in os.listdir(out)
                       if f.startswith("step_"))
        return steps[-1], torch.load(os.path.join(out, f"step_{steps[-1]}.pt"),
                                     weights_only=True)

    ref, run = str(tmp_path / "ref"), str(tmp_path / "run")
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False,
                                    deterministic=True):
        gat_driver.train(output_path=ref, **kw)
        with monkeypatch.context() as m:
            m.setattr(gat_driver, "GracefulShutdown", Counting)
            gat_driver.train(output_path=run, **kw)
        assert latest(os.path.join(run, "checkpoints"))[0] == 200_002
        before = ops.launch_counts()
        gat_driver.train(output_path=run, resume=True, **kw)
        launched = {n: c - before[n] for n, c in ops.launch_counts().items()}
    assert all(launched[n] > 0 for n in ("gat_attention_fwd",
                                         "gat_mapping_fwd",
                                         "gat_attention_bwd",
                                         "gat_mapping_bwd")), launched
    (s_ref, c_ref), (s_run, c_run) = (latest(os.path.join(d, "checkpoints"))
                                      for d in (ref, run))
    assert s_ref == s_run

    def flat(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree, key=str) for x in flat(tree[k])]
        if isinstance(tree, (list, tuple)):
            return [x for v in tree for x in flat(v)]
        return [tree]
    for a, b in zip(flat(c_ref), flat(c_run), strict=True):
        assert (torch.equal(a, b) if torch.is_tensor(a) else a == b)


def test_cyclegan_graph_equals_eager_steps(cuda_device):
    """The CycleGAN resident megastep (ndf 8, 64x64, B = 4, K = 2, dropout
    off, capturable Adam): three programs as CUDA graphs (the first eager,
    the second captured and replayed, the third replayed) against the same
    programs run eagerly on a twin from the same seed, bit for bit with
    cuDNN deterministic; no kernel of the port is launched."""
    from extended_gan_torch import ops
    from extended_gan_torch.data.resident import (
        ResidentVideos,
        make_cyclegan_resident_megastep,
    )
    from extended_gan_torch.train.cyclegan_driver import build_cyclegan

    rng = np.random.default_rng(0)
    store = ResidentVideos(rng.uniform(0, 1, (40, 64, 64)).astype(np.float32),
                           np.arange(33), 8, cuda_device)
    progs = store.epoch_programs(0, 2, 4)[:3]
    runs, before = [], ops.launch_counts()
    for graphs in (True, False):
        nets, opts = build_cyclegan(ndf=8, seed=0, device=cuda_device,
                                    dropout=0.0, capturable=True)
        mega = make_cyclegan_resident_megastep(*nets, *opts, store)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False,
                                        deterministic=True):
            logs = [(mega if graphs else mega.eager)(p) for p in progs]
        torch.cuda.synchronize()
        runs.append((_params(*nets), [v for g in logs for v in g.values()]))
        if graphs:
            assert (mega.captures, mega.replays) == (1, 2)
    assert ops.launch_counts() == before
    for a, b in zip(runs[0][0] + runs[0][1], runs[1][0] + runs[1][1],
                    strict=True):
        assert torch.equal(a, b)


def test_vanilla_fused_prop_equals_the_default_step(cuda_device):
    """The vanilla GAN's FusedProp step against its default step on the
    card at the published widths (latent 100, 28x28, b=64), exact f32, SGD,
    3 steps from one seed, z from one generator: losses within 1e-6
    relative, parameters and statistics within 2e-6 (JAX's
    ``tests/test_vanilla_fused_prop.py`` bounds)."""
    from extended_gan_torch.models.vanilla_gan import (
        MLPDiscriminator,
        MLPGenerator,
    )
    from extended_gan_torch.train.adversarial import make_vanilla_gan_step

    real = torch.rand(3, 64, 1, 28, 28, device=cuda_device,
                      generator=torch.Generator(cuda_device).manual_seed(1))
    runs = []
    for fused in (False, True):
        init = torch.Generator().manual_seed(0)
        g = MLPGenerator(generator=init).to(cuda_device)
        d = MLPDiscriminator(generator=init).to(cuda_device)
        opts = [torch.optim.SGD(n.parameters(), lr=1e-3) for n in (g, d)]
        step = make_vanilla_gan_step(
            g, d, *opts, latent_dim=100, fused_prop=fused,
            generator=torch.Generator(cuda_device).manual_seed(7))
        assert not torch.backends.cuda.matmul.allow_tf32  # exact f32
        losses = [step(r) for r in real]
        runs.append(([float(v) for lg in losses for v in lg.values()],
                     _params(g, d)))
    np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=1e-6, atol=1e-7)
    for a, b in zip(runs[0][1], runs[1][1], strict=True):
        np.testing.assert_allclose(b.cpu().numpy(), a.cpu().numpy(),
                                   atol=2e-6)
