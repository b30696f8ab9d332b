"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here is marked ``cuda`` and skips without a card: a CUDA kernel
has no CPU mode. The file imports nothing of JAX, so it also runs where
JAX is not installed (the repository's conftest.py imports JAX, hence
``--noconftest``):

  python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from extended_gan_torch.models.gat.layers import normalized_adjacency
from extended_gan_torch.models.registry import build_model
from extended_gan_torch.ops import dsconv as k3
from extended_gan_torch.ops import gat_attention as k1

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("nh,b,mm,hw", [
    (1, 1, 4, 400), (3, 8, 4, 400), (3, 2, 4, 6400),
    (1, 3, 4, 25),  # group_size % 4 != 0: the scalar path
    (2, 2, 3, 64), (1, 2, 8, 16),
])
def test_kernel_matches_plain(cuda_device, nh, b, mm, hw):
    rng = np.random.default_rng(20 + nh * b + mm)
    g = 6
    m = torch.from_numpy(rng.standard_normal((nh, b, mm, g * hw),
                                             dtype=np.float32)).to(cuda_device)
    a = torch.from_numpy(rng.standard_normal((nh, 2 * g),
                                             dtype=np.float32)).to(cuda_device)
    adj = normalized_adjacency(torch.from_numpy(
        rng.random((nh, mm, mm), dtype=np.float32)).to(cuda_device))
    before = k1.launch_count
    with torch.no_grad():
        got = k1.fused_gat_attention(m, a, adj, 0.2, hw)
    assert k1.launch_count == before + 1
    w1 = a[:, :g].repeat_interleave(hw, 1)[:, None, None, :]
    w2 = a[:, g:].repeat_interleave(hw, 1)[:, None, None, :]
    want = k1.reference_impl(m, w1, w2, adj[:, None], 0.2, hw)
    torch.cuda.synchronize()
    for name, g_, w_ in zip(("out", "att0", "att", "pos"), got, want):
        torch.testing.assert_close(g_, w_, rtol=1e-5, atol=1e-5, msg=name)


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
        else:
            w1 = inputs[1][:, :g].repeat_interleave(hw, 1)[:, None, None, :]
            w2 = inputs[1][:, g:].repeat_interleave(hw, 1)[:, None, None, :]
            out = k1.reference_impl(inputs[0], w1, w2, inputs[2][:, None],
                                    0.2, hw)[0]
        grads.append(torch.autograd.grad((out * cot).sum(), inputs))
    torch.cuda.synchronize()
    for name, g_, w_ in zip(("m", "a", "adj_norm"), *grads):
        # sums over up to B * P = 9,600 products per entry
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


def test_k3_gradient_launches_nothing_and_matches_plain(cuda_device):
    args = _k3_inputs(K3_SHAPES[0], cuda_device, 3)
    cot = torch.randn(4, 20, 20, 64, device=cuda_device)
    grads = []
    for fused in (True, False):
        inputs = [t.clone().requires_grad_() for t in args]
        fn = k3.fused_dsconv if fused else k3.reference_dsc
        out = fn(*inputs)
        before = k3.launch_count
        grads.append(torch.autograd.grad((out * cot).sum(), inputs))
        assert k3.launch_count == before  # the backward is plain torch
    for name, g_, w_ in zip(("x", "dw", "dwb", "pw", "pwb"), *grads):
        torch.testing.assert_close(g_, w_, rtol=1e-4,
                                   atol=1e-4 * w_.abs().max().item(),
                                   msg=name)


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
