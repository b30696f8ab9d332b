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
    with pytest.raises(NotImplementedError, match="backward"):
        k1.fused_gat_attention(m.requires_grad_(), a, adj, 0.2, 4)


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
