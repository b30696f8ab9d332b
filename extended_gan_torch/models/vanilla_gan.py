"""Vanilla MLP GAN, MNIST-scale (port of
``extended_gan_tpu/models/vanilla_gan.py``).

- :class:`MLPGenerator`: latent z (100) -> dense 128, 256, 512, 1024, each
  but the first followed by BatchNorm1d, LeakyReLU 0.2 after each -> a
  dense layer to C*H*W and tanh -> (B, C, H, W) in [-1, 1];
- :class:`MLPDiscriminator`: the flattened image -> dense 512, 256 with
  LeakyReLU 0.2 -> one logit -> sigmoid, (B, 1).

As in the reference, whose ``BatchNorm1d(out_feat, 0.8)`` sets ``eps`` by
position, the generator's BatchNorm has eps = 0.8 (and torch's momentum
0.1, flax's 0.9). Submodules carry the flax tree's names (``Dense_{i}``,
``BatchNorm_{i}``), so ``models/convert.py``'s ``from_flax_params``
carries weights across. The weights are drawn as torch's ``nn.Linear``
draws them, U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for the weight and the
bias (the distributions JAX's ``torch_kernel_init`` copies), from
``generator`` when one is given.

``dtype`` is the precision policy (``core/precision.py``): with
``torch.bfloat16`` each dense layer takes its input and weights in
bfloat16; BatchNorm takes float32 and stays float32, and the tanh and
sigmoid heads run in float32, as in JAX. Parameters stay float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..core.precision import cast_to, to_float32


def _dense(fan_in, width, generator):
    layer = nn.Linear(fan_in, width)
    if generator is not None:
        bound = 1.0 / math.sqrt(fan_in)
        with torch.no_grad():
            layer.weight.uniform_(-bound, bound, generator=generator)
            layer.bias.uniform_(-bound, bound, generator=generator)
    return layer


def _dense_in(layer, x, dtype):
    """``layer(x)`` with the input and the weights in ``dtype``."""
    return F.linear(cast_to(x, dtype), cast_to(layer.weight, dtype),
                    cast_to(layer.bias, dtype))


class MLPGenerator(nn.Module):
    def __init__(self, img_shape=(1, 28, 28), latent_dim=100,
                 widths=(128, 256, 512, 1024), bn_eps=0.8, *,
                 generator=None, dtype=torch.float32):
        super().__init__()
        self.img_shape = tuple(img_shape)
        self.n_blocks = len(widths)
        self.dtype = dtype
        fan_in = latent_dim
        for i, width in enumerate(widths):
            self.add_module(f"Dense_{i}", _dense(fan_in, width, generator))
            if i > 0:  # the first block is not normalised
                self.add_module(f"BatchNorm_{i - 1}",
                                nn.BatchNorm1d(width, eps=bn_eps,
                                               momentum=0.1))
            fan_in = width
        self.add_module(f"Dense_{len(widths)}",
                        _dense(fan_in, math.prod(self.img_shape), generator))

    def forward(self, z):
        x = z
        for i in range(self.n_blocks):
            x = _dense_in(getattr(self, f"Dense_{i}"), x, self.dtype)
            if i > 0:
                x = getattr(self, f"BatchNorm_{i - 1}")(to_float32(x))
            x = F.leaky_relu(x, 0.2)
        x = _dense_in(getattr(self, f"Dense_{self.n_blocks}"), x, self.dtype)
        x = torch.tanh(to_float32(x))
        return x.reshape(x.shape[0], *self.img_shape)


class MLPDiscriminator(nn.Module):
    def __init__(self, img_shape=(1, 28, 28), widths=(512, 256), *,
                 generator=None, dtype=torch.float32):
        super().__init__()
        self.n_blocks = len(widths)
        self.dtype = dtype
        fan_in = math.prod(img_shape)
        for i, width in enumerate(widths):
            self.add_module(f"Dense_{i}", _dense(fan_in, width, generator))
            fan_in = width
        self.add_module(f"Dense_{len(widths)}", _dense(fan_in, 1, generator))

    def forward(self, img):
        x = img.reshape(img.shape[0], -1)
        for i in range(self.n_blocks):
            x = F.leaky_relu(_dense_in(getattr(self, f"Dense_{i}"), x,
                                       self.dtype), 0.2)
        x = _dense_in(getattr(self, f"Dense_{self.n_blocks}"), x, self.dtype)
        return torch.sigmoid(to_float32(x))
