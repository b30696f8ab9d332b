"""DCGAN-style frame-prediction GAN (port of ``extended_gan_tpu/models/dcgan.py``).

- :class:`ConvBlock`: conv, BatchNorm if enabled, channel dropout, then the
  activation;
- :class:`Generator`: five stride-1 "same" 4x4 blocks, widths 8nc, 4nc,
  2nc, nc, nc, with a sigmoid head; the context frames are the channels,
  and there is no latent z;
- :class:`TemporalDiscriminator`: stride-2 blocks on cat(x, y), LeakyReLU
  0.2, then a stride-4 one-logit sigmoid block;
- :class:`FrameDiscriminator`: the classic DCGAN discriminator on y alone.

Tensors are (B, C, H, W) with C the frame count (nc = 4). Submodules carry
the flax tree's names (``ConvBlock_{i}.Conv_0``, ``ConvBlock_{i}.BatchNorm_0``;
the FrameDiscriminator's ``Conv_0..4`` and ``BatchNorm_0..2``), so
``models/convert.py``'s ``from_flax_params`` carries weights across.

Initialisation and BatchNorm are torch's own: the JAX package emulates
torch's default conv init (``extended_gan_tpu/ops/initializers.py``) and
``torch.nn.BatchNorm2d`` with its unbiased running variance, flax momentum
0.9 being torch's 0.1 (``extended_gan_tpu/ops/norm.py``). With a
``generator`` the weights are drawn from it, from the same distributions.

``dtype`` is the precision policy (``core/precision.py``), as the JAX
modules' ``dtype`` (``dcgan.py:135-164``): with ``torch.bfloat16`` every
convolution takes its input and weights in bfloat16 and writes bfloat16,
BatchNorm takes float32 and stays float32 (``:160-164``), and the nets'
outputs are float32. Parameters stay float32.

Channel dropout (the reference's 0.01) zeroes whole channels of a sample,
as ``torch.nn.Dropout2d`` does, drawing from ``dropout_generator`` when one
is given. The JAX package's ``packed`` generator (2x2 space-to-depth) is
not ported.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..core.precision import cast_to, to_float32


def _leaky_relu_02(x):
    return F.leaky_relu(x, 0.2)


ACTIVATIONS = {
    "relu": F.relu,
    "leaky_relu": _leaky_relu_02,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "elu": F.elu,
    "identity": lambda x: x,
}


def _conv_in(conv, x, dtype):
    """``conv(x)`` with the input and the weights in ``dtype``."""
    bias = cast_to(conv.bias, dtype) if conv.bias is not None else None
    return F.conv2d(cast_to(x, dtype), cast_to(conv.weight, dtype), bias,
                    conv.stride, conv.padding)


def _conv(chin, chout, k, stride, padding, bias, generator):
    conv = nn.Conv2d(chin, chout, k, stride=stride, padding=padding,
                     bias=bias)
    if generator is not None:
        # torch's default: kaiming_uniform(a=sqrt(5)) is U(-1/sqrt(fan_in),
        # 1/sqrt(fan_in)), the bias too
        bound = 1.0 / math.sqrt(chin * k * k)
        with torch.no_grad():
            conv.weight.uniform_(-bound, bound, generator=generator)
            if bias:
                conv.bias.uniform_(-bound, bound, generator=generator)
    return conv


class ConvBlock(nn.Module):
    """Conv2d -> BatchNorm2d? -> channel dropout -> activation.
    ``padding`` is "same" or a symmetric int."""

    def __init__(self, chin, chout, kernel_size=4, stride=1, padding=0,
                 use_bias=True, dropout=0.01, act="relu", batchnorm=True, *,
                 generator=None, dropout_generator=None, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        # "same" pads (k - 1) // 2 before and k // 2 after, as XLA does: 1
        # and 2 for the 4x4 kernels (torch's own "same" pads so too, through
        # the same copy, with a warning)
        self.same = ((kernel_size - 1) // 2, kernel_size // 2) \
            if padding == "same" else None
        self.Conv_0 = _conv(chin, chout, kernel_size, stride,
                            0 if self.same else padding, use_bias, generator)
        self.BatchNorm_0 = nn.BatchNorm2d(chout) if batchnorm else None
        self.dropout = dropout
        self.act = ACTIVATIONS[act]
        self.dropout_generator = dropout_generator

    def forward(self, x):
        if self.same:
            x = F.pad(x, self.same * 2)
        x = _conv_in(self.Conv_0, x, self.dtype)
        if self.BatchNorm_0 is not None:
            x = self.BatchNorm_0(to_float32(x))
        if self.dropout > 0 and self.training:
            keep = 1.0 - self.dropout
            draw = torch.rand(x.shape[:2] + (1, 1), device=x.device,
                              generator=self.dropout_generator)
            x = x * (draw < keep).to(x.dtype) / keep
        return self.act(x)


class Generator(nn.Module):
    """nc context frames (as channels) -> nc predicted frames in [0, 1].
    ``dropout`` reaches every block; 0 turns it off."""

    def __init__(self, nc=4, dropout=0.01, *, generator=None,
                 dropout_generator=None, dtype=torch.float32):
        super().__init__()
        widths = (nc, nc * 8, nc * 4, nc * 2, nc, nc)
        for i in range(5):
            last = i == 4
            self.add_module(f"ConvBlock_{i}", ConvBlock(
                widths[i], widths[i + 1], 4, padding="same",
                act="sigmoid" if last else "relu", batchnorm=not last,
                dropout=dropout, generator=generator,
                dropout_generator=dropout_generator, dtype=dtype))

    def forward(self, x):
        for block in self.children():
            x = block(x)
        return to_float32(x)


class TemporalDiscriminator(nn.Module):
    """Judges the joint (context, continuation) clip: cat(x, y) with 2nc
    channels -> one probability a sample, shape (B,)."""

    def __init__(self, nc=4, ndf=64, dropout=0.01, *, generator=None,
                 dropout_generator=None, dtype=torch.float32):
        super().__init__()
        kw = dict(use_bias=False, act="leaky_relu", dropout=dropout,
                  generator=generator, dropout_generator=dropout_generator,
                  dtype=dtype)
        widths = (2 * nc, ndf, 2 * ndf, 4 * ndf, 8 * ndf)
        for i in range(4):
            self.add_module(f"ConvBlock_{i}", ConvBlock(
                widths[i], widths[i + 1], 4, stride=2, padding=1,
                batchnorm=i > 0, **kw))
        self.ConvBlock_4 = ConvBlock(8 * ndf, 1, 4, stride=4, padding=0,
                                     batchnorm=False,
                                     **{**kw, "act": "sigmoid"})

    def forward(self, xy):
        for block in self.children():
            xy = block(xy)
        # keep the batch axis at B = 1 (the reference's bare squeeze drops it)
        return to_float32(xy).reshape(xy.shape[0])


class FrameDiscriminator(nn.Module):
    """The classic DCGAN discriminator on the predicted frames alone -> one
    probability a sample, shape (B,)."""

    def __init__(self, nc=4, ndf=64, *, generator=None, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        widths = (nc, ndf, 2 * ndf, 4 * ndf, 8 * ndf)
        for i in range(4):
            self.add_module(f"Conv_{i}", _conv(widths[i], widths[i + 1], 4, 2,
                                               1, False, generator))
        self.Conv_4 = _conv(8 * ndf, 1, 4, 1, 0, False, generator)
        for i in range(3):
            self.add_module(f"BatchNorm_{i}", nn.BatchNorm2d(widths[i + 2]))

    def forward(self, y):
        dt = self.dtype
        x = _leaky_relu_02(_conv_in(self.Conv_0, y, dt))
        for i in range(3):  # BatchNorm in float32
            conv = getattr(self, f"Conv_{i + 1}")
            x = _leaky_relu_02(getattr(self, f"BatchNorm_{i}")(
                to_float32(_conv_in(conv, x, dt))))
        x = torch.sigmoid(to_float32(_conv_in(self.Conv_4, x, dt)))
        return x.reshape(x.shape[0])
