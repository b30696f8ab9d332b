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
is given. Under a data axis (``parallel.attach_data_axis`` gives each
``ConvBlock`` its ``axis``) a block draws the masks of the whole global
batch and keeps this rank's rows (``DataAxis.draw_rows``): the ranks
together apply the masks one process applies, as JAX's one key over the
sharded batch does.

``Generator(packed=True)`` computes the same function in the 2x2
space-to-depth layout (``ops/space_to_depth.py``; JAX ``dcgan.py:175-253``):
its five stride-1 4x4 convs become 3x3 convs at half resolution with 4x
the channels. Its ``state_dict`` is the unpacked generator's, name for name
and shape for shape (the 4x4 kernels, the (C,) BatchNorm tensors), so
checkpoints, ``models/convert.py`` and ``serve/quantize.py`` take either;
its BatchNorm (:class:`_PackedBN`) is a ``BatchNorm2d``, so
``train/state.py::batchnorms`` finds it, and its dropout draws the
unpacked block's (B, C, 1, 1) mask from the same generator.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..core.precision import cast_to, to_float32
from ..parallel.batch_norm import BatchNorm2d
from ..ops.space_to_depth import (
    pack2,
    pack_conv_weights,
    packed_conv_same,
    unpack2,
)


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


class _PackedBN(BatchNorm2d):
    """BatchNorm2d(C) of a packed (B, 4C, H/2, W/2) map: it normalises the
    free view (4B, C, H/2, W/2), whose (batch, H/2, W/2) reduction is the
    (batch, phase, H/2, W/2) set of JAX's ``_PackedBN`` (``dcgan.py:69-108``)
    and the unpacked map's (batch, H, W): the same statistics, the same
    unbiased count, (C,) tensors. It is the data axis's
    ``parallel.BatchNorm2d`` (``nn.BatchNorm2d``'s forward without an
    axis), so under a data axis its statistics run over the global
    batch."""

    def forward(self, xp):
        b, c4, h, w = xp.shape
        return super().forward(xp.reshape(4 * b, c4 // 4, h, w)).reshape(
            b, c4, h, w)


class ConvBlock(nn.Module):
    """Conv2d -> BatchNorm2d? -> channel dropout -> activation.
    ``padding`` is "same" or a symmetric int. ``packed=True`` (the
    stride-1 "same" 4x4 block only) takes and returns the 2x2-packed map
    (``ops/space_to_depth.py``) and computes the same function."""

    axis = None  # a data axis: dropout masks drawn over its global batch

    def __init__(self, chin, chout, kernel_size=4, stride=1, padding=0,
                 use_bias=True, dropout=0.01, act="relu", batchnorm=True, *,
                 generator=None, dropout_generator=None, dtype=torch.float32,
                 packed=False):
        super().__init__()
        if packed and (kernel_size, stride, padding) != (4, 1, "same"):
            raise ValueError("a packed ConvBlock is a stride-1 'same' 4x4 "
                             "block")
        self.packed = packed
        self.dtype = dtype
        # "same" pads (k - 1) // 2 before and k // 2 after, as XLA does: 1
        # and 2 for the 4x4 kernels (torch's own "same" pads so too, through
        # the same copy, with a warning)
        self.same = ((kernel_size - 1) // 2, kernel_size // 2) \
            if padding == "same" else None
        self.Conv_0 = _conv(chin, chout, kernel_size, stride,
                            0 if self.same else padding, use_bias, generator)
        self.BatchNorm_0 = ((_PackedBN if packed else nn.BatchNorm2d)(chout)
                            if batchnorm else None)
        self.dropout = dropout
        self.act = ACTIVATIONS[act]
        self.dropout_generator = dropout_generator

    def _packed_conv(self, xp):
        """The 4x4 conv on a packed map: its weights packed in their own
        dtype, then cast, as JAX casts ``wp`` (``dcgan.py:184``)."""
        conv, dt = self.Conv_0, self.dtype
        bias = (cast_to(conv.bias, dt).repeat(4) if conv.bias is not None
                else None)
        return packed_conv_same(cast_to(xp, dt),
                                cast_to(pack_conv_weights(conv.weight), dt),
                                bias)

    def forward(self, x):
        if self.packed:
            x = self._packed_conv(x)
        else:
            if self.same:
                x = F.pad(x, self.same * 2)
            x = _conv_in(self.Conv_0, x, self.dtype)
        if self.BatchNorm_0 is not None:
            x = self.BatchNorm_0(to_float32(x))
        if self.dropout > 0 and self.training:
            keep = 1.0 - self.dropout
            # the unpacked block's (B, C, 1, 1) draw, tiled over the four
            # phases of a packed map
            c = x.shape[1] // 4 if self.packed else x.shape[1]

            def rand(n):
                return torch.rand((n, c, 1, 1), device=x.device,
                                  generator=self.dropout_generator)

            draw = None if self.axis is None else self.axis.draw_rows(rand)
            if draw is None:
                draw = rand(x.shape[0])
            mask = (draw < keep).to(x.dtype)
            x = x * (mask.repeat(1, 4, 1, 1) if self.packed else mask) / keep
        return self.act(x)


class Generator(nn.Module):
    """nc context frames (as channels) -> nc predicted frames in [0, 1].
    ``dropout`` reaches every block; 0 turns it off. ``packed=True``: the
    same function in the 2x2 space-to-depth layout (H, W even)."""

    def __init__(self, nc=4, dropout=0.01, *, generator=None,
                 dropout_generator=None, dtype=torch.float32, packed=False):
        super().__init__()
        self.packed = packed
        widths = (nc, nc * 8, nc * 4, nc * 2, nc, nc)
        for i in range(5):
            last = i == 4
            self.add_module(f"ConvBlock_{i}", ConvBlock(
                widths[i], widths[i + 1], 4, padding="same",
                act="sigmoid" if last else "relu", batchnorm=not last,
                dropout=dropout, generator=generator,
                dropout_generator=dropout_generator, dtype=dtype,
                packed=packed))

    def forward(self, x):
        if self.packed:
            x = pack2(x)
        for block in self.children():
            x = block(x)
        if self.packed:
            x = unpack2(x)
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
