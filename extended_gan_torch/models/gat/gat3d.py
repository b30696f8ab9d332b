"""GAT3D: spatiotemporal graph attention over video-frame grids.

Port of ``extended_gan_tpu/models/gat/gat3d.py`` (``_Mapping`` :111-190,
``GAT3DHead`` :193-264, ``GATMultiHead3D`` :267-323, ``Model`` :326-356).
Every public boundary keeps the JAX package's (B, H, W, T, V) layout.

The JAX package runs the heads of a multi-head block as one ``nn.vmap``
program with parameters stacked on a leading head axis. The port stores
them the same way (so a flax parameter tree converts leaf for leaf, see
``models/convert.py``) and runs them the same way: each conv of the mapping
is one grouped convolution over all heads, and the temporal attention is
one kernel launch over all heads (two launches per ``Model`` forward).

The conv mapping's convolutions are cuDNN's, as the JAX package leaves
them to XLA, unless ``use_pallas_mapping`` is on: then the whole
3x3 -> 1x1 -> 3x3 bottleneck of a block is one launch of the CUDA kernel of
``ops/gat_mapping.py`` (K2), under the JAX package's condition
``mapping_type == "conv" and use_pallas_mapping and h == w``. As in the JAX
package it is a constructor switch only: no registry, CLI or config passes
it. The fused attention is the CUDA kernel of ``ops/gat_attention.py`` when
``use_pallas`` is on (the names follow the JAX package's switches).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.gat_attention import attend_temporal
from ...ops.gat_mapping import fused_conv_bottleneck, reference_bottleneck
from .layers import (
    adjacency_b_init,
    lecun_normal_,
    normalized_adjacency,
    pairwise_scores,
    xavier_gain_1414,
)


class _StackedConv2d(nn.Module):
    """Parameters of ``nheads`` independent SAME convolutions: weight
    (NH, O, I, k, k) and bias (NH, O), flax's vmapped ``nn.Conv`` parameters
    with HWIO turned into torch's OIHW. ``_Mapping`` runs them."""

    def __init__(self, nheads, in_ch, out_ch, k, generator=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(nheads, out_ch, in_ch, k, k))
        self.bias = nn.Parameter(torch.zeros(nheads, out_ch))
        lecun_normal_(self.weight, in_ch * k * k, generator)


class _Mapping(nn.Module):
    """Per-node feature map on the T (frame-channel) axis, for ``nheads``
    heads at once: (B, H, W, T, V) -> (NH, B, H, W, T', V)."""

    def __init__(self, nfeat, nhid, mapping_type="linear", nheads=1,
                 conv_hidden=74, generator=None, use_pallas_mapping=False):
        super().__init__()
        self.mapping_type = mapping_type
        self.use_pallas_mapping = use_pallas_mapping
        if mapping_type == "linear":
            self.W = nn.Parameter(torch.empty(nheads, nfeat, nhid))
            self.b = nn.Parameter(torch.zeros(nheads, nhid))
            xavier_gain_1414(self.W, generator)
        elif mapping_type == "conv":
            # 3x3 -> 1x1 -> 3x3 bottleneck; width 74 pins the temporal/conv
            # Model to the reference's 43,936 parameters
            self.conv1 = _StackedConv2d(nheads, nfeat, conv_hidden, 3, generator)
            self.conv2 = _StackedConv2d(nheads, conv_hidden, conv_hidden, 1,
                                        generator)
            self.conv3 = _StackedConv2d(nheads, conv_hidden, nhid, 3, generator)
        elif mapping_type == "smaat_unet":
            raise NotImplementedError(
                "the smaat_unet mapping is not ported yet (ROADMAP queue 1 "
                "item 1, the rest of the conv-GAT family)")
        else:
            raise ValueError(f"unknown mapping_type {mapping_type!r}")

    def forward(self, x):
        if self.mapping_type == "linear":
            out = torch.einsum("bhwtv,nto->nbhwov", x, self.W)
            return out + self.b[:, None, None, None, :, None]
        params = (self.conv1.weight, self.conv1.bias, self.conv2.weight,
                  self.conv2.bias, self.conv3.weight, self.conv3.bias)
        if self.use_pallas_mapping and x.shape[1] == x.shape[2]:
            # one launch for every head, reading x in its own layout
            return fused_conv_bottleneck(x.contiguous(), *params)
        return reference_bottleneck(x, *params)


class GAT3DHead(nn.Module):
    """``nheads`` attention heads with stacked parameters: mapping -> graph
    attention over the chosen axis -> adjacency-normalised mixing -> ELU.
    (B, H, W, T, V) -> (NH, B, H, W, T', V)."""

    def __init__(self, nfeat, nhid, n_vertices, alpha=0.2, type_="temporal",
                 mapping_type="linear", use_pallas=False, nheads=1,
                 generator=None, use_pallas_mapping=False):
        super().__init__()
        if type_ not in ("temporal", "spatial", "multi_stream"):
            raise ValueError(f"unknown type_ {type_!r}")
        self.alpha = alpha
        self.type_ = type_
        self.use_pallas = use_pallas
        self.mapping = _Mapping(nfeat, nhid, mapping_type, nheads,
                                generator=generator,
                                use_pallas_mapping=use_pallas_mapping)
        axes = {"temporal": ["temporal"], "spatial": ["spatial"],
                "multi_stream": ["temporal", "spatial"]}[type_]
        # temporal graph: nodes T', features V; spatial: nodes V, features T'
        sizes = {"temporal": (nhid, n_vertices), "spatial": (n_vertices, nhid)}
        for axis in axes:
            nodes, feat = sizes[axis]
            a = nn.Parameter(torch.empty(nheads, 2 * feat, 1))
            xavier_gain_1414(a, generator)
            B = nn.Parameter(torch.empty(nheads, nodes, nodes))
            adjacency_b_init(B, generator)
            self.register_parameter(f"a_{axis}", a)
            self.register_parameter(f"B_{axis}", B)

    def _attend(self, mapped, axis):
        """mapped (NH, B, H, W, T', V); returns (out, elu_done)."""
        a = getattr(self, f"a_{axis}")[..., 0]  # (NH, 2 * feat)
        adj_norm = normalized_adjacency(getattr(self, f"B_{axis}"))
        if self.use_pallas and axis == "temporal" and self.type_ == "temporal":
            # the kernel fuses the trailing ELU
            return attend_temporal(mapped, a, adj_norm, self.alpha), True
        f = mapped.mean(dim=(2, 3))  # (NH, B, T', V)
        if axis == "spatial":
            f = f.transpose(-1, -2)  # (NH, B, V, T')
        e = pairwise_scores(f, a[:, None, :], self.alpha)  # (NH, B, m, m)
        attention = adj_norm[:, None] @ torch.softmax(e, dim=-1)
        if axis == "temporal":
            return torch.einsum("nbts,nbhwsv->nbhwtv", attention, mapped), False
        return torch.einsum("nbvu,nbhwtu->nbhwtv", attention, mapped), False

    def forward(self, x):
        mapped = self.mapping(x)
        if self.type_ == "multi_stream":
            # ELU applies to the averaged streams: no fused-ELU kernel here
            t_out, _ = self._attend(mapped, "temporal")
            s_out, _ = self._attend(mapped, "spatial")
            out, elu_done = 0.5 * (t_out + s_out), False
        else:
            out, elu_done = self._attend(mapped, self.type_)
        return out if elu_done else F.elu(out)


class GATMultiHead3D(nn.Module):
    """Head-averaged GAT3D block: (B, H, W, T, V) -> (B, H, W, T', V)."""

    def __init__(self, nfeat, nhid, n_vertices, alpha=0.2, nheads=1,
                 type_="temporal", mapping_type="linear", use_pallas=False,
                 generator=None, use_pallas_mapping=False):
        super().__init__()
        self.heads = GAT3DHead(nfeat, nhid, n_vertices, alpha, type_,
                               mapping_type, use_pallas, nheads, generator,
                               use_pallas_mapping=use_pallas_mapping)

    def forward(self, x):
        return self.heads(x).mean(dim=0)


class Model(nn.Module):
    """GAT3D.GATMultistream.Model reconstruction: 3-head hidden block ->
    1-head output block -> sigmoid (rain intensities live in [0, 1])."""

    def __init__(self, image_width, image_height, n_vertices,
                 attention_type="temporal", mapping_type="linear",
                 time_steps=4, use_pallas=False, generator=None,
                 use_pallas_mapping=False):
        super().__init__()
        self.image_width, self.image_height = image_width, image_height
        self.mapping_type = mapping_type
        common = dict(nfeat=time_steps, nhid=time_steps, n_vertices=n_vertices,
                      alpha=0.2, type_=attention_type,
                      mapping_type=mapping_type, use_pallas=use_pallas,
                      generator=generator,
                      use_pallas_mapping=use_pallas_mapping)
        self.hidden_layer = GATMultiHead3D(nheads=3, **common)
        self.output_layer = GATMultiHead3D(nheads=1, **common)

    def forward(self, x):
        return torch.sigmoid(self.output_layer(self.hidden_layer(x)))
