"""Per-vertex SmaAt-UNet frame predictor.

Port of ``extended_gan_tpu/models/unet_model.py``: one shared
``SmaAt_UNet(n_channels=T, n_classes=T)`` applied to every vertex's
T-as-channels frame stack. The vertex axis folds into the batch and the
UNet runs once on B*V images (b-major: image b*V + v), so every
depthwise-separable conv is one K3 launch for all vertices (18 a forward).

- ``per_vertex_bn=False`` (JAX's default): BatchNorm statistics pool over
  the B*V images; the module is ``unet``, as the flax tree's.
- ``per_vertex_bn=True`` (JAX ``:49-56``, ``:72-89``): the reference's
  per-vertex BatchNorm. JAX vmaps the shared UNet over the vertices with
  per-vertex ``batch_stats``; the port keeps the single B*V pass and makes
  each BatchNorm a :class:`PerVertexBatchNorm2d`, whose running statistics
  are (V, C), as the flax tree's. The module is ``shared.unet``, as the
  flax tree's, and the (C,) affine parameters are shared by all vertices.

``moe_experts`` > 0 gives the UNet its Switch-MoE bottleneck
(``models/moe.py``) on both paths, and this module sets its routing groups
(``SwitchMoE.group``) from the b-major layout: the whole B*V batch as one
group by default (JAX's ``UnetModel``); under ``per_vertex_bn`` each
vertex's B rows (every V-th row) as a group of its own, as JAX's vmapped
UNet routes them, and the trainer sums the groups' losses as JAX sums the
V sown values. :meth:`UnetModel.route_per_sample` (serving) routes each
sample's V rows apart (each row alone under ``per_vertex_bn``), so every
answer is the JAX batch-1 artifact's (``scripts/export_model.py:43-49``),
whatever else shares the batch.
"""

from __future__ import annotations

import torch
from torch import nn

from ..parallel.batch_norm import batch_norm
from .moe import moe_layers
from .smaat_unet import SmaAt_UNet


class PerVertexBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d(C) with statistics kept per vertex: on a b-major (B*V,
    C, H, W) batch it normalises the view (B, V*C, H, W), which reduces each
    (vertex, channel) over (B, H, W), with the (V, C) running statistics
    and the (C,) weight and bias repeated over the vertices. Momentum and
    ``num_batches_tracked`` behave as BatchNorm2d's (so
    ``train/state.py::running_stats_frozen`` freezes it too)."""

    axis = None  # a data axis: statistics over its global batch

    def __init__(self, num_features, n_vertices, eps=1e-5, momentum=0.1):
        super().__init__(num_features, eps=eps, momentum=momentum)
        self.n_vertices = n_vertices
        self.running_mean = torch.zeros(n_vertices, num_features)
        self.running_var = torch.ones(n_vertices, num_features)

    def forward(self, x):
        n, c, h, w = x.shape
        v = self.n_vertices
        if self.training and self.num_batches_tracked is not None:
            self.num_batches_tracked.add_(1)
        y = batch_norm(x.reshape(n // v, v * c, h, w),
                       self.running_mean.view(-1), self.running_var.view(-1),
                       self.weight.repeat(v), self.bias.repeat(v),
                       self.training, self.momentum, self.eps, self.axis)
        return y.reshape(n, c, h, w)


def _per_vertex(module: nn.Module, n_vertices: int):
    """Every BatchNorm2d under ``module`` -> a PerVertexBatchNorm2d of its
    width, eps and momentum."""
    for name, child in module.named_children():
        if isinstance(child, nn.BatchNorm2d):
            setattr(module, name, PerVertexBatchNorm2d(
                child.num_features, n_vertices, child.eps, child.momentum))
        else:
            _per_vertex(child, n_vertices)


class UnetModel(nn.Module):
    """(B, H, W, T, V) -> (B, H, W, T, V)."""

    def __init__(self, image_width, image_height, n_vertices,
                 mapping_type="conv", time_steps=4, kernels_per_layer=2,
                 per_vertex_bn=False, use_pallas=False, moe_experts=0,
                 generator=None, dtype=torch.float32):
        super().__init__()
        self.image_width, self.image_height = image_width, image_height
        self.mapping_type = mapping_type  # accepted for registry parity
        unet = SmaAt_UNet(n_channels=time_steps, n_classes=time_steps,
                          kernels_per_layer=kernels_per_layer,
                          use_pallas=use_pallas, moe_experts=moe_experts,
                          generator=generator, dtype=dtype)
        self.n_vertices, self.per_vertex_bn = n_vertices, per_vertex_bn
        if per_vertex_bn:
            _per_vertex(unet, n_vertices)
            self.shared = nn.ModuleDict({"unet": unet})
        else:
            self.unet = unet
        self.route_per_sample(False)

    def route_per_sample(self, on: bool = True) -> "UnetModel":
        """Route the MoE's tokens of each sample apart (``on``) or as the
        trainer does (the batch, or each vertex under ``per_vertex_bn``);
        returns the model."""
        stride = self.n_vertices if self.per_vertex_bn else 1
        for moe in moe_layers(self):
            moe.group = (stride, self.n_vertices // stride if on else 0)
        return self

    def forward(self, x):
        b, h, w, t, v = x.shape
        unet = self.shared["unet"] if self.per_vertex_bn else self.unet
        # (B, H, W, T, V) -> (B*V, H, W, T), seen as NCHW (channels last)
        xb = x.permute(0, 4, 1, 2, 3).reshape(b * v, h, w, t)
        y = unet(xb.permute(0, 3, 1, 2))  # (B*V, T, H, W)
        return y.permute(0, 2, 3, 1).reshape(b, v, h, w, t).permute(
            0, 2, 3, 4, 1)
