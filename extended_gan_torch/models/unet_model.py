"""Per-vertex SmaAt-UNet frame predictor.

Port of ``extended_gan_tpu/models/unet_model.py``: one shared
``SmaAt_UNet(n_channels=T, n_classes=T)`` applied to every vertex's
T-as-channels frame stack. As in the JAX package (``per_vertex_bn=False``,
its default), the vertex axis folds into the batch and the UNet runs once
on B*V images, so BatchNorm statistics pool over B*V samples.
"""

from __future__ import annotations

from torch import nn

from .smaat_unet import SmaAt_UNet


class UnetModel(nn.Module):
    """(B, H, W, T, V) -> (B, H, W, T, V)."""

    def __init__(self, image_width, image_height, n_vertices,
                 mapping_type="conv", time_steps=4, kernels_per_layer=2,
                 per_vertex_bn=False, use_pallas=False, moe_experts=0,
                 generator=None):
        super().__init__()
        if per_vertex_bn:
            raise NotImplementedError(
                "per_vertex_bn=True (per-vertex BatchNorm statistics) is not "
                "ported yet (ROADMAP: queue 1, SmaAt-UNet and UnetModel)")
        self.image_width, self.image_height = image_width, image_height
        self.mapping_type = mapping_type  # accepted for registry parity
        self.unet = SmaAt_UNet(n_channels=time_steps, n_classes=time_steps,
                               kernels_per_layer=kernels_per_layer,
                               use_pallas=use_pallas, moe_experts=moe_experts,
                               generator=generator)

    def forward(self, x):
        b, h, w, t, v = x.shape
        # (B, H, W, T, V) -> (B*V, H, W, T), seen as NCHW (channels last)
        xb = x.permute(0, 4, 1, 2, 3).reshape(b * v, h, w, t)
        y = self.unet(xb.permute(0, 3, 1, 2))  # (B*V, T, H, W)
        return y.permute(0, 2, 3, 1).reshape(b, v, h, w, t).permute(
            0, 2, 3, 4, 1)
