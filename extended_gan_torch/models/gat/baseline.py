"""Baseline GAT frame predictors (port of ``models/gat/baseline.py``).

- :class:`BaselineModel` flattens H*W*T per vertex, runs two one-head GAT
  layers and a tanh. As in the reference, the (B, V, F) output is reshaped
  straight to (B, H, W, T, V), row-major, which interleaves the vertex axis
  through the spatial and temporal axes; the published numbers depend on
  it.
- :class:`BaselineModel2D` flattens H*W only and runs two one-head 2-D GAT
  layers.

Both take ``mapping_type`` for the registry's sake and ignore it.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import GATMultiHead, GATMultiHead2D


class BaselineModel(nn.Module):
    """(B, H, W, T, V) -> (B, H, W, T, V)."""

    def __init__(self, image_width, image_height, n_vertices, time_steps=4,
                 mapping_type="linear", generator=None,
                 dtype=torch.float32):
        super().__init__()
        self.image_width, self.image_height = image_width, image_height
        self.mapping_type = mapping_type
        f = time_steps * image_height * image_width
        self.hidden_layer = GATMultiHead(f, f, n_vertices, 0.2, 1, generator,
                                         dtype)
        self.output_layer = GATMultiHead(f, f, n_vertices, 0.2, 1, generator,
                                         dtype)

    def forward(self, x):
        b, h, w, t, v = x.shape
        x = x.reshape(b, h * w * t, v).transpose(1, 2)  # (B, V, F)
        x = self.output_layer(self.hidden_layer(x))
        # the reference's raw view (B, V, F) -> (B, H, W, T, V)
        return torch.tanh(x.reshape(b, h, w, t, v))


class BaselineModel2D(nn.Module):
    """(B, H, W, T, V) -> (B, H, W, T, V)."""

    def __init__(self, image_width, image_height, n_vertices, time_steps=4,
                 mapping_type="linear", generator=None,
                 dtype=torch.float32):
        super().__init__()
        self.image_width, self.image_height = image_width, image_height
        self.mapping_type = mapping_type
        t = time_steps
        self.hidden_layer = GATMultiHead2D(t, t, n_vertices, 0.2, 1,
                                           generator, dtype)
        self.output_layer = GATMultiHead2D(t, t, n_vertices, 0.2, 1,
                                           generator, dtype)

    def forward(self, x):
        b, h, w, t, v = x.shape
        x = x.reshape(b, h * w, t, v)  # (N, C=H*W, T, V)
        x = self.output_layer(self.hidden_layer(x))  # (N, C, T, V)
        return torch.tanh(x.reshape(b, h, w, t, v))
