"""Thin models stacking GAT3D blocks (port of ``models/gat/wrappers.py``).

Each wrapper is one or two :class:`~.gat3d.GATMultiHead3D` blocks, named
``hidden_layer`` and ``output_layer`` as in the flax tree, with no sigmoid
after them. As in the JAX package they take no ``use_pallas``: the
registry notes that it is ignored, and the temporal attention runs its
plain version, on the card too.
"""

from __future__ import annotations

from torch import nn

from .gat3d import GATMultiHead3D


class _StackedGAT(nn.Module):
    """(B, H, W, T, V) -> (B, H, W, T, V) through one block a head count."""

    def __init__(self, image_width, image_height, n_vertices, time_steps=4,
                 mapping_type="linear", attention_type="temporal",
                 heads=(3,), generator=None):
        super().__init__()
        self.image_width, self.image_height = image_width, image_height
        self.mapping_type = mapping_type
        for i, nheads in enumerate(heads):
            block = GATMultiHead3D(
                time_steps, time_steps, n_vertices, alpha=0.2, nheads=nheads,
                type_=attention_type, mapping_type=mapping_type,
                generator=generator)
            self.add_module("hidden_layer" if i == 0 else "output_layer",
                            block)

    def forward(self, x):
        for block in self.children():
            x = block(x)
        return x


def _wrapper(attention_type, heads, doc):
    def make(image_width, image_height, n_vertices, time_steps=4,
             mapping_type="linear", generator=None):
        return _StackedGAT(image_width, image_height, n_vertices, time_steps,
                           mapping_type, attention_type, heads, generator)

    make.__doc__ = doc
    return make


SpatialModel = _wrapper("spatial", (3,), "One 3-head spatial block.")
TemporalModel = _wrapper("temporal", (3,), "One 3-head temporal block.")
TemporalModel4h = _wrapper("temporal", (4,), "One 4-head temporal block.")
TemporalModel2l = _wrapper("temporal", (3, 3), "Two 3-head temporal blocks.")
MultiStreamModel = _wrapper("multi_stream", (1, 1),
                            "Two 1-head multi_stream blocks.")


class ConvGAT(nn.Module):
    """An empty stub in the reference and in the JAX package: its forward
    raises."""

    def forward(self, x):
        raise NotImplementedError("ConvGAT is a stub in the reference too")
