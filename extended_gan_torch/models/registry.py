"""Model registry (port of ``extended_gan_tpu/models/registry.py``).

Every key of the JAX registry: the GAT3D ``Model`` families (``temporal``,
``spatial``, ``multi_stream``, with the linear, conv and smaat_unet
mappings), the SmaAt-UNet ``UnetModel`` (``unet``), the baseline GAT
models (``baseline``, ``baseline2d``) and the stacked GAT3D wrappers
(``temporal_1block``, ``temporal4h``, ``temporal2l``, ``spatial_1block``,
``multi_stream_2block``). Each maps (B, H, W, T, V) -> (B, H, W, T, V) and
exposes ``mapping_type``.
"""

from __future__ import annotations

import torch

from ..core.device import resolve_device
from .gat.baseline import BaselineModel, BaselineModel2D
from .gat.gat3d import Model as GatModel
from .gat.wrappers import (
    MultiStreamModel,
    SpatialModel,
    TemporalModel,
    TemporalModel2l,
    TemporalModel4h,
)
from .unet_model import UnetModel

# key -> (constructor, whether it takes the key as its attention_type,
# whether it has a fused kernel behind use_pallas)
model_classes = {
    "unet": (UnetModel, False, True),
    "temporal": (GatModel, True, True),
    "spatial": (GatModel, True, True),
    "multi_stream": (GatModel, True, True),
    "baseline": (BaselineModel, False, False),
    "baseline2d": (BaselineModel2D, False, False),
    "temporal_1block": (TemporalModel, False, False),
    "temporal4h": (TemporalModel4h, False, False),
    "temporal2l": (TemporalModel2l, False, False),
    "spatial_1block": (SpatialModel, False, False),
    "multi_stream_2block": (MultiStreamModel, False, False),
}


def build_model(model_type: str, *, image_width: int, image_height: int,
                n_vertices: int, mapping_type: str, time_steps: int = 4,
                use_pallas: bool | None = None, device=None,
                generator: torch.Generator | None = None) -> torch.nn.Module:
    """Build a model on ``device`` (default: the CUDA card), in eval mode,
    with weights drawn from ``generator``. ``use_pallas=None`` turns the
    fused kernels (K1 in GAT3D, K3 in SmaAt-UNet) on exactly when the model
    sits on the card; families without a kernel ignore it, with the JAX
    registry's note when the caller asked for it."""
    if model_type not in model_classes:
        raise KeyError(f"unknown model_type {model_type!r}; choose from "
                       f"{sorted(model_classes)}")
    ctor, takes_attention, has_kernel = model_classes[model_type]
    dev = resolve_device(device)
    kwargs = dict(mapping_type=mapping_type, time_steps=time_steps,
                  generator=generator)
    if takes_attention:
        kwargs["attention_type"] = model_type
    if has_kernel:
        kwargs["use_pallas"] = (dev.type == "cuda" if use_pallas is None
                                else use_pallas)
    elif use_pallas:
        name = getattr(ctor, "__name__", model_type)
        print(f"[registry] {name} has no Pallas path; use_pallas ignored")
    model = ctor(image_width, image_height, n_vertices, **kwargs)
    return model.to(dev).eval()
