"""Model registry (port of ``extended_gan_tpu/models/registry.py``).

Ported so far: the GAT3D ``Model`` families (``temporal``, ``spatial``,
``multi_stream``) and the SmaAt-UNet ``UnetModel`` (``unet``). Every other
key of the JAX registry raises ``NotImplementedError`` naming the ROADMAP
item that ports it.
"""

from __future__ import annotations

import torch

from ..core.device import resolve_device
from .gat.gat3d import Model as GatModel
from .unet_model import UnetModel

_GAT3D = ("temporal", "spatial", "multi_stream")
_PORTED = _GAT3D + ("unet",)
# JAX registry keys not ported yet -> the ROADMAP queue item that ports them
_NOT_PORTED = {
    "baseline": "queue 1, the rest of the conv-GAT family",
    "baseline2d": "queue 1, the rest of the conv-GAT family",
    "temporal_1block": "queue 1, the rest of the conv-GAT family",
    "temporal4h": "queue 1, the rest of the conv-GAT family",
    "temporal2l": "queue 1, the rest of the conv-GAT family",
    "spatial_1block": "queue 1, the rest of the conv-GAT family",
    "multi_stream_2block": "queue 1, the rest of the conv-GAT family",
}


def build_model(model_type: str, *, image_width: int, image_height: int,
                n_vertices: int, mapping_type: str, time_steps: int = 4,
                use_pallas: bool | None = None, device=None,
                generator: torch.Generator | None = None) -> torch.nn.Module:
    """Build a model on ``device`` (default: the CUDA card), in eval mode,
    with weights drawn from ``generator``. ``use_pallas=None`` turns the
    fused kernels (K1 in GAT3D, K3 in SmaAt-UNet) on exactly when the model
    sits on the card."""
    if model_type in _NOT_PORTED:
        raise NotImplementedError(
            f"model_type {model_type!r} is not ported yet (ROADMAP: "
            f"{_NOT_PORTED[model_type]})")
    if model_type not in _PORTED:
        raise KeyError(f"unknown model_type {model_type!r}; choose from "
                       f"{sorted(_PORTED + tuple(_NOT_PORTED))}")
    dev = resolve_device(device)
    if use_pallas is None:
        use_pallas = dev.type == "cuda"
    if model_type == "unet":
        model = UnetModel(image_width, image_height, n_vertices,
                          mapping_type=mapping_type, time_steps=time_steps,
                          use_pallas=use_pallas, generator=generator)
    else:
        model = GatModel(image_width, image_height, n_vertices,
                         attention_type=model_type, mapping_type=mapping_type,
                         time_steps=time_steps, use_pallas=use_pallas,
                         generator=generator)
    return model.to(dev).eval()
