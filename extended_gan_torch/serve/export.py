"""Serving artifacts (port of ``serve/export.py``).

The JAX package lowers the forward to StableHLO with the weights baked in,
and the artifact runs without the model's Python code. The port's artifact
is the model's spec (registry key, geometry, rollout) plus its
``state_dict``, written with ``torch.save``; :func:`load_exported` rebuilds
the model through the port's registry, so loading it needs this package.
(``torch.export`` cannot carry the ctypes-launched CUDA kernel.)

``<path>.json`` is the same sidecar as the JAX package's: ``format_version``,
``platforms``, ``inputs``, ``outputs`` and ``nbytes``, plus the spec.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable

import torch

from ..core.device import resolve_device
from ..models.registry import build_model
from .rollout import make_rollout

FORMAT_VERSION = 1
MODEL_KEYS = ("model_type", "mapping_type", "image_width", "image_height",
               "n_vertices", "time_steps")


def _io_shapes(spec: dict) -> tuple[str, str]:
    """The i/o contract in the JAX sidecar's notation; ``b`` is the batch
    axis, which any size may fill."""
    window = (spec["image_width"], spec["image_height"], spec["time_steps"],
              spec["n_vertices"])
    steps = spec.get("rollout", 1)
    out = window if steps == 1 or spec.get("rollout_final_only") \
        else (steps, *window)
    fmt = lambda dims: "float32[b," + ",".join(map(str, dims)) + "]"  # noqa: E731
    return fmt(window), fmt(out)


def save_exported(spec: dict, state_dict: dict, path: str,
                  metadata: dict | None = None) -> dict:
    """Write the artifact to ``path`` and its ``.json`` sidecar.

    ``spec`` holds the registry arguments (``model_type``, ``mapping_type``,
    ``image_width``, ``image_height``, ``n_vertices``, ``time_steps``) and
    optionally ``rollout`` (K) and ``rollout_final_only``."""
    missing = [k for k in MODEL_KEYS if k not in spec]
    if missing:
        raise ValueError(f"spec lacks {missing}")
    weights = {k: v.detach().cpu().contiguous() for k, v in state_dict.items()}
    torch.save({"format_version": FORMAT_VERSION, "spec": dict(spec),
                "state_dict": weights}, path)
    inputs, outputs = _io_shapes(spec)
    meta = {
        "format_version": FORMAT_VERSION,
        "platforms": ["cuda", "cpu"],
        "inputs": [inputs],
        "outputs": [outputs],
        "nbytes": os.path.getsize(path),
        "spec": dict(spec),
    }
    meta.update(metadata or {})
    with open(path + ".json", "w") as f:
        json.dump(meta, f, indent=2)
    return meta


@dataclasses.dataclass
class LoadedArtifact:
    spec: dict
    model: torch.nn.Module
    fn: Callable[[torch.Tensor], torch.Tensor]  # the model, rolled out if asked
    inputs: str
    outputs: str

    @property
    def window_shape(self) -> tuple[int, ...]:
        s = self.spec
        return (s["image_width"], s["image_height"], s["time_steps"],
                s["n_vertices"])


def load_exported(path: str, *, device=None) -> LoadedArtifact:
    """Rebuild an artifact's model on ``device`` (default: the CUDA card)."""
    dev = resolve_device(device)
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if blob.get("format_version") != FORMAT_VERSION:
        raise ValueError(f"{path}: artifact format "
                         f"{blob.get('format_version')!r}, this code reads "
                         f"{FORMAT_VERSION}")
    spec = blob["spec"]
    model = build_model(**{k: spec[k] for k in MODEL_KEYS}, device=dev)
    model.load_state_dict(blob["state_dict"])
    steps = spec.get("rollout", 1)
    fn = model if steps == 1 else make_rollout(
        model, steps, final_only=bool(spec.get("rollout_final_only")))
    inputs, outputs = _io_shapes(spec)
    return LoadedArtifact(spec, model, fn, inputs, outputs)
