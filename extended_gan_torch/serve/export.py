"""Serving artifacts (port of ``serve/export.py``).

The JAX package lowers the forward to StableHLO with the weights baked in,
and the artifact runs without the model's Python code. The port's artifact
is the model's spec plus its weights, written with ``torch.save``;
:func:`load_exported` rebuilds the forward through the port's own modules,
so loading it needs this package. (``torch.export`` cannot carry the
ctypes-launched CUDA kernels.)

The spec's ``workload`` says what the weights are:

- ``gat``: a conv-GAT family model (registry key, mapping, geometry), its
  ``state_dict``; with ``quantize="w8"`` the state_dict of
  ``serve/quantize.py::quantize_state_dict_w8`` (int8 kernels beside
  their f32 scales), dequantised into the model once, at load, so the model
  runs its f32 forward with its kernels (K1, K3) as before.
- ``dcgan_generator``: the DCGAN generator (``nc``, ``imsize``), NHWC
  ``float32[b, imsize, imsize, nc]`` in and out, as the JAX artifact takes
  it: with no ``quantize`` the ``Generator``'s state_dict, run in the
  spec's ``layout`` (``default``, or ``packed2``: ``Generator(packed=True)``,
  the 2x2 space-to-depth layout, the same state_dict); with ``w8`` or
  ``w8a8`` the state of ``serve/quantize.py::quantize_generator`` (the
  BN-folded int8 chain, default layout only).

A spec without ``workload`` (the artifacts of format 1) is a ``gat`` one.
``rollout`` K > 1 wraps the forward in a K-step autoregressive rollout.

``<path>.json`` is the same sidecar as the JAX package's: ``format_version``,
``platforms``, ``inputs``, ``outputs`` and ``nbytes``, plus the spec.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Callable

import torch
from torch import nn

from ..core.device import resolve_device
from ..models.dcgan import Generator
from ..models.registry import build_model
from ..train.checkpoint import tree_to_cpu
from .quantize import dequantize_state_dict, generator_apply
from .rollout import make_rollout

FORMAT_VERSION = 2
_READS = (1, 2)  # format 1: the GAT artifacts, before workloads
MODEL_KEYS = ("model_type", "mapping_type", "image_width", "image_height",
              "n_vertices", "time_steps")
_REQUIRED = {"gat": MODEL_KEYS, "dcgan_generator": ("nc", "imsize")}


def _window(spec: dict) -> tuple[int, ...]:
    """The shape of one input window (the batch axis left out)."""
    if spec.get("workload", "gat") == "dcgan_generator":
        return (spec["imsize"], spec["imsize"], spec["nc"])
    return (spec["image_width"], spec["image_height"], spec["time_steps"],
            spec["n_vertices"])


def _io_shapes(spec: dict) -> tuple[str, str]:
    """The i/o contract in the JAX sidecar's notation; ``b`` is the batch
    axis, which any size may fill."""
    window = _window(spec)
    steps = spec.get("rollout", 1)
    out = window if steps == 1 or spec.get("rollout_final_only") \
        else (steps, *window)
    fmt = lambda dims: "float32[b," + ",".join(map(str, dims)) + "]"  # noqa: E731
    return fmt(window), fmt(out)


def contract_window(contract: str) -> tuple[int, ...]:
    """``"float32[b,64,64,4]"`` -> (64, 64, 4)."""
    m = re.fullmatch(r"float32\[b((?:,\d+)*)\]", contract)
    if m is None:
        raise ValueError(f"unreadable i/o contract {contract!r}")
    return tuple(int(d) for d in m.group(1).split(",")[1:])


def save_exported(spec: dict, weights: dict, path: str,
                  metadata: dict | None = None) -> dict:
    """Write the artifact to ``path`` and its ``.json`` sidecar.

    ``spec`` holds ``workload`` (default ``gat``) and its keys: for ``gat``
    the registry arguments (``model_type``, ``mapping_type``,
    ``image_width``, ``image_height``, ``n_vertices``, ``time_steps``), for
    ``dcgan_generator`` ``nc`` and ``imsize``; and optionally ``quantize``,
    ``rollout`` (K) and ``rollout_final_only``. ``weights`` is the
    state_dict, or the quantised state, that the workload loads."""
    spec = {"workload": "gat", "quantize": "", **spec}
    if spec["workload"] not in _REQUIRED:
        raise ValueError(f"unknown workload {spec['workload']!r}")
    missing = [k for k in _REQUIRED[spec["workload"]] if k not in spec]
    if missing:
        raise ValueError(f"spec lacks {missing}")
    torch.save({"format_version": FORMAT_VERSION, "spec": spec,
                "weights": tree_to_cpu(weights)}, path)
    inputs, outputs = _io_shapes(spec)
    meta = {
        "format_version": FORMAT_VERSION,
        "platforms": ["cuda", "cpu"],
        "inputs": [inputs],
        "outputs": [outputs],
        "nbytes": os.path.getsize(path),
        "spec": spec,
    }
    meta.update(metadata or {})
    with open(path + ".json", "w") as f:
        json.dump(meta, f, indent=2)
    return meta


@dataclasses.dataclass
class LoadedArtifact:
    spec: dict
    model: nn.Module | None  # the GAT model or the f32 Generator
    fn: Callable[[torch.Tensor], torch.Tensor]  # rolled out if asked
    inputs: str
    outputs: str

    @property
    def window_shape(self) -> tuple[int, ...]:
        return contract_window(self.inputs)


def nhwc_generator(generator: nn.Module) -> Callable:
    """The NCHW ``Generator`` behind the JAX artifact's NHWC contract."""
    def fwd(x):
        return generator(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    return fwd


def build_forward(spec: dict, weights: dict, device
                  ) -> tuple[nn.Module | None, Callable]:
    """(the model or None, the one-step forward) of an artifact's spec and
    weights on ``device``."""
    quantize = spec.get("quantize", "")
    if spec.get("workload", "gat") == "gat":
        if quantize not in ("", "w8"):
            raise ValueError(f"gat artifacts take quantize '' or 'w8', not "
                             f"{quantize!r}")
        model = build_model(**{k: spec[k] for k in MODEL_KEYS}, device=device)
        model.load_state_dict(dequantize_state_dict(weights) if quantize
                              else weights)
        return model, model
    layout = spec.get("layout", "default")
    if layout not in ("default", "packed2"):
        raise ValueError(f"unknown generator layout {layout!r}")
    if quantize:
        if layout != "default":
            raise ValueError("a quantised generator runs the default layout")
        return None, generator_apply(weights, device)
    model = Generator(spec["nc"], dropout=0.0,
                      packed=layout == "packed2").to(device).eval()
    model.load_state_dict(weights)
    return model, nhwc_generator(model)


def load_exported(path: str, *, device=None) -> LoadedArtifact:
    """Rebuild an artifact's forward on ``device`` (default: the CUDA
    card)."""
    dev = resolve_device(device)
    blob = torch.load(path, map_location="cpu", weights_only=True)
    version = blob.get("format_version")
    if version not in _READS:
        raise ValueError(f"{path}: artifact format {version!r}, this code "
                         f"reads {_READS}")
    spec = blob["spec"]
    weights = blob["weights"] if version >= 2 else blob["state_dict"]
    model, fn = build_forward(spec, weights, dev)
    steps = spec.get("rollout", 1)
    if steps > 1:
        fn = make_rollout(fn, steps,
                          final_only=bool(spec.get("rollout_final_only")))
    inputs, outputs = _io_shapes(spec)
    return LoadedArtifact(spec, model, fn, inputs, outputs)
