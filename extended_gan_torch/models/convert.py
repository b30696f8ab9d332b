"""Carry weights from the JAX package's flax parameter trees to the port.

The port's parameter names and shapes follow the flax tree leaf for leaf
(``models/gat/gat3d.py``), so the conversion is a rename: nested keys are
joined with ``.``, and a conv ``kernel`` (HWIO, behind the head axis of a
vmapped block) becomes a ``weight`` in torch's OIHW. Everything else,
the head axis included, is kept as it is.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def from_flax_params(params: Mapping) -> dict[str, torch.Tensor]:
    """Flax ``params`` tree (numpy leaves or nested dicts) -> state_dict."""
    state = {}

    def walk(tree, prefix):
        for key, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{key}.")
                continue
            arr = np.array(value, np.float32)  # a writable copy
            if key == "kernel":
                nd = arr.ndim  # (..., kh, kw, I, O) -> (..., O, I, kh, kw)
                arr = arr.transpose(*range(nd - 4), nd - 1, nd - 2, nd - 4,
                                    nd - 3)
                key = "weight"
            state[prefix + key] = torch.from_numpy(np.ascontiguousarray(arr))

    walk(params, "")
    return state


def load_flax_npz(path: str) -> dict[str, torch.Tensor]:
    """A flat ``.npz`` of flax params whose keys are joined with ``/`` (as
    ``flax.traverse_util.flatten_dict(params, sep="/")`` writes them) ->
    state_dict."""
    tree: dict = {}
    with np.load(path, allow_pickle=False) as flat:
        for name in flat.files:
            *parents, leaf = name.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = flat[name]
    return from_flax_params(tree)
