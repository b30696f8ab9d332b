"""Carry weights from the JAX package's flax parameter trees to the port.

The port's parameter names and shapes follow the flax tree leaf for leaf
(``models/gat/gat3d.py``, ``models/smaat_unet.py``), so the conversion is a
rename. Nested keys are joined with ``.``, and:

- a conv ``*kernel`` (HWIO, behind the head axis of a vmapped block) becomes
  a ``*weight`` in torch's OIHW: the depthwise (3, 3, 1, C*kpl) kernel turns
  into (C*kpl, 1, 3, 3), the pointwise (1, 1, C*kpl, Cout) one into
  (Cout, C*kpl, 1, 1);
- a Dense ``kernel`` (in, out) becomes a ``Linear.weight`` (out, in);
- a BatchNorm's ``scale`` becomes its ``weight``, and its ``batch_stats``
  ``mean`` and ``var`` the ``running_mean`` and ``running_var`` buffers
  (with a zero ``num_batches_tracked``, which torch keeps beside them);
- an unrolled GAT3D head ``head_{i}`` (the smaat_unet mapping's) is a
  stack of one head in the port, so its attention's ``a_*`` and ``B_*``
  gain a leading head axis of size 1.

Everything else, the head axis of a vmapped block included, is kept as it
is: the baseline layers' ``W``, ``a`` and ``B`` need no renaming. Leaves
are numpy arrays (``jax.device_get`` of a flax tree gives them).
"""

from __future__ import annotations

from collections.abc import Mapping

import re

import numpy as np
import torch

_UNROLLED_HEAD = re.compile(r"(^|\.)head_\d+\.$")
_BN_STATS = {"mean": "running_mean", "var": "running_var"}


def from_flax_params(params: Mapping, batch_stats: Mapping | None = None
                     ) -> dict[str, torch.Tensor]:
    """Flax ``params`` (and ``batch_stats``) trees, numpy leaves or nested
    dicts -> state_dict."""
    state = {}

    def walk(tree, prefix, stats):
        for key, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{key}.", stats)
                continue
            arr = np.array(value, np.float32)  # a writable copy
            if stats:
                if key == "mean":
                    state[prefix + "num_batches_tracked"] = torch.tensor(0)
                key = _BN_STATS[key]
            elif key.endswith("kernel") and arr.ndim == 2:  # Dense
                arr, key = arr.T, "weight"
            elif key.endswith("kernel"):
                nd = arr.ndim  # (..., kh, kw, I, O) -> (..., O, I, kh, kw)
                arr = arr.transpose(*range(nd - 4), nd - 1, nd - 2, nd - 4,
                                    nd - 3)
                key = key[:-len("kernel")] + "weight"
            elif key == "scale":
                key = "weight"
            elif key.startswith(("a_", "B_")) and _UNROLLED_HEAD.search(prefix):
                arr = arr[None]
            state[prefix + key] = torch.from_numpy(np.ascontiguousarray(arr))

    walk(params, "", False)
    walk(batch_stats or {}, "", True)
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
