"""Streaming metrics as (numerator, denominator) pairs (port of the parts of
``extended_gan_tpu/utils/metrics.py`` that the DCGAN path uses).

The reference's quirks, which its published numbers depend on, are kept:

- frames are binarised with ``y < threshold`` (the inverted polarity);
- ``accuracy`` sums matches over the whole batch but divides by the element
  count of ONE sample, once a batch.

The per-batch functions take tensors and return 2-element tensors on the
same device, so a train or eval step keeps them there; only
:class:`IncrementalTuple` and :class:`MetricsManager` live on the host.
"""

from __future__ import annotations

import math

import numpy as np
import torch

DISCRETE_METRICS = ("accuracy", "precision", "recall")


def masked_batch_metrics(names: tuple[str, ...], y, y_hat, mask=None, *,
                         discretizing_threshold: float = 0.5):
    """{name: tensor([num, denom])} for one batch; a sample whose ``mask``
    entry is 0 adds nothing (``None``: every sample counts)."""
    if mask is None:
        mask = torch.ones(y.shape[0], device=y.device)
    m = mask.reshape((-1,) + (1,) * (y.dim() - 1)).float().expand_as(y)
    dy = (y < discretizing_threshold).float()
    dyh = (y_hat < discretizing_threshold).float()
    per_sample = torch.tensor(float(math.prod(y.shape[1:])), device=y.device)
    out = {}
    for name in names:
        if name == "mse":
            diff = (y_hat.float() - y.float()) ** 2
            out[name] = torch.stack([(diff * m).sum(), m.sum()])
        elif name == "accuracy":
            out[name] = torch.stack([((dy == dyh).float() * m).sum(),
                                     per_sample])
        elif name == "precision":
            tp = (dyh * dy * m).sum()
            fp = (dyh * (1 - dy) * m).sum()
            out[name] = torch.stack([tp, tp + fp])
        elif name == "recall":
            tp = (dyh * dy * m).sum()
            fn = ((1 - dyh) * dy * m).sum()
            out[name] = torch.stack([tp, tp + fn])
        else:
            raise ValueError(name)
    return out


def batch_metrics(names: tuple[str, ...], y, y_hat, *,
                  discretizing_threshold: float = 0.5):
    """:func:`masked_batch_metrics` over every sample of the batch."""
    return masked_batch_metrics(names, y, y_hat,
                                discretizing_threshold=discretizing_threshold)


def rounded_match_nd(a, b):
    """The reference's ``accuracy_criterion``: how many of the predictions
    ``a`` round to the labels ``b``, over the batch size."""
    return torch.stack([(torch.round(a) == torch.round(b)).sum().float(),
                        torch.tensor(float(a.shape[0]), device=a.device)])


def masked_rounded_match_nd(p, label: float, mask):
    """:func:`rounded_match_nd` of ``p`` against a constant label over the
    samples whose ``mask`` entry is 1, the denominator their count; computed
    on ``p``'s device, with no copy from the host."""
    matches = (torch.round(p.reshape(-1)) == label).to(mask.dtype)
    return torch.stack([(matches * mask).sum(), mask.sum()])


class IncrementalTuple:
    """(numerator, denominator) ratio accumulator: ``+``, ``+=``,
    ``.item()``, ``.reciprocal()``."""

    def __init__(self, val=None, denom=None):
        if val is None:
            self.val = np.zeros(2, np.float64)
        elif denom is not None:
            self.val = np.array([float(val), float(denom)], np.float64)
        else:
            self.val = np.asarray(val, np.float64).copy()

    def reciprocal(self) -> "IncrementalTuple":
        return IncrementalTuple(
            np.array([self.val[1] - self.val[0], self.val[1]]))

    def __add__(self, x):
        return IncrementalTuple(self.val + np.asarray(x.val, np.float64))

    def __iadd__(self, x):
        self.val = self.val + np.asarray(x.val, np.float64)
        return self

    def item(self) -> float:
        denom = self.val[1]
        return float(self.val[0] / denom) if denom != 0 else float("nan")

    def __str__(self):
        return f"{self.item()}"

    def __format__(self, spec):
        return self.item().__format__(spec)


class MetricsManager:
    """Named streaming metrics with a common prefix: results are
    ``{prefix}_{name}``."""

    def __init__(self, metrics_names: tuple[str, ...], *, prefix: str = "",
                 discretizing_threshold: float = 0.5):
        self.names = tuple(metrics_names)
        self.prefix = prefix
        self.discretizing_threshold = discretizing_threshold
        self.metrics = {n: IncrementalTuple() for n in self.names}

    def update(self, y, y_hat):
        """Compute one batch's metrics and accumulate them."""
        self.update_from_nd(batch_metrics(
            self.names, torch.as_tensor(y), torch.as_tensor(y_hat),
            discretizing_threshold=self.discretizing_threshold))

    def update_from_nd(self, nd: dict):
        """Accumulate {name: [num, denom]} pairs (tensors or arrays)."""
        for name, pair in nd.items():
            if isinstance(pair, torch.Tensor):
                pair = pair.detach().cpu().numpy()
            self.metrics[name] += IncrementalTuple(np.asarray(pair))

    def results(self) -> dict[str, float]:
        return {f"{self.prefix}_{k}": v.item()
                for k, v in self.metrics.items()}
