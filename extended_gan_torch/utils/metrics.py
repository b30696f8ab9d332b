"""Streaming metrics as (numerator, denominator) pairs (port of
``extended_gan_tpu/utils/metrics.py``: the parts the DCGAN path uses, and
the conv-GAT helpers :func:`thresholded_metrics`, :func:`get_metrics`,
:func:`nowcast_scores`, :func:`accuracy_criterion` and
:func:`denormalize`).

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


# --------------------------------------------------------------------------
# Thresholded frame metrics (conv-GAT flavour; JAX ``metrics.py:211-288``).
# --------------------------------------------------------------------------
def _binary(y, y_hat, threshold):
    y, y_hat = torch.as_tensor(y), torch.as_tensor(y_hat)
    return y >= threshold, y_hat >= threshold


def thresholded_metrics(y, y_hat, threshold) -> torch.Tensor:
    """(3,) float32 ``[acc, prec, rec]`` after binarising both at
    ``threshold`` (``>=``, the conv-GAT polarity): accuracy divides by the
    element count of one sample, precision and recall are scaled by the
    batch length; precision and recall are NaN where undefined (the caller
    zeroes them)."""
    yb, pb = _binary(y, y_hat, threshold)
    n = float(yb.shape[0])
    acc = (yb == pb).sum().float() / yb[0].numel()
    tp = (pb & yb).sum().float()
    fp = (pb & ~yb).sum().float()
    fn = (~pb & yb).sum().float()
    return torch.stack([acc, tp / (tp + fp) * n, tp / (tp + fn) * n])


def get_metrics(y, y_hat, threshold):
    """``(acc, prec, rec)`` of :func:`thresholded_metrics` on the host."""
    out = thresholded_metrics(y, y_hat, threshold).cpu().numpy()
    return out[0], out[1], out[2]


def nowcast_scores(y, y_hat, threshold, *, mask=None) -> dict:
    """Nowcasting skill scores on thresholded rain masks: ``f1`` (2PR / (P
    + R)), ``csi`` (TP / (TP + FN + FP)) and ``far`` (FP / (TP + FP)), each
    a float32 scalar tensor, NaN where undefined; a sample whose ``mask``
    entry is 0 counts for nothing."""
    yb, pb = _binary(y, y_hat, threshold)
    if mask is None:
        m = torch.ones(yb.shape, dtype=torch.float32, device=yb.device)
    else:
        m = torch.as_tensor(mask).float().reshape(
            (-1,) + (1,) * (yb.dim() - 1)).expand(yb.shape)
    tp = (pb & yb).float().mul(m).sum()
    fp = (pb & ~yb).float().mul(m).sum()
    fn = (~pb & yb).float().mul(m).sum()
    precision, recall = tp / (tp + fp), tp / (tp + fn)
    return {"f1": 2 * precision * recall / (precision + recall),
            "csi": tp / (tp + fn + fp), "far": fp / (tp + fp)}


def accuracy_criterion(a, b) -> IncrementalTuple:
    """The DCGAN reference's ``accuracy_criterion``: predictions that round
    to the target, over the batch size."""
    nd = rounded_match_nd(torch.as_tensor(a), torch.as_tensor(b))
    return IncrementalTuple(nd.cpu().numpy())


def denormalize(x, mean, var):
    """``x * var(var) + mean(mean)``, the variance the population's (JAX's
    ``jnp.var``)."""
    var, mean = torch.as_tensor(var), torch.as_tensor(mean)
    return torch.as_tensor(x) * var.var(correction=0) + mean.mean()
