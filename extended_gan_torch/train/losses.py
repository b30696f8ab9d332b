"""Masked criteria (port of ``extended_gan_tpu/train/losses.py``): the
conv-GAT trainer's ``mse`` and ``l1``, the DCGAN trainer's ``bce``.

The mask holds one weight per sample (1 for a real sample, 0 for padding);
padded samples add nothing and the mean runs over the real ones.
"""

from __future__ import annotations

import math

import torch


def _masked_mean(per: torch.Tensor, mask: torch.Tensor | None,
                 count: torch.Tensor | None = None):
    if mask is None:
        return per.mean()
    m = mask.reshape((-1,) + (1,) * (per.dim() - 1)).expand_as(per)
    if count is None:
        return (per * m).sum() / m.sum().clamp_min(1.0)
    return (per * m).sum() / (count.clamp_min(1.0) * math.prod(per.shape[1:]))


def mse(y_hat, y, *, mask=None, count=None):
    """== torch.nn.MSELoss on the real samples. ``count``: the samples the
    mean runs over, where these rows are one rank's share of them."""
    return _masked_mean((y_hat - y) ** 2, mask, count)


def l1(y_hat, y, *, mask=None, count=None):
    """== torch.nn.L1Loss on the real samples (``count`` as for
    :func:`mse`)."""
    return _masked_mean((y_hat - y).abs(), mask, count)


# torch.nn.BCELoss clamps the log at -100. Its backward at a saturated p (0
# or 1) divides by max(p (1 - p), 1e-12), and the JAX package's gradient
# there is that of the branch its where selects (0 for the clamped log), so
# the port computes the JAX form. The cutoff is the smallest normal f32:
# XLA flushes subnormals, so JAX takes any p below it for 0.
_MIN_NORMAL = 1.1754944e-38


def _clamped_log(x):
    return torch.where(x < _MIN_NORMAL, -100.0,
                       torch.log(x.clamp_min(_MIN_NORMAL)))


def bce(p, target, *, mask=None, count=None):
    """Binary cross-entropy on probabilities (after the sigmoid), mean over
    the real samples; ``target`` a number or a tensor of p's shape
    (``count`` as for :func:`mse`)."""
    per = -(target * _clamped_log(p) + (1.0 - target) * _clamped_log(1.0 - p))
    return _masked_mean(per, mask, count)


CRITERIA = {"mse": mse, "l1": l1}
