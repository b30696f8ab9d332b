"""Masked regression criteria (port of the ``mse`` and ``l1`` parts of
``extended_gan_tpu/train/losses.py``).

The mask holds one weight per sample (1 for a real sample, 0 for padding);
padded samples add nothing and the mean runs over the real ones.
"""

from __future__ import annotations

import torch


def _masked_mean(per: torch.Tensor, mask: torch.Tensor | None):
    if mask is None:
        return per.mean()
    m = mask.reshape((-1,) + (1,) * (per.dim() - 1)).expand_as(per)
    return (per * m).sum() / m.sum().clamp_min(1.0)


def mse(y_hat, y, *, mask=None):
    """== torch.nn.MSELoss on the real samples."""
    return _masked_mean((y_hat - y) ** 2, mask)


def l1(y_hat, y, *, mask=None):
    """== torch.nn.L1Loss on the real samples."""
    return _masked_mean((y_hat - y).abs(), mask)


CRITERIA = {"mse": mse, "l1": l1}
