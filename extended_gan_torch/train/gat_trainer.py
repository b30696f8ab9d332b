"""conv-GAT / U-Net MSE trainer (port of ``extended_gan_tpu/train/gat_trainer.py``).

- the train step's loss is the masked criterion minus 0.0005 * the mean
  prediction (the reference's sparsity bonus), and it returns the
  ``running_nd`` pair (sum of squared errors / elements of one sample,
  number of samples) that the epoch's train loss is summed from;
- batches with at most one sample are skipped in train and eval;
- eval de-normalises predictions and targets (``y ** (1 / power)``),
  thresholds both at the median of the target batch's unique values, and
  scores accuracy, precision and recall as the reference does (accuracy per
  element of one sample, precision and recall scaled by the batch length),
  plus the MSE scaled by the loader's ``normalizing_max``.

The JAX package pads every batch to a fixed shape for ``jit`` and masks the
padding out; PyTorch runs eagerly, so the port feeds each batch as it comes,
with a mask of ones. Metric sums stay on the card until one fetch at the
end of a pass.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.streaming import Prefetcher
from .losses import CRITERIA


def make_gat_train_step(model, optimizer, *, criterion: str = "mse"):
    """``step(x, y, mask) -> (loss, running_nd)``: forward in train mode,
    backward, one optimizer step. ``criterion`` is "mse" or "l1"."""
    if criterion not in CRITERIA:
        raise ValueError(
            f"unsupported criterion {criterion!r}; choose 'mse' or 'l1'")
    crit = CRITERIA[criterion]

    def step(x, y, mask):
        model.train()
        y_hat = model(x)
        m = mask.reshape((-1,) + (1,) * (y.dim() - 1))
        n_valid = mask.sum()
        err = crit(y_hat, y, mask=mask)  # sum(err * m) / (n_valid * y[0].numel())
        mean_pred = (y_hat * m).sum() / (n_valid.clamp_min(1.0) * y[0].numel())
        loss = err - 0.0005 * mean_pred
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        # running_loss contribution: sum(err) / y[0].numel()
        return loss.detach(), torch.stack([err.detach() * n_valid, n_valid])

    return step


def _eval_metrics(y_hat, y, mask, threshold, normalizing_max, power):
    """The per-batch eval metric sums."""
    inv = 1.0 / power
    y_p = y ** inv if power != 1.0 else y
    y_hat_p = y_hat.clamp_min(0.0) ** inv if power != 1.0 else y_hat
    m = mask.reshape((-1,) + (1,) * (y.dim() - 1))
    per_sample = float(y[0].numel())
    n_valid = mask.sum()
    sq = (((y_p - y_hat_p) ** 2) * m).sum()
    denorm_sq = ((((y_p - y_hat_p) * normalizing_max) ** 2) * m).sum()
    mb = m.expand_as(y)
    yb = y_p >= threshold
    pb = y_hat_p >= threshold
    acc = ((yb == pb) * mb).sum() / per_sample
    tp = (pb & yb) * mb
    fp = (pb & ~yb) * mb
    fn = (~pb & yb) * mb
    tp, fp, fn = tp.sum(), fp.sum(), fn.sum()
    return {
        "loss_num": sq / per_sample,
        "denorm_num": denorm_sq / per_sample,
        "acc": acc,
        "prec": tp / (tp + fp) * n_valid,
        "rec": tp / (tp + fn) * n_valid,
        "n": n_valid,
    }


def make_gat_eval_step(model):
    """``eval_step(x, y, mask, threshold, normalizing_max, power=1.0)`` ->
    the metric sums of :func:`_eval_metrics` plus ``y_hat``; eval mode, no
    gradient."""

    def eval_step(x, y, mask, threshold, normalizing_max, *, power=1.0):
        model.eval()
        with torch.no_grad():
            y_hat = model(x)
            out = _eval_metrics(y_hat, y, mask, threshold, normalizing_max,
                                power)
        out["y_hat"] = y_hat
        return out

    return eval_step


def to_device_batch(x, y, device):
    """Numpy (x, y) -> (x, y, mask) float32 tensors on ``device``; the copy
    is asynchronous from pinned memory when the device is the card."""
    def put(a):
        t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t

    return put(x), put(y), torch.ones(len(x), device=device)


def gat_feed(loader, device, *, depth=2):
    """Background feed: yields ``(n_samples, (x, y, mask))`` with the batch
    on ``device``, or ``(n, None)`` for a batch of at most one sample, which
    the caller skips."""
    def prepare(item):
        x, y = item
        n = len(x)
        return (n, None) if n <= 1 else (n, to_device_batch(x, y, device))

    return Prefetcher(iter(loader), depth=depth, transfer=prepare)


_METRICS = ("loss_num", "denorm_num", "acc", "prec", "rec")


def test(eval_step, loader, device):
    """Validation-set evaluation (the reference's ``test``)."""
    power = float(getattr(loader, "power", 1.0))
    norm_max = float(getattr(loader, "normalizing_max", 1.0))

    def prepare(item):
        x, y = item
        n = len(x)
        if n <= 1:
            return n, None, None
        unique = np.unique(np.asarray(y, np.float32) ** (1.0 / power))
        threshold = float(unique[int(len(unique) * 0.5)])
        return n, threshold, to_device_batch(x, y, device)

    pending, total = [], 0  # metric sums stay on the card; one fetch
    for n, threshold, batch in Prefetcher(iter(loader), depth=2,
                                          transfer=prepare):
        if n <= 1:
            continue
        out = eval_step(*batch, threshold, norm_max, power=power)
        pending.append(torch.stack([out[k] for k in _METRICS]))
        total += n
    sums = dict.fromkeys(_METRICS, 0.0)
    for row in (torch.stack(pending).tolist() if pending else []):
        for k, v in zip(_METRICS, row):
            undefined = k in ("prec", "rec") and np.isnan(v)
            sums[k] += 0.0 if undefined else v  # the reference drops them
    total = max(total, 1)
    return {
        "val_loss": sums["loss_num"] / total,
        "val_acc": sums["acc"] / total,
        "val_prec": sums["prec"] / total,
        "val_rec": sums["rec"] / total,
        "val_denorm_mse": sums["denorm_num"] / total,
    }
