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
padding out; PyTorch runs eagerly, so the port's single steps take each
batch as it comes, with a mask of ones. The megastep (K steps a CUDA graph,
``train/megastep.py``) needs fixed shapes as JAX's does, so
:func:`gat_megafeed` pads a short batch to the nominal size with zero rows
and a mask of zeros; train-mode BatchNorm then sees the padded rows, as it
does in JAX's megastep. Metric sums stay on the card until one fetch at the
end of a pass.

``remat=True`` runs the model's forward under ``torch.utils.checkpoint``
(non-reentrant): its activations are dropped after the forward and
recomputed during the backward, which trades a second forward for memory,
as ``jax.checkpoint`` does in the JAX step. ``jax.checkpoint`` is
functional, but a recomputed train-mode BatchNorm would update its running
statistics a second time, so the recompute normalises with the batch's
statistics as the first pass did and leaves the running ones as the first
pass left them (:func:`remat_forward`,
``state.running_stats_frozen``).

``moe_aux_weight`` > 0 (a model with a Switch-MoE bottleneck,
``models/moe.py``): the train step collects the load-balance loss of every
MoE call of its forward (``moe.sow_moe``, JAX's mutable ``"losses"``) and
adds ``moe_aux_weight`` times their sum to the loss, on the single-step,
megastep, resident, remat and bf16 paths alike (JAX
``gat_trainer.py:34-105``). At weight 0 nothing is collected, and the eval
step adds nothing.
"""

from __future__ import annotations

import contextlib
import itertools
import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..core.device import to_device
from ..data.streaming import Prefetcher
from ..models.moe import moe_layers, sow_moe
from ..parallel.expert import replicated_parameters
from ..parallel.fsdp import reduce_grads, working
from ..parallel.mesh import DataAxis, pad_to_batch_multiple
from .losses import CRITERIA
from .megastep import Megastep
from .state import batchnorms, running_stats_frozen


def remat_forward(model):
    """``model``'s forward under non-reentrant ``torch.utils.checkpoint``:
    the same outputs and gradients, with the activations recomputed during
    the backward. The recompute leaves the BatchNorm running statistics as
    the first pass left them, so a remat step updates them once, as a plain
    step does. ``preserve_rng_state=False`` is sound: the conv-GAT and UNet
    models draw no random numbers (and reading the card's generator state
    is what a CUDA graph capture may refuse)."""
    bns = batchnorms(model)

    def contexts():
        return contextlib.nullcontext(), running_stats_frozen(bns)

    def forward(x):
        return checkpoint(model, x, use_reentrant=False,
                          preserve_rng_state=False, context_fn=contexts)

    return forward


def make_gat_train_step(model, optimizer, *, criterion: str = "mse",
                        remat: bool = False, moe_aux_weight: float = 0.0,
                        axis: DataAxis | None = None):
    """``step(x, y, mask) -> (loss, running_nd)``: forward in train mode,
    backward, one optimizer step. ``criterion`` is "mse" or "l1";
    ``remat`` recomputes the forward during the backward
    (:func:`remat_forward`, ``state.running_stats_frozen``);
    ``moe_aux_weight`` > 0 adds that weight times the MoE layers'
    load-balance losses.

    With a data ``axis`` of more than one rank, (x, y, mask) are this
    rank's rows of the global batch (``DataAxis.rows``; maybe none) and
    the model's BatchNorm reads the axis (``parallel.attach_data_axis``).
    Each rank's loss divides by the global valid count, and the gradients
    and the loss are summed over the ranks in one all-reduce before the
    optimizer step: JAX's psum of the global-mean loss's gradient, exact
    for a ragged batch. Expert shards (``parallel/expert.py``) are left
    out of that sum: their exchange's backward already summed them. The
    gradients of FSDP's working weights (``parallel/fsdp.py``) go to their
    shards by a reduce-scatter instead, and the optimizer's step gathers
    the shards back. The returned loss and ``running_nd`` are the global
    ones."""
    if criterion not in CRITERIA:
        raise ValueError(
            f"unsupported criterion {criterion!r}; choose 'mse' or 'l1'")
    crit = CRITERIA[criterion]
    forward = remat_forward(model) if remat else model
    moe = moe_layers(model) if moe_aux_weight else []
    dp = axis is not None and axis.parallel
    # an expert shard's gradient is complete after the backward (its
    # exchange's backward sums the ranks' parts): it stays out of the sum;
    # an FSDP shard's is its working weight's, reduce-scattered
    params = working(replicated_parameters(model))

    def step(x, y, mask):
        model.train()
        n_valid = mask.sum()
        # the samples the loss's mean runs over: the global batch's
        count = axis.all_reduce(n_valid.clone()) if dp else n_valid
        with sow_moe(moe) as sown:
            y_hat = forward(x)
        m = mask.reshape((-1,) + (1,) * (y.dim() - 1))
        per_sample = math.prod(y.shape[1:])
        # sum(err * m) / (count * per_sample)
        err = crit(y_hat, y, mask=mask, count=count if dp else None)
        mean_pred = (y_hat * m).sum() / (count.clamp_min(1.0) * per_sample)
        loss = err - 0.0005 * mean_pred
        if sown:
            loss = loss + moe_aux_weight * torch.stack(
                [aux for aux, _ in sown]).sum()
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        loss, err = loss.detach(), err.detach()
        if dp:
            loss, err = reduce_grads(
                axis, params, torch.stack([loss, err])).unbind()
        optimizer.step()
        # running_loss contribution: sum(err) / per_sample
        return loss, torch.stack([err * count, count])

    return step


def make_gat_megastep(model, optimizer, *, criterion: str = "mse",
                      remat: bool = False, moe_aux_weight: float = 0.0,
                      axis: DataAxis | None = None):
    """K train steps a call (``megastep(xs, ys, masks) -> logs``, a leading
    K axis on each): one CUDA graph on the card, K eager steps on the CPU.
    Logs: ``loss`` of the last step, ``running_nd`` summed over the K. With
    a data ``axis`` each row of the inputs is this rank's share of a padded
    global batch (:func:`gat_megafeed`), and the steps' collectives are in
    the graph."""
    step = make_gat_train_step(model, optimizer, criterion=criterion,
                               remat=remat, moe_aux_weight=moe_aux_weight,
                               axis=axis)

    def body(x, y, mask):
        loss, running_nd = step(x, y, mask)
        return {"loss": loss, "running_nd": running_nd}

    return Megastep(body, optimizers=(optimizer,), axis=axis)


def _eval_metrics(y_hat, y, mask, threshold, normalizing_max, power):
    """The per-batch eval metric sums."""
    inv = 1.0 / power
    y_p = y ** inv if power != 1.0 else y
    y_hat_p = y_hat.clamp_min(0.0) ** inv if power != 1.0 else y_hat
    m = mask.reshape((-1,) + (1,) * (y.dim() - 1))
    per_sample = float(math.prod(y.shape[1:]))
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
        "tp": tp, "fp": fp, "fn": fn,
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


def predict_batch(model, x, device, *, axis: DataAxis | None = None):
    """The model's eval-mode prediction of the numpy batch ``x`` on
    ``device``, as numpy (the figures' ``predict_fn``; JAX
    ``gat_driver.py:720``). With a data ``axis`` of more than one rank
    (every rank calls it with the same ``x``), each rank predicts its rows
    and every rank returns the whole batch's prediction."""
    model.eval()
    x = np.asarray(x, np.float32)
    with torch.no_grad():
        if axis is None or not axis.parallel:
            return model(to_device(x, device)).float().cpu().numpy()
        n, rows = len(x), axis.rows(len(x))
        y = model(to_device(x[rows], device)).float()
        # every rank's rows, each padded to the first rank's count
        per = -(-n // axis.size)
        y = torch.cat([y, y.new_zeros((per - len(y),) + y.shape[1:])])
        return axis.gather_rows(y).flatten(0, 1)[:n].cpu().numpy()


def to_device_batch(x, y, device):
    """Numpy (x, y) -> (x, y, mask) float32 tensors on ``device``; the copy
    is asynchronous from pinned memory when the device is the card."""
    return (to_device(x, device), to_device(y, device),
            torch.ones(len(x), device=device))


def gat_feed(loader, device, *, axis: DataAxis | None = None, depth=2):
    """Background feed: yields ``(n_samples, (x, y, mask))`` with the batch
    on ``device``, or ``(n, None)`` for a batch of at most one sample, which
    the caller skips. With a data ``axis``, the batch is this rank's rows
    of the global one (``DataAxis.rows``) and ``n_samples`` the global
    batch's."""
    def prepare(item):
        x, y = item
        n = len(x)
        if n <= 1:
            return n, None
        if axis is not None:
            rows = axis.rows(n)
            x, y = x[rows], y[rows]
        return n, to_device_batch(x, y, device)

    return Prefetcher(iter(loader), depth=depth, transfer=prepare)


def pad_batch(x, y, batch_size):
    """(x, y, mask) with ``batch_size`` rows: the missing ones zeros, their
    mask entries 0 (JAX's ``MeshContext.pad_to_batch_multiple``)."""
    return pad_to_batch_multiple(x, y, batch_size=batch_size)


def gat_megafeed(loader, device, k: int, *, batch_size=None,
                 axis: DataAxis | None = None, depth=2):
    """Background feed of K loader batches a yield, for
    :func:`make_gat_megastep`: ``(consumed, n_samples, k_actual, (xs, ys,
    masks))``, each with a leading axis of ``k_actual`` (K, or fewer at the
    epoch's tail), on ``device``. Batches of at most one sample are dropped,
    as the single steps skip them; ``consumed`` counts them too. Each batch
    is padded to ``max(batch_size, the group's largest)`` rows by
    :func:`pad_batch`; with a data ``axis``, to the next multiple of its
    size, and each rank takes its even share of every batch
    (``n_samples`` stays the global count)."""

    def grouped():
        buf, consumed = [], 0
        for x, y in loader:
            consumed += 1
            if len(x) <= 1:
                continue
            buf.append((x, y))
            if len(buf) == k:
                yield consumed, buf
                buf, consumed = [], 0
        if buf:
            yield consumed, buf

    def prepare(item):
        consumed, buf = item
        rows = max(batch_size or 0, max(len(x) for x, _ in buf))
        if axis is not None:
            rows = axis.padded_batch_size(rows)
        padded = [pad_batch(np.asarray(x, np.float32),
                            np.asarray(y, np.float32), rows) for x, y in buf]
        stacked = (np.stack(a) for a in zip(*padded))
        if axis is not None:
            stacked = (axis.shard(a, 1) for a in stacked)
        staged = tuple(to_device(a, device) for a in stacked)
        return consumed, sum(len(x) for x, _ in buf), len(buf), staged

    return Prefetcher(grouped(), depth=depth, transfer=prepare)


def gat_step_logs(loader, step, device, *, max_batches: int = 0,
                  axis: DataAxis | None = None):
    """Single train steps over the first ``max_batches`` (all: 0) loader
    batches: (running_nd, samples, 1 loader batch, 1 train step) a step;
    a batch of at most one sample is skipped, as (None, 0, 1, 0). With a
    data ``axis`` each step takes this rank's rows (:func:`gat_feed`)."""
    for i, (n, batch) in enumerate(gat_feed(loader, device, axis=axis)):
        if max_batches and i >= max_batches:
            break
        if n <= 1:
            yield None, 0, 1, 0
            continue
        _, nd = step(*batch)
        yield nd, n, 1, 1


def gat_megastep_logs(loader, megastep, device, k: int, batch_size: int, *,
                      max_batches: int = 0, axis: DataAxis | None = None):
    """Groups of K of the first ``max_batches`` (all: 0) loader batches
    (:func:`gat_megafeed`; with a data ``axis``, this rank's rows) through
    ``megastep``: (running_nd, samples, loader batches consumed, train
    steps) a group."""
    batches = iter(loader)
    if max_batches:
        batches = itertools.islice(batches, max_batches)
    for consumed, n, steps, staged in gat_megafeed(batches, device, k,
                                                   batch_size=batch_size,
                                                   axis=axis):
        yield megastep(*staged)["running_nd"], n, consumed, steps


_METRICS = ("loss_num", "denorm_num", "acc", "prec", "rec")
# a batch's sums over its samples: what the ranks of a data axis add up
_SUMS = ("loss_num", "denorm_num", "acc", "tp", "fp", "fn", "n")


def test(eval_step, loader, device, *, axis: DataAxis | None = None):
    """Validation-set evaluation (the reference's ``test``). With a data
    ``axis``, each batch's threshold comes from the whole global batch
    (every rank holds it), each rank evaluates its rows, and the batch's
    sums (``_SUMS``) are added over the ranks before its precision and
    recall are formed: those are not sums over shards."""
    power = float(getattr(loader, "power", 1.0))
    norm_max = float(getattr(loader, "normalizing_max", 1.0))

    def prepare(item):
        x, y = item
        n = len(x)
        if n <= 1:
            return n, None, None
        unique = np.unique(np.asarray(y, np.float32) ** (1.0 / power))
        threshold = float(unique[int(len(unique) * 0.5)])
        if axis is not None:
            rows = axis.rows(n)
            x, y = x[rows], y[rows]
        return n, threshold, to_device_batch(x, y, device)

    pending, total = [], 0  # metric sums stay on the card; one fetch
    for n, threshold, batch in Prefetcher(iter(loader), depth=2,
                                          transfer=prepare):
        if n <= 1:
            continue
        out = eval_step(*batch, threshold, norm_max, power=power)
        pending.append(torch.stack([out[k] for k in _SUMS]))
        total += n
    rows = []
    if pending:
        sums = torch.stack(pending)
        if axis is not None:
            axis.all_reduce(sums)
        loss_num, denorm_num, acc, tp, fp, fn, n_valid = sums.unbind(1)
        rows = torch.stack([loss_num, denorm_num, acc,
                            tp / (tp + fp) * n_valid,
                            tp / (tp + fn) * n_valid], 1).tolist()
    sums = dict.fromkeys(_METRICS, 0.0)
    for row in rows:
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
