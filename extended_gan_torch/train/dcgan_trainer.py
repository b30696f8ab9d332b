"""DCGAN adversarial trainer (port of
``extended_gan_tpu/train/dcgan_trainer.py``).

The default train step keeps the reference's update order:

1. FrameDiscriminator (FD) and TemporalDiscriminator (TD) gradients on the
   real batch, against label 1;
2. ``fake = G(x)``, once;
3. FD and TD gradients on ``fake.detach()``, against label 0, added to 1.;
4. one Adam step each for FD and TD;
5. G's gradients through the UPDATED discriminators, against label 1;
6. the G Adam step.

G's forward runs once and step 5 back-propagates through it, as the
reference's torch code does and as the JAX package's ``dedup_g`` body does
(which it proves equal to its default body, ``tests/test_dedup_g.py``); so
G's channel dropout draws one mask a step, and its BatchNorm running
statistics take one update. FD's and TD's take three: real, detached fake,
then the fake for G. Step 5 asks autograd for G's gradients alone, so it
neither computes nor accumulates the discriminators'. The JAX package's
other bodies, ``fused_disc`` and ``fused_prop`` and the two together, are
options of :func:`make_dcgan_train_step`.

The JAX package pads a ragged last batch to a fixed shape and masks it; the
port's single steps take it as it comes (its BatchNorm sees no padding).
The megastep (K steps a CUDA graph, ``train/megastep.py``) needs fixed
shapes as JAX's does, so :func:`_megafeed` pads the short batch with zero
rows and a mask of zeros, and the step's losses and metrics are masked as
JAX's are; train-mode BatchNorm sees the padded rows there, as in JAX.
Loaders yield (B, T, 1, H, W) frames, which go to the card as (B, T, H, W):
frames are the channels. Every per-step log stays on the device until one
fetch at the end of the pass.
"""

from __future__ import annotations

import contextlib
import json
import math

import numpy as np
import torch

from ..core.device import to_device
from ..data.streaming import Prefetcher
from ..utils.metrics import (
    IncrementalTuple,
    MetricsManager,
    masked_batch_metrics,
    masked_rounded_match_nd,
)
from ..utils.viz import visualize_predictions
from ..parallel.fsdp import reduce_grads, working
from .gat_trainer import pad_batch
from .losses import bce
from .megastep import Megastep

PRED_METRICS = ("accuracy", "precision", "recall", "mse")


def to_nchw(a: np.ndarray) -> np.ndarray:
    """(B, T, 1, H, W) or (B, T, H, W) -> (B, T, H, W)."""
    return a.squeeze(2) if a.ndim == 5 else a


def _add_grads(params, grads):
    """Adds ``grads`` into the parameters' ``.grad`` (sets it where none is
    there yet)."""
    for p, grad in zip(params, grads):
        if p.grad is None:
            p.grad = grad
        else:
            p.grad.add_(grad)


def make_dcgan_train_step(g, fd, td, g_opt, fd_opt, td_opt, *,
                          fused_disc=False, fused_prop=False, axis=None):
    """``step(x, y, mask=None) -> logs``: one adversarial step on a (B, nc,
    H, W) batch; ``mask`` (B,) holds 1 for a real sample and 0 for padding,
    whose losses and metrics then count for nothing (no mask: every sample
    counts, and the losses are the plain means). The logs are device
    tensors: the three losses ``errFD``, ``errTD``, ``errG`` and the (num,
    denom) pairs ``train_mse_nd``, ``fd_acc_nd`` and ``td_acc_nd``
    (predictions that round to the label, real and fake together). Nothing
    in the step copies from the host, so a CUDA graph can capture it.

    The body is picked here, once, as JAX picks its step body
    (``dcgan_trainer.py:111-215``, ``:366-554``):

    - default: the six stages of the module docstring;
    - ``fused_disc``: one doubled-batch pass per discriminator over the
      real rows, then the detached fake rows. Deviations, as in JAX: the
      discriminators' BatchNorm statistics mix real and fake rows, and
      their running statistics take one update where two were; TD's
      dropout draws one mask over the 2B rows. The four BCE halves are
      summed into one backward. Stage 5 is unchanged.
    - ``fused_prop`` (FusedProp, arxiv 2004.03335): D on the real batch as
      before, then one fake chain G -> FD, TD, not detached, and two pulls
      back through it before any optimizer step: the fake rows' BCE
      against 0 to the discriminators' parameters, against 1 to G's. So G
      trains against the pre-update discriminators, FD's and TD's running
      statistics take two updates (real, fake), and TD draws one mask for
      the fake rows. As in the vanilla step (``train/adversarial.py``) the
      port makes two ``autograd.grad`` pulls with ``retain_graph``, each
      asking only for the leaves it needs, where JAX makes one vmapped
      pull of two cotangents.
    - both: one doubled-batch chain [real; fake] per discriminator, one
      pull of the D losses (real against 1, fake against 0) to D's
      parameters and one of the fake rows' G loss to G's.

    JAX's ``dedup_g`` body (G's forward once, step 5 pulled back through
    it) is the port's default body, so JAX's refusal of ``fused_prop``
    with ``dedup_g`` (``:172-173``) has no counterpart here.

    With a data ``axis`` of more than one rank (the nets attached to it by
    ``parallel.attach_data_axis``), (x, y, mask) are this rank's rows
    (``DataAxis.rows``; maybe none) of a global batch of ``n`` rows
    (default: this rank's times the axis size, the even shards of a
    megastep), as JAX's step runs on a batch sharded over its mesh: every
    masked BCE mean divides by the global count of real rows, BatchNorm's
    statistics run over the global batch, the dropout masks are the global
    batch's (``DataAxis.global_batch``), D's gradients are summed over the
    ranks in one flat all-reduce before ``fd_opt`` and ``td_opt`` step
    (stage 4) and G's in another before ``g_opt`` steps (under FusedProp
    both in one, after the second pull). The logs are the global ones: the
    losses and the train sums ride along in those all-reduces. Nets with
    FSDP shards (``parallel/fsdp.py``) are read through their working
    weights, whose gradients are reduce-scattered to the shards in the
    same places; each optimizer's step re-gathers its net, so stage 5 reads
    the updated discriminators."""
    # the tensors the forwards read: an FSDP shard's working weight
    g_params = working(g.parameters())
    d_params = working(list(fd.parameters()) + list(td.parameters()))
    dp = axis is not None and axis.parallel

    def doubled(x, y, fake, n):
        """(p_rf, p_rt, p_ff, p_ft) from one pass per discriminator over
        [real rows; ``fake`` rows]."""
        b = len(y)
        p_f = fd(torch.cat([y, fake]))
        with (axis.global_batch(n, copies=2) if dp
              else contextlib.nullcontext()):
            p_t = td(torch.cat([torch.cat([x, y], 1),
                                torch.cat([x, fake], 1)]))
        return p_f[:b], p_t[:b], p_f[b:], p_t[b:]

    def train_sums(fake, y, m, p_rf, p_ff, p_rt, p_ft):
        m4 = m.reshape(-1, 1, 1, 1)
        return torch.cat([
            torch.stack([((fake - y) ** 2 * m4).sum(),
                         m.sum() * math.prod(y.shape[1:])]),
            masked_rounded_match_nd(p_rf, 1.0, m)
            + masked_rounded_match_nd(p_ff, 0.0, m),
            masked_rounded_match_nd(p_rt, 1.0, m)
            + masked_rounded_match_nd(p_ft, 0.0, m)])

    def body(x, y, mask, n, count):
        def loss(p, label):
            if count is None:
                return bce(p, label, mask=mask)
            return bce(p, label, mask=mask, count=count)

        for net in (g, fd, td):
            net.train()
        fd_opt.zero_grad(set_to_none=True)
        td_opt.zero_grad(set_to_none=True)
        if fused_disc:
            # 2) fake, then 1) and 3) as one doubled-batch pass
            fake = g(x)
            p_rf, p_rt, p_ff, p_ft = doubled(
                x, y, fake if fused_prop else fake.detach(), n)
        else:
            # 1) real
            p_rf, p_rt = fd(y), td(torch.cat([x, y], 1))
        err_fd_real = loss(p_rf, 1.0)
        err_td_real = loss(p_rt, 1.0)
        if not fused_disc:
            (err_fd_real + err_td_real).backward()
            # 2) fake, 3) the fake rows (detached unless FusedProp)
            fake = g(x)
            fake_d = fake if fused_prop else fake.detach()
            p_ff, p_ft = fd(fake_d), td(torch.cat([x, fake_d], 1))
        err_fd_fake = loss(p_ff, 0.0)
        err_td_fake = loss(p_ft, 0.0)
        d_fake = err_fd_fake + err_td_fake
        err_d = torch.stack([err_fd_real + err_fd_fake,
                             err_td_real + err_td_fake]).detach()
        m = torch.ones(len(y), device=y.device) if mask is None else mask
        if fused_prop:
            # both pulls before any optimizer step: G against the
            # pre-update discriminators
            err_g = loss(p_ff, 1.0) + loss(p_ft, 1.0)
            d_loss = (err_fd_real + err_td_real + d_fake if fused_disc
                      else d_fake)
            _add_grads(d_params, torch.autograd.grad(d_loss, d_params,
                                                     retain_graph=True))
            g_grads = torch.autograd.grad(err_g, g_params)
            for p, grad in zip(g_params, g_grads):
                p.grad = grad
            with torch.no_grad():
                sums = torch.cat([err_d, err_g.detach().reshape(1),
                                  train_sums(fake, y, m, p_rf, p_ff, p_rt,
                                             p_ft)])
            if dp:
                sums = reduce_grads(axis, d_params + g_params, sums)
            fd_opt.step()
            td_opt.step()
        else:
            if fused_disc:
                (err_fd_real + err_td_real + d_fake).backward()
            else:
                d_fake.backward()
            if dp:
                err_d = reduce_grads(axis, d_params, err_d)
            # 4)
            fd_opt.step()
            td_opt.step()
            # 5) through the updated discriminators
            err_g = loss(fd(fake), 1.0) + loss(td(torch.cat([x, fake], 1)),
                                                1.0)
            g_grads = torch.autograd.grad(err_g, g_params)
            for p, grad in zip(g_params, g_grads):
                p.grad = grad
            with torch.no_grad():
                sums = torch.cat([err_g.detach().reshape(1),
                                  train_sums(fake, y, m, p_rf, p_ff, p_rt,
                                             p_ft)])
            if dp:
                sums = reduce_grads(axis, g_params, sums)
            sums = torch.cat([err_d, sums])
        # 6)
        g_opt.step()
        return {"errFD": sums[0], "errTD": sums[1], "errG": sums[2],
                "train_mse_nd": sums[3:5], "fd_acc_nd": sums[5:7],
                "td_acc_nd": sums[7:9]}

    def step(x, y, mask=None, n=None):
        if not dp:
            return body(x, y, mask, None, None)
        if mask is None:
            mask = torch.ones(len(y), device=y.device)
        count = axis.all_reduce(mask.sum())
        n = len(y) * axis.size if n is None else n
        with axis.global_batch(n):
            return body(x, y, mask, n, count)

    return step


def make_dcgan_megastep(g, fd, td, g_opt, fd_opt, td_opt, *, generators=(),
                        fused_disc=False, fused_prop=False, axis=None):
    """K adversarial steps a call (``megastep(xs, ys, masks) -> logs``, a
    leading K axis on each): one CUDA graph on the card, K eager steps on
    the CPU; the step is :func:`make_dcgan_train_step`'s body, with its
    ``fused_disc``, ``fused_prop`` and data ``axis`` (each row of the
    inputs this rank's even share of a padded global batch,
    :func:`_megafeed`). ``generators``: the dropout's generators on the
    card. Logs: the three losses of the last step, the ``*_nd`` pairs
    summed over the K."""
    return Megastep(make_dcgan_train_step(g, fd, td, g_opt, fd_opt, td_opt,
                                          fused_disc=fused_disc,
                                          fused_prop=fused_prop, axis=axis),
                    optimizers=(g_opt, fd_opt, td_opt), generators=generators,
                    axis=axis)


def make_dcgan_eval_step(g, fd, td):
    """``eval_step(x, y, mask=None) -> (fake, logs)`` in eval mode
    (BatchNorm's running statistics, no dropout), without gradients. The
    logs are (num, denom) pairs: ``fd_acc_nd`` and ``td_acc_nd`` (the
    reference's accuracy metric on the discriminators' outputs against
    label 1 for real and 0 for fake, one sample's denominator a call) and
    ``pred_{name}`` for the frame metrics of :data:`PRED_METRICS`; a sample
    whose ``mask`` entry is 0 adds nothing."""

    @torch.no_grad()
    def eval_step(x, y, mask=None):
        """With a data axis, (x, y, mask) may be this rank's rows: the
        logs are sums, which :func:`eval_results` adds over the ranks."""
        for net in (g, fd, td):
            net.eval()
        fake = g(x)
        p_rf, p_rt = fd(y), td(torch.cat([x, y], 1))
        p_ff, p_ft = fd(fake), td(torch.cat([x, fake], 1))
        ones, zeros = torch.ones_like(p_rf), torch.zeros_like(p_rf)

        def acc(p, label):
            return masked_batch_metrics(("accuracy",), label, p,
                                        mask)["accuracy"]

        logs = {"fd_acc_nd": acc(p_rf, ones) + acc(p_ff, zeros),
                "td_acc_nd": acc(p_rt, ones) + acc(p_ft, zeros)}
        for name, nd in masked_batch_metrics(PRED_METRICS, y, fake,
                                             mask).items():
            logs[f"pred_{name}"] = nd
        return fake, logs

    return eval_step


def dcgan_feed(loader, device, *, axis=None, depth=2):
    """Background feed of (x, y, n) on ``device``, frames as channels:
    the batch, or with a data ``axis`` this rank's rows of it
    (``DataAxis.rows``; maybe none), and the global batch's size ``n``."""
    def prepare(item):
        x, y = (to_nchw(a) for a in item)
        n = len(x)
        if axis is not None:
            x, y = axis.shard(x), axis.shard(y)
        return to_device(x, device), to_device(y, device), n

    return Prefetcher(iter(loader), depth=depth, transfer=prepare)


def fetch_nd(pending: list[dict], keys: tuple[str, ...], *, axis=None,
             once=()) -> np.ndarray:
    """The (num, denom) pairs of ``keys`` from every step's logs, in one
    copy from the device: (steps, keys, 2) float64. With a data ``axis``
    each rank's logs are its rows' sums, added over the ranks in one
    all-reduce; the keys of ``once`` count their denominator on rank 0
    alone (the reference's accuracy divides by one sample's size once a
    batch, whatever its rows)."""
    if not pending:
        return np.zeros((0, len(keys), 2))
    nd = torch.stack([torch.stack([logs[k] for k in keys])
                      for logs in pending])
    if axis is not None and axis.parallel:
        nd = nd.clone()
        if axis.rank:
            nd[:, [keys.index(k) for k in once], 1] = 0.0
        axis.all_reduce(nd)
    return nd.cpu().numpy().astype(np.float64)


def _megafeed(loader, device, batch_size: int, k: int, *, axis=None,
              depth=2):
    """Background feed of K loader batches a yield, for
    :func:`make_dcgan_megastep`: ``(k_actual, (xs, ys, masks))``, each with
    a leading axis of ``k_actual`` (K, or fewer at the epoch's tail), on
    ``device``; every batch padded to ``batch_size`` rows by
    ``gat_trainer.pad_batch``. (This loader drops nothing, so ``k_actual``
    counts the batches drawn too.) With a data ``axis`` the batches are
    padded to the next multiple of its size, as JAX's ``put_batch`` pads
    them, and each rank takes its even share of every one."""
    if axis is not None:
        batch_size = axis.padded_batch_size(batch_size)

    def grouped():
        buf = []
        for item in loader:
            buf.append(item)
            if len(buf) == k:
                yield buf
                buf = []
        if buf:
            yield buf

    def prepare(buf):
        padded = [pad_batch(to_nchw(x), to_nchw(y), batch_size)
                  for x, y in buf]
        stacked = (np.stack(a) for a in zip(*padded))
        if axis is not None:
            stacked = (axis.shard(a, 1) for a in stacked)
        return len(buf), tuple(to_device(a, device) for a in stacked)

    return Prefetcher(grouped(), depth=depth, transfer=prepare)


DCGAN_LOSS_LABELS = (("Loss_FD", "errFD"), ("Loss_TD", "errTD"),
                     ("Loss_G", "errG"))


def step_logs(dataloader, step, device, *, log_every: int = 50,
              labels=DCGAN_LOSS_LABELS, axis=None):
    """Single train steps over ``dataloader``, yielding (the step's logs,
    1 batch) a step; prints the losses ``labels`` names, (label, log key)
    each, every ``log_every`` steps. With a data ``axis`` each step takes
    this rank's rows of the batch as it comes (a ragged last batch may
    leave a rank none) and the global batch's size."""
    for i, (x, y, n) in enumerate(dcgan_feed(dataloader, device, axis=axis)):
        logs = step(x, y) if axis is None else step(x, y, None, n)
        if i % log_every == 0:
            print("\t".join(f"{label}: {float(logs[key]):.4f}"
                            for label, key in labels))
        yield logs, 1


def megastep_logs(dataloader, megastep, device, k: int, batch_size: int, *,
                  axis=None):
    """Groups of K batches of ``dataloader`` (:func:`_megafeed`, padded to
    ``batch_size``; with a data ``axis``, this rank's rows) through
    ``megastep``, yielding (the group's logs, its loader batches) a
    group."""
    for k_actual, staged in _megafeed(dataloader, device, batch_size, k,
                                      axis=axis):
        yield megastep(*staged), k_actual


DCGAN_TRAIN_SUMS = ("train_mse_nd", "fd_acc_nd", "td_acc_nd")
# each summed log's name in the v3 ``mid`` subtree and in the results
_SUM_NAMES = {"train_mse_nd": ("mse", "train_mse"),
              "fd_acc_nd": ("fd_acc", "train_fd_accuracy"),
              "td_acc_nd": ("td_acc", "train_td_accuracy")}


def train_single_epoch(logs, *, keys=DCGAN_TRAIN_SUMS, shutdown=None,
                       init_metrics=None, epoch=None, profiler=None):
    """One epoch's train metrics from ``logs``, (a train step's or a
    group's logs, the batches it counts for ``mid``) each
    (:func:`step_logs`, :func:`megastep_logs` or the resident programs),
    summing the (num, denom) pairs of ``keys`` (the CycleGAN's logs have
    ``train_mse_nd`` alone).

    Returns ``(results, None)``: ``train_mse``, and ``train_fd_accuracy``
    and ``train_td_accuracy`` where they are summed; or, when
    ``shutdown.requested`` is seen after a step (a group), ``(None,
    mid)``: the v3 ``mid`` subtree of the batches consumed so far and the
    epoch's partial (num, denom) sums (zeros for a pair not summed), which
    a resumed run passes back as ``init_metrics`` (JAX
    ``dcgan_trainer.py:696-795``). With a ``profiler``
    (``utils/profiling.EpochProfiler``) the epoch is timed up to the fetch
    of its sums, and its stats join the results (JAX ``:720-806``)."""
    sums = {k: IncrementalTuple() for k in keys}
    n_done = 0
    if init_metrics is not None and int(init_metrics["batch"]) > 0:
        n_done = int(init_metrics["batch"])
        for k in keys:
            sums[k] += IncrementalTuple(init_metrics[_SUM_NAMES[k][0]].numpy())
    if profiler is not None:
        profiler.start_epoch()
    pending, interrupted = [], False
    for item, n in logs:
        pending.append(item)
        n_done += n
        if shutdown is not None and shutdown.requested:
            interrupted = True
            break
    for row in fetch_nd(pending, keys):
        for k, nd in zip(keys, row):
            sums[k] += IncrementalTuple(nd)
    if interrupted:
        print(f"[preempt] epoch {epoch} interrupted after {n_done} batches")
        mid = {"batch": torch.tensor(n_done, dtype=torch.int64)}
        for k, (name, _) in _SUM_NAMES.items():
            mid[name] = torch.from_numpy(
                sums[k].val.copy() if k in sums else np.zeros(2))
        return None, mid
    results = {_SUM_NAMES[k][1]: sums[k].item() for k in keys}
    if profiler is not None:
        prof_stats = profiler.end_epoch()
        print(f"Step timing: {json.dumps(prof_stats)}")
        results |= prof_stats
    return results, None


_EVAL_KEYS = ("fd_acc_nd", "td_acc_nd") + tuple(f"pred_{n}"
                                                for n in PRED_METRICS)


def eval_results(pending: list[dict], axis=None) -> dict:
    """The eval metrics from every eval step's logs, fetched at once (with
    a data ``axis``, summed over the ranks): ``frame_disc_accuracy``,
    ``temp_disc_accuracy`` and ``pred_{accuracy,precision,recall,mse}``."""
    fd_m = MetricsManager(("accuracy",), prefix="frame_disc")
    td_m = MetricsManager(("accuracy",), prefix="temp_disc")
    pred = MetricsManager(PRED_METRICS, prefix="pred")
    for row in fetch_nd(pending, _EVAL_KEYS, axis=axis, once=(
            "fd_acc_nd", "td_acc_nd", "pred_accuracy")):
        fd_m.update_from_nd({"accuracy": row[0]})
        td_m.update_from_nd({"accuracy": row[1]})
        pred.update_from_nd(dict(zip(PRED_METRICS, row[2:])))
    return fd_m.results() | td_m.results() | pred.results()


def draw_batch(x, y, fake, epoch, img_path):
    """``<img_path>/pred.png`` of a batch of (N, T, H, W) tensors (frames as
    channels), brought to the host (``utils/viz.py``)."""
    visualize_predictions(*(t.float().cpu().numpy() for t in (x, y, fake)),
                          epoch, img_path)


def test(dataloader, eval_step, device, *, img_path=None, epoch=None,
         axis=None):
    """Eval metrics over ``dataloader`` (:func:`eval_results`); with
    ``img_path``, the first batch's figure (JAX ``dcgan_trainer.py:
    832-842``). With a data ``axis`` each rank evaluates its rows of every
    batch and the sums are added over the ranks."""
    pending = []
    for i, (x, y, _) in enumerate(dcgan_feed(dataloader, device, axis=axis)):
        fake, logs = eval_step(x, y)
        pending.append(logs)
        if i == 0 and img_path is not None:
            draw_batch(x, y, fake, epoch, img_path)
    return eval_results(pending, axis)
