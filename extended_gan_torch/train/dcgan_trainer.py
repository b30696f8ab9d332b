"""DCGAN adversarial trainer (port of the default step of
``extended_gan_tpu/train/dcgan_trainer.py``).

One train step keeps the reference's update order:

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
neither computes nor accumulates the discriminators'.

The JAX package pads a ragged last batch to a fixed shape and masks it; the
port feeds it as it comes (its BatchNorm sees no padding). Loaders yield
(B, T, 1, H, W) frames, which go to the card as (B, T, H, W): frames are
the channels. Every per-step log stays on the device until one fetch at the
end of the pass.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import to_device
from ..data.streaming import Prefetcher
from ..utils.metrics import (
    IncrementalTuple,
    MetricsManager,
    batch_metrics,
    rounded_match_nd,
)
from .losses import bce

PRED_METRICS = ("accuracy", "precision", "recall", "mse")


def to_nchw(a: np.ndarray) -> np.ndarray:
    """(B, T, 1, H, W) or (B, T, H, W) -> (B, T, H, W)."""
    return a.squeeze(2) if a.ndim == 5 else a


def make_dcgan_train_step(g, fd, td, g_opt, fd_opt, td_opt):
    """``step(x, y) -> logs``: one adversarial step on a (B, nc, H, W)
    batch. The logs are device tensors: the three losses ``errFD``,
    ``errTD``, ``errG`` and the (num, denom) pairs ``train_mse_nd``,
    ``fd_acc_nd`` and ``td_acc_nd`` (predictions that round to the label,
    real and fake together)."""
    g_params = list(g.parameters())

    def step(x, y):
        for net in (g, fd, td):
            net.train()
        fd_opt.zero_grad(set_to_none=True)
        td_opt.zero_grad(set_to_none=True)
        # 1) real
        p_rf, p_rt = fd(y), td(torch.cat([x, y], 1))
        err_fd_real, err_td_real = bce(p_rf, 1.0), bce(p_rt, 1.0)
        (err_fd_real + err_td_real).backward()
        # 2) fake, 3) detached fake
        fake = g(x)
        fake_sg = fake.detach()
        p_ff, p_ft = fd(fake_sg), td(torch.cat([x, fake_sg], 1))
        err_fd_fake, err_td_fake = bce(p_ff, 0.0), bce(p_ft, 0.0)
        (err_fd_fake + err_td_fake).backward()
        # 4)
        fd_opt.step()
        td_opt.step()
        # 5) through the updated discriminators, 6)
        err_g = bce(fd(fake), 1.0) + bce(td(torch.cat([x, fake], 1)), 1.0)
        for p, grad in zip(g_params, torch.autograd.grad(err_g, g_params)):
            p.grad = grad
        g_opt.step()
        with torch.no_grad():
            ones, zeros = torch.ones_like(p_rf), torch.zeros_like(p_rf)
            return {
                "errFD": err_fd_real + err_fd_fake,
                "errTD": err_td_real + err_td_fake,
                "errG": err_g.detach(),
                "train_mse_nd": torch.stack([((fake - y) ** 2).sum(),
                                             y.new_tensor(float(y.numel()))]),
                "fd_acc_nd": rounded_match_nd(p_rf, ones)
                + rounded_match_nd(p_ff, zeros),
                "td_acc_nd": rounded_match_nd(p_rt, ones)
                + rounded_match_nd(p_ft, zeros),
            }

    return step


def make_dcgan_eval_step(g, fd, td):
    """``eval_step(x, y) -> (fake, logs)`` in eval mode (BatchNorm's running
    statistics, no dropout), without gradients. The logs are (num, denom)
    pairs: ``fd_acc_nd`` and ``td_acc_nd`` (the reference's accuracy
    metric on the discriminators' outputs against label 1 for real and 0
    for fake, one sample's denominator a call) and ``pred_{name}`` for the
    frame metrics of :data:`PRED_METRICS`."""

    @torch.no_grad()
    def eval_step(x, y):
        for net in (g, fd, td):
            net.eval()
        fake = g(x)
        p_rf, p_rt = fd(y), td(torch.cat([x, y], 1))
        p_ff, p_ft = fd(fake), td(torch.cat([x, fake], 1))
        ones, zeros = torch.ones_like(p_rf), torch.zeros_like(p_rf)

        def acc(p, label):
            return batch_metrics(("accuracy",), label, p)["accuracy"]

        logs = {"fd_acc_nd": acc(p_rf, ones) + acc(p_ff, zeros),
                "td_acc_nd": acc(p_rt, ones) + acc(p_ft, zeros)}
        for name, nd in batch_metrics(PRED_METRICS, y, fake).items():
            logs[f"pred_{name}"] = nd
        return fake, logs

    return eval_step


def dcgan_feed(loader, device, *, depth=2):
    """Background feed of (x, y) batches on ``device``, frames as
    channels."""
    def prepare(item):
        return tuple(to_device(to_nchw(a), device) for a in item)

    return Prefetcher(iter(loader), depth=depth, transfer=prepare)


def _fetch(pending: list[dict], keys: tuple[str, ...]) -> np.ndarray:
    """The (num, denom) pairs of ``keys`` from every step's logs, in one
    copy from the device: (steps, keys, 2) float64."""
    if not pending:
        return np.zeros((0, len(keys), 2))
    return torch.stack([torch.stack([logs[k] for k in keys])
                        for logs in pending]).cpu().numpy().astype(np.float64)


def train_single_epoch(*, dataloader, step, device, log_every: int = 50):
    """One epoch of train steps; prints the losses every ``log_every``
    steps. Returns ``train_mse``, ``train_fd_accuracy`` and
    ``train_td_accuracy``."""
    pending = []
    for i, (x, y) in enumerate(dcgan_feed(dataloader, device)):
        logs = step(x, y)
        pending.append(logs)
        if i % log_every == 0:
            print(f"Loss_FD: {float(logs['errFD']):.4f}\t"
                  f"Loss_TD: {float(logs['errTD']):.4f}\t"
                  f"Loss_G: {float(logs['errG']):.4f}\t")
    pred = MetricsManager(("mse",), prefix="train")
    acc_fd, acc_td = IncrementalTuple(), IncrementalTuple()
    for mse, fd_nd, td_nd in _fetch(
            pending, ("train_mse_nd", "fd_acc_nd", "td_acc_nd")):
        pred.metrics["mse"] += IncrementalTuple(mse)
        acc_fd += IncrementalTuple(fd_nd)
        acc_td += IncrementalTuple(td_nd)
    return pred.results() | {"train_fd_accuracy": acc_fd.item(),
                             "train_td_accuracy": acc_td.item()}


def test(dataloader, eval_step, device):
    """Eval metrics over ``dataloader``: ``frame_disc_accuracy``,
    ``temp_disc_accuracy`` and ``pred_{accuracy,precision,recall,mse}``
    (the reference's figure of the first batch is not ported)."""
    fd_m = MetricsManager(("accuracy",), prefix="frame_disc")
    td_m = MetricsManager(("accuracy",), prefix="temp_disc")
    pred = MetricsManager(PRED_METRICS, prefix="pred")
    keys = ("fd_acc_nd", "td_acc_nd") + tuple(f"pred_{n}"
                                              for n in PRED_METRICS)
    pending = [eval_step(x, y)[1] for x, y in dcgan_feed(dataloader, device)]
    for row in _fetch(pending, keys):
        fd_m.update_from_nd({"accuracy": row[0]})
        td_m.update_from_nd({"accuracy": row[1]})
        pred.update_from_nd(dict(zip(PRED_METRICS, row[2:])))
    return fd_m.results() | td_m.results() | pred.results()
