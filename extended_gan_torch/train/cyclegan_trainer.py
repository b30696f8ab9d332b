"""CycleGAN trainer (port of ``extended_gan_tpu/train/cyclegan_trainer.py``).

Two generators, G_xy (context frames -> future frames) and G_yx (future ->
context), the DCGAN ``Generator``; two ``FrameDiscriminator`` s, D_x on
context frames and D_y on future ones. One train step:

1. the generators in train mode: ``fake_y = G_xy(x)``, ``fake_x = G_yx(y)``
   and the cycle forwards ``G_yx(fake_y)`` and ``G_xy(fake_x)``;
2. the discriminators in eval mode (their running statistics) judge the
   fakes; the loss is BCE(D_y(fake_y), 1) + BCE(D_x(fake_x), 1) plus
   ``cycle_lambda`` times L1(G_yx(fake_y), x) + L1(G_xy(fake_x), y);
3. one Adam step each for the generators, from gradients taken for their
   parameters alone (``torch.autograd.grad``): the discriminators get
   none from this loss;
4. each discriminator in train mode on its real batch, then on the
   detached fake of step 1 (the generators' before their update); the
   loss is the mean of BCE(real, 1) and BCE(fake, 0) for each, summed;
5. one Adam step each for the discriminators.

BatchNorm running statistics, as JAX keeps them: each generator's move once
a step, with its forward on the real input. The cycle forwards normalise
with their batch's statistics, as every train-mode forward does, but leave
the running ones alone (``state.running_stats_frozen``): the JAX step
drops their ``batch_stats``. The discriminators' move twice a step, real
batch then fake batch, in step 4; the eval forwards of step 2 leave them.

Channel dropout: the four generator forwards draw from the generators'
``dropout_generator`` (the driver's ``KeySeq`` on the card), in the order
above; JAX splits its step key into four. Both sides draw different masks
for the same seed.

Losses and metrics are masked as JAX's (a mask of 0 marks a padded row):
``bce`` and ``l1`` average over the real rows, and ``train_mse_nd`` is
(sum of (fake_y - y)^2 over the real rows, real rows x the elements of
one sample). Single steps take a ragged last batch as it comes (no mask),
as the port's DCGAN trainer does; the megastep pads it
(``dcgan_trainer._megafeed``), as JAX pads every batch.
"""

from __future__ import annotations

import math

import torch

from ..parallel.fsdp import reduce_grads, working
from ..utils.metrics import IncrementalTuple
from .dcgan_trainer import dcgan_feed, draw_batch, fetch_nd
from .losses import bce, l1
from .megastep import Megastep
from .state import batchnorms, running_stats_frozen

LOSS_KEYS = ("g_loss", "adv_loss", "cycle_loss", "d_x_loss", "d_y_loss")


def _ones_like_rows(y, mask):
    return torch.ones(len(y), device=y.device) if mask is None else mask


def _mse_nd(fake_y, y, m):
    m4 = m.reshape((-1,) + (1,) * (y.dim() - 1))
    return torch.stack([((fake_y - y) ** 2 * m4).sum(),
                        m.sum() * math.prod(y.shape[1:])])


def make_cyclegan_train_step(g_xy, g_yx, d_x, d_y, g_xy_opt, g_yx_opt,
                             d_x_opt, d_y_opt, *, cycle_lambda: float = 10.0,
                             axis=None):
    """``step(x, y, mask=None) -> logs``: one CycleGAN step on (B, nc, H, W)
    context and future frames. The logs are device tensors: the five losses
    of :data:`LOSS_KEYS` and ``train_mse_nd``. Nothing in the step copies
    from the host, so a CUDA graph can capture it.

    With a data ``axis`` of more than one rank (the nets attached to it),
    ``step(x, y, mask=None, n=None)`` takes this rank's rows of a global
    batch of ``n`` (default: this rank's times the axis size), as
    ``dcgan_trainer.make_dcgan_train_step`` does: the masked means divide
    by the global count, the four generator forwards draw the global
    batch's dropout masks, the generators' gradients are summed over the
    ranks in one all-reduce before their Adam steps, the discriminators'
    in another before theirs, and the logs are the global ones. Under FSDP
    (``parallel/fsdp.py``) the nets' sharded leaves are read through their
    working weights and reduce-scattered in the same two places."""
    # the tensors the forwards read: an FSDP shard's working weight
    g_params = [working(g_xy.parameters()), working(g_yx.parameters())]
    d_params = working(list(d_x.parameters()) + list(d_y.parameters()))
    g_bns = batchnorms(g_xy, g_yx)
    dp = axis is not None and axis.parallel

    def step(x, y, mask=None, n=None):
        if not dp:
            return body(x, y, mask, None)
        if mask is None:
            mask = torch.ones(len(y), device=y.device)
        count = axis.all_reduce(mask.sum())
        with axis.global_batch(len(y) * axis.size if n is None else n):
            return body(x, y, mask, count)

    def body(x, y, mask, count):
        # 1-3) the generators, against the discriminators' running stats
        g_xy.train()
        g_yx.train()
        d_x.eval()
        d_y.eval()
        fake_y = g_xy(x)
        fake_x = g_yx(y)
        with running_stats_frozen(g_bns):
            cyc_x = g_yx(fake_y)
            cyc_y = g_xy(fake_x)
        adv = (bce(d_y(fake_y), 1.0, mask=mask, count=count)
               + bce(d_x(fake_x), 1.0, mask=mask, count=count))
        cyc = (l1(cyc_x, x, mask=mask, count=count)
               + l1(cyc_y, y, mask=mask, count=count))
        g_loss = adv + cycle_lambda * cyc
        grads = torch.autograd.grad(g_loss, g_params[0] + g_params[1])
        for p, grad in zip(g_params[0] + g_params[1], grads):
            p.grad = grad
        g_logs = torch.stack([g_loss, adv, cyc]).detach()
        if dp:
            g_logs = reduce_grads(axis, g_params[0] + g_params[1], g_logs)
        g_xy_opt.step()
        g_yx_opt.step()
        # 4-5) the discriminators, on the detached fakes
        d_x.train()
        d_y.train()
        d_x_opt.zero_grad(set_to_none=True)
        d_y_opt.zero_grad(set_to_none=True)
        fake_x, fake_y = fake_x.detach(), fake_y.detach()
        d_x_loss = (bce(d_x(x), 1.0, mask=mask, count=count)
                    + bce(d_x(fake_x), 0.0, mask=mask, count=count)) / 2.0
        d_y_loss = (bce(d_y(y), 1.0, mask=mask, count=count)
                    + bce(d_y(fake_y), 0.0, mask=mask, count=count)) / 2.0
        (d_x_loss + d_y_loss).backward()
        with torch.no_grad():
            d_logs = torch.cat([
                torch.stack([d_x_loss, d_y_loss]),
                _mse_nd(fake_y, y, _ones_like_rows(y, mask))])
        if dp:
            d_logs = reduce_grads(axis, d_params, d_logs)
        d_x_opt.step()
        d_y_opt.step()
        return {"g_loss": g_logs[0], "adv_loss": g_logs[1],
                "cycle_loss": g_logs[2], "d_x_loss": d_logs[0],
                "d_y_loss": d_logs[1], "train_mse_nd": d_logs[2:4]}

    return step


def make_cyclegan_megastep(g_xy, g_yx, d_x, d_y, g_xy_opt, g_yx_opt,
                           d_x_opt, d_y_opt, *, cycle_lambda: float = 10.0,
                           generators=(), axis=None):
    """K CycleGAN steps a call (``megastep(xs, ys, masks) -> logs``, a
    leading K axis on each): one CUDA graph on the card, K eager steps on
    the CPU, over the data ``axis`` as the step is.
    ``generators``: the dropout's generators on the card. Logs: the five
    losses of the last step, ``train_mse_nd`` summed over the K."""
    opts = (g_xy_opt, g_yx_opt, d_x_opt, d_y_opt)
    return Megastep(make_cyclegan_train_step(g_xy, g_yx, d_x, d_y, *opts,
                                             cycle_lambda=cycle_lambda,
                                             axis=axis),
                    optimizers=opts, generators=generators, axis=axis)


def make_cyclegan_eval_step(g_xy, g_yx):
    """``eval_step(x, y, mask=None) -> (fake_y, logs)`` in eval mode,
    without gradients: ``fake_y = G_xy(x)`` and the cycle ``G_yx(fake_y)``;
    the logs are the (num, denom) pairs ``pred_mse_nd`` (squared error of
    fake_y) and ``cycle_l1_nd`` (absolute error of the cycle against x),
    over the real rows."""

    @torch.no_grad()
    def eval_step(x, y, mask=None):
        g_xy.eval()
        g_yx.eval()
        fake_y = g_xy(x)
        cyc_x = g_yx(fake_y)
        m = _ones_like_rows(y, mask)
        m4 = m.reshape((-1,) + (1,) * (y.dim() - 1))
        mse = _mse_nd(fake_y, y, m)
        return fake_y, {"pred_mse_nd": mse,
                        "cycle_l1_nd": torch.stack([
                            ((cyc_x - x).abs() * m4).sum(), mse[1]])}

    return eval_step


def eval_results(pending: list[dict], axis=None) -> dict:
    """``pred_mse`` and ``cycle_l1`` from every eval step's (or resident
    program's) logs (with a data ``axis``, summed over the ranks)."""
    pred, cycle = IncrementalTuple(), IncrementalTuple()
    for mse, l1_nd in fetch_nd(pending, ("pred_mse_nd", "cycle_l1_nd"),
                               axis=axis):
        pred += IncrementalTuple(mse)
        cycle += IncrementalTuple(l1_nd)
    return {"pred_mse": pred.item(), "cycle_l1": cycle.item()}


def test(dataloader, eval_step, device, *, img_path=None, epoch=None,
         axis=None):
    """The eval over one loader pass: ``{"pred_mse", "cycle_l1"}``, the
    sums fetched once; with ``img_path``, the first batch's figure (JAX
    ``cyclegan_trainer.py:224-231``). With a data ``axis`` each rank
    evaluates its rows and the sums are added over the ranks."""
    pending = []
    for i, (x, y, _) in enumerate(dcgan_feed(dataloader, device, axis=axis)):
        fake_y, logs = eval_step(x, y)
        pending.append(logs)
        if i == 0 and img_path is not None:
            draw_batch(x, y, fake_y, epoch, img_path)
    return eval_results(pending, axis)


# the console line of every ``log_every``-th step
# (``dcgan_trainer.step_logs``)
LOSS_LABELS = (("Loss_G", "g_loss"), ("cycle", "cycle_loss"),
               ("Loss_DX", "d_x_loss"), ("Loss_DY", "d_y_loss"))
# the (num, denom) pairs an epoch sums (``dcgan_trainer.train_single_epoch``)
TRAIN_SUMS = ("train_mse_nd",)
