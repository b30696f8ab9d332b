"""Cross-rank BatchNorm: train-mode statistics over the global batch.

In a JAX step over a ``data`` mesh axis, BatchNorm's batch statistics are
reductions over the whole sharded batch, so every shard normalises with
the global batch's mean and variance and the running statistics follow
the global batch (``tests/test_data_parallel.py`` holds JAX to that). The
port's data-parallel ranks each hold a shard, so their train-mode
BatchNorm combines the shards' statistics:

- the forward gathers each rank's per-channel count, mean and M2 (the
  sum of squared deviations from its own mean: no raw sums of squares,
  whose difference loses the variance to roundoff) and combines them in
  rank order, in float64, the same way on every rank;
- the backward gathers the two per-channel sums it needs (of dy and of
  dy times the normalised input) and forms dx from the global ones; the
  weight's and bias's gradients stay this rank's share, which the
  trainer's gradient all-reduce sums;
- the running variance is unbiased over the global count.

Both collectives are all-reduces of one slot a rank (``DataAxis.
gather_rows``), so one code runs on gloo (CPU) and NCCL (card). A rank
with no rows joins them with a count of 0. ``torch.nn.SyncBatchNorm``
refuses CPU tensors, which the tests need.

:func:`attach_data_axis` turns every ``nn.BatchNorm2d`` of a model into a
:class:`BatchNorm2d` that reads the axis (the same object, parameters and
buffers, so a state_dict is unchanged) and gives the model's
``PerVertexBatchNorm2d`` layers the axis too; with an axis of one rank
both are ``nn.BatchNorm2d``'s forward itself, bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .mesh import DataAxis


def _dims(x):
    return (0,) + tuple(range(2, x.dim()))


def _channel(v, x):
    return v.reshape((1, -1) + (1,) * (x.dim() - 2))


class _CrossRankBatchNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum,
                eps, axis):
        c = x.shape[1]
        count = x.numel() // c if c else 0
        if count:
            mean = x.mean(_dims(x))
            m2 = ((x - _channel(mean, x)) ** 2).sum(_dims(x))
        else:
            mean, m2 = x.new_zeros(c), x.new_zeros(c)
        slots = axis.gather_rows(torch.stack(
            [mean.new_full((c,), float(count)), mean, m2])).double()
        n, means, m2s = slots[:, 0], slots[:, 1], slots[:, 2]
        total = n.sum(0)
        g_mean = (n * means).sum(0) / total
        g_m2 = (m2s + n * (means - g_mean) ** 2).sum(0)
        invstd = (g_m2 / total + eps).rsqrt()
        if running_mean is not None:
            with torch.no_grad():
                unbiased = g_m2 / (total - 1)
                running_mean.mul_(1 - momentum).add_(
                    g_mean.to(running_mean.dtype), alpha=momentum)
                running_var.mul_(1 - momentum).add_(
                    unbiased.to(running_var.dtype), alpha=momentum)
        mean32, invstd32 = g_mean.to(x.dtype), invstd.to(x.dtype)
        x_hat = (x - _channel(mean32, x)) * _channel(invstd32, x)
        y = x_hat
        if weight is not None:
            y = x_hat * _channel(weight, x) + _channel(bias, x)
        ctx.save_for_backward(x_hat, invstd32, weight, total.to(x.dtype))
        ctx.axis = axis
        return y

    @staticmethod
    def backward(ctx, dy):
        x_hat, invstd, weight, total = ctx.saved_tensors
        dims = _dims(dy)
        sum_dy = dy.sum(dims)
        sum_dy_xhat = (dy * x_hat).sum(dims)
        g = ctx.axis.gather_rows(torch.stack([sum_dy, sum_dy_xhat])) \
            .double().sum(0).to(dy.dtype)
        scale = invstd if weight is None else invstd * weight
        dx = (dy - _channel(g[0] / total, dy)
              - x_hat * _channel(g[1] / total, dy)) * _channel(scale, dy)
        dw = sum_dy_xhat if weight is not None else None
        db = sum_dy if weight is not None else None
        return dx, dw, db, None, None, None, None, None


def batch_norm(x, running_mean, running_var, weight, bias, training,
               momentum, eps, axis: DataAxis | None = None):
    """``F.batch_norm`` with train-mode statistics over ``axis``'s global
    batch; ``F.batch_norm`` itself on an axis of one or in eval mode."""
    if axis is None or not axis.parallel or not training:
        return F.batch_norm(x, running_mean, running_var, weight, bias,
                            training, momentum, eps)
    return _CrossRankBatchNorm.apply(x, weight, bias, running_mean,
                                     running_var, momentum, eps, axis)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train-mode statistics run over ``axis``
    (``nn.BatchNorm2d``'s own forward on an axis of one)."""

    axis: DataAxis | None = None

    def forward(self, x):
        if self.axis is None or not self.axis.parallel:
            return super().forward(x)
        self._check_input_dim(x)
        # nn.BatchNorm2d's bookkeeping: the running-average factor, the
        # batch counter (none under running_stats_frozen: momentum 0)
        factor = 0.0 if self.momentum is None else self.momentum
        if self.training and self.track_running_stats \
                and self.num_batches_tracked is not None:
            self.num_batches_tracked.add_(1)
            if self.momentum is None:
                factor = 1.0 / float(self.num_batches_tracked)
        training = self.training or (self.running_mean is None
                                     and self.running_var is None)
        keep = not self.training or self.track_running_stats
        return batch_norm(x, self.running_mean if keep else None,
                          self.running_var if keep else None, self.weight,
                          self.bias, training, factor, self.eps, self.axis)


def attach_data_axis(model: nn.Module, axis: DataAxis) -> nn.Module:
    """Every ``nn.BatchNorm2d`` of ``model`` reads ``axis`` from now on (as
    a :class:`BatchNorm2d`, in place), and so does every layer that takes
    an ``axis`` attribute (``PerVertexBatchNorm2d``); returns ``model``."""
    for m in model.modules():
        if type(m) is nn.BatchNorm2d:
            m.__class__ = BatchNorm2d
        if isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.axis = axis
    return model
