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
``PerVertexBatchNorm2d`` layers, its subclasses of :class:`BatchNorm2d`
(the packed generator's ``_PackedBN``) and every other layer that declares
an ``axis`` attribute (the DCGAN's ``ConvBlock``, for its dropout draws)
the axis too; with an axis of one rank the BatchNorms are
``nn.BatchNorm2d``'s forward itself, bit for bit. A subclass of
``nn.BatchNorm2d`` that declares no ``axis`` would keep
``nn.BatchNorm2d``'s forward, local statistics, so it raises.
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


def _sums(*ts):
    """Per channel, float64: the sums of each of ``ts`` over the batch and
    the pixels (each sample's pixels summed in the tensors' type, the
    samples in float64, so no float64 copy of a tensor is made)."""
    return torch.stack([t.reshape(t.shape[0], t.shape[1], -1).sum(2)
                        for t in ts]).sum(1, dtype=torch.float64)


def _normalise(d, shift, mean, invstd):
    """x_hat = (x - mean) * invstd from ``d = x - shift`` (float32) and the
    float64 ``mean`` and ``invstd``: ``mean - shift`` is small against the
    spread, so it loses nothing to float32, where a mean rounded to
    float32 would shift every x_hat of a channel alike when the mean is
    large against the spread."""
    scale = invstd.to(d.dtype)
    offset = ((shift.double() - mean) * invstd).to(d.dtype)
    return torch.addcmul(_channel(offset, d), d, _channel(scale, d))


class _CrossRankBatchNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum,
                eps, axis):
        c = x.shape[1]
        count = x.numel() // c if c else 0
        # this rank's statistics from the differences to a shift near its
        # mean, so the mean's size costs them nothing: their variance and
        # mean in one pass (Welford's), in float32
        shift = x.mean(_dims(x)) if count else x.new_zeros(c)
        d = x - _channel(shift, x)
        if count:
            var, off = torch.var_mean(d, _dims(x), correction=0)
            mean = shift.double() + off.double()
            m2 = var.double() * count
        else:
            mean = m2 = x.new_zeros(c, dtype=torch.float64)
        slots = axis.gather_rows(torch.stack(
            [mean.new_full((c,), float(count)), mean, m2]))
        n, means, m2s = slots[:, 0], slots[:, 1], slots[:, 2]
        total = n.sum(0)
        g_mean = (n * means).sum(0) / total
        g_m2 = (m2s + n * (means - g_mean) ** 2).sum(0)
        invstd = (g_m2 / total + eps).rsqrt()
        # momentum 0 (``state.running_stats_frozen``) leaves them bit for
        # bit, as ``running * 1 + batch * 0`` does
        if running_mean is not None and momentum:
            with torch.no_grad():
                unbiased = g_m2 / (total - 1)
                running_mean.mul_(1 - momentum).add_(
                    g_mean.to(running_mean.dtype), alpha=momentum)
                running_var.mul_(1 - momentum).add_(
                    unbiased.to(running_var.dtype), alpha=momentum)
        x_hat = _normalise(d, shift, g_mean, invstd)
        y = x_hat
        if weight is not None:
            y = torch.addcmul(_channel(bias, x), x_hat, _channel(weight, x))
        ctx.save_for_backward(x_hat, invstd.to(x.dtype), weight, total)
        ctx.axis = axis
        return y

    @staticmethod
    def backward(ctx, dy):
        x_hat, invstd, weight, total = ctx.saved_tensors
        # float64 sums over the samples: dx is their small difference from
        # dy where dy is nearly affine in x_hat
        if dy.numel():
            sums = _sums(dy, dy * x_hat)
        else:
            sums = dy.new_zeros((2, dy.shape[1]), dtype=torch.float64)
        g = (ctx.axis.gather_rows(sums).sum(0) / total).to(dy.dtype)
        scale = invstd if weight is None else invstd * weight
        # (dy - g0 - x_hat g1) * scale, in two passes
        dx = torch.addcmul(_channel(-g[0] * scale, dy), dy,
                           _channel(scale, dy))
        dx.addcmul_(x_hat, _channel(-g[1] * scale, dy))
        dw = sums[1].to(dy.dtype) if weight is not None else None
        db = sums[0].to(dy.dtype) if weight is not None else None
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


def join_data_axis(axis: DataAxis, *models: nn.Module):
    """On an axis of more than one rank: each of ``models`` reads ``axis``
    (:func:`attach_data_axis`) and starts from rank 0's parameters and
    buffers, as DDP starts. Nothing on an axis of one."""
    if axis.parallel:
        for model in models:
            attach_data_axis(model, axis)
            axis.broadcast_module(model)


def attach_data_axis(model: nn.Module, axis: DataAxis) -> nn.Module:
    """Every ``nn.BatchNorm2d`` of ``model`` reads ``axis`` from now on (as
    a :class:`BatchNorm2d`, in place), and so does every layer that takes
    an ``axis`` attribute (``PerVertexBatchNorm2d``); returns ``model``."""
    for m in model.modules():
        if type(m) is nn.BatchNorm2d:
            m.__class__ = BatchNorm2d
        elif isinstance(m, nn.BatchNorm2d) and not hasattr(type(m), "axis"):
            raise TypeError(f"{type(m).__name__} subclasses nn.BatchNorm2d, "
                            "whose forward would normalise with this rank's "
                            "rows alone: make it subclass parallel."
                            "BatchNorm2d")
        if isinstance(m, nn.modules.batchnorm._BatchNorm) or hasattr(
                m, "axis"):
            m.axis = axis
    return model
