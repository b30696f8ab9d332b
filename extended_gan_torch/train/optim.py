"""Optimizers and learning-rate schedules for conv-GAT training (port of
``extended_gan_tpu/train/optim.py``).

The JAX package re-creates torch's semantics in optax; the port uses
torch's own:

- ``torch.optim.Adam(weight_decay=...)`` adds the L2 term to the gradient
  before the moment updates, which is what the JAX package's
  ``add_decayed_weights`` before ``scale_by_adam`` reproduces;
- ``StepLR(step_size, gamma)`` and ``ReduceLROnPlateau(mode="min",
  factor=0.5, patience=0)``, whose default relative threshold of 1e-4 the
  JAX package's scheduler copies. Both step once an epoch, after the
  validation pass.
"""

from __future__ import annotations

import torch
from torch.optim.lr_scheduler import ReduceLROnPlateau, StepLR


def make_optimizer(name: str, params, learning_rate: float, *,
                   weight_decay: float = 0.0,
                   capturable: bool = False) -> torch.optim.Optimizer:
    """``adam`` (betas 0.9, 0.999; eps 1e-8) or ``sgd`` (no momentum).
    ``capturable``: Adam keeps its step count on the card, so a CUDA graph
    can capture its step (``train/megastep.py``); SGD needs nothing."""
    if name.lower() == "adam":
        return torch.optim.Adam(params, lr=learning_rate,
                                weight_decay=weight_decay,
                                capturable=capturable)
    if name.lower() == "sgd":
        return torch.optim.SGD(params, lr=learning_rate,
                               weight_decay=weight_decay)
    raise KeyError(f"unknown optimizer {name!r}; choose 'adam' or 'sgd'")


def make_scheduler(optimizer, *, reduce_lr_on_plateau: bool, lr_step: int,
                   gamma: float):
    if reduce_lr_on_plateau:
        return ReduceLROnPlateau(optimizer, mode="min", factor=0.5,
                                 patience=0)
    return StepLR(optimizer, step_size=lr_step, gamma=gamma)


def scheduler_step(scheduler, val_loss: float) -> float:
    """Advance one epoch; returns the learning rate for the next one."""
    if isinstance(scheduler, ReduceLROnPlateau):
        scheduler.step(val_loss)
    else:
        scheduler.step()
    return current_lr(scheduler.optimizer)


def current_lr(optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])
