"""Train state (port of ``extended_gan_tpu/train/state.py``).

The JAX package carries a net's parameters, BatchNorm statistics and
optimizer moments as one functional ``NetState``. In PyTorch they live in
the module and the optimizer, so :class:`NetState` only bundles the two
(and a learning-rate scheduler, where there is one) and gives a checkpoint
their state tree: ``{"model", "optimizer"[, "scheduler"]}``.

A flax step returns a forward's new ``batch_stats`` and may drop them (the
CycleGAN's cycle forwards, a recomputed forward under ``jax.checkpoint``);
a torch BatchNorm in train mode writes its running statistics in place.
:func:`running_stats_frozen` is the port's way to drop them.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch


@dataclasses.dataclass
class NetState:
    """One net, its optimizer and, optionally, its scheduler."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: Any = None

    def state_dict(self) -> dict:
        tree = {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict()}
        if self.scheduler is not None:
            tree["scheduler"] = self.scheduler.state_dict()
        return tree

    def load_state_dict(self, tree: dict):
        """Loads a checkpoint's tree into the running objects. The running
        optimizer keeps its own ``capturable`` flag (an eager run's
        checkpoint resumes under CUDA graphs and the reverse), and Adam's
        step count goes where that optimizer keeps it: on the card when
        capturable, else on the CPU."""
        self.model.load_state_dict(tree["model"])
        load_optimizer_state(self.optimizer, tree["optimizer"])
        if self.scheduler is not None and "scheduler" in tree:
            self.scheduler.load_state_dict(tree["scheduler"])


def load_optimizer_state(opt: torch.optim.Optimizer, saved: dict):
    """``opt.load_state_dict(saved)`` with ``opt``'s own ``capturable``
    flag (``Optimizer.load_state_dict`` takes the flag, and with it where
    ``step`` lives, from the file)."""
    groups = [{**saved_g, "capturable": g["capturable"]}
              if "capturable" in g else dict(saved_g)
              for g, saved_g in zip(opt.param_groups, saved["param_groups"])]
    opt.load_state_dict({**saved, "param_groups": groups})


def report_in_sync(axis, modules, optimizers):
    """On a data axis of more than one rank: raises unless every rank ends
    with the same train state, bit for bit (``DataAxis.check_in_sync``),
    and prints how much was compared."""
    if axis.parallel:
        n = axis.check_in_sync(modules, optimizers)
        print(f"[data axis] {axis.size} ranks in sync: {n} tensors of the "
              "train state bit for bit")


def param_count(module: torch.nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


def batchnorms(*modules: torch.nn.Module) -> list:
    """Every BatchNorm layer of ``modules``."""
    return [m for mod in modules for m in mod.modules()
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]


@contextlib.contextmanager
def running_stats_frozen(bns):
    """Train-mode BatchNorm that normalises with the batch's statistics
    and saves for its backward what a plain pass saves, but leaves the
    running statistics as they are: momentum 0 keeps them bit for bit
    (running * 1 + batch * 0), and with no batch counter there is none to
    advance."""
    saved = [(m.momentum, m.num_batches_tracked) for m in bns]
    for m in bns:
        m.momentum, m.num_batches_tracked = 0.0, None
    try:
        yield
    finally:
        for m, (momentum, tracked) in zip(bns, saved):
            m.momentum, m.num_batches_tracked = momentum, tracked
