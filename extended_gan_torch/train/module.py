"""A Lightning-style training module and its trainer (port of
``extended_gan_tpu/train/module.py``).

A :class:`TrainModule` says how to build its state and what one train and
one validation step do; :class:`Trainer` drives the epochs on one device.
In the JAX package the state is a pytree that the jitted step returns
anew; here it is whatever the module keeps (its nets and optimizers), and
a step may update it in place and return it.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.prng import KeySeq


class TrainModule:
    """Subclass and implement:

    - ``configure(generator, device) -> state``: build the nets and the
      optimizers, drawing from ``generator`` (a ``torch.Generator``);
    - ``training_step(state, batch, generator) -> (state, logs)``;
    - optionally ``validation_step(state, batch) -> logs``.

    ``batch`` is a tuple of tensors on the trainer's device."""

    def configure(self, generator: torch.Generator, device) -> Any:
        raise NotImplementedError

    def training_step(self, state, batch, generator):
        raise NotImplementedError

    def validation_step(self, state, batch):
        return {}


class Trainer:
    """Runs a module's epochs on ``device`` (default: the CUDA card).
    ``seed`` seeds the generator passed to ``configure`` and to every
    step; ``max_batches`` cuts each epoch."""

    def __init__(self, *, device=None, seed: int = 369, log_every: int = 50,
                 max_batches: int = 0):
        self.device = resolve_device(device)
        self.keys = KeySeq(seed, device=self.device)
        self.log_every = log_every
        self.max_batches = max_batches

    def _put(self, batch):
        return tuple(torch.as_tensor(np.asarray(a)).to(self.device)
                     for a in batch)

    def fit(self, module: TrainModule,
            train_data: Callable[[], Iterable],
            val_data: Callable[[], Iterable] | None = None, *,
            epochs: int = 1, state=None):
        """``(state, history)``: ``history`` holds each epoch's validation
        logs, averaged over its batches (an empty dict without
        ``val_data``)."""
        if state is None:
            state = module.configure(self.keys.generator, self.device)
        history = []
        for epoch in range(1, epochs + 1):
            for i, batch in enumerate(train_data()):
                if self.max_batches and i >= self.max_batches:
                    break
                state, logs = module.training_step(state, self._put(batch),
                                                   self.keys.generator)
                if i % self.log_every == 0:
                    msg = "\t".join(f"{k}: {float(v):.4f}"
                                    for k, v in logs.items())
                    print(f"[epoch {epoch}] {msg}")
            epoch_logs = {}
            if val_data is not None:
                accs: dict[str, list] = {}
                with torch.no_grad():
                    for batch in val_data():
                        for k, v in module.validation_step(
                                state, self._put(batch)).items():
                            accs.setdefault(k, []).append(float(v))
                epoch_logs = {k: float(np.mean(v)) for k, v in accs.items()}
            history.append(epoch_logs)
        return state, history
