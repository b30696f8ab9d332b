"""Seeded random streams (port of ``extended_gan_tpu/core/prng.py``).

JAX threads explicit keys; the port draws from ``torch.Generator`` s.
:class:`KeySeq` is the counterpart of the JAX package's key stream: one
generator (on the CPU, or on the card for draws made there) whose state a
checkpoint carries, so a resumed run continues the stream instead of
restarting it from the seed.

- ``next()`` draws the seed of a new stream (a Python int) and advances;
- ``split(n)`` draws ``n`` of them at once;
- ``fold_in(data)`` derives one from the current state and ``data``
  without advancing;
- ``generator`` is the stream itself, for ops that take a generator (the
  DCGAN's channel dropout draws from it on the card);
- ``state`` is the generator's state tensor; ``KeySeq(state, device=...)``
  rebuilds the same stream from it.
"""

from __future__ import annotations

import hashlib

import torch

DEFAULT_SEED = 369  # the reference's seed


class KeySeq:
    """A stream of seeds from one ``torch.Generator`` on ``device``.

    >>> ks = KeySeq(369)
    >>> a, b = ks.next(), ks.next()   # distinct, fixed by the seed
    """

    def __init__(self, seed: int | torch.Tensor = DEFAULT_SEED, *,
                 device: str | torch.device = "cpu"):
        self.generator = torch.Generator(device=device)
        if isinstance(seed, torch.Tensor):
            self.generator.set_state(seed.to("cpu", torch.uint8))
        else:
            self.generator.manual_seed(int(seed))

    def next(self) -> int:
        return self.split(1)[0]

    def split(self, n: int) -> list[int]:
        dev = self.generator.device
        draws = torch.randint(0, 2**62, (n,), generator=self.generator,
                              device=dev, dtype=torch.int64)
        return [int(v) for v in draws.tolist()]

    def fold_in(self, data: int) -> int:
        digest = hashlib.sha256(self.state.numpy().tobytes()
                                + int(data).to_bytes(8, "little",
                                                     signed=True)).digest()
        return int.from_bytes(digest[:8], "little") >> 2

    @property
    def state(self) -> torch.Tensor:
        """The generator's state (a CPU uint8 tensor), for checkpoints."""
        return self.generator.get_state()

    @state.setter
    def state(self, value: torch.Tensor):
        self.generator.set_state(value.to("cpu", torch.uint8))
