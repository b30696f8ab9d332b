"""Preemption-safe training: a snapshot on SIGTERM (port of
``extended_gan_tpu/train/preempt.py``).

A preemptible machine gets SIGTERM and a grace window before the hard kill.
Both drivers poll a :class:`GracefulShutdown` after every train step (after
every group of K steps under a megastep): a caught SIGTERM stops the epoch
there and the driver writes a full resumable checkpoint (weights, optimizer
and scheduler state, the random streams, the epoch, and the ``mid``
subtree: the batches consumed in the epoch and its partial metric sums).
``resume`` then rebuilds the epoch's loader, replays past the consumed
batches (the same random draws) and continues bit for bit as an
uninterrupted run would. The grace window has to cover one step (or one
group) plus one save, not the rest of an epoch.

The handler only sets a flag: the step in flight finishes, and the
snapshot is written after it, from the host. It installs from the main
thread only (``signal.signal`` raises elsewhere); anywhere else it is a
no-op whose flag never sets, so the drivers still run from worker threads.
"""

from __future__ import annotations

import signal


class GracefulShutdown:
    """Context manager that turns SIGTERM into a polled flag,
    ``requested``."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._signals = signals
        self._prev: dict = {}
        self.requested = False

    def _handler(self, signum, frame):
        print(f"[preempt] caught signal {signum}; checkpointing and exiting "
              "after the current step")
        self.requested = True

    def __enter__(self) -> "GracefulShutdown":
        for s in self._signals:
            try:
                self._prev[s] = signal.signal(s, self._handler)
            except ValueError:
                pass  # not the main thread: the flag never sets
        return self

    def __exit__(self, *exc) -> bool:
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()
        return False


class AnyRankShutdown:
    """A :class:`GracefulShutdown` seen by every rank of a data axis
    (``parallel.DataAxis``): ``requested`` is set on all of them as soon
    as any rank caught the signal, so every rank stops after the same
    step. Each read is one all-reduce, and every rank reads at the same
    points of the loop."""

    def __init__(self, shutdown: GracefulShutdown, axis):
        self.shutdown, self.axis = shutdown, axis

    @property
    def requested(self) -> bool:
        return self.axis.any(self.shutdown.requested)


def any_rank_shutdown(shutdown: GracefulShutdown, axis):
    """``shutdown`` seen by every rank of ``axis`` (:class:`AnyRankShutdown`);
    ``shutdown`` itself on an axis of one."""
    return AnyRankShutdown(shutdown, axis) if axis.distributed else shutdown
