"""Holding the train state of one run to a reference run of the same steps.

Where the steps repeat bit for bit, the run is held to ``limit``: each
tensor's L2 gap at most ``limit`` times its scale. Where they do not (an op
that adds with atomics in an order that changes from run to run), further
runs of the reference's steps measure the run-to-run drift (:func:`drift`;
the widest of several samples, :func:`widest`), and each tensor ``i`` is
held to the largest of

- ``limit``,
- ``margin`` times its own drift,
- ``margin`` times the whole state's relative drift,

all in units of its scale: the larger of ``||want_i||`` and the state's RMS
entry times ``sqrt(numel_i)``, so that a tensor that is zero, or rounding
noise, in the reference (a bias ahead of a BatchNorm) is measured against
the state's typical entry and not against itself. One sample of a small
tensor's drift (a loss sum, a BatchNorm of one channel) can read far below
its typical size, so the floor should be the widest of several samples.
"""

from __future__ import annotations

import math

import torch


def _gaps(got, want) -> tuple[list[float], float]:
    """Each pair's L2 gap in units of the reference tensor's scale, and the
    whole state's relative L2 gap."""
    got = [g.detach().double() for g in got]
    want = [w.detach().double() for w in want]
    if len(got) != len(want):
        raise ValueError(f"{len(got)} tensors against {len(want)}")
    total = math.sqrt(sum(float((w * w).sum()) for w in want))
    rms = total / math.sqrt(max(sum(w.numel() for w in want), 1))
    diffs = [float((g - w).norm()) for g, w in zip(got, want)]
    per = [d / max(float(w.norm()), rms * math.sqrt(w.numel()), 1e-30)
           for d, w in zip(diffs, want)]
    return per, math.sqrt(sum(d * d for d in diffs)) / max(total, 1e-30)


def drift(again, want) -> dict:
    """How far ``again``, another run of the steps that gave ``want``, lies
    from it: ``per`` tensor in units of its scale, and the ``whole``
    state's relative gap."""
    per, whole = _gaps(again, want)
    return dict(per=per, whole=whole)


def widest(drifts) -> dict:
    """The largest of several drifts of the same tensors, tensor by
    tensor."""
    drifts = list(drifts)
    return dict(per=[max(col) for col in zip(*(d["per"] for d in drifts))],
                whole=max(d["whole"] for d in drifts))


def held_to_reference(got, want, floor: dict | None = None, *,
                      limit: float = 1e-6, margin: float = 10.0) -> dict:
    """``got`` and ``want``: lists of tensors in one order; ``floor``: a
    :func:`drift` of the same tensors, or the :func:`widest` of several.
    Returns ``ok`` (every tensor within its bound), ``bitwise`` (``got``
    equals ``want`` exactly), ``worst`` (the largest gap over its bound;
    ``ok`` is ``worst <= 1``), ``at`` (that tensor's index), ``gap`` (the
    largest gap in units of scale) and ``floor`` (the whole state's
    relative drift; 0 without ``floor``)."""
    rel, _ = _gaps(got, want)
    per = floor["per"] if floor else [0.0] * len(rel)
    whole = floor["whole"] if floor else 0.0
    ratio = [r / max(limit, margin * f, margin * whole)
             for r, f in zip(rel, per)]
    at = max(range(len(ratio)), key=ratio.__getitem__, default=None)
    worst = ratio[at] if ratio else 0.0
    return dict(ok=worst <= 1.0, worst=worst, at=at,
                gap=max(rel, default=0.0), floor=whole,
                bitwise=all(torch.equal(a, b) for a, b in zip(got, want)))
