"""conv-GAT helpers of ``convolutional_gat/utils.py`` that no other module
of the port holds (the metrics are in ``utils/metrics.py``, the figures in
``utils/viz.py``)."""

from __future__ import annotations

import numpy as np


def model_persistence(x):
    """The last-input-frame persistence baseline on (B, H, W, T, V)
    batches: the last context frame repeated over the T steps."""
    last = np.asarray(x)[:, :, :, -1:, :]
    return np.repeat(last, x.shape[3], axis=3)
