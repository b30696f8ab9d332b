"""Zero-copy sliding-window segmentation (port of
``extended_gan_tpu/data/windowing.py``)."""

from __future__ import annotations

import numpy as np


def sliding_windows(data: np.ndarray, window: int) -> np.ndarray:
    """All overlapping windows along axis 0.

    (N, ...) -> view of shape (N - window + 1, window, ...).
    """
    if len(data) < window:
        return np.empty((0, window) + data.shape[1:], data.dtype)
    view = np.lib.stride_tricks.sliding_window_view(data, window, axis=0)
    # sliding_window_view puts the window axis last; bring it to axis 1
    return np.moveaxis(view, -1, 1)


def truncate_to_multiple(data: np.ndarray, m: int) -> np.ndarray:
    """data[: (len//m)*m]."""
    return data[: (len(data) // m) * m]
