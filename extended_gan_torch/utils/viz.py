"""Prediction figures (port of ``extended_gan_tpu/utils/viz.py``).

- :func:`visualize_predictions`: input, GT and pred rows by frame columns
  of the first sample, ``pred.png`` (JAX ``:25-47``);
- :func:`visualize_gat_predictions`: the first sample whose raininess
  reaches the threshold, x, y and pred rows by 4 frame columns of vertex
  1, ``pred_{epoch}.png`` (JAX ``:50-93``).

Inputs are frames-first numpy arrays, (B, T, H, W) and (B, H, W, T, V).
The arrays a figure shows are computed before anything is drawn (on the
card, where the caller's ``predict_fn`` runs there) and brought to the
host; only the drawing needs matplotlib, which is imported when a figure
is drawn, never when this module is. Where it cannot be imported (the
card's machine has none), a figure call prints one line, ``[viz]
matplotlib is not installed: <path> not drawn``, writes nothing and
returns None, as :func:`visualize_gat_predictions` does when no sample
qualifies; the run's numbers and files are untouched.
"""

from __future__ import annotations

import os

import numpy as np


def pyplot():
    """``matplotlib.pyplot``, with the Agg backend forced only when
    nothing else chose one (no display, no ``MPLBACKEND``; JAX
    ``utils/history.py:15-19``); None when matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError:
        return None
    if not os.environ.get("DISPLAY") and not os.environ.get("MPLBACKEND"):
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def not_drawn(path: str):
    print(f"[viz] matplotlib is not installed: {path} not drawn")


def visualize_predictions(x, y, preds, epoch=1, path="", show_plot=False):
    """x, y, preds: (B, T, H, W). Saves ``<path>/pred.png`` and returns
    its path (None without matplotlib)."""
    save_path = os.path.join(path, "pred.png")
    to_plot = [np.asarray(x[0]), np.asarray(y[0]), np.asarray(preds[0])]
    plt = pyplot()
    if plt is None:
        not_drawn(save_path)
        return None
    if path != "" and not os.path.exists(path):
        os.makedirs(path, exist_ok=True)
    n_frames = to_plot[0].shape[0]
    _, ax = plt.subplots(nrows=len(to_plot), ncols=n_frames)
    ax = np.atleast_2d(ax)
    plt.suptitle(f"Epoch {epoch}")
    for i, row in enumerate(ax):
        for j, col in enumerate(row):
            col.imshow(to_plot[i][j])
    for ax_, row in zip(ax[:, 0], ["input", "GT", "pred"]):
        ax_.set_ylabel(row)
    for ax_, col in zip(ax[0, :], [f"F{i}" for i in range(n_frames)]):
        ax_.set_title(col)
    if not show_plot:
        plt.savefig(save_path)
    else:  # pragma: no cover
        plt.show()
    plt.close()
    return save_path


def gat_prediction_panels(predict_fn, loader, *,
                          raininess_threshold: float = 0.5,
                          power: float = 1.0):
    """The three (H, W, T, V) arrays :func:`visualize_gat_predictions`
    shows: x, y and the prediction of the first sample whose raininess
    (its share of x above 0) reaches the threshold, each to the power
    ``1 / power``; None when no sample does. ``predict_fn(x_batch)`` runs
    on the whole batch holding that sample."""
    for x, y in loader:
        for k in range(len(x)):
            raininess = float((x[k] > 0.0).sum()) / x[k].size
            if raininess < raininess_threshold:
                continue
            preds = np.asarray(predict_fn(x))
            return [np.power(np.asarray(v), 1.0 / power)
                    for v in (x[k], y[k], preds[k])]
    return None


def draw_gat_predictions(panels, *, epoch: int = 1, path: str = ""):
    """``pred_{epoch}.png`` of :func:`gat_prediction_panels`'s arrays: 3
    rows by 4 frame columns of vertex 1 (JAX ``viz.py:74-93``); its path,
    or None without matplotlib."""
    save_path = os.path.join(path, f"pred_{epoch}.png")
    plt = pyplot()
    if plt is None:
        not_drawn(save_path)
        return None
    plt.clf()
    n_cols = 4
    _fig, ax = plt.subplots(nrows=3, ncols=n_cols)
    plt.title(f"Epoch {epoch}")
    v_idx = min(1, panels[0].shape[-1] - 1)
    for i, row in enumerate(ax):
        for j, col in enumerate(row):
            col.imshow(panels[i][:, :, j, v_idx])
    for ax_, label in zip(ax[:, 0], ["x", "y", "preds"]):
        ax_.set_ylabel(label)
    for ax_, label in zip(ax[0, :], [f"frame{i+1}" for i in range(n_cols)]):
        ax_.set_title(label)
    plt.savefig(save_path)
    plt.close()
    return save_path


def visualize_gat_predictions(predict_fn, loader, *, epoch: int = 1,
                              path: str = "",
                              raininess_threshold: float = 0.5,
                              power: float = 1.0, draw: bool = True):
    """Finds the first sample with raininess >= threshold and saves its x,
    y and pred rows by 4 frame columns of vertex 1 as
    ``<path>/pred_{epoch}.png`` (the reference's ``utils.py:74-98``).
    ``predict_fn(x_batch) -> preds`` over (B, H, W, T, V) arrays. Returns
    the path, or None when no sample qualifies (with JAX's line) or
    matplotlib is missing. ``draw=False`` runs ``predict_fn`` alone (a
    data-parallel rank that joins the forward but writes nothing)."""
    panels = gat_prediction_panels(predict_fn, loader,
                                   raininess_threshold=raininess_threshold,
                                   power=power)
    if not draw:
        return None
    if panels is None:
        print("Raininess threshold too strict, hasn't found anything")
        return None
    return draw_gat_predictions(panels, epoch=epoch, path=path)
