"""Side-by-side prediction plots of saved models (port of
``convolutional_gat/create_plots.py``).

  python -m extended_gan_torch.create_plots <exp dir> <exp dir> ... \\
      [--out-file comparison_plot.png] [--preprocessed-folder <knmi>]

Each directory holds ``config.py`` and the port's ``model.pt``
(``compare_models.__main__.load_experiment_model``; a missing ``model.pt``
raises: a random init drawn under the experiment's name would mislead).
The first test sample whose target's share of nonzero entries reaches
0.3 is predicted by every model on the device (the card unless
``device="cpu"``), and ``comparison_plot.png`` shows the ground truth
against each model's four frames of vertex 1 (``utils/viz.py``: without
matplotlib it prints one line and draws nothing).
"""

from __future__ import annotations

import os
from argparse import ArgumentParser

import numpy as np

from .compare_models.__main__ import (
    loaders,
    load_experiment_model,
    multi_model_panels,
)
from .core.device import resolve_device
from .utils.viz import not_drawn, pyplot


def create_comparison_plot(experiment_dirs: list[str],
                           labels: list[str] | None = None, *,
                           preprocessed_folder: str = "",
                           dataset: str = "kmni", downsample_size=(20, 20),
                           out_file: str = "comparison_plot.png",
                           raininess_threshold: float = 0.3, seed: int = 369,
                           device=None):
    """Returns ``out_file``, or None when no sample is rainy enough (with
    JAX's line) or matplotlib is missing."""
    dev = resolve_device(device)
    if dataset == "kmni" and not os.path.isdir(
            os.path.join(preprocessed_folder, "train")):
        dataset, preprocessed_folder = "synthetic", ""
    labels = labels or [os.path.basename(d) for d in experiment_dirs]
    x0, _ = next(iter(loaders(preprocessed_folder, dataset,
                              downsample_size, seed)[1]))
    _, w, h, t, v = x0.shape
    entries = {d: load_experiment_model(
        d, image_width=w, image_height=h, n_vertices=v, time_steps=t,
        device=dev, seed=seed) for d in experiment_dirs}
    # a fresh loader: the probe took the first batch
    rows = multi_model_panels(
        loaders(preprocessed_folder, dataset, downsample_size, seed)[1],
        entries, dev, raininess_threshold)
    if rows is None:
        print("no sufficiently rainy sample found")
        return None
    plt = pyplot()
    if plt is None:
        not_drawn(out_file)
        return None
    _fig, ax = plt.subplots(nrows=len(rows), ncols=4)
    for i, row_ax in enumerate(np.atleast_2d(ax)):
        for j, col in enumerate(row_ax):
            v_idx = min(1, rows[i].shape[-1] - 1)
            col.imshow(rows[i][:, :, j, v_idx])
    for ax_, rl in zip(np.atleast_2d(ax)[:, 0], ["y"] + labels):
        ax_.set_ylabel(rl, fontsize=7)
    plt.savefig(out_file)
    plt.close()
    return out_file


def main(argv=None):
    parser = ArgumentParser(prog="python -m extended_gan_torch.create_plots")
    parser.add_argument("dirs", nargs="+")
    parser.add_argument("--out-file", type=str, default="comparison_plot.png")
    parser.add_argument("--preprocessed-folder", type=str, default="")
    parser.add_argument("--device", default=None,
                        help="default: the CUDA card; 'cpu' on request")
    args = parser.parse_args(argv)
    return create_comparison_plot(
        args.dirs, out_file=args.out_file,
        preprocessed_folder=args.preprocessed_folder, device=args.device)


if __name__ == "__main__":
    main()
