"""One trained experiment's prediction grid (port of
``convolutional_gat/plot_image.py``).

  python -m extended_gan_torch.plot_image <experiment_dir>
      [--preprocessed-folder DIR] [--dataset kmni] [--split test]
      [--downsample-size 20 20] [--raininess 0.5] [--epoch 1] [--out DIR]
      [--device cpu]

Loads the model of ``<experiment_dir>/config.py`` with the weights of
``<experiment_dir>/model.pt`` (what ``python -m extended_gan_torch.gat
generate_experiment`` writes into ``--output-path``, beside a copy of the
experiment's ``config.py``), finds the first sample of the split whose
rainy-pixel fraction reaches ``--raininess``, and saves its 3-row (x, y,
prediction) x 4-frame grid as ``<out>/pred_{epoch}.png`` through
``utils/viz.py``, the figure the training driver draws each epoch. The
prediction runs on ``--device`` (the card by default); without
matplotlib the figure prints its not-drawn line and nothing is written. A
missing KNMI archive falls back to the synthetic one.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m extended_gan_torch.plot_image")
    parser.add_argument("experiment_dir")
    parser.add_argument("--preprocessed-folder", type=str, default="")
    parser.add_argument("--dataset", type=str, default="kmni")
    parser.add_argument("--split", choices=("train", "val", "test"),
                        default="test")
    parser.add_argument("--downsample-size", type=int, nargs=2,
                        default=None,
                        help="crop geometry (default: the experiment "
                             "config's DOWNSAMPLE_SIZE)")
    parser.add_argument("--raininess", type=float, default=0.5,
                        help="minimum rainy-pixel fraction of the sample "
                             "to plot")
    parser.add_argument("--epoch", type=int, default=1,
                        help="label and output file suffix (pred_N.png)")
    parser.add_argument("--out", type=str, default="",
                        help="output directory (default: the experiment "
                             "dir)")
    parser.add_argument("--device", default=None,
                        help="default: the CUDA card; 'cpu' to predict on "
                             "the CPU")
    args = parser.parse_args(argv)

    from .compare_models.__main__ import load_experiment_model
    from .core.device import resolve_device
    from .data.streaming import get_loaders
    from .train.gat_trainer import predict_batch
    from .utils.config import load_experiment_config
    from .utils.viz import visualize_gat_predictions

    cfg = load_experiment_config(args.experiment_dir)
    size = tuple(args.downsample_size or cfg.downsample_size)
    dataset = args.dataset
    folder = args.preprocessed_folder or cfg.preprocessed_folder
    if dataset == "kmni" and not os.path.isdir(os.path.join(folder, "train")):
        print(f"[plot_image] dataset not found at {folder!r}; "
              "using synthetic")
        dataset, folder = "synthetic", ""

    def split():
        loaders = get_loaders(2, 2, folder, dataset=dataset,
                              downsample_size=size, shuffle=False)
        return dict(zip(("train", "val", "test"), loaders))[args.split]

    x, _ = next(iter(split()))
    _, w, h, t, v = x.shape
    device = resolve_device(args.device)
    if not os.path.exists(os.path.join(args.experiment_dir, "model.pt")):
        raise SystemExit(f"no checkpoint at {args.experiment_dir}/model.pt; "
                         "train the experiment first (generate_experiment "
                         "--output-path)")
    model = load_experiment_model(args.experiment_dir, image_width=w,
                                  image_height=h, n_vertices=v,
                                  time_steps=t, device=device, seed=cfg.seed)
    out_dir = args.out or args.experiment_dir
    os.makedirs(out_dir, exist_ok=True)
    loader = split()  # fresh: the probe took a batch
    path = visualize_gat_predictions(
        lambda xb: predict_batch(model, xb, device), loader,
        epoch=args.epoch, path=out_dir, raininess_threshold=args.raininess,
        power=float(getattr(loader, "power", 1.0)))
    if path is None:
        print(f"[plot_image] no grid written (no sample with raininess >= "
              f"{args.raininess} in the {args.split} split, or no "
              "matplotlib)")
    else:
        print(f"[plot_image] wrote {path}")
    return path


if __name__ == "__main__":
    main()
