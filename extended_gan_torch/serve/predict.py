"""Batch prediction over a dataset split (port of ``scripts/predict.py``):
``python -m extended_gan_torch.serve predict``.

Loads a trained experiment (``config.py`` and the ``model.pt`` that
``python -m extended_gan_torch.gat`` writes), runs its eval step over a
split in order (no shuffle) on the card, unless ``--device cpu``, and
writes ``predictions`` and ``targets`` to an ``.npz``. A missing KNMI
archive falls back to the synthetic one. Prints and returns the JAX
script's summary: ``experiment``, ``split``, ``samples``, ``seconds``,
``samples_per_sec``, ``mse`` and ``out``.

  python -m extended_gan_torch.serve predict \\
      convolutional_gat/experiments/final_temp_conv --split test \\
      --out /tmp/preds.npz [--downsample-size 80 80] [--batch-size 64]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def add_arguments(parser: argparse.ArgumentParser):
    parser.add_argument("experiment_dir")
    parser.add_argument("--preprocessed-folder", dest="preprocessed_folder",
                        type=str, default="")
    parser.add_argument("--dataset", type=str, default="kmni")
    parser.add_argument("--split", choices=("train", "val", "test"),
                        default="test")
    parser.add_argument("--downsample-size", dest="downsample_size", type=int,
                        nargs=2, default=(20, 20))
    parser.add_argument("--batch-size", dest="batch_size", type=int,
                        default=64)
    parser.add_argument("--out", type=str, default="predictions.npz")
    parser.add_argument("--max-batches", dest="max_batches", type=int,
                        default=0)
    parser.add_argument("--device", default=None,
                        help="default: the CUDA card; 'cpu' to run on the CPU")


def predict(args) -> dict:
    """Run ``args`` (the flags of :func:`add_arguments`); returns the
    summary."""
    from ..core.device import resolve_device
    from ..data.streaming import get_loaders
    from ..models.registry import build_model
    from ..train.checkpoint import load_model
    from ..train.gat_trainer import make_gat_eval_step, to_device_batch
    from ..utils.config import load_experiment_config

    cfg = load_experiment_config(args.experiment_dir)
    dev = resolve_device(args.device)
    dataset = args.dataset
    folder = args.preprocessed_folder or cfg.preprocessed_folder
    if dataset == "kmni" and not os.path.isdir(os.path.join(folder, "train")):
        print(f"[predict] dataset not found at {folder!r}; using synthetic")
        dataset, folder = "synthetic", ""

    def split_loader():
        loaders = get_loaders(args.batch_size, args.batch_size, folder,
                              dataset=dataset,
                              downsample_size=tuple(args.downsample_size),
                              shuffle=False)
        return dict(zip(("train", "val", "test"), loaders))[args.split]

    probe_x, _ = next(iter(split_loader()))
    _, w, h, t, v = probe_x.shape
    model = build_model(cfg.model_type, image_width=w, image_height=h,
                        n_vertices=v, mapping_type=cfg.mapping_type,
                        time_steps=t, device=dev)
    ckpt = os.path.join(args.experiment_dir, "model.pt")
    if not os.path.exists(ckpt):
        raise SystemExit(f"no checkpoint at {ckpt}; train the experiment "
                         f"first (generate_experiment)")
    model.load_state_dict(load_model(ckpt, model.state_dict()))
    eval_step = make_gat_eval_step(model)

    preds, targets = [], []
    t0 = time.time()
    n = 0
    # a fresh loader: the probe took a batch
    for i, (x, y) in enumerate(split_loader()):
        if args.max_batches and i >= args.max_batches:
            break
        out = eval_step(*to_device_batch(x, y, dev), 0.5, 1.0, power=1.0)
        preds.append(out["y_hat"].cpu().numpy())  # waits for the card
        targets.append(np.asarray(y, np.float32))
        n += len(x)
    dt = time.time() - t0
    preds = np.concatenate(preds)
    targets = np.concatenate(targets)
    mse = float(((preds - targets) ** 2).mean())
    np.savez_compressed(args.out, predictions=preds, targets=targets)
    summary = {
        "experiment": args.experiment_dir,
        "split": args.split,
        "samples": int(n),
        "seconds": round(dt, 3),
        "samples_per_sec": round(n / dt, 2),
        "mse": mse,
        "out": args.out,
    }
    print(json.dumps(summary, indent=2))
    return summary

