"""Model comparison harness (port of
``convolutional_gat/compare_models/__main__.py``).

  python -m extended_gan_torch.compare_models --base-folder <dir> \\
      --folders <exp> <exp> ... --out-path <out> [--dataset kmni]

Each ``<base-folder>/<exp>`` is an experiment directory: its ``config.py``
(the JAX package's format) and the port's ``model.pt`` (what
``python -m extended_gan_torch.gat generate_experiment`` writes to
``--output-path``; copy the experiment's ``config.py`` beside it). The
harness rebuilds each model on the device (the card unless ``--device
cpu``), evaluates it on the test split with the training driver's
``test`` (a warm-up pass, then a timed one) and writes ``results.json``
(the metrics, ``forward_pass_time_s`` as the reference computes it, the
timed pass's total over 1000, ``eval_time_s`` and ``n_parameters``),
``results.html`` (``json_to_table``), ``multi_model_plot.png`` (the first
test sample with raininess >= 0.3, ground truth against each model's four
frames) and ``pred_0.png`` (the first model's prediction figure). The
predictions are computed on the device and drawn on the host
(``utils/viz.py``: without matplotlib each figure prints one line and
nothing is drawn). A missing ``model.pt`` raises, as a missing checkpoint
does in JAX. ``--out-path`` defaults to ``compare_models_results`` under
the working directory: the port writes nothing into the JAX package's
folders.
"""

from __future__ import annotations

import json
import os
import time
from argparse import ArgumentParser

import numpy as np
import torch

from ..core.device import resolve_device
from ..data.streaming import get_loaders
from ..models.registry import build_model
from ..train.checkpoint import load_model
from ..train.gat_trainer import make_gat_eval_step, predict_batch, test
from ..train.state import param_count
from ..utils.config import load_experiment_config
from ..utils.viz import not_drawn, pyplot, visualize_gat_predictions

DEFAULT_DATA = "/mnt/kmni_dataset/20_plus_preprocessed"


def load_experiment_model(data_folder: str, *, image_width: int,
                          image_height: int, n_vertices: int,
                          time_steps: int, device, seed: int = 369):
    """The model of ``<data_folder>/config.py`` on ``device`` with the
    weights of ``<data_folder>/model.pt``; raises when there is none."""
    cfg = load_experiment_config(data_folder)
    model = build_model(cfg.model_type, image_width=image_width,
                        image_height=image_height, n_vertices=n_vertices,
                        mapping_type=cfg.mapping_type, time_steps=time_steps,
                        device=device,
                        generator=torch.Generator().manual_seed(seed),
                        moe_experts=getattr(cfg, "moe_experts", 0))
    model_path = os.path.join(data_folder, "model.pt")
    if not os.path.exists(model_path):
        raise ValueError(f"error: {model_path}")
    model.load_state_dict(load_model(model_path, model.state_dict()))
    return model


def loaders(preprocessed_folder, dataset, downsample_size, seed,
            test_batch_size=2):
    """The harness's (train, test, validation) loaders: train batches of 2,
    test batches of ``test_batch_size``, shuffled within batches."""
    return get_loaders(2, test_batch_size, preprocessed_folder,
                       dataset=dataset,
                       downsample_size=tuple(downsample_size),
                       merge_nodes=False, shuffle=True, seed=seed)


def get_metrics(entries, device, preprocessed_folder, dataset,
                downsample_size, seed=369):
    """Each model's eval on the test split at batch 100, timed (the
    reference's ``:14-34``): a warm-up pass first, so the time is a
    steady pass's."""
    results = {}
    for folder, model in entries.items():
        eval_step = make_gat_eval_step(model)
        test(eval_step, loaders(preprocessed_folder, dataset,
                                downsample_size, seed, 100)[1], device)
        loader = loaders(preprocessed_folder, dataset, downsample_size,
                         seed, 100)[1]
        t0 = time.time()
        metrics = test(eval_step, loader, device)
        t1 = time.time()
        metrics["forward_pass_time_s"] = (t1 - t0) / 1000  # as the reference
        metrics["eval_time_s"] = t1 - t0
        metrics["n_parameters"] = param_count(model)
        results[folder] = metrics
    return results


def multi_model_panels(loader, entries, device, raininess_threshold=0.3):
    """The rows of ``multi_model_plot.png``: ground truth and each model's
    prediction (on ``device``) of the first sample whose target's share of
    nonzero entries reaches the threshold, each to the power ``1 /
    power``; None when no sample does."""
    power = float(getattr(loader, "power", 1.0))
    for x, y in loader:
        for k in range(len(x)):
            raininess = (y[k] != 0).sum() / y[k].size
            if raininess < raininess_threshold:
                continue
            preds = [predict_batch(model, x, device)[k]
                     for model in entries.values()]
            return [np.power(tp, 1 / power)
                    for tp in [np.asarray(y[k])] + preds]
    return None


def draw_multi_model(out_path, panels, folders):
    """``multi_model_plot.png``: the panels' rows by four frame columns
    of vertex 1 (the reference's ``:37-60``)."""
    save_path = os.path.join(out_path, "multi_model_plot.png")
    plt = pyplot()
    if plt is None:
        not_drawn(save_path)
        return None
    _fig, ax = plt.subplots(nrows=len(folders) + 1, ncols=4)
    for i, row in enumerate(ax):
        for j, col in enumerate(row):
            v_idx = min(1, panels[i].shape[-1] - 1)
            col.imshow(panels[i][:, :, j, v_idx])
    row_labels = ["y"] + [" ".join(f.split("_")[1:]) for f in folders]
    for ax_, rl in zip(ax[:, 0], row_labels):
        ax_.set_ylabel(rl)
    for ax_, cl in zip(ax[0, :], [f"frame{i+1}" for i in range(4)]):
        ax_.set_title(cl)
    plt.savefig(save_path)
    plt.close()
    return save_path


def json_to_table(data: dict, out_path: str) -> str:
    """``results.html`` (the reference's ``:63-78``)."""
    result = "<table>"
    model_keys = list(data.keys())
    result += (
        "<head><th>"
        + "".join(f"<td>{k.replace('_', ' ')}</td>" for k in model_keys)
        + "</th></head><tbody>"
    )
    feature_keys = data[model_keys[0]].keys()
    for fk in feature_keys:
        result += f"<tr><td>{fk.replace('_', ' ')}</td>"
        for mk in model_keys:
            result += f"<td>{data[mk][fk]:.5f}</td>"
        result += "</tr>"
    result += "</tbody></table>"
    with open(os.path.join(out_path, "results.html"), "w") as f:
        f.write(result)
    return result


def compare_models(base_path: str, folders: list[str],
                   out_path: str = "compare_models_results",
                   downsample_size=(20, 20),
                   preprocessed_folder: str = DEFAULT_DATA,
                   dataset: str = "kmni", plot_only: bool = False,
                   seed: int = 369, device=None):
    """The reference's ``:81-134``: returns ``{folder: model}``."""
    dev = resolve_device(device)
    if dataset == "kmni" and not os.path.isdir(
            os.path.join(preprocessed_folder, "train")):
        print(f"[compare_models] dataset not found at "
              f"{preprocessed_folder!r}; using synthetic")
        dataset, preprocessed_folder = "synthetic", ""
    os.makedirs(out_path, exist_ok=True)
    train_loader, test_loader, _ = loaders(preprocessed_folder, dataset,
                                           downsample_size, seed)
    x, _y = next(iter(train_loader))
    _, image_width, image_height, steps, n_vertices = x.shape
    entries = {folder: load_experiment_model(
        os.path.join(base_path, folder), image_width=image_width,
        image_height=image_height, n_vertices=n_vertices, time_steps=steps,
        device=dev, seed=seed) for folder in folders}

    if not plot_only:
        results = get_metrics(entries, dev, preprocessed_folder, dataset,
                              downsample_size, seed=seed)
        print(json_to_table(results, out_path))
        print(json.dumps(results, indent=4))
        with open(os.path.join(out_path, "results.json"), "w") as f:
            json.dump(results, f, indent=4)
    panels = multi_model_panels(test_loader, entries, dev)
    if panels is not None:
        draw_multi_model(out_path, panels, list(entries))
    # pred_0.png: the first model's prediction figure, as the reference's
    # results directory holds
    viz_loader = loaders(preprocessed_folder, dataset, downsample_size,
                          seed)[1]
    first = next(iter(entries.values()))
    visualize_gat_predictions(
        lambda xb: predict_batch(first, xb, dev)[:len(xb)], viz_loader,
        epoch=0, path=out_path,
        power=float(getattr(viz_loader, "power", 1.0)))
    return entries


def main(argv=None):
    parser = ArgumentParser(prog="python -m extended_gan_torch.compare_models")
    parser.add_argument("--base-folder", type=str,
                        default="convolutional_gat/experiments")
    parser.add_argument("--folders", nargs="+",
                        default=["local_temporal_conv", "local_unet"])
    parser.add_argument("--out-path", type=str,
                        default="compare_models_results")
    parser.add_argument("--preprocessed-folder", type=str,
                        default=DEFAULT_DATA)
    parser.add_argument("--dataset", type=str, default="kmni")
    parser.add_argument("--plot-only", action="store_true")
    parser.add_argument("--device", default=None,
                        help="default: the CUDA card; 'cpu' on request")
    args = parser.parse_args(argv)
    return compare_models(
        args.base_folder, args.folders, out_path=args.out_path,
        preprocessed_folder=args.preprocessed_folder, dataset=args.dataset,
        plot_only=args.plot_only, device=args.device)


if __name__ == "__main__":
    main()
