"""Config-driven experiment runner (port of
``convolutional_gat/generate_experiment.py``).

Reads ``convolutional_gat/experiments/<name>/config.py`` (the JAX package's
experiment directories, parsed by the port's ``utils/config.py``) and
trains with it. Unlike the JAX runner, outputs (``history.json``,
``model.pt``) go to ``output_path``, never into the experiment directory;
with no ``output_path`` nothing is written.
"""

from __future__ import annotations

from pathlib import Path

from ..train.gat_driver import train
from ..utils.config import dump_config, load_experiment_config

EXPERIMENTS = Path(__file__).resolve().parents[2] / "convolutional_gat" / \
    "experiments"


def generate_experiment(exp_folder_name: str, *, output_path: str = "",
                        device=None, **overrides):
    """Train ``exp_folder_name`` with its config; a keyword set to anything
    but None overrides the config's value."""
    cfg = load_experiment_config(str(EXPERIMENTS / exp_folder_name))
    cfg.output_path = output_path
    kwargs = cfg.to_dict()
    for k, v in overrides.items():
        if v is not None:
            kwargs[k] = v
            if hasattr(cfg, k):
                setattr(cfg, k, v)
    dump_config(cfg)  # the settings the run actually uses
    return train(**kwargs, device=device)


def experiment_model_axis(exp_folder_name: str) -> int:
    """The experiment config's MODEL_AXIS (1 when it sets none)."""
    cfg = load_experiment_config(str(EXPERIMENTS / exp_folder_name))
    return int(cfg.to_dict().get("model_axis") or 1)
