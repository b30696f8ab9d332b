"""Training history (port of ``extended_gan_tpu/utils/history.py``): the
conv-GAT driver's ``update_history``, ``plot_history`` and ``history.json``
writer, and the GAN drivers' :class:`TrainingHistory` with its grouped
plots. The plots draw with matplotlib, imported only when one is drawn
(``utils/viz.py``: without it each plot prints one line and writes
nothing)."""

from __future__ import annotations

import json
import os

from .viz import not_drawn, pyplot


def update_history(history: dict[str, list[float]], data: dict[str, float]):
    for key, val in data.items():
        history.setdefault(key, []).append(float(val))


def save_history_json(history: dict, output_path: str):
    with open(os.path.join(output_path, "history.json"), "w") as f:
        json.dump(history, f, indent=4)


class TrainingHistory:
    """Per-epoch scalar history, ``{key: [value of each epoch]}``, with
    grouped plots.

    Groups are substring filters applied in order; each key lands in the
    first group whose substring it contains (the reference's
    ``dcgan/utils.py:31-60``). The empty-string group catches the rest and
    is plotted as "metrics"."""

    def __init__(self, history: dict | None = None,
                 groups: tuple[str, ...] = ("mse", "disc", ""),
                 save_path: str = "training_plots"):
        self.save_path = save_path
        self.groups = groups
        self.history: dict[str, list[float]] = \
            history if history is not None else {}

    def append(self, new_data: dict) -> "TrainingHistory":
        update_history(self.history, new_data)
        return self

    def to_json(self, path: str):
        with open(path, "w") as f:
            json.dump(self.history, f, indent=4)

    @classmethod
    def from_json(cls, path: str, **kwargs) -> "TrainingHistory":
        with open(path) as f:
            return cls(history=json.load(f), **kwargs)

    def key_groups(self) -> list[list[str]]:
        """Each group's keys, in the order of ``groups``."""
        used: list[str] = []
        key_groups: list[list[str]] = []
        for group_key in self.groups:
            group: list[str] = []
            key_groups.append(group)
            for key in self.history:
                if key not in used and group_key in key:
                    group.append(key)
                    used.append(key)
        return key_groups

    def plot(self, save: bool = True):
        """One figure a non-empty group, ``<save_path>/<group>.png``
        ("metrics" for the empty-string group; JAX ``:56-81``)."""
        plt = pyplot()
        for i, group in enumerate(self.key_groups()):
            if not group:
                continue
            name = self.groups[i] if self.groups[i] != "" else "metrics"
            if plt is None:
                not_drawn(os.path.join(self.save_path, name + ".png"))
                continue
            os.makedirs(self.save_path, exist_ok=True)
            plt.clf()
            for key in group:
                plt.plot(self.history[key], label=key.replace("_", " "))
            plt.legend()
            plt.title("Training History")
            if save:
                plt.savefig(os.path.join(self.save_path, name))
            else:  # pragma: no cover - interactive
                plt.show()
            plt.close()


def plot_history(history: dict[str, list[float]],
                 title: str = "Training History", save: bool = False,
                 filename: str = "history"):
    """The train and validation loss curves (the reference's
    ``convolutional_gat/utils.py:106-125``, JAX ``:90-106``)."""
    plt = pyplot()
    if plt is None:
        not_drawn(filename)
        return
    plt.clf()
    plt.plot(history.get("train_loss", []), label="Train loss")
    plt.plot(history.get("val_loss", []), label="Val loss")
    plt.legend()
    plt.title(title)
    if save:
        plt.savefig(filename)
    else:  # pragma: no cover - interactive
        plt.show()
    plt.close()
