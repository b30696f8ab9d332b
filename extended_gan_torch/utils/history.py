"""Training history (port of ``extended_gan_tpu/utils/history.py``): the
conv-GAT driver's ``update_history`` and ``history.json`` writer, and the
DCGAN driver's :class:`TrainingHistory`. The plots are not ported."""

from __future__ import annotations

import json
import os


def update_history(history: dict[str, list[float]], data: dict[str, float]):
    for key, val in data.items():
        history.setdefault(key, []).append(float(val))


def save_history_json(history: dict, output_path: str):
    with open(os.path.join(output_path, "history.json"), "w") as f:
        json.dump(history, f, indent=4)


class TrainingHistory:
    """Per-epoch scalar history: ``{key: [value of each epoch]}``."""

    def __init__(self, history: dict | None = None):
        self.history: dict[str, list[float]] = \
            history if history is not None else {}

    def append(self, new_data: dict) -> "TrainingHistory":
        update_history(self.history, new_data)
        return self

    def to_json(self, path: str):
        with open(path, "w") as f:
            json.dump(self.history, f, indent=4)

    @classmethod
    def from_json(cls, path: str) -> "TrainingHistory":
        with open(path) as f:
            return cls(history=json.load(f))
