"""Training history (port of ``update_history`` and the ``history.json``
writer of ``extended_gan_tpu/utils/history.py``). The history plots are not
ported."""

from __future__ import annotations

import json
import os


def update_history(history: dict[str, list[float]], data: dict[str, float]):
    for key, val in data.items():
        history.setdefault(key, []).append(float(val))


def save_history_json(history: dict, output_path: str):
    with open(os.path.join(output_path, "history.json"), "w") as f:
        json.dump(history, f, indent=4)
