"""The data axis on N cards against one, through the conv-GAT CLI.

  python -m extended_gan_torch.parallel.probe [--cards 4] [--turns 2]

Makes a synthetic KNMI archive (20 + 2 files of 96 frames of 20x20x6),
then trains final_smaatunet's model (``--model-type unet --mapping-type
linear``, the global batch 32) for an epoch with ``--profile``, in turns:
one card, N cards (``--data-axis N``: NCCL, one process a card), N cards,
one card, ...; prints each run's ms a step (1000 over ``steps_per_sec``:
the epoch's wall over its steps), its losses and the kernels' launches,
one JSON line a run, after the cards' names and power limits.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

from ..data.synthetic import make_kmni_dataset


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m extended_gan_torch.parallel.probe")
    parser.add_argument("--cards", type=int, default=4)
    parser.add_argument("--turns", type=int, default=2,
                        help="pairs of runs: one card then N, N then one")
    args = parser.parse_args(argv)
    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, check=True).stdout.strip()
    print(cards, flush=True)
    with tempfile.TemporaryDirectory(prefix="dp_probe_") as tmp:
        knmi = make_kmni_dataset(os.path.join(tmp, "knmi"),
                                 n_train_files=20, n_test_files=2,
                                 frames_per_file=96, hw=20)
        order = [1, args.cards, args.cards, 1] * args.turns
        for i, axis in enumerate(order[:2 * args.turns]):
            out = os.path.join(tmp, f"run{i}")
            cmd = [sys.executable, "-m", "extended_gan_torch.gat", "train",
                   "--model-type", "unet", "--mapping-type", "linear",
                   "--dataset", "kmni", "--preprocessed-folder", knmi,
                   "--downsample-size", "20", "20", "--epochs", "1",
                   "--profile", "--output-path", out,
                   "--data-axis", str(axis)]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode:
                sys.stderr.write(res.stdout[-3000:] + res.stderr[-3000:])
                return res.returncode
            with open(os.path.join(out, "history.json")) as f:
                h = json.load(f)
            launches = next(json.loads(ln)["kernel_launches"]
                            for ln in res.stdout.splitlines()
                            if ln.startswith('{"kernel_launches"'))
            print(json.dumps({
                "cards": axis, "ms_a_step": 1e3 / h["steps_per_sec"][0],
                "steps": h["profiled_steps"][0],
                "epoch_wall_s": h["epoch_wall_s"][0],
                "train_loss": h["train_loss"][0],
                "val_loss": h["val_loss"][0],
                "launches_rank0": launches}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
