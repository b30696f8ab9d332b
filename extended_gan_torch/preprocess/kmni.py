"""KNMI radar archive -> per-city rain videos (port of
``extended_gan_tpu/preprocess/kmni.py``).

Walks ``<in>/<year>/<month>/*.h5`` (from ``--from-year`` on), reads each
file's ``image1/image_data``, crops the Netherlands window ``[243:590,
234:512]``, cuts the six fixed 80x80 city patches, zeroes the 65535 no-data
sentinel and gates on raininess (the share of non-zero pixels) with one
frame of patience: a run of rainy frames (one dry frame tolerated) is
saved as ``<out>/train/<index:010d>.pt``, a (T, 6, 80, 80) int64 tensor.
The reference's two flush rules are kept as they are: a run ending on a
second dry frame is saved at 8 frames or more, a run open at a month's end
only past 8. ``train/metadata.json`` holds the raw archive's ``max`` and
``min``. Then 20% of the files (a seed-369 permutation) move to ``test/``;
``z-score`` writes ``metadata.npz``, the per-pixel mean and variance (ddof
1) of the train split.

  python -m extended_gan_torch.preprocess.kmni preprocess -i IN -o OUT
  python -m extended_gan_torch.preprocess.kmni test-split -o OUT
  python -m extended_gan_torch.preprocess.kmni z-score -o OUT

The radar files are HDF5, so the tool needs h5py; without it the read
raises, as the JAX package's does.
"""

from __future__ import annotations

import json
import os
import shutil
from argparse import ArgumentParser
from pathlib import Path

import numpy as np

from ..data.io import listdir, load_array, mkdir, save_array

# the city patches' corners within the cropped image
COORDINATES = (
    (201, 38),
    (201 - 80, 81),
    (201 - 80 + 4, 81 + 92),
    (214, 140),
    (29, 190),
    (29 + 10, 186 - 85),
)
PATCH = 80
CROP = (slice(243, 590), slice(234, 512))
NAN_SENTINEL = 65535


def _read_radar_h5(file_path: str) -> np.ndarray:
    import h5py

    with h5py.File(file_path, "r") as f:
        return f["image1"]["image_data"][...].astype(np.int64)


def get_z_score_normalizing_constants(preprocessed_folder: str) -> dict:
    """Per-pixel mean and variance (ddof 1) over every train frame, written
    to ``<folder>/metadata.npz`` and returned."""
    acc = np.concatenate([
        load_array(fpath)
        for _, fpath in listdir(os.path.join(preprocessed_folder, "train"))
        if not fpath.endswith(".json")]).astype(np.float32)
    result = {"mean": acc.mean(axis=0), "var": acc.var(axis=0, ddof=1)}
    np.savez(os.path.join(preprocessed_folder, "metadata.npz"), **result)
    return result


def preprocess(in_dir: str, out_dir: str, from_year: int = 2016,
               rain_threshold: float = 0.2):
    """The radar archive under ``in_dir`` -> videos under
    ``<out_dir>/train``."""
    out_train = Path(out_dir) / "train"
    mkdir(str(out_train))
    years = listdir(in_dir)
    if from_year != -1:
        names = [name for name, _ in years]
        if str(from_year) in names:
            years = years[names.index(str(from_year)):]

    acc: list[np.ndarray] = []
    file_index = 0
    patience = True
    max_val, min_val = 0, 1000

    def flush():
        nonlocal acc, file_index
        save_array(str(out_train / f"{file_index:010d}.pt"), np.stack(acc))
        acc = []
        file_index += 1

    for year, year_path in years:
        print(f"Year: {year}")
        for month, month_path in listdir(year_path):
            print(f"\t{month}")
            for name, file_path in listdir(month_path):
                if not name.endswith(".h5"):
                    continue
                raw = _read_radar_h5(file_path)
                max_val = max(int(raw.max()), max_val)
                min_val = min(int(raw.min()), min_val)
                raw = raw[CROP]
                content = np.stack([raw[x:x + PATCH, y:y + PATCH]
                                    for x, y in COORDINATES])
                content[content == NAN_SENTINEL] = 0
                raininess = 1 - (content == 0).sum() / content.size
                if raininess >= rain_threshold:
                    acc.append(content)
                    patience = True
                elif patience:  # one dry frame is tolerated
                    acc.append(content)
                    patience = False
                elif len(acc) >= 8:
                    flush()
                else:
                    acc = []
            if len(acc) > 8:
                flush()
    with open(out_train / "metadata.json", "w") as f:
        json.dump({"max": max_val, "min": min_val}, f)


def test_split(out_dir: str, ratio: float = 0.2, seed: int = 369):
    """Move ``ratio`` of ``<out_dir>/train``'s videos, picked by a ``seed``
    permutation, to ``<out_dir>/test``."""
    train_out = os.path.join(out_dir, "train")
    test_out = os.path.join(out_dir, "test")
    mkdir(test_out)
    files = [(fn, fp) for fn, fp in listdir(train_out)
             if not fn.endswith(".json")]
    rng = np.random.default_rng(seed)
    for i in rng.permutation(len(files))[:int(len(files) * ratio)]:
        file_name, file_path = files[i]
        shutil.move(file_path, os.path.join(test_out, file_name))


def main(argv=None):
    parser = ArgumentParser(
        prog="python -m extended_gan_torch.preprocess.kmni")
    parser.add_argument("action", choices=("preprocess", "test-split",
                                           "minimize", "z-score"))
    parser.add_argument("-i", "--in-dir", type=str)
    parser.add_argument("-o", "--out-dir", type=str)
    parser.add_argument("-r", "--rain-threshold", type=float, default=0.5)
    parser.add_argument("-y", "--from-year", type=int, default=2016)
    args = parser.parse_args(argv)
    if args.rain_threshold > 1:
        parser.error("--rain-threshold must be <= 1")
    print(json.dumps(args.__dict__, indent=4))
    if args.action == "preprocess":
        preprocess(args.in_dir, args.out_dir, args.from_year,
                   args.rain_threshold)
        test_split(args.out_dir)
    elif args.action == "test-split":
        test_split(args.out_dir)
    elif args.action == "z-score":
        get_z_score_normalizing_constants(args.out_dir)
    else:  # the reference's CLI offers "minimize" and never implemented it
        raise SystemExit("'minimize' is not implemented (the reference "
                         "never implemented it either); use "
                         "preprocess/test-split/z-score")


if __name__ == "__main__":
    main()
