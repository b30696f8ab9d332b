"""Head and tail train/test split of one array file (port of
``extended_gan_tpu/preprocess/train_test_split.py``).

About a tenth of the frames from each end of the sequence become
``test/test_1.h5`` and ``test/test_2.h5``, the middle ``train/train.h5``,
each an ``.h5`` file with the key ``default`` (so h5py is needed).

  python -m extended_gan_torch.preprocess.train_test_split IN OUT_DIR
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..data.io import load_array, mkdir, save_array


def split(in_file_name: str, out_dir: str):
    """Write the three files of ``in_file_name`` under ``out_dir``."""
    mkdir(os.path.join(out_dir, "test"))
    mkdir(os.path.join(out_dir, "train"))
    data = np.asarray(load_array(in_file_name))
    to_cut = (int(0.2 * len(data)) + 16) // 2
    test_1, test_2 = data[:to_cut], data[-to_cut:]
    train = data[to_cut:-to_cut]
    if len(train) + len(test_1) + len(test_2) != len(data):
        raise ValueError(f"{in_file_name}: {len(data)} frames are too few "
                         f"to cut {to_cut} from each end")
    save_array(os.path.join(out_dir, "test", "test_1.h5"), test_1)
    save_array(os.path.join(out_dir, "test", "test_2.h5"), test_2)
    save_array(os.path.join(out_dir, "train", "train.h5"), train)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m extended_gan_torch.preprocess.train_test_split")
    parser.add_argument("in_file_name", nargs="?",
                        default="/mnt/tmp/data.hdf5")
    parser.add_argument("out_dir", nargs="?",
                        default="/mnt/tmp/multi_channel_train_test")
    args = parser.parse_args(argv)
    split(args.in_file_name, args.out_dir)


if __name__ == "__main__":
    main()
