"""The port's ARAI data path against the JAX package's.

``make_arai_dataset`` writes the same files for the same arguments, and
``get_loaders(dataset="arai")`` yields byte-identical batches in the same
order, with the same ``len()``, for two seeds (the seed shuffles the train
split's file order). A short CLI run trains on the archive.
"""

import os

import numpy as np
import pytest

from extended_gan_tpu.data import streaming as jax_streaming
from extended_gan_tpu.data import synthetic as jax_synthetic
from extended_gan_torch.data import streaming, synthetic
from extended_gan_torch.gat.__main__ import main as cli
from test_torch_port_gat_family import one_torch_thread  # noqa: F401 - the autouse fixture

KW = dict(n_files=3, frames_per_file=14, n_regions=4, h=16, w=14)


@pytest.mark.parametrize("seed", [369, 5])
def test_arai_archive_and_batches_are_byte_identical(tmp_path, seed):
    ours = synthetic.make_arai_dataset(str(tmp_path / "torch"), seed=seed,
                                       **KW)
    theirs = jax_synthetic.make_arai_dataset(str(tmp_path / "jax"),
                                             seed=seed, **KW)
    for sub in ("training", "validation", "metadata.json"):
        a, b = os.path.join(ours, sub), os.path.join(theirs, sub)
        names = sorted(os.listdir(a)) if os.path.isdir(a) else [""]
        assert names == (sorted(os.listdir(b)) if os.path.isdir(b) else [""])
        for name in names:
            with open(os.path.join(a, name) if name else a, "rb") as fa, \
                    open(os.path.join(b, name) if name else b, "rb") as fb:
                assert fa.read() == fb.read(), (sub, name)
    got = streaming.get_loaders(3, 4, ours, dataset="arai",
                                downsample_size=(12, 10), seed=seed)
    want = jax_streaming.get_loaders(3, 4, theirs, dataset="arai",
                                     downsample_size=(12, 10), seed=seed)
    for split, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w) > 1, split
        g, w = list(g), list(w)
        assert len(g) == len(w), split
        for (xg, yg), (xw, yw) in zip(g, w):
            for a, b in ((xg, xw), (yg, yw)):
                assert a.dtype == b.dtype == np.float32
                assert a.shape == b.shape and a.tobytes() == b.tobytes()
    # windows do not span files: 14 frames make 7 windows of 8 frames, two
    # batches of 4 a file
    assert len(got[1]) == 2 * KW["n_files"]


def test_cli_trains_on_an_arai_archive(tmp_path):
    folder = synthetic.make_arai_dataset(str(tmp_path / "arai"), **KW)
    model, history = cli([
        "train", "--model-type", "temporal", "--mapping-type", "linear",
        "--dataset", "arai", "--preprocessed-folder", folder,
        "--downsample-size", "12", "10", "--epochs", "1", "--max-batches",
        "2", "--train-batch-size", "3", "--device", "cpu"])
    assert (model.image_width, model.image_height) == (12, 10)
    assert len(history["val_loss"]) == 1
    assert all(np.isfinite(v) for vals in history.values() for v in vals)
