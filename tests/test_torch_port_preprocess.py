"""The port's preprocessing tools (``extended_gan_torch/preprocess``)
against the JAX package's (``extended_gan_tpu/preprocess``), on the CPU.

Each tool runs on the same small synthetic input, once from each package,
into two output folders, and the two trees must match: the same files, the
arrays in them equal element for element with the same dtype and shape,
and equal metadata (``metadata.json``, ``metadata.npz``).

- ``kmni``: a tree of radar ``.h5`` files over two years (the first before
  ``--from-year``) and two months, whose frames' raininess walks the gate
  through its cases: rainy runs, one tolerated dry frame, a run cut at 8
  and at 7 frames (the ``>= 8`` flush), runs open at a month's end of 8
  and 9 frames (the ``> 8`` flush), the 65535 sentinel; then the
  seed-369 test split and the z-score pass, all through each CLI
  (``preprocess``, ``z-score``); ``minimize`` refused.
- ``arai``: a two-region archive of 15-minute files with gaps, a run
  across midnight into the next day, a day that does not follow, a block
  below ``min_block``, through a numpy reader; and the run-count check
  when a region lacks a time range.
- ``coastal_sea``: two ``.npy`` dumps of ``thetao``.
- ``train_test_split``: one ``.h5`` array.

Each port module also runs as ``python -m`` does (``runpy``).
"""

import importlib.util
import json
import os
import runpy
import sys
import warnings

import h5py
import numpy as np
import pytest
import torch

from extended_gan_torch.data.io import listdir
from extended_gan_torch.preprocess import arai, coastal_sea, kmni
from extended_gan_torch.preprocess import train_test_split as split
from extended_gan_tpu.preprocess import arai as jarai
from extended_gan_tpu.preprocess import coastal_sea as jcoastal
from extended_gan_tpu.preprocess import kmni as jkmni
from extended_gan_tpu.preprocess import train_test_split as jsplit


def _read(path):
    if path.endswith(".pt"):
        return torch.load(path, weights_only=True).numpy()
    if path.endswith(".h5"):
        with h5py.File(path, "r") as f:
            return f["default"][...]
    if path.endswith(".json"):
        with open(path) as f:
            return json.load(f)
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def assert_same_tree(got, want):
    """The same relative file names under both roots, and equal contents."""
    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    names = files(want)
    assert names and files(got) == names
    for name in names:
        a, b = _read(os.path.join(got, name)), _read(os.path.join(want, name))
        if isinstance(b, dict) and name.endswith(".npz"):
            assert sorted(a) == sorted(b), name
            for k in b:
                assert a[k].dtype == b[k].dtype, (name, k)
                np.testing.assert_array_equal(a[k], b[k], err_msg=name)
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name


def _as_main(module, argv, monkeypatch):
    """``python -m module *argv``, in this process."""
    monkeypatch.setattr(sys, "argv", [module, *argv])
    with warnings.catch_warnings():  # the module is imported already
        warnings.simplefilter("ignore", RuntimeWarning)
        runpy.run_module(module, run_name="__main__", alter_sys=False)


# ------------------------------------------------------------ kmni
# the raininess of each frame, a month a list: >= 0.2 is rainy
_MONTHS = {
    ("2015", "12"): [0.9] * 10,  # before --from-year: skipped
    # 5 rainy, 1 dry (tolerated), 3 rainy, 1 dry (tolerated), 1 dry: the
    # run of 10 is saved (>= 8); 6 rainy, 1 nearly dry, 1 dry: the run of
    # 7 is dropped; 9 rainy open at the month's end: saved (> 8)
    ("2016", "01"): ([0.9] * 5 + [0.0] + [0.9] * 3 + [0.0, 0.0]
                     + [0.9] * 6 + [0.05, 0.0]
                     + [0.5] * 9),
    # a dry frame alone, dropped; 7 rainy + 1 tolerated, then dry: 8 saved;
    # 8 rainy open at the month's end: not > 8, and lost at the end
    ("2016", "02"): ([0.0, 0.0] + [0.9] * 7 + [0.0] + [0.0]
                     + [0.9] * 8),
}


def _radar_frame(rng, raininess):
    """A (600, 520) radar image whose six city patches have about
    ``raininess`` of their pixels non-zero, some of the rest 65535."""
    wet = rng.random((600, 520)) < raininess
    img = np.where(wet, rng.integers(1, 60, wet.shape), 0).astype(np.uint16)
    img[rng.random(img.shape) < 0.05] = 65535
    return img


@pytest.fixture(scope="module")
def radar_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("knmi")
    rng = np.random.default_rng(0)
    for (year, month), rains in _MONTHS.items():
        folder = root / year / month
        folder.mkdir(parents=True)
        for i, r in enumerate(rains):
            with h5py.File(folder / f"RAD_{year}{month}{i:03d}.h5", "w") as f:
                f.create_group("image1")["image_data"] = _radar_frame(rng, r)
        (folder / "notes.txt").write_text("not a radar file")
    return str(root)


def test_kmni_tool_matches_jax(radar_tree, tmp_path, monkeypatch):
    out_j, out_p = str(tmp_path / "jax"), str(tmp_path / "port")
    args = ["-i", radar_tree, "-r", "0.2", "-y", "2016"]
    jkmni.main(["preprocess", *args, "-o", out_j])
    jkmni.main(["z-score", "-o", out_j])
    _as_main("extended_gan_torch.preprocess.kmni",
             ["preprocess", *args, "-o", out_p], monkeypatch)
    kmni.main(["z-score", "-o", out_p])
    assert_same_tree(out_p, out_j)
    videos = [n for d in ("train", "test")
              for n, _ in listdir(os.path.join(out_p, d))
              if n.endswith(".pt")]
    # three videos: a fifth of 3 rounds to none moved to test/
    assert len(videos) == 3 and len(listdir(os.path.join(out_p, "test"))) == 0
    lengths = [len(_read(os.path.join(out_p, "train", n)))
               for n in sorted(videos)]
    assert lengths == [10, 9, 8]
    video = _read(os.path.join(out_p, "train", sorted(videos)[0]))
    assert video.dtype == np.int64 and video.shape[1:] == (6, 80, 80)
    assert video.max() < 65535
    meta = _read(os.path.join(out_p, "train", "metadata.json"))
    assert meta == {"max": 65535, "min": 0}
    with pytest.raises(SystemExit, match="minimize"):
        kmni.main(["minimize", "-o", out_p])


def test_kmni_test_split_moves_a_fifth_by_seed(tmp_path):
    """The seed-369 split on more files: the same files move."""
    roots = {}
    for name, mod in (("jax", jkmni), ("port", kmni)):
        root = tmp_path / name
        (root / "train").mkdir(parents=True)
        for i in range(12):
            torch.save(torch.full((2, 6, 3, 3), i), root / "train" /
                       f"{i:010d}.pt")
        (root / "train" / "metadata.json").write_text("{}")
        mod.test_split(str(root))
        roots[name] = str(root)
    assert_same_tree(roots["port"], roots["jax"])
    assert len(os.listdir(os.path.join(roots["port"], "test"))) == 2


# ------------------------------------------------------------ arai
def _arai_tree(root, slots_by_day, regions=("R1", "R2"),
               folder="CRR", shape=(4, 5)):
    """``root/<region>/<condition>/<day>/<folder>/`` with one file a slot
    (its HHMM in the name), each holding a small .npy frame."""
    rng = np.random.default_rng(1)
    grid = jarai.get_time_range()
    for region in regions:
        for condition, days in slots_by_day.items():
            for day, slots in days.items():
                d = os.path.join(root, region, condition, day, folder)
                os.makedirs(d, exist_ok=True)
                for s in slots:
                    hhmm = f"{grid[s]:04d}"
                    path = os.path.join(
                        d, f"S_NWC_CRR_MSG4_Europe_2020{day:>04}T{hhmm}00Z.nc")
                    with open(path, "wb") as f:
                        np.save(f, rng.random((1, *shape), np.float32))


def _npy_reader(path, var_name):
    assert var_name == "crr"
    return np.load(path)


_ARAI_DAYS = {
    "training": {
        "1": list(range(0, 20)) + list(range(90, 96)),  # 20; 6 to midnight
        "2": list(range(0, 13)) + list(range(50, 56)),  # +13 = 19; 6: short
        "4": list(range(10, 26)),  # day 3 missing: a new run of 16
    },
    "validation": {
        "7": list(range(30, 42)),  # 12
        "8": list(range(0, 4)),  # day 7 ends before midnight: 4, short
    },
}


def test_arai_tool_matches_jax(tmp_path, monkeypatch):
    src = str(tmp_path / "mai")
    _arai_tree(src, _ARAI_DAYS)
    out_j, out_p = str(tmp_path / "jax"), str(tmp_path / "port")
    variables = (("CRR", "crr"),)
    meta_j = jarai.preprocess(False, src, out_j, variables, _npy_reader)
    meta_p = arai.preprocess(False, src, out_p, variables, _npy_reader)
    assert meta_p == meta_j == {"n_regions": 2,
                                "training": {"length": 20 + 19 + 16},
                                "validation": {"length": 12}}
    assert_same_tree(out_p, out_j)
    block = _read(os.path.join(out_p, "training", "1.pt"))
    assert block.shape == (19, 2, 1, 4, 5) and block.dtype == np.float32
    if importlib.util.find_spec("netCDF4") is None:
        # as python -m runs it: the default reader needs netCDF4
        with pytest.raises(ImportError):
            _as_main("extended_gan_torch.preprocess.arai",
                     ["--in-path", src, "--out-path", out_p,
                      "--select-variables", '[["CRR", "crr"]]'], monkeypatch)


def test_arai_regions_with_different_runs_raise(tmp_path):
    src = str(tmp_path / "mai")
    _arai_tree(src, _ARAI_DAYS, regions=("R1",))
    days = {c: dict(d) for c, d in _ARAI_DAYS.items()}
    days["training"]["4"] = []  # R2 lacks day 4's run
    _arai_tree(src, days, regions=("R2",))
    for mod in (jarai, arai):
        with pytest.raises(ValueError, match="continuous-run counts"):
            mod.preprocess(False, src, str(tmp_path / "out"),
                           (("CRR", "crr"),), _npy_reader)


# ------------------------------------------------------------ coastal sea
def test_coastal_sea_tool_matches_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(2)
    names = []
    for i in range(2):
        path = str(tmp_path / f"thetao_{i}.npy")
        np.save(path, (rng.standard_normal((6, 2, 40, 80)) * 3 + 10 * i)
                .astype(np.float32))
        names.append(path)
    want = jcoastal.preprocess(names, str(tmp_path / "jax.pt"))
    _as_main("extended_gan_torch.preprocess.coastal_sea",
             [*names, "--out", str(tmp_path / "port.pt")], monkeypatch)
    got = _read(str(tmp_path / "port.pt"))
    assert got.shape == (6, 2, 20, 65) and got.dtype == np.float32
    np.testing.assert_array_equal(got, _read(str(tmp_path / "jax.pt")))
    np.testing.assert_array_equal(got, want)
    assert got.min() == 0.0 and got.max() == 1.0
    if importlib.util.find_spec("netCDF4") is None:
        with pytest.raises(ImportError, match="netCDF4"):
            coastal_sea.preprocess([str(tmp_path / "TEM.nc")],
                                   str(tmp_path / "x.pt"))


# ------------------------------------------------------------ train/test
def test_train_test_split_matches_jax(tmp_path, monkeypatch):
    src = str(tmp_path / "data.h5")
    data = np.random.default_rng(3).random((100, 4, 4)).astype(np.float32)
    with h5py.File(src, "w") as f:
        f["default"] = data
    jsplit.main(src, str(tmp_path / "jax"))
    _as_main("extended_gan_torch.preprocess.train_test_split",
             [src, str(tmp_path / "port")], monkeypatch)
    assert_same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))
    test_1 = _read(str(tmp_path / "port" / "test" / "test_1.h5"))
    np.testing.assert_array_equal(test_1, data[:18])
    split.split(src, str(tmp_path / "again"))
    assert_same_tree(str(tmp_path / "again"), str(tmp_path / "jax"))
