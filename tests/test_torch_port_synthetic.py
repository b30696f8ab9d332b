"""Two processes asking for one synthetic archive at once (the port's
``data/synthetic.py``), on the CPU.

The CPU tests of several files read the default KNMI archive under the
temporary directory, from xdist workers that run at the same time. A
process that finds the archive's ``train/`` folder takes the archive as
made, so ``train/`` must not appear before the archive is whole. Here a
second process waits, imported and polling, for ``train/`` to appear in an
empty folder and then asks for the archive; the first one makes it. Both
must see every file, each readable at its full shape: the KNMI archive's
three train files, ``train/metadata.json`` and one test file, and the
coastal-sea archive's two train files and one test file.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# asks for the archive in argv[2] with ensure_synthetic_<argv[1]>, after
# train/ appears when argv[3] is "wait", and prints what it sees: {sub:
# {file: shape, or the error reading it}}
CHILD = r"""
import json, os, sys, time
sys.path.insert(0, sys.argv[4])
from extended_gan_torch.data import synthetic
from extended_gan_torch.data.io import load_array
kind, folder, mode = sys.argv[1:4]
if mode == "wait":
    print("ready", flush=True)
    while not os.path.isdir(os.path.join(folder, "train")):
        time.sleep(0.0005)
getattr(synthetic, "ensure_synthetic_" + kind)(folder)
seen = {}
for sub in ("train", "test"):
    path = os.path.join(folder, sub)
    names = sorted(os.listdir(path)) if os.path.isdir(path) else []
    seen[sub] = {}
    for name in names:
        try:
            seen[sub][name] = (json.load(open(os.path.join(path, name)))
                               if name.endswith(".json") else
                               list(load_array(os.path.join(path, name)).shape))
        except Exception as e:
            seen[sub][name] = repr(e)
print(json.dumps(seen), flush=True)
"""

WHOLE = {
    "kmni": {"train": {**{f"{i:010d}.pt": [24, 6, 80, 80] for i in range(3)},
                       "metadata.json": {"max": 254, "min": 0}},
             "test": {f"{0:010d}.pt": [24, 6, 80, 80]}},
    "coastal": {"train": {f"{i:04d}.pt": [48, 1, 64, 64] for i in range(2)},
                "test": {"0000.pt": [48, 1, 64, 64]}},
}


def _child(kind, folder, mode):
    return subprocess.Popen(
        [sys.executable, "-c", CHILD, kind, folder, mode, REPO],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "1"})


@pytest.mark.parametrize("kind", ["kmni", "coastal"])
def test_a_process_that_finds_train_finds_the_whole_archive(tmp_path, kind):
    folder = str(tmp_path / "archive")
    waiter = _child(kind, folder, "wait")
    assert waiter.stdout.readline().strip() == "ready", waiter.stderr.read()
    maker = _child(kind, folder, "make")
    seen = []
    for proc in (maker, waiter):
        out, err = proc.communicate(timeout=240)
        assert proc.returncode == 0, err
        seen.append(json.loads(out.strip().splitlines()[-1]))
    assert seen[0] == WHOLE[kind], "the maker"
    assert seen[1] == WHOLE[kind], "the process released by train/"
    # no staging folder is left beside the archive
    assert os.listdir(tmp_path) == ["archive"]
