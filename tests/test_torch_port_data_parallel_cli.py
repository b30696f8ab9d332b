"""The port's data axis through the conv-GAT CLI and its refusals, on the
CPU.

- ``--device cpu --data-axis 2``: the CLI starts two gloo processes itself
  and trains an epoch of GAT3D (conv mapping, 16x16, 2 steps at batch 5,
  a ragged validation batch); its ``history.json`` equals the
  one-process run's within ``CLI_RTOL``: the two differ only in the order
  of their reductions, which one Adam step then carries into the second
  step's loss (Adam moves an entry by about the learning rate whatever
  its gradient's size, so a reordered sum near 0 moves it by up to 1e-3).
- ``--multihost`` under a launcher environment of one rank (gloo,
  ``MASTER_PORT=0``): the same history and weights as without it, bit for
  bit (a world of one is the single-device path).
- ``DataAxis.rows`` gives each rank the rows JAX's ``put_batch`` puts on
  its device, the padding left out; the padding helpers match JAX's.
- With an axis of one rank, the port's ``BatchNorm2d`` is
  ``nn.BatchNorm2d`` bit for bit.
- Refusals: ``--multihost`` without a launcher environment, a partial or
  garbled one, a data axis larger than the visible cards, a data axis
  without its processes, and the data axis with TP, SP or PP (ROADMAP
  queue 1 item 9); FSDP, ``--moe-experts``, ``--megastep`` and
  ``--resident`` pass the data axis's checks (a resident batch must
  divide by it).
"""

import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch import nn

from extended_gan_tpu.parallel import MeshContext
from extended_gan_torch.gat.__main__ import main as cli
from extended_gan_torch.parallel import (
    BatchNorm2d,
    DataAxis,
    attach_data_axis,
    initialize_distributed,
    local_batch_size,
    pad_to_batch_multiple,
)
from extended_gan_torch.parallel.mesh import (
    LAUNCHER_VARS,
    _multihost_env_configured,
)
from extended_gan_torch.train.gat_driver import train

CLI_RTOL = 1e-3
ARGS = ["train", "--model-type", "temporal", "--mapping-type", "conv",
        "--dataset", "synthetic", "--downsample-size", "16", "16",
        "--train-batch-size", "5", "--test-batch-size", "7", "--epochs",
        "1", "--max-batches", "2", "--device", "cpu"]


@pytest.fixture
def no_launcher(monkeypatch):
    for k in LAUNCHER_VARS + ("SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)


def _history(out):
    with open(os.path.join(out, "history.json")) as f:
        return json.load(f)


def test_cli_data_axis_2_on_the_cpu_matches_one_process(tmp_path,
                                                        no_launcher):
    cli(ARGS + ["--output-path", str(tmp_path / "one")])
    assert cli(ARGS + ["--output-path", str(tmp_path / "two"),
                       "--data-axis", "2"]) is None
    one, two = _history(tmp_path / "one"), _history(tmp_path / "two")
    assert sorted(one) == sorted(two)
    for k in one:
        np.testing.assert_allclose(two[k], one[k], rtol=CLI_RTOL,
                                   atol=1e-12, err_msg=k)
    # rank 0 alone wrote: the same files as the one-process run
    assert sorted(os.listdir(tmp_path / "two")) == \
        sorted(os.listdir(tmp_path / "one"))


def test_multihost_world_of_one_is_the_single_device_path(tmp_path,
                                                          monkeypatch,
                                                          no_launcher):
    _, plain = cli(ARGS + ["--output-path", str(tmp_path / "plain")])
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                     MASTER_ADDR="127.0.0.1", MASTER_PORT="0").items():
        monkeypatch.setenv(k, v)
    try:
        model, multi = cli(ARGS + ["--output-path", str(tmp_path / "multi"),
                                   "--multihost"])
        assert dist.is_initialized() and dist.get_world_size() == 1
        # a second initialisation is benign
        assert initialize_distributed(require=True, device="cpu")
    finally:
        dist.destroy_process_group()
    assert multi == plain
    a = torch.load(tmp_path / "plain" / "model.pt", weights_only=True)
    b = torch.load(tmp_path / "multi" / "model.pt", weights_only=True)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_multihost_without_a_launcher_raises(no_launcher):
    assert not _multihost_env_configured()
    with pytest.raises(RuntimeError, match="launcher environment"):
        initialize_distributed(require=True, device="cpu")
    with pytest.raises(RuntimeError, match="launcher environment"):
        cli(ARGS + ["--multihost"])
    assert not dist.is_initialized()


@pytest.mark.parametrize("env,match", [
    (dict(RANK="0"), "partial launcher environment"),
    (dict(RANK="0", WORLD_SIZE="2", MASTER_ADDR="127.0.0.1"),
     "partial launcher environment"),
    (dict(RANK="0", WORLD_SIZE="two", MASTER_ADDR="127.0.0.1",
          MASTER_PORT="1"), "garbled launcher environment"),
    (dict(RANK="2", WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
          MASTER_PORT="1"), "garbled launcher environment"),
    (dict(SLURM_NTASKS="4"), "partial launcher environment"),
    (dict(OMPI_COMM_WORLD_SIZE="x"), "partial launcher environment"),
])
def test_a_partial_or_garbled_launcher_environment_raises(env, match,
                                                          monkeypatch,
                                                          no_launcher):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert _multihost_env_configured()
    for require in (False, True):
        with pytest.raises(RuntimeError, match=match):
            initialize_distributed(require=require, device="cpu")
    assert not dist.is_initialized()


def test_a_data_axis_larger_than_the_visible_cards_raises(no_launcher):
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = max(2, have + 1)
    with pytest.raises(ValueError, match=f"--data-axis {n} needs {n} cards, "
                                         f"have {have}"):
        cli([a for a in ARGS if a not in ("--device", "cpu")]
            + ["--data-axis", str(n)])


def test_a_data_axis_without_its_processes_raises(no_launcher):
    with pytest.raises(RuntimeError, match="needs 2 processes"):
        train(dataset="synthetic", device="cpu", data_axis=2)
    with pytest.raises(ValueError, match="data_axis must be >= 1"):
        train(dataset="synthetic", device="cpu", data_axis=0)


@pytest.mark.parametrize("option", [dict(fsdp=True), dict(model_axis=2),
                                    dict(spatial=True),
                                    dict(pipeline_stages=2)])
def test_the_data_axis_refuses_what_item_9_ports(option, no_launcher):
    """SP and PP wait for item 9; FSDP and TP are ported and, like the
    MoE's expert parallelism (the next test), get past the option checks
    to the process group's (a model axis of 2 on a data axis of 2: four
    processes)."""
    if "model_axis" in option:
        with pytest.raises(RuntimeError, match="needs 4 processes"):
            train(dataset="synthetic", device="cpu", data_axis=2, **option)
        return
    if "fsdp" in option:
        with pytest.raises(RuntimeError, match="needs 2 processes"):
            train(dataset="synthetic", device="cpu", data_axis=2, **option)
        return
    with pytest.raises(NotImplementedError,
                       match=r"not ported yet \(ROADMAP queue 1 item 9\)"):
        train(dataset="synthetic", device="cpu", data_axis=2, **option)


def test_the_moe_takes_the_data_axis(no_launcher):
    """Past the option checks to the process group's."""
    with pytest.raises(RuntimeError, match="needs 2 processes"):
        train(dataset="synthetic", device="cpu", data_axis=2, moe_experts=8)


@pytest.mark.parametrize("option", [dict(megastep=2), dict(resident=True),
                                    dict(megastep=8, resident=True)])
def test_graphs_and_resident_data_take_the_data_axis(option, no_launcher):
    """Past the option checks to the process group's."""
    with pytest.raises(RuntimeError, match="needs 2 processes"):
        train(dataset="synthetic", device="cpu", data_axis=2, **option)


def test_a_resident_batch_must_divide_by_the_data_axis(no_launcher):
    with pytest.raises(ValueError, match="train_batch_size 5 not divisible "
                                         "by the data axis 2"):
        train(dataset="synthetic", device="cpu", data_axis=2, resident=True,
              train_batch_size=5)


class _Axis(DataAxis):
    """The data axis as rank ``r`` of ``n`` sees it (no group)."""

    def __init__(self, r, n):
        super().__init__(torch.device("cpu"))
        self._r, self._n = r, n

    size = property(lambda self: self._n)
    rank = property(lambda self: self._r)


@pytest.mark.parametrize("n,size", [(8, 2), (7, 2), (1, 2), (5, 4), (2, 4),
                                    (32, 8), (3, 8)])
def test_rows_are_the_rows_jax_puts_on_each_device(n, size):
    mesh = MeshContext.create(data=size)
    padded = mesh.padded_batch_size(n)
    assert _Axis(0, size).padded_batch_size(n) == padded
    x = np.arange(n, dtype=np.float32)
    xp, mask = mesh.pad_to_batch_multiple(x, batch_size=padded)
    xq, mask_q = pad_to_batch_multiple(x, batch_size=padded)
    assert np.array_equal(xp, xq) and np.array_equal(mask, mask_q)
    arr = mesh.put_batch(((xp + 1.0) * mask).astype(np.float32))  # 0: padding
    by_device = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    for r, dev in enumerate(mesh.mesh.devices.reshape(-1)):
        real = by_device[dev][by_device[dev] > 0] - 1.0
        assert np.array_equal(x[_Axis(r, size).rows(n)], real), (r, dev)
    if n % size:
        with pytest.raises(ValueError, match="not divisible"):
            local_batch_size(n, _Axis(0, size))
    else:
        assert local_batch_size(n, _Axis(0, size)) == n // size


@pytest.mark.parametrize("momentum", [0.1, None, 0.0])
def test_an_axis_of_one_is_batchnorm2d_bit_for_bit(momentum):
    torch.manual_seed(0)
    plain = nn.BatchNorm2d(6, momentum=momentum)
    with torch.no_grad():
        plain.weight.uniform_(0.5, 1.5)
        plain.bias.normal_()
    ours = nn.Sequential(nn.BatchNorm2d(6, momentum=momentum))
    ours[0].load_state_dict(plain.state_dict())
    attach_data_axis(ours, DataAxis(torch.device("cpu")))
    assert type(ours[0]) is BatchNorm2d
    x = torch.randn(4, 6, 5, 5) * 3 + 1
    for _ in range(2):
        xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
        ya, yb = plain(xa), ours(xb)
        g = torch.randn_like(ya)
        ya.backward(g)
        yb.backward(g)
        assert torch.equal(ya, yb) and torch.equal(xa.grad, xb.grad)
    for k, v in plain.state_dict().items():
        assert torch.equal(v, ours[0].state_dict()[k]), k
    assert torch.equal(plain.weight.grad, ours[0].weight.grad)
    plain.eval()
    ours.eval()
    assert torch.equal(plain(x), ours(x))
