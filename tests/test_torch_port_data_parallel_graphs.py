"""``--megastep`` and ``--resident`` under the port's data axis, on the CPU
(where a megastep is K eager steps; the card captures them into one CUDA
graph with their NCCL collectives, ``chip_smoke.py``'s
``gan_data_parallel`` phase).

- Two gloo ranks (``torch_dp_ranks.graph_runs``) train the narrow UNet,
  DCGAN and CycleGAN (dropout on for the GANs) with SGD, each by
  ``make_*_megastep`` (K = 4 over 5 streamed global batches of 4, the
  last ragged: groups of 4 and 1, every batch padded to a multiple of the
  axis and split evenly) and by ``make_*_resident_megastep`` (programs of
  2 x 4 over a store of two files of 7 windows, the tail padded with -1),
  and evaluate
  the resident store in batches of 3 (ragged shards: 2 + 1 rows). They
  are held to the same runs in one process: every group's logs, the
  weights, the statistics and the eval's results within ``TRAIN_TOL`` of
  each tensor's largest entry or ``SENS_FACTOR`` times the one process's
  own roundoff there, from the plain path alone (float32 against
  float64, against its input under 1e-7 noise, and against itself on 4
  torch threads: another reduction order, which at these shapes flips a
  roundoff-decided branch of the DCGAN's first group, its TD loss 0.35%
  and a BatchNorm running variance 2.7% off float64 on 4 or 8 threads,
  0.02% and 0.27% on 1, 2, 3 or 6; over a few SGD steps the UNet
  amplifies roundoff to 1e-3 of its losses); the ranks end equal, bit
  for bit.
- Each rank's columns of a resident program are the shard JAX's
  ``device_put`` over the data axis gives its device
  (``extended_gan_tpu/data/resident.py:236-239``).
- A resident train batch must divide by the axis, in all three drivers.
- CUDA graphs over a gloo group on the card raise, naming NCCL (as far as
  it can be reached without a card: ``DataAxis.check_capturable``, which
  ``Megastep`` calls).
- The ``dcgan`` and ``cycle_gan`` CLIs with ``--device cpu --data-axis
  2``: their history within ``CLI_RTOL`` of one process (Adam carries a
  reordered sum near 0 into the next step), rank 0 alone writing; and
  ``--multihost`` under a launcher environment of one rank equals the
  plain CLI bit for bit.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_dp_ranks as ranks
from extended_gan_tpu.parallel import MeshContext
from extended_gan_torch.cycle_gan.__main__ import main as cyclegan_cli
from extended_gan_torch.data.resident import ResidentVideos
from extended_gan_torch.dcgan.__main__ import main as dcgan_cli
from extended_gan_torch.models.dcgan import (
    FrameDiscriminator,
    Generator,
    TemporalDiscriminator,
)
from extended_gan_torch.parallel.mesh import LAUNCHER_VARS
from extended_gan_torch.train import cyclegan_driver, dcgan_driver, gat_driver
from test_torch_port_data_parallel_cli import CLI_RTOL, _Axis
from test_torch_port_gat_family import one_torch_thread  # noqa: F401 - the autouse fixture
from test_torch_port_gat_smaat import SENS_FACTOR, TRAIN_TOL, gap, perturbed

KINDS = ("unet", "dcgan", "cyclegan")
PATHS = ("megastep", "resident")


@functools.cache
def _state(kind):
    """The port's own initial weights of ``kind``, one state_dict a net."""
    init = torch.Generator().manual_seed(3)
    nc, ndf = ranks.GAN_NC, ranks.GAN_NDF
    if kind == "unet":
        torch.manual_seed(3)
        nets = (ranks.make_model("unet"),)
    elif kind == "dcgan":
        nets = (Generator(nc, generator=init),
                FrameDiscriminator(nc, ndf, generator=init),
                TemporalDiscriminator(nc, ndf, generator=init))
    else:
        nets = (Generator(nc, generator=init), Generator(nc, generator=init),
                FrameDiscriminator(nc, ndf, generator=init),
                FrameDiscriminator(nc, ndf, generator=init))
    return [net.state_dict() for net in nets]


def _case(kind, path, perturb=False):
    rng = np.random.default_rng(11)
    if kind == "unet":
        shape = (ranks.HW, ranks.HW, ranks.T, ranks.V)
        frame = (ranks.HW, ranks.HW, ranks.V)
    else:
        shape = (ranks.GAN_NC, ranks.GAN_IM, ranks.GAN_IM)
        frame = (ranks.GAN_IM, ranks.GAN_IM)
    case = dict(kind=kind, path=path, state=_state(kind))
    if path == "megastep":
        case["batches"] = [tuple(rng.random((n,) + shape, np.float32)
                                 for _ in range(2))
                           for n in (4, 4, 4, 4, 3)]
    else:
        case["video"] = rng.random((28,) + frame, np.float32)
    if perturb and path == "megastep":
        case["batches"] = [tuple(map(perturbed, b)) for b in case["batches"]]
    elif perturb:
        case["video"] = perturbed(case["video"])
    return case


CASES = {f"{k} {p}": (k, p) for k in KINDS for p in PATHS}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    cases = {name: _case(*spec) for name, spec in CASES.items()}
    return ranks.run("graph_runs", 2, tmp_path_factory.mktemp("graph_ranks"),
                     {"cases": cases})


@functools.cache
def _single(name, dtype=torch.float32, perturb=False, threads=1):
    with ranks.torch_threads(threads):
        return ranks.graph_run(_case(*CASES[name], perturb), None, dtype)


def test_every_rank_ends_with_the_same_state(two_ranks):
    r0, r1 = two_ranks
    for name in CASES:
        for part in ("params", "stats"):
            for t0, t1 in zip(r0[name][part], r1[name][part]):
                for k, v in t0.items():
                    assert np.array_equal(v, t1[k]), (name, part, k)
        assert r0[name].get("eval") == r1[name].get("eval"), name


def _tensors(run):
    """{label: array} of a run: each group's logs, the weights and
    statistics after the run, the eval's results."""
    out = {f"group {i} {k}": np.asarray(v, np.float64)
           for i, logs in enumerate(run["logs"]) for k, v in logs.items()}
    for part in ("params", "stats"):
        for i, tree in enumerate(run[part]):
            out.update({f"{part} {i} {k}": v for k, v in tree.items()})
    out.update({f"eval {k}": np.float64(v)
                for k, v in run.get("eval", {}).items()})
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_two_ranks_match_one_process(two_ranks, name):
    got, want = _tensors(two_ranks[0][name]), _tensors(_single(name))
    twins = [(_single(name), _single(name, torch.float64)),
             (_single(name, perturb=True), _single(name)),
             (_single(name, threads=4), _single(name))]
    twins = [(_tensors(a), _tensors(b)) for a, b in twins]
    assert sorted(got) == sorted(want)
    assert sum(k.startswith("group") for k in want) > 2
    worst = []
    for k, w in want.items():
        sens = max(gap(a[k], b[k]) for a, b in twins)
        worst.append((gap(got[k], w) / max(TRAIN_TOL, SENS_FACTOR * sens),
                      k))
    worst.sort(reverse=True)
    assert worst[0][0] <= 1.0, worst[:3]


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("batch", [4, 8])
def test_resident_program_rows_are_jax_device_shards(size, batch):
    frames = np.random.default_rng(0).random((60, 8, 8), np.float32)
    store = ResidentVideos(frames, np.arange(53), 8,
                           file_starts=[np.arange(53)])
    progs = store.epoch_programs(7, 3, batch)  # a -1 padded tail
    assert (progs[-1] == -1).any()
    mesh = MeshContext.create(data=size)
    import jax

    sharded = jax.device_put(progs.numpy(), mesh.sharding(None, None, "data"))
    by_device = {s.device: np.asarray(s.data) for s in sharded.addressable_shards}
    for r, dev in enumerate(mesh.mesh.devices.reshape(-1)):
        assert np.array_equal(_Axis(r, size).shard(progs, -1).numpy(),
                              by_device[dev]), (r, dev)
    evals, _ = store.eval_programs(2, 5, min_batch=1)
    ragged = [_Axis(r, 2).shard(evals, -1) for r in range(2)]
    assert torch.equal(torch.cat(ragged, -1), evals)
    assert [p.shape[-1] for p in ragged] == [3, 2]


@pytest.mark.parametrize("driver,kw", [
    (gat_driver, dict(dataset="synthetic")), (dcgan_driver, {}),
    (cyclegan_driver, dict(ndf=8))])
def test_a_resident_batch_must_divide_by_the_data_axis(driver, kw):
    with pytest.raises(ValueError, match="train_batch_size 6 not divisible "
                                         "by the data axis 4"):
        driver.train(device="cpu", data_axis=4, resident=True,
                     train_batch_size=6, **kw)


def test_graphs_over_gloo_on_the_card_raise_naming_nccl(two_ranks):
    for r in two_ranks:
        assert r["refusal"] and "needs NCCL" in r["refusal"] \
            and "gloo" in r["refusal"]
    # an axis of one has no collectives to capture
    ranks.DataAxis(torch.device("cuda", 0)).check_capturable()


DCGAN_ARGS = ["--device", "cpu", "--epochs", "1", "--max-batches", "2",
              "--synthetic", "--train-batch-size", "5", "--test-batch-size",
              "64", "--save-epoch", "1"]
CYCLEGAN_ARGS = DCGAN_ARGS + ["--ndf", "8"]
CLIS = {"dcgan": (dcgan_cli, DCGAN_ARGS),
        "cycle_gan": (cyclegan_cli, CYCLEGAN_ARGS)}


@pytest.fixture
def no_launcher(monkeypatch):
    for k in LAUNCHER_VARS + ("SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)


def _history(out):
    with open(os.path.join(out, "history.json")) as f:
        return json.load(f)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("cli", sorted(CLIS))
def test_cli_data_axis_2_on_the_cpu_matches_one_process(tmp_path, cli,
                                                        no_launcher):
    main, args = CLIS[cli]
    main(args + ["--out-dir", str(tmp_path / "one")])
    assert main(args + ["--out-dir", str(tmp_path / "two"),
                        "--data-axis", "2"]) is None
    one, two = _history(tmp_path / "one"), _history(tmp_path / "two")
    assert sorted(one) == sorted(two)
    for k in one:
        np.testing.assert_allclose(two[k], one[k], rtol=CLI_RTOL, atol=1e-12,
                                   err_msg=k)
    # rank 0 alone wrote: the same files as the one-process run
    assert _files(tmp_path / "two") == _files(tmp_path / "one")


@pytest.mark.parametrize("cli", sorted(CLIS))
def test_multihost_world_of_one_is_the_single_device_path(tmp_path, cli,
                                                          monkeypatch,
                                                          no_launcher):
    main, args = CLIS[cli]
    _, plain = main(args + ["--out-dir", str(tmp_path / "plain")])
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                     MASTER_ADDR="127.0.0.1", MASTER_PORT="0").items():
        monkeypatch.setenv(k, v)
    try:
        _, multi = main(args + ["--out-dir", str(tmp_path / "multi"),
                                "--multihost"])
        assert dist.is_initialized() and dist.get_world_size() == 1
    finally:
        dist.destroy_process_group()
    assert multi.history == plain.history
    assert _history(tmp_path / "multi") == _history(tmp_path / "plain")
