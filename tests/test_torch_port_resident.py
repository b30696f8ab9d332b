"""The port's device-resident archive (``data/resident.py``) against the JAX
package's, on the CPU.

- ``from_kmni``, ``from_h5`` (the JAX package's ``.h5`` archive and the
  port's ``.npy`` one) and ``from_arai`` hold the same video, window starts
  and per-file starts as JAX's, exactly.
- ``epoch_programs(shuffle=False)``, ``eval_programs`` and
  ``program_sample_counts`` equal JAX's. A shuffled epoch (the port's
  ``torch.randperm``, whose order differs from JAX's) is a permutation of
  the starts, padded with -1 in its last program only, and the same for
  the same seed.
- ``_median_of_uniques`` equals the reference's ``np.unique`` rule, with
  ties and with padded rows repeating row 0.
- The GAT and DCGAN resident megasteps against JAX's fed the same programs
  (a partly and a wholly padded row among them; strict SGD, dropout off),
  parameters, statistics and logs within 2e-5 of each tensor's largest
  entry (the DCGAN's within ``SENS_FACTOR`` times what one rounding of the
  stored frames moves either side's own result, where that is more:
  ``test_torch_port_megastep.assert_dcgan_runs_match``); the resident GAT
  and DCGAN evals against JAX's at 2e-5, and the DCGAN's against the
  port's streaming eval.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extended_gan_tpu.data import resident as jax_resident
from extended_gan_tpu.data import synthetic as jax_synthetic
from extended_gan_torch.data import resident, synthetic
from extended_gan_torch.models.convert import from_flax_params
from test_torch_port_gat_family import one_torch_thread  # noqa: F401 - the autouse fixture
from test_torch_port_gat_smaat import gap, perturbed
from test_torch_port_megastep import (
    _dcgan_pair,
    _gat_pair,
    assert_dcgan_runs_match,
    dcgan_trees,
)

TOL = 2e-5
K, B = 2, 4


@pytest.fixture(scope="module")
def kmni(tmp_path_factory):
    """2 train files of 16 frames at 8x8: 9 windows each."""
    return synthetic.make_kmni_dataset(
        str(tmp_path_factory.mktemp("kmni")), n_train_files=2,
        frames_per_file=16, hw=8, seed=3)


@pytest.fixture(scope="module")
def h5(tmp_path_factory):
    """The JAX package's .h5 archive and the port's .npy one, 64x64."""
    kw = dict(frames_train=24, frames_test=16, h=64, w=64, seed=4)
    return {"jax": jax_synthetic.make_h5_dataset(
                str(tmp_path_factory.mktemp("h5")), **kw),
            "port": synthetic.make_h5_dataset(
                str(tmp_path_factory.mktemp("npy")), **kw)}


def _same_store(got, want):
    np.testing.assert_array_equal(got.video.numpy(), np.asarray(want.video))
    np.testing.assert_array_equal(got.starts.numpy(), np.asarray(want.starts))
    assert len(got.file_starts) == len(want.file_starts) > 0
    for g, w in zip(got.file_starts, want.file_starts):
        np.testing.assert_array_equal(g, w)
    assert (got.n_windows, got.window, got.power, got.normalizing_max) == (
        want.n_windows, want.window, want.power, want.normalizing_max)


@pytest.mark.parametrize("power", [1.0, 0.5])
def test_kmni_store_equals_jax(kmni, power):
    kw = dict(crop=6, power=power)
    _same_store(resident.ResidentVideos.from_kmni(kmni + "/train", **kw),
                jax_resident.ResidentVideos.from_kmni(kmni + "/train", **kw))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_h5_store_equals_jax(h5, writer):
    kw = dict(crop=48, in_seq_len=4, out_seq_len=4)
    folder = h5[writer] + "/train"
    _same_store(resident.ResidentVideos.from_h5(folder, **kw),
                jax_resident.ResidentVideos.from_h5(folder, **kw))


def test_arai_store_equals_jax(tmp_path):
    synthetic.make_arai_dataset(str(tmp_path), n_files=2, frames_per_file=14,
                                n_regions=5, h=12, w=12)
    (tmp_path / "training" / "notes.md").write_text("not data")
    kw = dict(downsample_size=(8, 10))
    _same_store(
        resident.ResidentVideos.from_arai(str(tmp_path / "training"), **kw),
        jax_resident.ResidentVideos.from_arai(str(tmp_path / "training"),
                                              **kw))


def test_programs_equal_jax(kmni):
    store = resident.ResidentVideos.from_kmni(kmni + "/train")
    theirs = jax_resident.ResidentVideos.from_kmni(kmni + "/train")
    for k, b in ((2, 4), (3, 5), (1, 18), (4, 32)):
        got = store.epoch_programs(0, k, b, shuffle=False)
        want = theirs.epoch_programs(jax.random.PRNGKey(0), k, b,
                                     shuffle=False)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert store.program_sample_counts(len(got), k, b) == \
            theirs.program_sample_counts(len(got), k, b)
        for min_batch in (1, 2):
            (gp, gt), (wp, wt) = (s.eval_programs(k, b, min_batch=min_batch)
                                  for s in (store, theirs))
            np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
            assert gt == wt


def test_shuffled_epoch_is_a_permutation(kmni):
    store = resident.ResidentVideos.from_kmni(kmni + "/train")
    k, b = 2, 4
    progs = store.epoch_programs(resident.epoch_seed(369, 1), k, b)
    flat = progs.reshape(-1).numpy()
    valid = flat[flat >= 0]
    np.testing.assert_array_equal(np.sort(valid), store.starts.numpy())
    assert (flat == -1).sum() == len(progs) * k * b - store.n_windows
    assert (progs[:-1] >= 0).all() and (progs[-1] == -1).any()
    assert torch.equal(progs, store.epoch_programs(
        resident.epoch_seed(369, 1), k, b))
    assert not torch.equal(progs, store.epoch_programs(
        resident.epoch_seed(369, 2), k, b))
    assert not np.array_equal(valid, store.starts.numpy())


def test_median_of_uniques_equals_the_reference_rule():
    rng = np.random.default_rng(5)
    for trial in range(20):
        vals = (rng.integers(0, 9, (6, 3, 4)) / 4).astype(np.float32)
        valid = rng.integers(1, 7)
        padded = np.where((np.arange(6) < valid)[:, None, None], vals,
                          vals[0:1])
        unique = np.unique(vals[:valid])
        want = unique[int(len(unique) * 0.5)]
        got = resident._median_of_uniques(torch.from_numpy(padded))
        assert got.shape == () and got.item() == want, trial


def _gat_programs(store_j):
    """The epoch's programs as JAX makes them (shuffled): the last holds a
    partly and a wholly padded row."""
    progs = np.asarray(store_j.epoch_programs(jax.random.PRNGKey(7), K, B))
    assert (progs[-1, -1] == -1).all() and (progs[-1, 0] >= 0).any()
    return progs


def test_gat_resident_megastep_matches_jax(kmni):
    store = resident.ResidentVideos.from_kmni(kmni + "/train")
    store_j = jax_resident.ResidentVideos.from_kmni(kmni + "/train")
    progs = _gat_programs(store_j)
    fmodel, tx, state, model, opt = _gat_pair(1e-2)
    jmega = jax_resident.make_gat_resident_megastep(fmodel, tx, time_steps=4)
    mega = resident.make_gat_resident_megastep(model, opt, store)
    for i, prog in enumerate(progs):
        state, want = jmega(state, store_j.video, jnp.asarray(prog),
                            jax.random.split(jax.random.PRNGKey(i), K))
        got = mega(torch.from_numpy(prog.copy()))
        for key in ("loss", "running_nd"):
            np.testing.assert_allclose(got[key].detach().numpy(),
                                       np.asarray(want[key]), rtol=TOL,
                                       atol=1e-7, err_msg=f"{i} {key}")
    expect = from_flax_params(jax.device_get(state.params),
                              jax.device_get(state.batch_stats))
    for name, t in model.state_dict().items():
        if not name.endswith("num_batches_tracked"):
            assert gap(t.numpy(), expect[name].numpy()) <= TOL, name


def test_gat_resident_eval_matches_jax(kmni):
    store = resident.ResidentVideos.from_kmni(kmni + "/train", power=0.5)
    store_j = jax_resident.ResidentVideos.from_kmni(kmni + "/train",
                                                    power=0.5)
    fmodel, _, state, model, _ = _gat_pair(1e-2)
    jeval = jax_resident.make_gat_resident_eval(
        fmodel, time_steps=4, power=0.5, normalizing_max=254.0)
    for b in (4, 7):
        want = jax_resident.resident_gat_test(jeval, state, store_j, k=3,
                                              batch_size=b)
        got = resident.resident_gat_test(
            resident.make_gat_resident_eval(model, store), store, k=3,
            batch_size=b)
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=TOL,
                                       atol=1e-7, err_msg=f"b={b} {key}")


def _dcgan_programs(store_j):
    progs = np.asarray(store_j.epoch_programs(jax.random.PRNGKey(8), K, B))
    assert (progs[-1, -1] == -1).all()
    return progs


def _run_dcgan_resident(video, starts, progs, side):
    """The resident megastep over ``progs`` from the same narrow nets, on a
    store of ``video``: (logs of each program, ``dcgan_trees``)."""
    models, txs, states, nets, opts = _dcgan_pair(1e-2)
    if side == "jax":
        store = jax_resident.ResidentVideos(video, starts, 8)
        mega = jax_resident.make_dcgan_resident_megastep(*models, *txs,
                                                         dedup_g=True)
        logs = []
        for i, prog in enumerate(progs):
            states, out = mega(states, store.video, jnp.asarray(prog),
                               jax.random.split(jax.random.PRNGKey(i), K))
            logs.append({n: np.asarray(v) for n, v in
                         jax.device_get(out).items()})
        return logs, dcgan_trees(states=states)
    store = resident.ResidentVideos(video, starts, 8)
    mega = resident.make_dcgan_resident_megastep(*nets, *opts, store)
    logs = [{n: v.detach().numpy()
             for n, v in mega(torch.from_numpy(prog.copy())).items()}
            for prog in progs]
    return logs, dcgan_trees(nets=nets)


def test_dcgan_resident_megastep_matches_jax(h5):
    """Held as ``test_torch_port_megastep.assert_dcgan_runs_match`` holds
    the streaming megastep, the noise on the stored frames."""
    store_j = jax_resident.ResidentVideos.from_h5(h5["port"] + "/train")
    progs = _dcgan_programs(store_j)
    video, starts = np.asarray(store_j.video), np.asarray(store_j.starts)
    assert_dcgan_runs_match(
        {(side, n): _run_dcgan_resident(v, starts, progs, side)
         for side in ("jax", "port")
         for n, v in (("x", video), ("noisy", perturbed(video)))},
        len(progs))


def test_dcgan_resident_eval_matches_jax(h5):
    folder = h5["port"] + "/test"
    store = resident.ResidentVideos.from_h5(folder)
    store_j = jax_resident.ResidentVideos.from_h5(folder)
    models, _, states, nets, _ = _dcgan_pair(1e-2)
    jeval = jax_resident.make_dcgan_resident_eval(*models)
    for b in (3, 4):
        want = jax_resident.resident_dcgan_test(jeval, states, store_j, k=2,
                                                batch_size=b)
        got = resident.resident_dcgan_test(
            resident.make_dcgan_resident_eval(*nets, store), store, k=2,
            batch_size=b)
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=TOL,
                                       atol=1e-7, err_msg=f"b={b} {key}")


def test_dcgan_resident_eval_equals_the_streaming_eval(h5):
    """Over the same split, the resident eval's batches are the streaming
    eval's (one file, consecutive windows), so the metrics agree."""
    from extended_gan_torch.data.streaming import H5SequenceLoader

    _, _, _, nets, _ = _dcgan_pair(1e-2)
    store = resident.ResidentVideos.from_h5(h5["port"] + "/test")
    loader = H5SequenceLoader(h5["port"] + "/test", 3, crop=64, shuffle=False,
                              in_seq_len=4, out_seq_len=4)
    from extended_gan_torch.train import dcgan_trainer

    ref = dcgan_trainer.test(loader, dcgan_trainer.make_dcgan_eval_step(*nets),
                             torch.device("cpu"))
    got = resident.resident_dcgan_test(
        resident.make_dcgan_resident_eval(*nets, store), store, k=2,
        batch_size=3)
    for key in ref:
        np.testing.assert_allclose(got[key], ref[key], rtol=TOL, atol=1e-7,
                                   err_msg=key)
