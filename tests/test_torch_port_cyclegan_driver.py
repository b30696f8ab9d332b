"""The port's CycleGAN paths (megastep, resident data, the driver, resume,
preemption, export) against the JAX package's and against themselves, on
the CPU, at ndf 8, 64x64, B 4, dropout off where the JAX side is compared.

- ``make_cyclegan_megastep`` at K = 3 against JAX's, strict SGD (JAX's
  ``tests/test_cyclegan_megastep.py``): parameters, running statistics and
  logs within TOL of each tensor's largest entry (the last step's losses,
  ``train_mse_nd`` summed), or within ``SENS_FACTOR`` times roundoff's
  scale where that is more (:func:`assert_runs_match`); and against
  three of the port's single steps, bit for bit (on the CPU the megastep
  runs its steps eagerly).
- ``make_cyclegan_resident_megastep`` and ``resident_cyclegan_test``
  against JAX's, fed the same programs (a padded tail among them), strict
  SGD: by the same rule (the noise on the stored frames), the eval within
  TOL. A planted fault, x and y swapped in the resident body, fails it.
- The driver end to end on the streaming, megastep and resident paths, and
  in bf16: finite results under the JAX driver's history keys (one JAX
  epoch run for them), float32 parameters, ``history.json`` and
  ``checkpoints/`` only under ``out_dir``.
- A preemption (a counting stand-in for ``GracefulShutdown``, as in
  ``test_torch_port_preempt.py``) inside epoch 2 on each path, then
  ``resume``: the last checkpoint's tree and ``history.json`` equal an
  uninterrupted run's, bit for bit (dropout on: its stream comes back).
- The JAX keywords the port does not have are refused, naming their
  ROADMAP item; a data axis without its processes raises; the CLI passes
  its flags through, ``--multihost`` into a launcher's group of one.
- ``serve export --workload cyclegan`` in both directions (f32 and w8a8,
  ``--check``): each artifact is its generator from the checkpoint, and
  the HTTP server answers with it.
"""

import json
import os
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

from extended_gan_tpu.data import resident as jax_resident
from extended_gan_tpu.train import cyclegan_driver as jax_driver
from extended_gan_tpu.train import cyclegan_trainer as jax_trainer
from extended_gan_torch.cycle_gan.__main__ import main as cli
from extended_gan_torch.data import resident, synthetic
from extended_gan_torch.parallel.mesh import LAUNCHER_VARS
from extended_gan_torch.serve import load_exported, make_server
from extended_gan_torch.serve.__main__ import main as serve_cli
from extended_gan_torch.train import cyclegan_driver, cyclegan_trainer
from extended_gan_torch.train.checkpoint import CYCLEGAN_NETS
from test_torch_port_cyclegan import (
    LAMBDA,
    _all_trees,
    jax_cyclegan,
    port_cyclegan,
)
from test_torch_port_export import _post
from test_torch_port_gat_family import one_torch_thread  # noqa: F401 - the autouse fixture
from test_torch_port_gat_smaat import SENS_FACTOR, gap
from test_torch_port_megastep import TOL
from test_torch_port_preempt import CountingShutdown
from test_torch_port_resume import assert_dcgan_runs_equal, latest

SGD_LR = 1e-3
K, B = 3, 4
RUN = dict(train_batch_size=4, test_batch_size=8, ndf=8, synthetic=True,
           seed=17, device="cpu")
KEYS = ["cycle_l1", "pred_mse", "train_mse"]


_SGD = {}  # the JAX side, built once: its jitted programs compile once


def sgd_pair():
    """JAX's CycleGAN under SGD (fresh states) and the port's with the same
    weights."""
    if not _SGD:
        models, txs, states, _ = jax_cyclegan(tx=lambda: optax.sgd(SGD_LR))
        _SGD.update(
            models=models, txs=txs, states=states,
            mega=jax_trainer.make_cyclegan_megastep(*models, *txs,
                                                    cycle_lambda=LAMBDA),
            resident=jax_resident.make_cyclegan_resident_megastep(
                *models, *txs, seq_len=4, cycle_lambda=LAMBDA))
    states = jax.tree_util.tree_map(jnp.copy, _SGD["states"])  # donated
    nets, opts = port_cyclegan(
        states, opt=lambda p: torch.optim.SGD(p, lr=SGD_LR))
    return _SGD["models"], _SGD["txs"], states, nets, opts


def _flat(trees):
    return {f"{net}.{kind}.{name}": v for (net, kind), tree in trees.items()
            for name, v in tree.items()}


def assert_runs_match(runs, n_groups):
    """``runs[side, inputs]`` = (logs of each group, flat trees) for side
    "jax", "port" and "f64" (the port in float64), inputs "x" and
    :func:`noisy` draws 0, 1, ... ("f64" runs on x only). Each tensor and
    log of the port within TOL of JAX's, relative to its largest entry, or
    within SENS_FACTOR times roundoff's scale: the most that a draw moves
    JAX's own result or the port's, or the port's float32 lies from its
    float64 twin. None of these grows with a fault that the port's float32
    and float64 share, so such a fault shows as a gap to JAX.

    Several draws, on every input: at K = 3 the third step's D_y update
    sits within roundoff of a switch, and one draw in two or three carries
    JAX or the port across it, moving D_y's BatchNorm biases by 1e-3 to
    7e-3 of their largest entry (the port in float32 stays on its float64
    twin's side; JAX lands on the other)."""
    (want_logs, want), (got_logs, got) = runs["jax", "x"], runs["port", "x"]
    assert len(got_logs) == len(want_logs) == n_groups
    assert sorted(got_logs[0]) == sorted(want_logs[0])
    assert sorted(got) == sorted(want)

    def value(side, n, label):
        logs, trees = runs[side, n]
        if label.startswith("group"):
            _, i, key = label.split()
            return np.asarray(logs[int(i)][key], np.float64)
        return np.asarray(trees[label], np.float64)

    labels = [f"group {i} {key}" for i in range(n_groups)
              for key in want_logs[0]] + list(want)
    draws = [n for side, n in runs if side == "jax" and n != "x"]
    assert draws and all(("port", n) in runs for n in draws)
    for label in labels:
        port = value("port", "x", label)
        scale = max(gap(value(side, n, label), value(side, "x", label))
                    for side in ("jax", "port") for n in draws)
        scale = max(scale, gap(port, value("f64", "x", label)))
        err = gap(port, value("jax", "x", label))
        assert err <= max(TOL, SENS_FACTOR * scale), (label, err, scale)


NOISE_DRAWS = 3


def noisy(a):
    """{f"noisy{i}": a with each entry scaled by 1 + 1e-7 noise, about one
    rounding} for ``NOISE_DRAWS`` draws, from seeds 0, 1, ..."""
    return {f"noisy{i}": (a * (1 + 1e-7 * np.random.default_rng(i)
                                .standard_normal(a.shape))).astype(np.float32)
            for i in range(NOISE_DRAWS)}


def _megastep_run(side, xs, ys, masks):
    """One K-step megastep from the SGD pair's weights: ([logs], trees);
    side "f64" is the port in float64."""
    models, txs, states, nets, opts = sgd_pair()
    if side == "f64":
        nets = [n.double() for n in nets]
        opts = [torch.optim.SGD(n.parameters(), lr=SGD_LR) for n in nets]
        xs, ys, masks = (a.astype(np.float64) for a in (xs, ys, masks))
    if side == "jax":
        states, logs = _SGD["mega"](states, jnp.asarray(nhwc_k(xs)),
                            jnp.asarray(nhwc_k(ys)), jnp.asarray(masks),
                            jax.random.split(jax.random.PRNGKey(0), K))
        return [jax.device_get(logs)], _flat(_all_trees(states=states))
    logs = cyclegan_trainer.make_cyclegan_megastep(
        *nets, *opts, cycle_lambda=LAMBDA)(
            *(torch.from_numpy(a) for a in (xs, ys, masks)))
    return ([{k: v.numpy() for k, v in logs.items()}],
            _flat(_all_trees(nets=nets)))


def test_megastep_matches_jax_and_its_single_steps():
    """:func:`assert_runs_match`."""
    rng = np.random.default_rng(0)
    xs, ys = (rng.random((K, B, 4, 64, 64), np.float32) for _ in range(2))
    masks = np.ones((K, B), np.float32)
    inputs = {"x": np.stack([xs, ys]), **noisy(np.stack([xs, ys]))}
    runs = {(side, n): _megastep_run(side, *xy, masks)
            for side in ("jax", "port") for n, xy in inputs.items()}
    runs["f64", "x"] = _megastep_run("f64", xs, ys, masks)
    assert_runs_match(runs, 1)
    # the same K steps one by one, from the same weights: bit for bit
    _, _, _, nets, opts = sgd_pair()
    step = cyclegan_trainer.make_cyclegan_train_step(*nets, *opts,
                                                     cycle_lambda=LAMBDA)
    nd = 0
    for i in range(K):
        logs = step(*(torch.from_numpy(a[i]) for a in (xs, ys, masks)))
        nd = nd + logs["train_mse_nd"].numpy()
    mega_logs, mega_trees = runs["port", "x"]
    assert np.array_equal(nd, mega_logs[0]["train_mse_nd"])
    assert float(logs["g_loss"]) == float(mega_logs[0]["g_loss"])
    trees = _flat(_all_trees(nets=nets))
    assert sorted(trees) == sorted(mega_trees)
    for k, v in trees.items():
        assert np.array_equal(v, mega_trees[k]), k


def nhwc_k(a):
    return np.moveaxis(a, 2, -1)


@pytest.fixture(scope="module")
def coastal(tmp_path_factory):
    """2 train files of 12 frames at 64x64 (5 windows each: batches of 4
    and 1) and a test file of 12."""
    root = str(tmp_path_factory.mktemp("coastal"))
    synthetic.make_coastal_dataset(root, n_train_files=2, n_test_files=1,
                                   frames_per_file=12, seed=5)
    return root


def _resident_run(side, video, starts, progs):
    """The resident megastep over ``progs`` from the SGD pair's weights,
    on a store of ``video``: ([logs of each program], trees); side "f64" is
    the port in float64."""
    models, txs, states, nets, opts = sgd_pair()
    if side == "f64":
        nets = [n.double() for n in nets]
        opts = [torch.optim.SGD(n.parameters(), lr=SGD_LR) for n in nets]
    if side == "jax":
        logs = []
        for prog in progs:
            states, out = _SGD["resident"](states, jnp.asarray(video),
                               jnp.asarray(prog.astype(np.int32)),
                               jax.random.split(jax.random.PRNGKey(1), 2))
            logs.append(jax.device_get(out))
        return logs, _flat(_all_trees(states=states))
    store = resident.ResidentVideos(video, starts, 8)
    if side == "f64":
        store.video = store.video.double()
    mega = resident.make_cyclegan_resident_megastep(
        *nets, *opts, store, seq_len=4, cycle_lambda=LAMBDA)
    logs = [{k: v.numpy() for k, v in mega(torch.from_numpy(p)).items()}
            for p in progs]
    return logs, _flat(_all_trees(nets=nets))


@pytest.fixture(scope="module")
def resident_jax(coastal):
    """The train split's store (10 windows; K = 2 programs of B = 4, the
    second ending in 6 padded rows) and JAX's resident runs on it, on the
    stored frames and on their :func:`noisy` draws."""
    store = resident.ResidentVideos.from_pt_frames(
        os.path.join(coastal, "train"))
    progs = store.epoch_programs(0, 2, B, shuffle=False).numpy()
    assert len(progs) == 2 and int((progs[1] < 0).sum()) == 6
    video, starts = store.video.numpy(), store.starts.numpy()
    inputs = {"x": video, **noisy(video)}
    runs = {("jax", n): _resident_run("jax", v, starts, progs)
            for n, v in inputs.items()}
    return inputs, starts, progs, runs


def _resident_port_runs(resident_jax):
    inputs, starts, progs, jax_runs = resident_jax
    runs = {("port", n): _resident_run("port", v, starts, progs)
            for n, v in inputs.items()}
    runs["f64", "x"] = _resident_run("f64", inputs["x"], starts, progs)
    return {**jax_runs, **runs}


def test_resident_megastep_and_eval_match_jax(coastal, resident_jax):
    assert_runs_match(_resident_port_runs(resident_jax), 2)
    models, _, states, nets, _ = sgd_pair()
    test_folder = os.path.join(coastal, "test")
    t_store = resident.ResidentVideos.from_pt_frames(test_folder)
    t_store_j = jax_resident.ResidentVideos.from_pt_frames(test_folder)
    j_eval = jax_resident.make_cyclegan_resident_eval(models[0], models[1])
    p_eval = resident.make_cyclegan_resident_eval(nets[0], nets[1], t_store)
    for bs in (3, 4):
        want = jax_resident.resident_cyclegan_test(j_eval, states, t_store_j,
                                                   k=2, batch_size=bs)
        got = resident.resident_cyclegan_test(p_eval, t_store, k=2,
                                              batch_size=bs)
        assert sorted(got) == sorted(want) == ["cycle_l1", "pred_mse"]
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=TOL, err_msg=k)
    # the resident eval's batches are the streaming eval's (one file,
    # consecutive windows), so the sums agree
    from extended_gan_torch.data.streaming import CoastalSeaLoader

    stream = cyclegan_trainer.test(
        CoastalSeaLoader(test_folder, 3, shuffle=False),
        cyclegan_trainer.make_cyclegan_eval_step(nets[0], nets[1]),
        torch.device("cpu"))
    got = resident.resident_cyclegan_test(p_eval, t_store, k=2, batch_size=3)
    for k in stream:
        np.testing.assert_allclose(got[k], stream[k], rtol=1e-6, err_msg=k)


def test_a_resident_body_with_x_and_y_swapped_fails(monkeypatch,
                                                   resident_jax):
    """A planted fault, in the port's float32 and float64 runs alike: the
    resident gather hands the future frames over as the context and the
    context as the future. :func:`assert_runs_match` must fail it."""
    gather = resident._gather_windows

    def swapped(video, starts, w, **kwargs):
        wins, mask = gather(video, starts, w, **kwargs)
        return torch.cat([wins[:, w // 2:], wins[:, :w // 2]], 1), mask

    monkeypatch.setattr(resident, "_gather_windows", swapped)
    with pytest.raises(AssertionError):
        assert_runs_match(_resident_port_runs(resident_jax), 2)


@pytest.fixture(scope="module")
def jax_keys(coastal, tmp_path_factory):
    """The JAX driver's history keys, from one epoch of one batch (on this
    file's archive: the JAX package's default synthetic one is made in
    place, and other test files read it)."""
    root = tmp_path_factory.mktemp("jax_cyclegan")
    _, history = jax_driver.train(
        epochs=1, train_batch_size=4, test_batch_size=64, ndf=8,
        max_batches=1, out_dir=str(root / "out"), data_location=coastal)
    return sorted(history.history)


PATHS = {"streaming": {}, "megastep": {"megastep": 2},
         "resident": {"resident": True, "megastep": 2},
         "bf16": {"precision": "bf16"}}


@pytest.mark.parametrize("path", list(PATHS))
def test_driver_trains_on_each_path(tmp_path, jax_keys, path):
    out = str(tmp_path / "out")
    nets, history = cyclegan_driver.train(
        epochs=1, max_batches=4, out_dir=out, save_epoch=1, **RUN,
        **PATHS[path])
    assert sorted(history.history) == jax_keys == KEYS
    assert all(np.isfinite(v[0]) for v in history.history.values())
    assert sorted(os.listdir(out)) == ["checkpoints", "history.json",
                                       "imgs", "training_plots"]
    assert all(p.isfinite().all() and p.dtype == torch.float32
               for n in nets for p in n.parameters())
    step, tree = latest(out)
    assert sorted(tree["states"]) == sorted(CYCLEGAN_NETS)
    assert int(tree["epoch"]) == 1


# (path, the read of the shutdown flag that stops the run): one read a step
# or group of K and one at each epoch's end, so with 4 steps an epoch (2
# groups of 2) the first step (group) of epoch 2
PREEMPT = [("streaming", 6), ("megastep", 4), ("resident", 4)]


@pytest.mark.parametrize("path,fire_at", PREEMPT)
def test_a_preempted_run_resumes_bit_for_bit(tmp_path, monkeypatch, coastal,
                                             path, fire_at):
    kw = dict(epochs=2, max_batches=4, save_epoch=5, **RUN, **PATHS[path],
              data_location=coastal)
    kw["synthetic"] = False
    ref, run = str(tmp_path / "ref"), str(tmp_path / "run")
    _, h_ref = cyclegan_driver.train(out_dir=ref, **kw)
    shutdown = CountingShutdown(fire_at)
    monkeypatch.setattr(cyclegan_driver, "GracefulShutdown",
                        lambda: shutdown)
    cyclegan_driver.train(out_dir=run, **kw)
    step, tree = latest(run)
    assert 0 < int(tree["mid"]["batch"]) < 4 and int(tree["epoch"]) == 2
    monkeypatch.undo()
    _, h_run = cyclegan_driver.train(out_dir=run, resume=True, **kw)
    assert h_run.history == h_ref.history
    assert_dcgan_runs_equal(ref, run)


# item 9's options that are ported now (FSDP, TP): taken, not refused
PORTED = {"fsdp", "fsdp_min_size", "model_axis", "tp_min_channels"}


@pytest.mark.parametrize("key,value,item", [
    ("model_axis", 2, 9), ("tp_min_channels", 8, 9),
    ("fsdp", True, 9), ("fsdp_min_size", 1, 9), ("spatial", True, 9)])
def test_unported_keywords_are_refused(key, value, item, monkeypatch):
    """The options item 9 has not ported raise, naming it; FSDP's and
    TP's are taken (past the option checks: the data axis's)."""
    if key in PORTED:
        stop = RuntimeError("past the option checks")

        def stopped(*args, **kwargs):
            raise stop

        monkeypatch.setattr(cyclegan_driver, "data_axis_for", stopped)
        with pytest.raises(RuntimeError, match="past the option checks"):
            cyclegan_driver.train(**{key: value}, **RUN)
        assert key not in cyclegan_driver._NOT_PORTED
        return
    with pytest.raises(NotImplementedError, match=f"queue 1 item {item}"):
        cyclegan_driver.train(**{key: value}, **RUN)


def test_a_data_axis_without_its_processes_raises():
    with pytest.raises(RuntimeError, match="needs 2 processes"):
        cyclegan_driver.train(data_axis=2, **RUN)
    with pytest.raises(ValueError, match="not divisible by the data axis 3"):
        cyclegan_driver.train(data_axis=3, resident=True, **RUN)


def test_off_values_unknown_keywords_and_the_cli(monkeypatch):
    with pytest.raises(TypeError, match="fused_prop"):
        cyclegan_driver.train(fused_prop=True, **RUN)
    seen = {}
    monkeypatch.setattr("extended_gan_torch.cycle_gan.__main__.train",
                        lambda **kw: seen.update(kw))
    cli(["--device", "cpu", "--resident", "--megastep", "4", "--precision",
         "bf16", "--resume", "--save-epoch", "2", "--out-dir", "/o",
         "--cycle-lambda", "5", "--imsize", "32", "--ndf", "16"])
    assert (seen["device"], seen["resident"], seen["megastep"],
            seen["precision"], seen["resume"], seen["save_epoch"],
            seen["out_dir"], seen["cycle_lambda"], seen["imsize"],
            seen["ndf"]) == ("cpu", True, 4, "bf16", True, 2, "/o", 5.0, 32,
                             16)
    # the JAX CLI's defaults for the options the port refuses are their
    # off values
    off = {k: v[0] for k, v in cyclegan_driver._NOT_PORTED.items()}
    assert {k: seen[k] for k in off} == off
    assert seen["packed_g"] is None  # JAX's default: off
    assert seen["data_axis"] is None
    # --multihost joins the launcher's group (here a gloo world of one)
    # and passes on to the driver; without a launcher it raises
    for k in LAUNCHER_VARS + ("SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="launcher environment"):
        cli(["--multihost"])
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                     MASTER_ADDR="127.0.0.1", MASTER_PORT="0").items():
        monkeypatch.setenv(k, v)
    seen.clear()
    try:
        cli(["--device", "cpu", "--multihost"])
        assert dist.is_initialized() and dist.get_world_size() == 1
    finally:
        dist.destroy_process_group()
    assert seen["device"] == "cpu" and seen["data_axis"] is None


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """One CLI epoch, checkpointed, and both generators exported (f32 and
    w8a8, each checked)."""
    root = tmp_path_factory.mktemp("cg_export")
    out = str(root / "run")
    nets, _ = cli(["--device", "cpu", "--epochs", "1", "--max-batches", "2",
                   "--synthetic", "--out-dir", out, "--save-epoch", "1",
                   "--train-batch-size", "4", "--test-batch-size", "8",
                   "--ndf", "8"])
    arts = {}
    for direction in ("xy", "yx"):
        for q in ("", "w8a8"):
            path = str(root / f"g_{direction}{q}.pt")
            info = serve_cli(["export", out, "--workload", "cyclegan",
                              "--direction", direction, "--ndf", "8",
                              "--out", path, "--check", "--device", "cpu",
                              *(["--quantize", q] if q else [])])
            arts[direction, q] = (path, info)
    return nets, arts


def test_export_is_the_generator_of_each_direction(exported):
    nets, arts = exported
    x = np.random.default_rng(3).random((3, 64, 64, 4), np.float32)
    for i, direction in enumerate(("xy", "yx")):
        path, info = arts[direction, ""]
        assert info["model_type"] == f"cyclegan_generator_{direction}"
        assert info["epoch"] == 1 and info["inputs"] == ["float32[b,64,64,4]"]
        art = load_exported(path, device="cpu")
        with torch.no_grad():
            got = art.fn(torch.from_numpy(x)).numpy()
            want = nets[i].eval()(torch.from_numpy(
                np.ascontiguousarray(x.transpose(0, 3, 1, 2)))).numpy()
        np.testing.assert_allclose(got, want.transpose(0, 2, 3, 1), rtol=0,
                                   atol=1e-6)
        assert arts[direction, "w8a8"][1]["spec"]["quantize"] == "w8a8"
    # the two directions are different generators
    a, b = (load_exported(arts[d, ""][0], device="cpu") for d in ("xy", "yx"))
    with torch.no_grad():
        assert not np.allclose(a.fn(torch.from_numpy(x)).numpy(),
                               b.fn(torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("q", ["", "w8a8"])
def test_server_answers_with_the_exported_generator(exported, q):
    path = exported[1]["yx", q][0]
    server = make_server(path, port=0, device="cpu")
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            assert json.loads(r.read())["inputs"] == ["float32[b,64,64,4]"]
        art = load_exported(path, device="cpu")
        x = np.random.default_rng(5).random((5, 64, 64, 4), np.float32)
        y = _post(url + "/predict", x)
        with torch.no_grad():
            want = art.fn(torch.from_numpy(x)).numpy()
        assert y.shape == x.shape and np.isfinite(y).all()
        np.testing.assert_allclose(y, want, rtol=0,
                                   atol=1e-6 if not q else 5e-3)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
