"""Export of trained models with the port, on the CPU: the DCGAN generator
from the DCGAN driver's checkpoint, int8 quantisation, rollouts, the conv-GAT
w8 artifacts, the HTTP server over a generator artifact, and the refusals.

The generator is trained for one epoch of two batches (ndf 8, save_epoch 1)
and exported as f32, w8, w8a8 and rollout 3, each with ``--check``; the
sidecars carry the keys the JAX export writes
(``tests/test_export.py::test_export_cli_dcgan_generator``), and the w8 and
w8a8 artifacts stay within that test's budgets of the f32 one (5e-3 and
3e-2). A conv-GAT model exports as w8 from a flax ``.npz`` (its answers
within 1e-5 of the JAX package's ``make_w8_apply``) and from the trained
``model.pt``. An artifact in the format written before workloads (format
1) still loads.
"""

import io
import json
import os
import shutil
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from extended_gan_tpu.models.gat.gat3d import Model as FlaxModel
from extended_gan_tpu.serve.quantize import make_w8_apply as jax_make_w8_apply
from extended_gan_torch.dcgan.__main__ import main as dcgan_cli
from extended_gan_torch.models.convert import from_flax_params
from extended_gan_torch.models.registry import build_model
from extended_gan_torch.serve import load_exported, make_server
from extended_gan_torch.serve.__main__ import main as cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPERIMENT = os.path.join(REPO, "convolutional_gat", "experiments",
                          "local_temporal_conv")
BUDGETS = {"w8": 5e-3, "w8a8": 3e-2}  # tests/test_export.py's, against f32
H = W = 8
T, V = 4, 6


def _x(b, seed=7):
    return np.random.default_rng(seed).random((b, 64, 64, 4), np.float32)


def _run(art, x):
    with torch.no_grad():
        return art.fn(torch.from_numpy(x)).numpy()


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The DCGAN driver's output directory after one epoch, and the
    artifacts exported from its checkpoint: {name: (path, sidecar)}."""
    root = tmp_path_factory.mktemp("dcgan")
    out = str(root / "run")
    dcgan_cli(["--device", "cpu", "--epochs", "1", "--max-batches", "2",
               "--synthetic", "--out-dir", out, "--save-epoch", "1",
               "--train-batch-size", "4", "--test-batch-size", "8"])
    arts = {}
    for name, extra in (("f32", []), ("w8", ["--quantize", "w8"]),
                        ("w8a8", ["--quantize", "w8a8"]),
                        ("roll", ["--rollout", "3"])):
        path = str(root / f"g_{name}.pt")
        info = cli(["export", out, "--workload", "dcgan", "--ndf", "8",
                    "--out", path, "--check", "--device", "cpu", *extra])
        with open(path + ".json") as f:
            assert json.load(f) == info
        arts[name] = (path, info)
    return out, arts


def test_generator_sidecars(trained):
    _, arts = trained
    for name, (path, meta) in arts.items():
        assert meta["model_type"] == "dcgan_generator"
        assert meta["epoch"] == 1
        assert meta["layout"] == "default"
        assert meta["nbytes"] == os.path.getsize(path)
        assert meta["inputs"] == ["float32[b,64,64,4]"]
        assert meta["spec"]["workload"] == "dcgan_generator"
        assert (meta["spec"]["nc"], meta["spec"]["imsize"]) == (4, 64)
    assert arts["roll"][1]["rollout"] == 3
    assert arts["roll"][1]["outputs"] == ["float32[b,3,64,64,4]"]
    for mode in ("w8", "w8a8"):
        meta = arts[mode][1]
        assert meta["quantize"] == meta["spec"]["quantize"] == mode
        assert meta["n_layers"] == 5
        assert meta["calibration"] == "uniform[0,1) synthetic"
    assert len(arts["w8a8"][1]["activation_scales"]) == 5
    assert "activation_scales" not in arts["w8"][1]


def test_quantized_artifacts_are_small_and_close(trained):
    _, arts = trained
    assert arts["w8"][1]["nbytes"] < arts["f32"][1]["nbytes"]
    x = _x(3)
    f32 = _run(load_exported(arts["f32"][0], device="cpu"), x)
    for mode, budget in BUDGETS.items():
        err = float(np.abs(_run(load_exported(arts[mode][0], device="cpu"),
                                x) - f32).max())
        assert 0 < err < budget, f"{mode}: {err}"


def test_generator_artifact_is_the_trained_generator(trained):
    out, arts = trained
    from extended_gan_torch.models.dcgan import Generator
    from extended_gan_torch.train.checkpoint import CheckpointManager

    restored = CheckpointManager(os.path.join(out, "checkpoints")).restore(
        None)
    g = Generator(4, dropout=0.0).eval()
    g.load_state_dict(restored["states"]["g"]["model"])
    x = _x(2, seed=1)
    with torch.no_grad():
        want = g(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    art = load_exported(arts["f32"][0], device="cpu")
    np.testing.assert_array_equal(_run(art, x), want.numpy())


def test_rollout_iterates_the_one_step_artifact(trained):
    _, arts = trained
    x = _x(3)
    rolled = _run(load_exported(arts["roll"][0], device="cpu"), x)
    assert rolled.shape == (3, 3, 64, 64, 4)
    one = load_exported(arts["f32"][0], device="cpu")
    h = x
    for k in range(3):
        h = _run(one, h)
        np.testing.assert_allclose(rolled[:, k], h, rtol=0, atol=1e-5)


def _post(url, x):
    buf = io.BytesIO()
    np.save(buf, x)
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return np.load(io.BytesIO(r.read()), allow_pickle=False)


@pytest.mark.parametrize("name", ["f32", "w8a8"])
def test_http_round_trip_of_a_generator_artifact(trained, name):
    path = trained[1][name][0]
    server = make_server(path, port=0, device="cpu")
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            assert json.loads(r.read())["inputs"] == ["float32[b,64,64,4]"]
        art = load_exported(path, device="cpu")
        for b in (1, 5):
            x = _x(b, seed=b)
            y = _post(url + "/predict", x)
            assert y.shape == x.shape and np.isfinite(y).all()
            want = _run(art, x)
            # a batch padded to a power of two runs other shapes: in w8a8 a
            # roundoff-level difference may flip a bin
            np.testing.assert_allclose(y, want, rtol=0,
                                       atol=1e-6 if name == "f32" else 5e-3)
        with pytest.raises(urllib.error.HTTPError) as bad:
            _post(url + "/predict", np.zeros((2, 64, 64, 3), np.float32))
        assert bad.value.code == 400
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_calibration_batch_from_a_file(trained, tmp_path):
    out, _ = trained
    calib = _x(4, seed=11) * 0.5
    npz = str(tmp_path / "calib.npz")
    np.savez(npz, batch=calib)
    path = str(tmp_path / "g.pt")
    info = cli(["export", out, "--workload", "dcgan", "--ndf", "8", "--out",
                path, "--quantize", "w8a8", "--calib-npz", npz, "--device",
                "cpu"])
    assert info["calibration"] == npz
    assert info["activation_scales"][0] * 127 == pytest.approx(
        float(calib.max()), rel=1e-6)
    bad = str(tmp_path / "bad.npy")
    np.save(bad, np.zeros((2, 32, 32, 4), np.float32))
    with pytest.raises(SystemExit, match="does not match"):
        cli(["export", out, "--workload", "dcgan", "--ndf", "8", "--out",
             path, "--quantize", "w8a8", "--calib-npz", bad, "--device",
             "cpu"])


@pytest.fixture(scope="module")
def flax_gat():
    """The JAX package's temporal/conv Model (8x8) with seeded params."""
    model = FlaxModel(image_width=W, image_height=H, n_vertices=V,
                      attention_type="temporal", mapping_type="conv")
    params = jax.device_get(jax.jit(model.init)(
        jax.random.PRNGKey(1), jnp.zeros((2, H, W, T, V)))["params"])
    return model, params


def _gat_x(b, seed=4):
    return np.random.default_rng(seed).random((b, H, W, T, V), np.float32)


def test_gat_w8_from_flax_weights_matches_jax(tmp_path, flax_gat):
    fmodel, params = flax_gat
    npz = tmp_path / "params.npz"
    np.savez(npz, **traverse_util.flatten_dict(params, sep="/"))
    out = str(tmp_path / "gat_w8.pt")
    info = cli(["export", EXPERIMENT, "--weights", str(npz), "--out", out,
                "--width", str(W), "--height", str(H), "--quantize", "w8",
                "--check", "--device", "cpu"])
    fwd, jmeta = jax_make_w8_apply(
        lambda v, x: fmodel.apply(v, x, train=False), {"params": params})
    for k in ("quantize", "quantized_leaves", "weight_bytes_int8",
              "weight_bytes_f32"):
        assert info[k] == jmeta[k], k
    assert info["spec"]["quantize"] == "w8"
    x = _gat_x(3)
    got = _run(load_exported(out, device="cpu"), x)
    np.testing.assert_allclose(got, np.asarray(fwd(jnp.asarray(x))),
                               rtol=0, atol=1e-5)
    f32 = str(tmp_path / "gat.pt")
    finfo = cli(["export", EXPERIMENT, "--weights", str(npz), "--out", f32,
                 "--width", str(W), "--height", str(H), "--device", "cpu"])
    assert info["nbytes"] < finfo["nbytes"]


def test_gat_w8_from_the_trained_model_pt(tmp_path):
    exp = tmp_path / "exp"
    exp.mkdir()
    shutil.copy(os.path.join(EXPERIMENT, "config.py"), exp / "config.py")
    args = ["export", str(exp), "--out", str(tmp_path / "a.pt"), "--width",
            str(W), "--height", str(H), "--device", "cpu"]
    with pytest.raises(SystemExit, match="model.pt"):
        cli(args)
    model = build_model("temporal", image_width=W, image_height=H,
                        n_vertices=V, mapping_type="conv", device="cpu",
                        generator=torch.Generator().manual_seed(3))
    torch.save(model.state_dict(), exp / "model.pt")  # as the gat driver does
    info = cli([*args, "--quantize", "w8", "--check"])
    assert info["weights"] == str(exp / "model.pt")
    art = load_exported(str(tmp_path / "a.pt"), device="cpu")
    x = _gat_x(2)
    with torch.no_grad():
        want = model(torch.from_numpy(x)).numpy()
    # w8 moves a 3-layer conv mapping by its kernels' rounding, not more
    err = float(np.abs(_run(art, x) - want).max())
    assert 0 < err < 5e-2


def test_format_1_artifacts_still_load(tmp_path, flax_gat):
    """An artifact as the port wrote it before workloads and quantisation."""
    fmodel, params = flax_gat
    path = str(tmp_path / "old.pt")
    spec = dict(model_type="temporal", mapping_type="conv", image_width=W,
                image_height=H, n_vertices=V, time_steps=T, rollout=1,
                rollout_final_only=False)
    torch.save({"format_version": 1, "spec": spec,
                "state_dict": from_flax_params(params)}, path)
    art = load_exported(path, device="cpu")
    assert art.window_shape == (W, H, T, V)
    x = _gat_x(2)
    want = np.asarray(fmodel.apply({"params": params}, jnp.asarray(x),
                                   train=False))
    np.testing.assert_allclose(_run(art, x), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("argv,match", [
    (["--workload", "cyclegan"], "no checkpoints"),
    (["--packed-g"], "dcgan/cyclegan generator workloads only"),
    (["--platforms", "cpu"], "StableHLO"),
    (["--fixed-batch", "2"], "StableHLO"),
    (["--quantize", "w8a8"], "weight-only --quantize w8"),
    (["--workload", "dcgan", "--weights", "p.npz"], "checkpoint"),
    (["--workload", "cyclegan", "--weights", "p.npz"], "checkpoint"),
    (["--workload", "dcgan"], "no checkpoints"),
    (["--rollout", "0"], "rollout"),
    (["--rollout-final"], "rollout-final"),
])
def test_export_refuses(tmp_path, argv, match):
    with pytest.raises(SystemExit, match=match):
        cli(["export", str(tmp_path), "--out", str(tmp_path / "x.pt"),
             "--device", "cpu", *argv])
    assert not os.path.exists(tmp_path / "x.pt")
