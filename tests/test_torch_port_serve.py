"""The port's serving path against the JAX package's.

Export (CLI and API), the HTTP server, rollouts, the experiment-config
loader, the device default, and the rule that the port imports nothing of
JAX. Weights come from flax and are carried over with the port's
converter, so every served answer is held against flax ``Model.apply``.
"""

import io
import json
import os
import subprocess
import sys
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
from extended_gan_tpu.serve import make_rollout as jax_make_rollout
from extended_gan_tpu.utils.config import (
    load_experiment_config as jax_load_experiment_config,
)
from extended_gan_torch.core.device import resolve_device
from extended_gan_torch.models.convert import from_flax_params
from extended_gan_torch.models.registry import build_model
from extended_gan_torch.serve import (
    ModelServer,
    load_exported,
    make_rollout,
    make_server,
    save_exported,
)
from extended_gan_torch.serve.__main__ import main as cli
from extended_gan_torch.utils.config import load_experiment_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPERIMENTS = os.path.join(REPO, "convolutional_gat", "experiments")
TOL = 2e-5
H = W = 8
T, V = 4, 6
SPEC = dict(model_type="temporal", mapping_type="conv", image_width=W,
            image_height=H, n_vertices=V, time_steps=T)


@pytest.fixture(scope="module")
def flax_model():
    """The JAX package's temporal/conv Model with seeded weights."""
    model = FlaxModel(image_width=W, image_height=H, n_vertices=V,
                      attention_type="temporal", mapping_type="conv",
                      use_pallas=True)
    params = jax.device_get(jax.jit(model.init)(
        jax.random.PRNGKey(1), jnp.zeros((2, H, W, T, V)))["params"])
    apply = jax.jit(lambda x: model.apply({"params": params}, x, train=False))
    return params, apply


def _x(b, seed=0):
    return np.random.default_rng(seed).random((b, H, W, T, V), np.float32)


def _artifact(tmp_path, params, **spec_extra):
    path = str(tmp_path / "model.pt")
    save_exported({**SPEC, **spec_extra}, from_flax_params(params), path)
    return path


def _post(url, x):
    buf = io.BytesIO()
    np.save(buf, x)
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return np.load(io.BytesIO(r.read()), allow_pickle=False)


def test_http_server_matches_flax(tmp_path, flax_model):
    params, apply = flax_model
    server = make_server(_artifact(tmp_path, params), port=0, device="cpu")
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        assert health["platforms"] == ["cpu"]
        assert health["inputs"] == [f"float32[b,{W},{H},{T},{V}]"]
        assert health["bucket_batches"] is True
        for b in (1, 5):  # 5 pads to 8 internally
            x = _x(b, seed=b)
            y = _post(url + "/predict", x)
            assert y.shape == x.shape
            np.testing.assert_allclose(y, np.asarray(apply(jnp.asarray(x))),
                                       rtol=TOL, atol=TOL)
        with pytest.raises(urllib.error.HTTPError) as bad:
            _post(url + "/predict", np.zeros((2, H, W, T, V + 1), np.float32))
        assert bad.value.code == 400
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            assert json.loads(r.read())["requests_served"] == 2
        with pytest.raises(urllib.error.HTTPError) as missing:
            urllib.request.urlopen(url + "/nope", timeout=60)
        assert missing.value.code == 404
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


@pytest.mark.parametrize("bucket", [True, False])
def test_model_server_predict_pads_without_changing_rows(tmp_path, flax_model,
                                                         bucket):
    params, apply = flax_model
    server = ModelServer(_artifact(tmp_path, params), device="cpu",
                         bucket_batches=bucket)
    x = _x(3, seed=9)
    np.testing.assert_allclose(server.predict(x),
                               np.asarray(apply(jnp.asarray(x))),
                               rtol=TOL, atol=TOL)
    assert server.contract()["requests_served"] == 1


def test_rollout_matches_jax(flax_model):
    params, apply = flax_model
    model = build_model(**SPEC, device="cpu")
    model.load_state_dict(from_flax_params(params))
    x = _x(2, seed=3)
    with torch.no_grad():
        got = make_rollout(model, 3)(torch.from_numpy(x)).numpy()
        final = make_rollout(model, 3, final_only=True)(torch.from_numpy(x))
        strip = make_rollout(model, 3, concat_axis=-2)(torch.from_numpy(x))
    want = np.asarray(jax_make_rollout(apply, 3)(jnp.asarray(x)))
    assert got.shape == (2, 3, H, W, T, V)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(final.numpy(), want[:, -1], rtol=TOL, atol=TOL)
    assert strip.shape == (2, H, W, 3 * T, V)
    np.testing.assert_array_equal(strip[..., T:2 * T, :].numpy(), got[:, 1])


@pytest.mark.parametrize("kwargs,match", [
    (dict(steps=0), "steps"),
    (dict(steps=2, concat_axis=0), "batch axis"),
    (dict(steps=2, concat_axis=7), "out of range"),
    (dict(steps=2, final_only=True, concat_axis=-1), "final_only"),
])
def test_rollout_rejects_bad_arguments(kwargs, match):
    with pytest.raises(ValueError, match=match):
        make_rollout(torch.sigmoid, **kwargs)(torch.zeros(2, 3))


def test_rollout_rejects_shape_changing_forward():
    with pytest.raises(ValueError, match="shape-preserving"):
        make_rollout(lambda x: x[:, :1], 2)(torch.zeros(2, 3))


def test_export_cli_weights_and_rollout(tmp_path, flax_model):
    params, apply = flax_model
    npz = tmp_path / "params.npz"
    np.savez(npz, **traverse_util.flatten_dict(params, sep="/"))
    out = str(tmp_path / "rolled.pt")
    info = cli(["export", os.path.join(EXPERIMENTS, "local_temporal_conv"),
                "--weights", str(npz), "--out", out, "--width", str(W),
                "--height", str(H), "--rollout", "2"])
    sidecar = json.load(open(out + ".json"))
    assert sidecar == info
    assert {"format_version", "platforms", "inputs", "outputs",
            "nbytes"} <= set(sidecar)
    assert sidecar["nbytes"] == os.path.getsize(out)
    assert sidecar["outputs"] == [f"float32[b,2,{W},{H},{T},{V}]"]
    art = load_exported(out, device="cpu")
    x = _x(2, seed=4)
    with torch.no_grad():
        y = art.fn(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_make_rollout(apply, 2)(jnp.asarray(x)))
    np.testing.assert_allclose(y, want, rtol=TOL, atol=TOL)


def test_export_cli_init_seed_defaults_to_config_size(tmp_path):
    out = str(tmp_path / "seeded.pt")
    exp = os.path.join(EXPERIMENTS, "final_temp_conv")
    info = cli(["export", exp, "--init-seed", "0", "--out", out])
    assert info["inputs"] == ["float32[b,80,80,4,6]"]
    again = str(tmp_path / "again.pt")
    cli(["export", exp, "--init-seed", "0", "--out", again])
    a = load_exported(out, device="cpu").model.state_dict()
    b = load_exported(again, device="cpu").model.state_dict()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


@pytest.mark.parametrize("argv,match", [
    (["--quantize", "w8"], "ROADMAP"),
    (["--rollout", "0"], "rollout"),
    (["--rollout-final"], "rollout-final"),
])
def test_export_cli_refuses(tmp_path, argv, match):
    with pytest.raises(SystemExit, match=match):
        cli(["export", os.path.join(EXPERIMENTS, "local_temporal_conv"),
             "--init-seed", "0", "--out", str(tmp_path / "x.pt"), *argv])


@pytest.mark.parametrize("name", ["final_temp_conv", "local_temporal_conv"])
def test_config_loader_matches_jax(name):
    exp = os.path.join(EXPERIMENTS, name)
    assert load_experiment_config(exp).to_dict() == \
        jax_load_experiment_config(exp).to_dict()


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(**SPEC)
    assert resolve_device("cpu") == torch.device("cpu")


def test_server_without_cuda_refuses_the_default_device(tmp_path, flax_model,
                                                        monkeypatch):
    path = _artifact(tmp_path, flax_model[0])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ModelServer(path)


def test_port_imports_no_jax():
    """Every module of extended_gan_torch, and chip_smoke.py, imports with
    jax, flax and extended_gan_tpu blocked."""
    code = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "extended_gan_tpu"):
    sys.modules[name] = None
import extended_gan_torch
mods = [m.name for m in pkgutil.walk_packages(extended_gan_torch.__path__,
                                              "extended_gan_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
print(len(mods))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 15
