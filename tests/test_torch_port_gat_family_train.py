"""Training and serving the new conv-GAT families with the port.

- Three train steps of the port's trainer against the JAX package's
  ``make_gat_train_step`` from the same weights on the same batches, as
  ``test_torch_port_train.py`` holds them: ``baseline`` with Adam (every
  entry within 2 lr a step of JAX's, at least 99% within 1e-5: Adam moves
  an entry whose gradient is roundoff the other way, as it does the tied
  adjacency ``B``), and ``temporal`` with the smaat_unet mapping with SGD,
  held on losses and updates (after minus before, each tensor within 10%
  of its largest update; running statistics likewise): train-mode
  BatchNorm over a few samples amplifies roundoff
  (``test_torch_port_gat_smaat.py``). Losses agree at ``LOSS_TOL``
  relative. Where roundoff alone moves a result more (the same three steps
  on inputs scaled by 1 + 1e-7 noise, on each side), the bound is
  ``SENS_FACTOR`` times that move: the smaat model's losses after an
  update, and the updates of its adjacency, whose gradient is roundoff.
- ``python -m extended_gan_torch.gat generate_experiment`` of a copy of
  ``final_temp_smaat`` on the CPU, outputs in a temporary directory.
- ``python -m extended_gan_torch.serve export`` of that copy, served over
  HTTP on the CPU: each reply equals the model's forward.
"""

import copy
import io
import json
import shutil
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extended_gan_tpu.models.registry import build_model as jax_build_model
from extended_gan_tpu.train import gat_trainer as jax_trainer
from extended_gan_tpu.train import optim as jax_optim
from extended_gan_tpu.train.state import NetState
from extended_gan_torch.gat.__main__ import main as gat_cli
from extended_gan_torch.gat.generate_experiment import EXPERIMENTS
from extended_gan_torch.models.convert import from_flax_params
from extended_gan_torch.models.registry import build_model
from extended_gan_torch.ops import gat_attention as k1
from extended_gan_torch.serve import load_exported, make_server
from extended_gan_torch.serve.__main__ import main as serve_cli
from extended_gan_torch.train import gat_trainer, optim
from test_torch_port_gat_family import one_torch_thread  # noqa: F401 - the autouse fixture
from test_torch_port_gat_family import to_flax
from test_torch_port_gat_smaat import SENS_FACTOR, perturbed

LR = 1e-3
LOSS_TOL = 1e-5
UPDATE_TOL = 0.1
PARAM_TOL = 1e-5
NEAR_SHARE = 0.99
B, T, V = 4, 4, 3


@pytest.mark.parametrize("model_type,mapping_type,hw,opt_name", [
    ("baseline", "linear", 8, "adam"),
    ("temporal", "smaat_unet", 16, "sgd"),
])
def test_three_train_steps_match_jax(model_type, mapping_type, hw, opt_name):
    kw = dict(image_width=hw, image_height=hw, n_vertices=V,
              mapping_type=mapping_type)
    model = build_model(model_type, device="cpu", use_pallas=False,
                        generator=torch.Generator().manual_seed(2), **kw)
    params, stats = to_flax(model)
    fmodel = jax_build_model(model_type, **kw)
    tx = jax_optim.make_optimizer(opt_name, LR, weight_decay=0.01)
    state = NetState(params=params, batch_stats=stats,
                     opt_state=tx.init(params))
    jstep = jax_trainer.make_gat_train_step(fmodel, tx)
    twin = copy.deepcopy(model)  # the same run on perturbed inputs
    steps = [gat_trainer.make_gat_train_step(m, optim.make_optimizer(
        opt_name, m.parameters(), LR, weight_decay=0.01))
        for m in (model, twin)]
    init = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(4)
    mask = jnp.ones(B, jnp.float32)
    state2 = jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True), state)
    for i in range(3):
        x, y = (rng.random((B, hw, hw, T, V), np.float32) for _ in range(2))
        key = jax.random.PRNGKey(i)
        (loss, nd), (loss2, _) = (
            fn(*gat_trainer.to_device_batch(xi, y, torch.device("cpu")))
            for fn, xi in zip(steps, (x, perturbed(x))))
        state, logs = jstep(state, jnp.asarray(x), jnp.asarray(y), mask, key)
        state2, logs2 = jstep(state2, jnp.asarray(perturbed(x)),
                              jnp.asarray(y), mask, key)
        want = float(logs["loss"])
        # what roundoff alone moves either side's loss
        sens = max(abs(loss2.item() - loss.item()),
                   abs(float(logs2["loss"]) - want)) / abs(want)
        tol = max(LOSS_TOL, SENS_FACTOR * sens)
        np.testing.assert_allclose(loss.item(), want, rtol=tol,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(nd.numpy(), np.asarray(logs["running_nd"]),
                                   rtol=tol, err_msg=f"step {i}")
    want, want2 = (from_flax_params(jax.device_get(st.params),
                                    jax.device_get(st.batch_stats))
                   for st in (state, state2))
    got, got2 = model.state_dict(), twin.state_dict()
    assert sorted(k for k in got if not k.endswith("num_batches_tracked")) \
        == sorted(k for k in want if not k.endswith("num_batches_tracked"))
    near = total = 0
    for name, w in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        diff = (got[name] - w).abs()
        if opt_name == "sgd":
            update = (w - init[name]).abs().max().item()
            sens = max((got2[name] - got[name]).abs().max().item(),
                       (want2[name] - w).abs().max().item())
            assert diff.max().item() <= max(UPDATE_TOL * update,
                                            SENS_FACTOR * sens) + 1e-8, \
                (name, diff.max().item(), update, sens)
        else:
            assert diff.max().item() <= 2 * LR * 3, name
            near += int((diff <= PARAM_TOL).sum())
            total += diff.numel()
    assert near >= NEAR_SHARE * total, (near, total)


@pytest.fixture(scope="module")
def smaat_experiment(tmp_path_factory):
    """A copy of final_temp_smaat's experiment directory."""
    dest = tmp_path_factory.mktemp("exp") / "final_temp_smaat"
    shutil.copytree(EXPERIMENTS / "final_temp_smaat", dest)
    return dest


def test_generate_experiment_trains_final_temp_smaat(smaat_experiment,
                                                     tmp_path, capsys):
    out = tmp_path / "run"
    model, history = gat_cli([
        "generate_experiment", "--exp_folder_name", str(smaat_experiment),
        "--epochs", "1", "--max-batches", "1", "--train-batch-size", "4",
        "--test-batch-size", "8", "--device", "cpu",
        "--output-path", str(out)])
    assert model.mapping_type == "smaat_unet"
    assert sum(p.numel() for p in model.parameters()) == 569_036
    assert len(history["train_loss"]) == len(history["val_loss"]) == 1
    assert all(np.isfinite(v) for vals in history.values() for v in vals)
    state = torch.load(out / "model.pt", weights_only=True)
    assert sorted(state) == sorted(model.state_dict())
    # train mode moved the running statistics, as flax's batch_stats move
    assert state["hidden_layer.head_0.mapping.unet.inc.bn0.running_mean"] \
        .abs().max() > 0
    with open(out / "history.json") as f:
        assert json.load(f) == history
    assert "Using mapping: smaat_unet" in capsys.readouterr().out


def _post(url, x):
    buf = io.BytesIO()
    np.save(buf, x)
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return np.load(io.BytesIO(r.read()), allow_pickle=False)


def test_export_and_serve_temporal_smaat(smaat_experiment, tmp_path):
    path = str(tmp_path / "smaat.pt")
    serve_cli(["export", str(smaat_experiment), "--init-seed", "0",
               "--out", path, "--width", "16", "--height", "16",
               "--vertices", str(V)])
    artifact = load_exported(path, device="cpu")
    assert artifact.spec["mapping_type"] == "smaat_unet"
    model = artifact.model
    assert not model.training
    server = make_server(path, port=0, device="cpu")
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        for b in (1, 4):  # powers of two: the server pads neither
            x = np.random.default_rng(b).random((b, 16, 16, T, V), np.float32)
            before = k1.launch_count
            y = _post(url + "/predict", x)
            assert k1.launch_count == before  # the CPU launches nothing
            with torch.no_grad():
                want = model(torch.from_numpy(x)).numpy()
            assert y.shape == x.shape
            np.testing.assert_array_equal(y, want)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
