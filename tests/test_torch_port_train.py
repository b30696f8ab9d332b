"""The port's conv-GAT training path against the JAX package.

- The synthetic KNMI archive and the loaders' batches are byte-identical for
  the same seed. The JAX package's loader is run with its C++ batch core
  off: that core multiplies by a rounded 1/254 where both Python paths
  divide by 254 (``tests/test_native.py`` holds the two within 1e-5).
- Three train steps of the port's trainer against ``make_gat_train_step``
  from the same initial parameters (flax init, converted) on the same
  batches: the narrow SmaAt-UNet with SGD, the GAT3D ``Model`` with Adam,
  both at lr 1e-3 with weight decay 0.01. Per-step losses agree at 1e-5
  relative (f32 summation order). Parameters:

  - SGD moves an entry by lr times its gradient, so each tensor's update
    (after minus before) is held to 10% of its largest entry: train-mode
    BatchNorm over a few samples amplifies roundoff in the gradients.
  - Adam moves an entry by about lr times the sign of its gradient, so an
    entry whose gradient is zero up to roundoff can step the other way.
    In the GAT3D model that is an entry of the adjacency ``B``, whose
    entries start equal and tie in its min-max normalisation. So every
    entry within 2 lr a step (the most two Adam runs can part) and at least
    99% of them within 1e-5 (1% of one step).
- ``test()`` metrics from the same parameters at 1e-5 relative.
- K1's gradient (the autograd wrapper's analytic backward) against
  ``jax.grad`` through ``_reference_impl`` at 1e-5 of each gradient's
  largest entry.
"""

import json
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extended_gan_tpu.data import native as jax_native
from extended_gan_tpu.data import streaming as jax_streaming
from extended_gan_tpu.data import synthetic as jax_synthetic
from extended_gan_tpu.models.gat.gat3d import Model as FlaxGatModel
from extended_gan_tpu.models.gat.layers import (
    normalized_adjacency as jax_normalized_adjacency,
)
from extended_gan_tpu.models.smaat_unet import SmaAt_UNet as FlaxUNet
from extended_gan_tpu.ops.pallas import gat_attention as jax_k1
from extended_gan_tpu.parallel import MeshContext
from extended_gan_tpu.train import gat_trainer as jax_trainer
from extended_gan_tpu.train import optim as jax_optim
from extended_gan_tpu.train.state import NetState
from extended_gan_torch.data import streaming, synthetic
from extended_gan_torch.gat.__main__ import main as cli
from extended_gan_torch.models.convert import from_flax_params
from extended_gan_torch.models.gat.layers import normalized_adjacency
from extended_gan_torch.models.registry import build_model
from extended_gan_torch.models.smaat_unet import SmaAt_UNet
from extended_gan_torch.ops import dsconv as k3
from extended_gan_torch.ops import gat_attention as k1
from extended_gan_torch.ops import gat_mapping as k2
from extended_gan_torch.train import gat_trainer, optim
from extended_gan_torch.train.gat_driver import train

LR = 1e-3
LOSS_TOL = 1e-5
UPDATE_TOL = 0.1
PARAM_TOL = 1e-5
NEAR_SHARE = 0.99
METRIC_TOL = 1e-5
HW, B, V, T = 16, 4, 6, 4


@pytest.fixture
def jax_numpy_loader(monkeypatch):
    """The JAX package's loaders on their numpy batch path."""
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_lib_failed", True)


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    root = tmp_path_factory.mktemp("knmi")
    return synthetic.make_kmni_dataset(str(root), hw=HW, frames_per_file=20)


@pytest.mark.parametrize("seed", [369, 5])
def test_synthetic_archive_and_batches_are_byte_identical(
        tmp_path, jax_numpy_loader, seed):
    kw = dict(hw=HW, frames_per_file=20, seed=seed)
    ours = synthetic.make_kmni_dataset(str(tmp_path / "torch"), **kw)
    theirs = jax_synthetic.make_kmni_dataset(str(tmp_path / "jax"), **kw)
    for sub in ("train", "test"):
        names = sorted(os.listdir(os.path.join(ours, sub)))
        assert names == sorted(os.listdir(os.path.join(theirs, sub)))
        for name in names:
            with open(os.path.join(ours, sub, name), "rb") as a, \
                    open(os.path.join(theirs, sub, name), "rb") as b:
                assert a.read() == b.read(), (sub, name)
    got = streaming.get_loaders(5, 7, ours, dataset="synthetic",
                                downsample_size=(12, 12), seed=seed)
    want = jax_streaming.get_loaders(5, 7, theirs, dataset="synthetic",
                                     downsample_size=(12, 12), seed=seed)
    for split, (g, w) in enumerate(zip(got, want)):
        g, w = list(g), list(w)
        assert len(g) == len(w) > 1, split
        for (xg, yg), (xw, yw) in zip(g, w):
            for a, b in ((xg, xw), (yg, yw)):
                assert a.dtype == b.dtype == np.float32
                assert a.shape == b.shape and a.tobytes() == b.tobytes()


def _batches(archive, n=3):
    """n full (x, y) batches of B windows from the port's loader."""
    loader = streaming.KmniLoader(B, os.path.join(archive, "train"), seed=1)
    out = [(x, y) for x, y in loader if len(x) == B][:n]
    assert len(out) == n
    return out


class _FlaxNarrowUnetModel(fnn.Module):
    """The JAX UnetModel's vertex fold around a narrow SmaAt-UNet."""

    @fnn.compact
    def __call__(self, x, *, train=True):
        b, h, w, t, v = x.shape
        xb = x.transpose(0, 4, 1, 2, 3).reshape(b * v, h, w, t)
        y = FlaxUNet(n_channels=t, n_classes=t, base=8, name="unet")(
            xb, train=train)
        return y.reshape(b, v, h, w, t).transpose(0, 2, 3, 4, 1)


def _models(kind):
    """(flax model, torch model with the converted flax init)."""
    x0 = jnp.zeros((2, HW, HW, T, V))
    if kind == "unet":
        fmodel = _FlaxNarrowUnetModel()
        model = build_model("unet", image_width=HW, image_height=HW,
                            n_vertices=V, mapping_type="linear", device="cpu")
        model.unet = SmaAt_UNet(n_channels=T, n_classes=T, base=8)
    else:
        fmodel = FlaxGatModel(image_width=HW, image_height=HW, n_vertices=V,
                              attention_type="temporal", mapping_type="conv",
                              use_pallas=True)
        model = build_model("temporal", image_width=HW, image_height=HW,
                            n_vertices=V, mapping_type="conv", use_pallas=True,
                            device="cpu")
    variables = jax.device_get(jax.jit(lambda k: fmodel.init(
        k, x0, train=False))(jax.random.PRNGKey(3)))
    model.load_state_dict(from_flax_params(variables["params"],
                                           variables.get("batch_stats")))
    return fmodel, variables, model


class _Split(list):
    """A list of (x, y) batches with a KNMI loader's attributes."""

    batch_size = B
    power = 1.0
    normalizing_max = 254.0


@pytest.mark.parametrize("kind,opt_name", [("unet", "sgd"), ("gat3d", "adam")])
def test_three_train_steps_and_test_metrics_match_jax(archive, kind,
                                                      opt_name):
    batches = _batches(archive)
    fmodel, variables, model = _models(kind)
    tx = jax_optim.make_optimizer(opt_name, LR, weight_decay=0.01)
    state = NetState(params=variables["params"],
                     batch_stats=variables.get("batch_stats", {}),
                     opt_state=tx.init(variables["params"]))
    jstep = jax_trainer.make_gat_train_step(fmodel, tx)
    opt = optim.make_optimizer(opt_name, model.parameters(), LR,
                               weight_decay=0.01)
    step = gat_trainer.make_gat_train_step(model, opt)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    mask = np.ones(B, np.float32)
    for i, (x, y) in enumerate(batches):
        state, logs = jstep(state, jnp.asarray(x), jnp.asarray(y),
                            jnp.asarray(mask), jax.random.PRNGKey(i))
        loss, nd = step(*gat_trainer.to_device_batch(x, y,
                                                     torch.device("cpu")))
        np.testing.assert_allclose(loss.item(), float(logs["loss"]),
                                   rtol=LOSS_TOL, err_msg=f"step {i}")
        np.testing.assert_allclose(nd.numpy(), np.asarray(logs["running_nd"]),
                                   rtol=LOSS_TOL, err_msg=f"step {i}")
    want = from_flax_params(jax.device_get(state.params),
                            jax.device_get(state.batch_stats))
    got = model.state_dict()
    near = total = 0
    for name, w in want.items():
        if name.endswith("num_batches_tracked"):  # torch's bookkeeping only
            continue
        diff = (got[name] - w).abs()
        if opt_name == "sgd":
            update = (w - init[name]).abs().max().item()
            assert diff.max().item() <= UPDATE_TOL * update + 1e-8, \
                (name, diff.max().item(), update)
        else:
            assert diff.max().item() <= 2 * LR * len(batches), name
            near += int((diff <= PARAM_TOL).sum())
            total += diff.numel()
    assert near >= NEAR_SHARE * total, (near, total)

    # test() on the same parameters: the JAX state's, converted
    model.load_state_dict(want)
    split = _Split(batches)
    mesh = MeshContext.create(data=1, devices=jax.devices()[:1])
    jeval = jax_trainer.make_gat_eval_step(fmodel)
    expect = jax_trainer.test(jeval, state, split, mesh)
    result = gat_trainer.test(gat_trainer.make_gat_eval_step(model), split,
                              torch.device("cpu"))
    assert sorted(result) == sorted(expect)
    for k in expect:
        np.testing.assert_allclose(result[k], expect[k], rtol=METRIC_TOL,
                                   atol=1e-7, err_msg=k)


def test_k1_autograd_gradients_match_jax_grad():
    rng = np.random.default_rng(11)
    nh, b, mm, g, gs = 3, 2, 4, 6, 25
    m = rng.standard_normal((nh, b, mm, g * gs)).astype(np.float32)
    a = rng.standard_normal((nh, 2 * g)).astype(np.float32)
    badj = rng.random((nh, mm, mm)).astype(np.float32)
    cot = rng.standard_normal(m.shape).astype(np.float32)
    tm, ta = (torch.from_numpy(t).requires_grad_() for t in (m, a))
    tadj = normalized_adjacency(torch.from_numpy(badj)).detach() \
        .requires_grad_()
    before = k1.launch_count
    out = k1.fused_gat_attention(tm, ta, tadj, 0.2, gs)[0]
    (out * torch.from_numpy(cot)).sum().backward()
    assert k1.launch_count == before  # the CPU path launches nothing

    def jloss(m_, a_, adj_, c_):
        w1 = jnp.repeat(a_[:g], gs)[None, :]
        w2 = jnp.repeat(a_[g:], gs)[None, :]
        return jnp.sum(jax_k1._reference_impl(m_, w1, w2, adj_, 0.2, gs) * c_)

    for h in range(nh):
        adj = jax_normalized_adjacency(jnp.asarray(badj[h]))
        want = jax.grad(jloss, argnums=(0, 1, 2))(
            jnp.asarray(m[h]), jnp.asarray(a[h]), adj, jnp.asarray(cot[h]))
        for name, t, w in (("m", tm, want[0]), ("a", ta, want[1]),
                           ("adj_norm", tadj, want[2])):
            w = np.asarray(w)
            np.testing.assert_allclose(t.grad[h].numpy(), w, rtol=0,
                                       atol=1e-5 * np.abs(w).max(),
                                       err_msg=f"head {h} d{name}")


def test_schedulers_follow_the_jax_package():
    losses = [1.0, 0.99995, 0.5, 0.6, 0.61, 0.4]  # 0.99995: within 1e-4 rel
    for plateau in (False, True):
        params = [torch.nn.Parameter(torch.zeros(1))]
        opt = optim.make_optimizer("adam", params, LR)
        sched = optim.make_scheduler(opt, reduce_lr_on_plateau=plateau,
                                     lr_step=2, gamma=0.5)
        ref = (jax_optim.ReduceLROnPlateau(LR, factor=0.5, patience=0)
               if plateau else jax_optim.StepLR(LR, 2, 0.5))
        for v in losses:
            opt.step()  # an epoch's updates come before its scheduler step
            np.testing.assert_allclose(optim.scheduler_step(sched, v),
                                       ref.step(v), rtol=1e-12)


def test_cli_trains_on_the_cpu_and_writes_outside_the_repo(tmp_path, capsys):
    out = tmp_path / "run"
    model, history = cli([
        "train", "--model-type", "temporal", "--mapping-type", "conv",
        "--dataset", "synthetic", "--preprocessed-folder",
        str(tmp_path / "data"), "--downsample-size", "16", "16",
        "--epochs", "2", "--max-batches", "2", "--device", "cpu",
        "--output-path", str(out)])
    assert next(model.parameters()).device.type == "cpu"
    assert len(history["train_loss"]) == len(history["val_loss"]) == 2
    assert all(np.isfinite(v) for vals in history.values() for v in vals)
    with open(out / "history.json") as f:
        assert json.load(f) == history
    state = torch.load(out / "model.pt", weights_only=True)
    assert sorted(state) == sorted(model.state_dict())
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"kernel_launches": {
        "gat_attention_fwd": k1.launch_count,
        "gat_attention_bwd": k1.bwd_launch_count,
        "dsconv_fwd": k3.launch_count, "dsconv_bwd": k3.bwd_launch_count,
        "gat_mapping_fwd": k2.fwd_launch_count,
        "gat_mapping_bwd": k2.bwd_launch_count}}


def test_generate_experiment_reads_the_jax_configs(tmp_path):
    model, history = cli([
        "generate_experiment", "--exp_folder_name", "local_temporal_conv",
        "--epochs", "1", "--max-batches", "1", "--device", "cpu",
        "--output-path", str(tmp_path)])
    assert model.mapping_type == "conv" and len(history["val_loss"]) == 1
    assert (tmp_path / "history.json").exists()


@pytest.mark.parametrize("kwargs,error", [
    (dict(megastep=4), NotImplementedError),
    (dict(precision="bf16"), NotImplementedError),
    (dict(bogus=1), TypeError),
])
def test_unported_driver_options_raise(kwargs, error):
    with pytest.raises(error):
        train(dataset="synthetic", device="cpu", **kwargs)
