"""Training of the Switch-MoE UNet in the port against the
JAX package, on the CPU (the narrow UNet and its weights of
``test_torch_port_moe.py``).

- One train step of ``make_gat_train_step`` with ``moe_aux_weight`` 0.01,
  on the default path and under ``per_vertex_bn``, held to a witness that
  owes nothing to the port: JAX's step and loss in float64
  (``jax.enable_x64``, the ``float32`` of JAX's UNet, BatchNorm, DSC and
  MoE modules read as float64, so the witness computes what JAX's float32
  step computes, without its roundoff), and for each parameter tensor the
  forward-mode derivative (``jax.jvp``) of that loss along a seeded random
  direction in the tensor:
  - the loss: the port's float64 within 1e-10 relative of JAX's float64,
    its float32 within 1e-4;
  - every gradient tensor of the port's float64 step along its direction
    within JVP_TOL of the tensor's scale of JAX's forward-mode derivative;
    and entry for entry within GRAD64_TOL of JAX's own float64 gradient
    wherever that is the same derivative. Under ``per_vertex_bn`` it is
    everywhere. On the default path it is not upstream of down4's second
    convolution: there JAX's reverse-mode gradient, in float32 and float64
    alike, is not the derivative of JAX's own loss (down4's ``dsc1``
    depthwise bias, whose gradient is 0 since a train-mode BatchNorm
    follows, gets a nonzero one), and central differences of the loss side
    with the forward mode (checked for the three tensors where the two
    modes differ most);
  - every gradient of the port's float32 step within TRAIN_TOL of its
    float64 step's largest entry (or of the whole gradient's RMS entry,
    for a tensor that is 0: a bias ahead of a BatchNorm), or 10x what
    1e-7 noise on the input moves the float32 step where that is more
    (the per-vertex UNet's gradients are roundoff-unstable at 4 samples
    a vertex, JAX's float32 as much as the port's). The float64 step is
    the reference here because the witness holds it;
  - a planted fault, the MoE's routing and dispatch cut from the graph
    (its input detached), misses the witness.
  remat's step equals the plain step.
- The driver and the CLI: ``train(..., moe_experts=4)`` adds one aux term
  in every step, on single steps and on ``--megastep 2 --resident``.

"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import extended_gan_tpu.models.moe as jax_moe
import extended_gan_tpu.models.smaat_unet as jax_smaat_unet
import extended_gan_tpu.ops.norm as jax_norm
import extended_gan_tpu.ops.pallas.dsconv as jax_dsconv
from extended_gan_tpu.train import gat_trainer as jtrainer
from extended_gan_tpu.train.state import NetState as JaxNetState
from extended_gan_torch.models import moe
from extended_gan_torch.models.convert import from_flax_params
from extended_gan_torch.train import gat_trainer
from test_torch_port_gat_family import one_torch_thread  # noqa: F401 - the autouse fixture
from test_torch_port_gat_smaat import bound, perturbed
from test_torch_port_moe import (  # noqa: F401 - the narrow fixture
    AUX_W,
    B,
    HW,
    LOSS_RTOL,
    T,
    V,
    _flax_unet,
    _unet_pair,
    narrow,
)

JVP_TOL, GRAD64_TOL, LOSS64_RTOL = 1e-9, 1e-6, 1e-10
FD_TOL, FD_EPS = 1e-2, 3e-7


# ------------------------------------------------------------ the witness
class _Float64Numpy:
    """``jax.numpy`` with ``float32`` read as ``float64``."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@contextlib.contextmanager
def jax_float64():
    """JAX in float64, with the modules of the MoE UNet that cast to
    float32 casting to float64 instead."""
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        for module in (jax_smaat_unet, jax_norm, jax_dsconv, jax_moe):
            mp.setattr(module, "jnp", _Float64Numpy())
        yield


def _grad_recorder():
    """optax transformation that leaves the params and keeps the
    gradients as its state."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


def _batch(seed=7):
    rng = np.random.default_rng(seed)
    return (rng.random((B, HW, HW, T, V), np.float32),
            rng.random((B, HW, HW, T, V), np.float32))


def _torch_names(params):
    """{flax path: the port's parameter name}, by the converter."""
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    marked = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params),
        [np.full(np.shape(v), i + 1.0, np.float32)
         for i, (_, v) in enumerate(flat)])
    by_mark = {int(t.reshape(-1)[0]): k
               for k, t in from_flax_params(marked).items()}
    return {path: by_mark[i + 1] for i, (path, _) in enumerate(flat)}


def _from_flax64(tree):
    """``from_flax_params`` of a float64 tree, kept to about 1e-14: the
    converter rounds to float32 and only moves entries, so convert the
    float32 head and the remainder apart and add them."""
    head = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)
    rest = jax.tree_util.tree_map(
        lambda a, h: (np.asarray(a, np.float64) - h).astype(np.float32),
        tree, head)
    tail = from_flax_params(rest)
    return {k: v.double().numpy() + tail[k].double().numpy()
            for k, v in from_flax_params(head).items()}


def _with_leaf(params, path, value):
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params),
        [value if p == path else v for p, v in leaves])


def _entry_floor(grads):
    """The root-mean-square entry of a whole gradient: the scale of a
    tensor that is 0 (a bias ahead of a BatchNorm)."""
    return np.sqrt(sum(float((g * g).sum()) for g in grads.values())
                   / sum(g.size for g in grads.values()))


def _scales(grads):
    """Each tensor's scale: its L2 norm, or the whole gradient's RMS entry
    times the root of its size where that is more."""
    rms = _entry_floor(grads)
    return {k: max(np.linalg.norm(g), rms * np.sqrt(g.size))
            for k, g in grads.items()}


def witness_misses_of(grads, dirs, fwd, tol=JVP_TOL):
    """{tensor: its error over ``tol``} for each float64 gradient tensor in
    ``grads`` whose derivative along ``dirs`` misses ``fwd``, in units of
    the tensor's scale."""
    out = {}
    for k, scale in _scales(grads).items():
        err = abs(float((grads[k] * dirs[k]).sum()) - fwd[k])
        if err > tol * scale:
            out[k] = err / scale / tol
    return out


@functools.cache
def _witness(per_vertex):
    """JAX's float64 step on ``_batch()``: its loss and its gradient (the
    port's names and layouts); for each parameter tensor a seeded random
    unit direction (the port's layout) and the forward-mode derivative of
    the loss along it; central differences of the loss along the
    directions of the three tensors whose reverse-mode gradient misses the
    forward mode most."""
    fmodel, variables = _flax_unet(per_vertex)
    x, y = _batch()
    rng = np.random.default_rng(11)
    with jax_float64():
        fmodel = fmodel.clone(dtype=jnp.float64)
        v64 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a), jnp.float64), variables)
        params, stats = v64["params"], v64["batch_stats"]
        tx = _grad_recorder()
        xj, yj = jnp.asarray(x, jnp.float64), jnp.asarray(y, jnp.float64)
        ones = jnp.ones(B, jnp.float64)
        step = jax.jit(jtrainer.make_gat_train_step(
            fmodel, tx, moe_aux_weight=AUX_W))
        new, logs = step(JaxNetState(params=params, batch_stats=stats,
                                     opt_state=tx.init(params)),
                         xj, yj, ones, jax.random.PRNGKey(0))
        grads = _from_flax64(jax.device_get(new.opt_state))

        @jax.jit
        def loss(p):  # the step's loss (gat_trainer.py:90-100), forward only
            y_hat, upd = fmodel.apply({"params": p, "batch_stats": stats},
                                      xj, train=True,
                                      mutable=["batch_stats", "losses"])
            n_el = B * y[0].size
            aux = sum(jnp.sum(a) for a in
                      jax.tree_util.tree_leaves(upd["losses"]))
            return (jnp.sum((y_hat - yj) ** 2) / n_el
                    - 0.0005 * jnp.sum(y_hat) / n_el + AUX_W * aux)

        assert float(loss(params)) == pytest.approx(float(logs["loss"]),
                                                    rel=1e-13)
        names = _torch_names(params)
        units = jax.tree_util.tree_map(
            lambda a: (lambda u: u / np.linalg.norm(u))(
                rng.standard_normal(a.shape)), params)
        zeros = jax.tree_util.tree_map(jnp.zeros_like, params)
        jvp = jax.jit(lambda t: jax.jvp(loss, (params,), (t,))[1])
        pairs = list(zip(jax.tree_util.tree_flatten_with_path(params)[0],
                         jax.tree_util.tree_flatten_with_path(units)[0]))
        fwd = {names[path]: float(jvp(_with_leaf(zeros, path, u)))
               for (path, _), (_, u) in pairs}
        dirs = _from_flax64(units)
        # where JAX's reverse-mode gradient is not its forward-mode
        # derivative, central differences of the loss for the worst three
        off = witness_misses_of(grads, dirs, fwd)
        fd = {}
        for (path, leaf), (_, u) in pairs:
            if names[path] in sorted(off, key=off.get)[-3:]:
                eps = FD_EPS * max(1.0, float(jnp.abs(leaf).max()))
                lp = float(loss(_with_leaf(params, path, leaf + eps * u)))
                lm = float(loss(_with_leaf(params, path, leaf - eps * u)))
                fd[names[path]] = (lp - lm) / (2 * eps)
    return dict(loss=float(logs["loss"]), grads=grads, dirs=dirs, fwd=fwd,
                fd=fd)


def _port_train(per_vertex, x, y, aux_weight=AUX_W, remat=False,
                dtype=torch.float32):
    _, _, model = _unet_pair(per_vertex)
    model = model.to(dtype)
    opt = torch.optim.SGD(model.parameters(), lr=0.0)
    step = gat_trainer.make_gat_train_step(model, opt, remat=remat,
                                           moe_aux_weight=aux_weight)
    loss, _ = step(*(torch.from_numpy(a).to(dtype)
                     for a in (x, y, np.ones(len(x), np.float32))))
    return loss.item(), {k: p.grad.double().numpy().copy()
                         for k, p in model.named_parameters()}


def from_the_bottleneck(name):
    """The MoE, the bottleneck's CBAM and the decoder: on the default path
    JAX's reverse-mode gradient is the derivative of its loss there."""
    parts = name.split(".")
    return parts[parts.index("unet") + 1] in (
        "moe", "cbam5", "up1", "up2", "up3", "up4", "outc")


def witness_misses(per_vertex, grads):
    """:func:`witness_misses_of` against JAX's forward-mode derivatives of
    its float64 loss."""
    w = _witness(per_vertex)
    return witness_misses_of(grads, w["dirs"], w["fwd"])


@pytest.mark.parametrize("per_vertex", [False, True],
                         ids=["default", "per_vertex_bn"])
def test_moe_train_step_matches_jax(per_vertex, narrow):
    """The module docstring's rules, on the default path and under
    ``per_vertex_bn`` (the V vertices' losses summed)."""
    x, y = _batch()
    w = _witness(per_vertex)
    p_loss, p_grads = _port_train(per_vertex, x, y)
    p0, _ = _port_train(per_vertex, x, y, 0.0)
    # the aux term is at least 1 a routing group (1 at uniform routing) and
    # moves the loss 10x the bound below
    assert (p_loss - p0) / AUX_W >= (V if per_vertex else 1) * 0.999
    assert abs(p_loss - p0) > 10 * LOSS_RTOL * abs(w["loss"])
    assert p_loss == pytest.approx(w["loss"], rel=LOSS_RTOL)
    l64, g64 = _port_train(per_vertex, x, y, dtype=torch.float64)
    assert l64 == pytest.approx(w["loss"], rel=LOSS64_RTOL)
    assert sorted(g64) == sorted(w["grads"]) == sorted(w["fwd"])
    assert witness_misses(per_vertex, g64) == {}
    # JAX's own gradient, where it is the derivative of its loss: on the
    # default path not upstream of down4's second conv, where the loss's
    # differences side with the forward mode
    jax_off = witness_misses(per_vertex, w["grads"])
    assert not any(from_the_bottleneck(k) for k in jax_off)
    assert bool(jax_off) != per_vertex, sorted(jax_off)
    assert per_vertex or "unet.down4.conv.dsc1.depthwise_bias" in jax_off
    scales = _scales(g64)
    for k, fd in w["fd"].items():
        jax_rev = float((w["grads"][k] * w["dirs"][k]).sum())
        assert abs(w["fwd"][k] - fd) <= FD_TOL * scales[k], k
        assert abs(jax_rev - fd) > FD_TOL * scales[k], k
    floor = _entry_floor(w["grads"])
    for k in sorted(set(g64) - set(jax_off)):
        want = w["grads"][k]
        g = np.abs(g64[k] - want).max() / max(np.abs(want).max(), floor)
        assert g <= GRAD64_TOL, (k, g)
    # the port's float32 step against its float64 step, now held; a
    # tensor's entries in units of its largest, or of the whole gradient's
    # RMS entry where that is more (a bias ahead of a BatchNorm is 0)
    floor = _entry_floor(g64)
    noisy = _port_train(per_vertex, perturbed(x), y)[1]
    for k, want in g64.items():
        scale = max(np.abs(want).max(), floor)
        sens = np.abs(noisy[k] - p_grads[k]).max() / scale
        err = np.abs(p_grads[k] - want).max() / scale
        assert err <= bound(sens), (k, err, sens)


def test_a_moe_cut_from_its_input_misses_the_witness(narrow, monkeypatch):
    """The planted fault: the MoE routes and dispatches a detached copy of
    its input (the residual keeps the input's own gradient). The MoE's
    weights still get their gradients; the encoder's miss the witness."""
    real = moe.SwitchMoE.grouped_tokens
    monkeypatch.setattr(moe.SwitchMoE, "grouped_tokens",
                        lambda self, x: real(self, x.detach()))
    x, y = _batch()
    _, g64 = _port_train(False, x, y, dtype=torch.float64)
    misses = witness_misses(False, g64)
    assert misses and not any(".moe." in k for k in misses)
    assert any(k.startswith("unet.inc.") for k in misses), sorted(misses)


def test_moe_remat_step_equals_the_plain_step(narrow):
    rng = np.random.default_rng(8)
    x = rng.random((B, HW, HW, T, V), np.float32)
    y = rng.random((B, HW, HW, T, V), np.float32)
    loss, grads = _port_train(False, x, y)
    r_loss, r_grads = _port_train(False, x, y, remat=True)
    assert r_loss == loss
    for k, g in grads.items():
        np.testing.assert_allclose(r_grads[k], g, rtol=0,
                                   atol=1e-6 * np.abs(g).max(), err_msg=k)


# ------------------------------------------------------------ the driver
@pytest.fixture
def count_sown(monkeypatch):
    """Counts the MoE losses each train step collects."""
    counts = []
    real = gat_trainer.sow_moe

    def counting(layers):
        cm = real(layers)

        class Wrapped:
            def __enter__(self):
                self.sown = cm.__enter__()
                return self.sown

            def __exit__(self, *exc):
                counts.append(len(self.sown))
                return cm.__exit__(*exc)
        return Wrapped()

    monkeypatch.setattr(gat_trainer, "sow_moe", counting)
    return counts


def test_driver_trains_the_moe_unet_with_its_aux(count_sown, narrow):
    from extended_gan_torch.train.gat_driver import train

    model, history = train(model_type="unet", mapping_type="linear",
                           dataset="synthetic", downsample_size=(20, 20),
                           train_batch_size=4, test_batch_size=8, epochs=1,
                           max_batches=2, device="cpu", moe_experts=4)
    assert len(moe.moe_layers(model)) == 1
    assert count_sown == [1, 1]  # one MoE loss a step, two steps
    assert np.isfinite(history["train_loss"][0])


def test_cli_megastep_resident_moe(count_sown, narrow):
    from extended_gan_torch.gat.__main__ import main

    model, history = main([
        "train", "--model-type", "unet", "--mapping-type", "linear",
        "--dataset", "synthetic", "--downsample-size", "20", "20",
        "--train-batch-size", "4", "--test-batch-size", "8", "--epochs", "1",
        "--max-batches", "1", "--megastep", "2", "--resident",
        "--moe-experts", "4", "--moe-aux-weight", "0.5", "--device", "cpu"])
    assert len(moe.moe_layers(model)) == 1 and count_sown == [1, 1]
    assert np.isfinite(history["train_loss"][0])
