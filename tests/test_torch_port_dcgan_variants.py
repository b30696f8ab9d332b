"""The port's DCGAN step bodies ``fused_disc``, ``fused_prop``, both, and
``fused_disc`` with the packed generator, against the JAX package's, on
the CPU.

Narrow nets (ndf = 8) at 64x64, B = 4, dropout off (cross-framework
dropout draws cannot agree); weights go across with ``from_flax_params``.
Each variant:

- two epochs of four train batches and two eval batches through the
  port's ``train_single_epoch`` and ``test`` and the JAX package's, as
  ``test_torch_port_dcgan_train.py::test_two_epochs_match_jax``: per-step
  losses within rtol 5e-3, atol 1e-4, per-epoch metrics within 1% (or one
  sample's share of an accuracy's count);
- one SGD step: every gradient the step applies (JAX's read from a
  recording optax transform chained before ``sgd``, the port's from
  ``.grad`` after the step) within 1e-5 of its tensor's largest entry of
  JAX's gradient on the batch in its order or in another order of its
  rows (the same gradient, the rows being exchangeable): in one order or
  the other, JAX's float32 reductions over G's first block's 16,384
  entries a channel round 0.1-2% away from float64 (measured against the
  port's float64 twin: 1.05e-2 in one order, 2.8e-6 in the other); and
  within 1e-5 of the port's float64 twin, everywhere. The running
  statistics within 1e-5 of JAX's, the losses within 1e-5 relative. The
  generator's pre-BatchNorm conv biases have a gradient of zero up to
  roundoff (train-mode BatchNorm subtracts them again), so those are held
  below 1e-3 of their weights' gradients on both sides;
- a planted fault, the fake rows' discriminator loss taken against label
  1, must miss that bound by 100x;
- ``Megastep`` with K = 2 on the CPU equals two single steps bit for bit.

Also: the driver hands each option to the single step, ``--megastep`` and
``--resident``; ``python -m extended_gan_torch.dcgan --fused-disc
--fused-prop --packed-g --device cpu`` trains (streaming and resident
megastep) and the CLI's flags and defaults are JAX's.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from extended_gan_tpu.core import KeySeq
from extended_gan_tpu.models import dcgan as jax_dcgan
from extended_gan_tpu.parallel import MeshContext
from extended_gan_tpu.train.dcgan_trainer import (
    GANStates,
    make_dcgan_eval_step as jax_eval_step,
    make_dcgan_train_step as jax_train_step,
    test as jax_test,
    train_single_epoch as jax_train_single_epoch,
)
from extended_gan_tpu.train.optim import adam
from extended_gan_tpu.train.state import create_net_state
from extended_gan_torch.dcgan.__main__ import main as cli
from extended_gan_torch.models import dcgan
from extended_gan_torch.models.convert import from_flax_params
from extended_gan_torch.train import dcgan_driver, dcgan_trainer
from test_torch_port_dcgan import (
    LOSS_TOL,
    NETS,
    STATS_TOL,
    jax_tree,
    nhwc,
    port_tree,
)
from test_torch_port_dcgan_train import METRIC_BUDGET, STEP_ATOL, STEP_RTOL
from test_torch_port_gat_family import one_torch_thread  # noqa: F401 - the autouse fixture
from test_torch_port_gat_smaat import gap

NC, NDF, IM, B = 4, 8, 64, 4
LR, BETA1, SGD_LR = 2e-4, 0.5, 0.1
GRAD_TOL = 1e-5
LOSS_KEYS = ("errFD", "errTD", "errG")
# (the step body's options, packed generator)
VARIANTS = {
    "fused_disc": (dict(fused_disc=True), False),
    "fused_prop": (dict(fused_prop=True), False),
    "both": (dict(fused_disc=True, fused_prop=True), False),
    "fused_disc_packed_g": (dict(fused_disc=True), True),
}
# G's conv biases followed by BatchNorm: zero gradient up to roundoff
PRE_BN_BIASES = {f"ConvBlock_{i}.Conv_0.bias" for i in range(4)}


def _recorder():
    """An optax transform that passes the gradients on and keeps them as
    its state."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (grads, grads))


def jax_gan(packed, tx, seed=5):
    """Flax models (dropout off), optax transforms and initial GANStates."""
    models = (jax_dcgan.Generator(nc=NC, dropout=0.0, packed=packed),
              jax_dcgan.FrameDiscriminator(nc=NC, ndf=NDF),
              jax_dcgan.TemporalDiscriminator(nc=NC, ndf=NDF, dropout=0.0))
    txs = tuple(tx() for _ in models)
    keys = KeySeq(seed)
    samples = (jnp.zeros((2, IM, IM, NC)),) * 2 + (
        jnp.zeros((2, IM, IM, 2 * NC)),)
    states = GANStates(*(create_net_state(m, t, keys.next(), s)
                         for m, t, s in zip(models, txs, samples)))
    return models, txs, states


def port_gan(states, packed, opt):
    """The port's (G, FD, TD), dropout off, from the flax states, and an
    optimizer each."""
    nets = (dcgan.Generator(NC, dropout=0.0, packed=packed),
            dcgan.FrameDiscriminator(NC, NDF),
            dcgan.TemporalDiscriminator(NC, NDF, dropout=0.0))
    for net, name in zip(nets, NETS):
        st = getattr(states, name)
        net.load_state_dict(from_flax_params(jax.device_get(st.params),
                                             jax.device_get(st.batch_stats)))
    return nets, tuple(opt(n.parameters()) for n in nets)


def _adam():
    return adam(LR, b1=BETA1)


def _torch_adam(params):
    return torch.optim.Adam(params, lr=LR, betas=(BETA1, 0.999), eps=1e-8)


def _sgd():
    return optax.chain(_recorder(), optax.sgd(SGD_LR))


def _torch_sgd(params):
    return torch.optim.SGD(params, lr=SGD_LR)


def frames(rng, b=B):
    return rng.uniform(0, 1, (b, NC, IM, IM)).astype(np.float32)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_two_epochs_match_jax(variant):
    body, packed = VARIANTS[variant]
    rng = np.random.default_rng(3)
    train_batches = [(frames(rng), frames(rng)) for _ in range(4)]
    val_batches = [(frames(rng), frames(rng)) for _ in range(2)]
    models, txs, states = jax_gan(packed, _adam)
    nets, opts = port_gan(states, packed, _torch_adam)
    port_step = dcgan_trainer.make_dcgan_train_step(*nets, *opts, **body)
    port_eval = dcgan_trainer.make_dcgan_eval_step(*nets)
    p_steps, p_hist, j_steps, j_hist = [], [], [], []

    def capture_port(x, y):
        logs = port_step(x, y)
        p_steps.append([float(logs[k]) for k in LOSS_KEYS])
        return logs

    jstep = jax_train_step(*models, *txs, **body)

    def capture_jax(states, x, y, mask, rng):
        states, logs = jstep(states, x, y, mask, rng)
        j_steps.append([float(logs[k]) for k in LOSS_KEYS])
        return states, logs

    mesh = MeshContext.create(data=1)  # no padding rows in BatchNorm
    states = mesh.put_replicated(states)
    keys = KeySeq(5)
    cpu = torch.device("cpu")
    for epoch in (1, 2):
        result, _ = dcgan_trainer.train_single_epoch(
            dcgan_trainer.step_logs(train_batches, capture_port, cpu,
                                    log_every=1000))
        p_hist.append(result | dcgan_trainer.test(val_batches, port_eval,
                                                  cpu))
        states, result, _ = jax_train_single_epoch(
            dataloader=list(train_batches), states=states, step=capture_jax,
            mesh=mesh, batch_size=B, rng_keys=keys, epoch=epoch,
            log_every=1000)
        j_hist.append(result | jax_test(
            list(val_batches), states, jax_eval_step(*models), mesh, B,
            epoch))
    assert len(p_steps) == len(j_steps) == 8
    np.testing.assert_allclose(p_steps, j_steps, rtol=STEP_RTOL,
                               atol=STEP_ATOL)
    quantum = {"train_fd_accuracy": 1 / (2 * B * 4),
               "train_td_accuracy": 1 / (2 * B * 4),
               "frame_disc_accuracy": 1 / 4, "temp_disc_accuracy": 1 / 4}
    for p, j in zip(p_hist, j_hist):
        assert sorted(p) == sorted(j)
        for k, want in j.items():
            assert (abs(p[k] - want) <= METRIC_BUDGET * abs(want)
                    or abs(p[k] - want) <= quantum.get(k, 0.0) + 1e-9), \
                (k, p[k], want)


def _step_batch():
    rng = np.random.default_rng(7)
    return frames(rng), frames(rng)


def _grads_of(trees):
    return {n: {k: v.numpy() for k, v in from_flax_params(jax.device_get(
        tree)).items()} for n, tree in zip(NETS, trees)}


ROW_ORDER = np.array([2, 0, 3, 1])


@functools.cache
def _jax_sgd_steps(variant):
    """One JAX SGD step from the initial states, on the batch and on its
    rows in ``ROW_ORDER``: (losses, grads, stats) each, per net; and the
    initial states."""
    body, packed = VARIANTS[variant]
    models, txs, states = jax_gan(packed, _sgd)
    step = jax_train_step(*models, *txs, **body)
    x, y = _step_batch()

    def run(x, y):
        new, logs = step(jax.tree_util.tree_map(jnp.copy, states),
                         jnp.asarray(nhwc(x)), jnp.asarray(nhwc(y)),
                         jnp.ones(B), jax.random.PRNGKey(0))
        return ([float(logs[k]) for k in LOSS_KEYS],
                _grads_of([getattr(new, n).opt_state[0] for n in NETS]),
                {n: jax_tree(getattr(new, n), True) for n in NETS})

    return run(x, y), run(x[ROW_ORDER], y[ROW_ORDER]), states


def _port_sgd_step(variant, states, x, dtype=torch.float32):
    """The port's SGD step from ``states`` on (x, the batch's y), in
    ``dtype``: (losses, grads, stats) per net."""
    body, packed = VARIANTS[variant]
    nets, _ = port_gan(states, packed, _torch_sgd)
    nets = tuple(n.to(dtype) for n in nets)
    opts = tuple(_torch_sgd(n.parameters()) for n in nets)
    y = _step_batch()[1]
    logs = dcgan_trainer.make_dcgan_train_step(*nets, *opts, **body)(
        torch.from_numpy(x).to(dtype), torch.from_numpy(y).to(dtype))
    grads = {n: {k: p.grad.double().numpy() for k, p in
                 net.named_parameters()} for n, net in zip(NETS, nets)}
    return ([float(logs[k]) for k in LOSS_KEYS], grads,
            {n: {k: np.asarray(v, np.float64) for k, v in
                 port_tree(net, True).items()} for n, net in zip(NETS, nets)})


def _grad_gaps(got, want):
    """{(net, tensor): gap} of every gradient but G's pre-BatchNorm biases,
    which are checked to be zero up to roundoff on both sides."""
    gaps = {}
    for n in NETS:
        assert sorted(got[n]) == sorted(want[n])
        for k, w in want[n].items():
            if n == "g" and k in PRE_BN_BIASES:
                weight = k.replace("bias", "weight")
                for side in (got, want):
                    assert np.abs(side[n][k]).max() <= 1e-3 * np.abs(
                        side[n][weight]).max(), (k, side is got)
                continue
            gaps[n, k] = gap(got[n][k], w)
    return gaps


def _grad_misses(variant, port):
    """{(net, tensor): gap} of the gradients farther than GRAD_TOL from
    JAX's in both row orders (the nearer one's gap)."""
    (_, j_grads, _), (_, j_other, _), _ = _jax_sgd_steps(variant)
    gaps, other = _grad_gaps(port, j_grads), _grad_gaps(port, j_other)
    near = {k: min(g, other[k]) for k, g in gaps.items()}
    return {k: g for k, g in near.items() if g > GRAD_TOL}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_one_sgd_step_matches_jax(variant):
    (j_loss, j_grads, j_stats), _, states = _jax_sgd_steps(variant)
    x = _step_batch()[0]
    p_loss, p_grads, p_stats = _port_sgd_step(variant, states, x)
    np.testing.assert_allclose(p_loss, j_loss, rtol=LOSS_TOL)
    assert not _grad_misses(variant, p_grads)
    # and every gradient within GRAD_TOL of the port's float64 twin
    twin = _port_sgd_step(variant, states, x, torch.float64)[1]
    gaps = _grad_gaps(p_grads, twin)
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= GRAD_TOL, (worst, gaps[worst])
    for n in NETS:
        assert sorted(p_stats[n]) == sorted(j_stats[n])
        for k, want in j_stats[n].items():
            assert gap(p_stats[n][k], want) <= STATS_TOL, (n, k)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_fake_rows_against_label_1_fail(variant, monkeypatch):
    """The planted fault: the discriminators' fake-row loss against label 1
    in place of 0. The bound of the test above must see it."""
    _, _, states = _jax_sgd_steps(variant)
    real_bce = dcgan_trainer.bce

    def swapped(p, target, *, mask=None):
        return real_bce(p, 1.0 if target == 0.0 else target, mask=mask)

    monkeypatch.setattr(dcgan_trainer, "bce", swapped)
    grads = _port_sgd_step(variant, states, _step_batch()[0])[1]
    misses = _grad_misses(variant, grads)
    worst = max(misses.values(), default=0.0) / GRAD_TOL
    print(f"{variant}: fake rows against label 1 miss the bound on "
          f"{len(misses)} gradients, by up to {worst:.1f}x")
    assert worst > 100


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_megastep_of_two_equals_two_steps(variant):
    body, packed = VARIANTS[variant]
    _, _, states = jax_gan(packed, _adam)
    rng = np.random.default_rng(11)
    xs = torch.from_numpy(np.stack([frames(rng) for _ in range(2)]))
    ys = torch.from_numpy(np.stack([frames(rng) for _ in range(2)]))
    masks = torch.ones(2, B)
    nets_a, opts_a = port_gan(states, packed, _torch_adam)
    nets_b, opts_b = port_gan(states, packed, _torch_adam)
    logs_a = dcgan_trainer.make_dcgan_megastep(*nets_a, *opts_a, **body)(
        xs, ys, masks)
    step = dcgan_trainer.make_dcgan_train_step(*nets_b, *opts_b, **body)
    logs_b = [step(xs[i], ys[i], masks[i]) for i in range(2)]
    for k, v in logs_a.items():
        want = (logs_b[0][k] + logs_b[1][k] if k.endswith("_nd")
                else logs_b[1][k])
        assert torch.equal(v, want), k
    for a, b in zip(nets_a, nets_b):
        for (k, va), vb in zip(a.state_dict().items(),
                               b.state_dict().values()):
            assert torch.equal(va, vb), k


@pytest.mark.parametrize("path", ["single", "megastep", "resident"])
def test_driver_hands_each_option_to_the_step(path, monkeypatch, capsys):
    seen = {}
    stop = RuntimeError("step built")

    def recorder(name):
        def make(*args, **kw):
            seen[name] = {k: kw.get(k) for k in ("fused_disc", "fused_prop")}
            seen["packed"] = args[0].packed
            if name == path:
                raise stop
            return lambda *a: None
        return make

    for name, fn in (("single", "make_dcgan_train_step"),
                     ("megastep", "make_dcgan_megastep"),
                     ("resident", "make_dcgan_resident_megastep")):
        monkeypatch.setattr(dcgan_driver, fn, recorder(name))
    kw = {"megastep": dict(megastep=2), "resident": dict(resident=True),
          "single": {}}[path]
    with pytest.raises(RuntimeError, match="step built"):
        dcgan_driver.train(device="cpu", synthetic=True, fused_disc=True,
                           fused_prop=True, packed_g=True,
                           params={"ndf": 8}, **kw)
    assert seen[path] == dict(fused_disc=True, fused_prop=True)
    assert seen["packed"] is True
    out = capsys.readouterr().out
    for tag in ("[packed-g]", "[fused-disc]", "[fused-prop]"):
        assert tag in out


def test_cli_flags_and_defaults_are_jax(monkeypatch):
    seen = {}
    monkeypatch.setattr("extended_gan_torch.dcgan.__main__.train",
                        lambda **kw: seen.update(kw))
    cli([])
    assert (seen["fused_disc"], seen["fused_prop"], seen["packed_g"]) == \
        (False, False, None)
    cli(["--fused-disc", "--fused-prop", "--packed-g"])
    assert (seen["fused_disc"], seen["fused_prop"], seen["packed_g"]) == \
        (True, True, True)
    cli(["--no-packed-g"])
    assert seen["packed_g"] is False


@pytest.mark.parametrize("extra", [[], ["--megastep", "2", "--resident"]])
def test_cli_trains_every_option_on_the_cpu(tmp_path, monkeypatch, extra):
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "out"
    nets, history = cli(["--device", "cpu", "--epochs", "1", "--max-batches",
                         "2", "--synthetic", "--out-dir", str(out),
                         "--train-batch-size", "4", "--test-batch-size", "8",
                         "--fused-disc", "--fused-prop", "--packed-g",
                         *extra])
    assert nets[0].packed
    assert all(len(v) == 1 and np.isfinite(v[0])
               for v in history.history.values())
    assert sorted(os.listdir(out)) == ["checkpoints", "history.json",
                                       "imgs", "training_plots"]
