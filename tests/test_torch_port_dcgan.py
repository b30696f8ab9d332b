"""The port's DCGAN modules against the JAX package's, on the CPU.

Narrow nets (ndf = 8) at the discriminators' 64x64, B = 4, dropout off
(cross-framework dropout draws cannot agree); weights go across with
``from_flax_params``.

- Eval-mode forwards of the three nets within 2e-4 (the bar of
  ``tests/test_e2e_torch_parity.py``); the TemporalDiscriminator at B = 1
  too, where its output keeps the batch axis.
- ``bce`` against JAX's at random p, and at saturated p (0, a subnormal, 1,
  1 - 2^-24), where value and gradient equal JAX's and are finite.
- The metrics against JAX's on the same arrays: exact.
- One train step against ``make_dcgan_train_step`` (all-ones mask): the
  three losses within 1e-5 relative; the running statistics of all three
  nets within 1e-5 of each tensor's largest entry; the updated parameters
  within 1e-4 of each tensor's largest entry, or, where a tensor misses
  that, within ``SENS_FACTOR`` times what perturbing x by 1e-7 noise moves
  either side's own result. The generator's pre-BatchNorm conv biases have
  a gradient of zero up to roundoff, which Adam turns into steps of up to
  lr either way; the same holds wherever train-mode BatchNorm cancels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extended_gan_tpu.core import KeySeq
from extended_gan_tpu.models import dcgan as jax_dcgan
from extended_gan_tpu.train import losses as jax_losses
from extended_gan_tpu.train.dcgan_trainer import (
    GANStates,
    make_dcgan_train_step as jax_train_step,
)
from extended_gan_tpu.train.optim import adam
from extended_gan_tpu.train.state import create_net_state
from extended_gan_tpu.utils import metrics as jax_metrics
from extended_gan_torch.models import dcgan
from extended_gan_torch.models.convert import from_flax_params
from extended_gan_torch.train import losses
from extended_gan_torch.train.dcgan_trainer import make_dcgan_train_step
from extended_gan_torch.utils import metrics
from test_torch_port_gat_family import one_torch_thread  # noqa: F401 - the autouse fixture
from test_torch_port_gat_smaat import SENS_FACTOR, gap, perturbed

NC, NDF, IM, B = 4, 8, 64, 4
LR, BETA1 = 2e-4, 0.5
FWD_TOL = 2e-4
LOSS_TOL = 1e-5
PARAM_TOL = 1e-4
STATS_TOL = 1e-5
NETS = ("g", "fd", "td")


def jax_gan(seed=5):
    """Flax models, optax transforms and initial GANStates, dropout off."""
    models = (jax_dcgan.Generator(nc=NC, dropout=0.0),
              jax_dcgan.FrameDiscriminator(nc=NC, ndf=NDF),
              jax_dcgan.TemporalDiscriminator(nc=NC, ndf=NDF, dropout=0.0))
    txs = tuple(adam(LR, b1=BETA1) for _ in models)
    keys = KeySeq(seed)
    samples = (jnp.zeros((2, IM, IM, NC)),) * 2 + (
        jnp.zeros((2, IM, IM, 2 * NC)),)
    states = GANStates(*(create_net_state(m, tx, keys.next(), s)
                         for m, tx, s in zip(models, txs, samples)))
    return models, txs, states


def port_gan(states):
    """The port's (G, FD, TD) with the flax states' weights and running
    statistics, dropout off, and their Adam optimizers."""
    nets = (dcgan.Generator(NC, dropout=0.0),
            dcgan.FrameDiscriminator(NC, NDF),
            dcgan.TemporalDiscriminator(NC, NDF, dropout=0.0))
    for net, name in zip(nets, NETS):
        st = getattr(states, name)
        net.load_state_dict(from_flax_params(jax.device_get(st.params),
                                             jax.device_get(st.batch_stats)))
    opts = tuple(torch.optim.Adam(n.parameters(), lr=LR, betas=(BETA1, 0.999),
                                  eps=1e-8) for n in nets)
    return nets, opts


def nhwc(a):
    return np.moveaxis(a, 1, -1)


def frames(rng, b=B):
    return rng.uniform(0, 1, (b, NC, IM, IM)).astype(np.float32)


def port_tree(net, stats=False):
    """The port's parameters (or running statistics) under their state_dict
    names, as numpy."""
    if stats:
        return {k: v.numpy().copy() for k, v in net.state_dict().items()
                if k.endswith(("running_mean", "running_var"))}
    return {k: v.detach().numpy().copy() for k, v in net.named_parameters()}


def jax_tree(state, stats=False):
    """A NetState's parameters (or batch_stats) under the port's names."""
    if stats:
        sd = from_flax_params({}, jax.device_get(state.batch_stats))
        return {k: v.numpy() for k, v in sd.items()
                if not k.endswith("num_batches_tracked")}
    return {k: v.numpy()
            for k, v in from_flax_params(jax.device_get(state.params)).items()}


@pytest.fixture(scope="module")
def gan():
    return jax_gan()


def test_parameter_names_and_counts_match_flax(gan):
    _, _, states = gan
    nets, _ = port_gan(states)
    for net, name in zip(nets, NETS):
        want = jax_tree(getattr(states, name))
        assert sorted(port_tree(net)) == sorted(want)
    full = (dcgan.Generator(), dcgan.FrameDiscriminator(),
            dcgan.TemporalDiscriminator())
    assert [sum(p.numel() for p in n.parameters()) for n in full] == \
        [13_240, 2_766_592, 2_770_688]


@pytest.mark.parametrize("b", [B, 1])
def test_eval_forwards_match_flax(gan, b):
    models, _, states = gan
    nets, _ = port_gan(states)
    rng = np.random.default_rng(b)
    x, y = frames(rng, b), frames(rng, b)
    inputs = (x, y, np.concatenate([x, y], axis=1))
    for model, net, name, a in zip(models, nets, NETS, inputs):
        st = getattr(states, name)
        variables = {"params": st.params}
        if st.batch_stats:
            variables["batch_stats"] = st.batch_stats
        want = np.asarray(model.apply(variables, jnp.asarray(nhwc(a)),
                                      train=False))
        with torch.no_grad():
            got = net.eval()(torch.from_numpy(a)).numpy()
        if name == "g":
            want = np.moveaxis(want, -1, 1)
        else:
            assert got.shape == want.shape == (b,)
        np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)


def test_bce_matches_jax_at_random_p():
    rng = np.random.default_rng(0)
    p = rng.uniform(0, 1, 64).astype(np.float32)
    target = (rng.uniform(0, 1, 64) > 0.5).astype(np.float32)
    mask = (np.arange(64) < 50).astype(np.float32)
    for t in (1.0, 0.0, target):
        for m in (None, mask):
            want = float(jax_losses.bce(
                jnp.asarray(p), jnp.asarray(t),
                mask=None if m is None else jnp.asarray(m)))
            got = float(losses.bce(
                torch.from_numpy(p), torch.as_tensor(t),
                mask=None if m is None else torch.from_numpy(m)))
            assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("target", [0.0, 1.0])
def test_bce_at_saturated_p_matches_jax(target):
    p = np.array([0.0, 1e-45, 1.0, 1 - 2.0**-24], np.float32)
    for i in range(len(p)):
        pi = p[i:i + 1]
        want, want_grad = jax.value_and_grad(
            lambda q: jax_losses.bce(q, target))(jnp.asarray(pi))
        t = torch.from_numpy(pi.copy()).requires_grad_()
        got = losses.bce(t, target)
        (got_grad,) = torch.autograd.grad(got, t)
        got = got.detach()
        assert np.isfinite(float(got)) and np.isfinite(got_grad.numpy()).all()
        assert float(got) == pytest.approx(float(want), rel=1e-6)
        np.testing.assert_allclose(got_grad.numpy(), np.asarray(want_grad),
                                   rtol=1e-6)


def test_metrics_match_jax():
    rng = np.random.default_rng(1)
    y = rng.uniform(0, 1, (5, NC, 8, 8)).astype(np.float32)
    y_hat = rng.uniform(0, 1, (5, NC, 8, 8)).astype(np.float32)
    mask = np.array([1, 1, 0, 1, 0], np.float32)
    names = ("accuracy", "precision", "recall", "mse")
    for m in (mask, None):
        want = (jax_metrics.batch_metrics(names, jnp.asarray(y),
                                          jnp.asarray(y_hat))
                if m is None else jax_metrics.masked_batch_metrics(
                    names, jnp.asarray(y), jnp.asarray(y_hat),
                    jnp.asarray(m)))
        got = (metrics.batch_metrics(names, torch.from_numpy(y),
                                     torch.from_numpy(y_hat))
               if m is None else metrics.masked_batch_metrics(
                   names, torch.from_numpy(y), torch.from_numpy(y_hat),
                   torch.from_numpy(m)))
        for k in names:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    p = np.array([0.2, 0.5, 0.51, 0.9, 1.5], np.float32)
    labels = np.ones(5, np.float32)
    np.testing.assert_array_equal(
        metrics.rounded_match_nd(torch.from_numpy(p),
                                 torch.from_numpy(labels)).numpy(),
        np.asarray(jax_metrics.rounded_match_nd(jnp.asarray(p),
                                                jnp.asarray(labels))))
    # the host accumulators, fed the same pairs
    jm = jax_metrics.MetricsManager(names, prefix="pred")
    pm = metrics.MetricsManager(names, prefix="pred")
    jm.update(y, y_hat)
    pm.update(y, y_hat)
    jt, pt = jax_metrics.IncrementalTuple(), metrics.IncrementalTuple()
    for pair in ([3.0, 4.0], [1.0, 2.0]):
        jt += jax_metrics.IncrementalTuple(pair)
        pt += metrics.IncrementalTuple(pair)
    assert pm.results() == jm.results()
    assert (pt.item(), pt.reciprocal().item(), (pt + pt).item()) == \
        (jt.item(), jt.reciprocal().item(), (jt + jt).item())
    assert np.isnan(metrics.IncrementalTuple().item())


def _jax_step(gan, x, y):
    """One JAX train step from the initial states: (losses, params, stats)
    per net."""
    models, txs, states = gan
    step = jax_train_step(*models, *txs)
    states = jax.tree_util.tree_map(jnp.copy, states)  # the step donates
    new, logs = step(states, jnp.asarray(nhwc(x)), jnp.asarray(nhwc(y)),
                     jnp.ones(len(x)), jax.random.PRNGKey(0))
    loss = [float(logs[k]) for k in ("errFD", "errTD", "errG")]
    return (loss, {n: jax_tree(getattr(new, n)) for n in NETS},
            {n: jax_tree(getattr(new, n), True) for n in NETS})


def _port_step(gan, x, y):
    nets, opts = port_gan(gan[2])
    logs = make_dcgan_train_step(*nets, *opts)(torch.from_numpy(x),
                                               torch.from_numpy(y))
    loss = [float(logs[k]) for k in ("errFD", "errTD", "errG")]
    return (loss, {n: port_tree(net) for n, net in zip(NETS, nets)},
            {n: port_tree(net, True) for n, net in zip(NETS, nets)})


def test_one_train_step_matches_jax(gan):
    rng = np.random.default_rng(7)
    x, y = frames(rng), frames(rng)
    j_loss, j_params, j_stats = _jax_step(gan, x, y)
    p_loss, p_params, p_stats = _port_step(gan, x, y)
    np.testing.assert_allclose(p_loss, j_loss, rtol=LOSS_TOL)
    for n in NETS:
        assert sorted(p_stats[n]) == sorted(j_stats[n])
        for k, want in j_stats[n].items():
            assert gap(p_stats[n][k], want) <= STATS_TOL, (n, k)
    # roundoff sensitivity, measured only where the plain bound misses
    sens = None
    for n in NETS:
        for k, want in j_params[n].items():
            g = gap(p_params[n][k], want)
            if g <= PARAM_TOL:
                continue
            if sens is None:
                xp = perturbed(x)
                sens = (_jax_step(gan, xp, y)[1], _port_step(gan, xp, y)[1])
            limit = SENS_FACTOR * max(gap(sens[0][n][k], want),
                                      gap(sens[1][n][k], p_params[n][k]))
            assert g <= limit, (n, k, g, limit)
