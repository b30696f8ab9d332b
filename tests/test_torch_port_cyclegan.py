"""The port's CycleGAN step (``train/cyclegan_trainer.py``) against the JAX
package's, on the CPU.

Narrow discriminators (ndf = 8) at 64x64, B = 4, nc = 4, dropout off
(cross-framework dropout draws cannot agree); weights go across with
``from_flax_params``. The DCGAN test's bounds (``test_torch_port_dcgan.py``):

- the four nets' parameter names equal the flax trees'; at full width the
  generators hold 13,240 parameters and the discriminators 2,766,592;
- the eval step (G_xy, then G_yx on its output) and its (num, denom) sums
  within FWD_TOL, a padded row masked out;
- one train step against ``make_cyclegan_train_step`` (all-ones mask and a
  mask with a padded row): the five losses within LOSS_TOL relative; the
  four nets' running statistics within STATS_TOL of each tensor's largest
  entry; their parameters within PARAM_TOL, or within ``SENS_FACTOR``
  times what 1e-7 noise on x moves either side's own result where a
  tensor misses that (Adam turns a gradient within roundoff of zero into a
  step of up to lr either way: the generators' pre-BatchNorm conv biases);
  ``train_mse_nd`` within LOSS_TOL;
- a planted fault, a step whose cycle forwards update the generators'
  running statistics (a literal port's), fails the statistics bound: the
  gap it makes is printed and must exceed 100 x STATS_TOL;
- the bf16 eval step (the nets built with ``dtype=torch.bfloat16``)
  against JAX's bf16 one, by ``test_torch_port_precision.hold_to_jax``'s
  rule (root-mean-square gap at most twice JAX's own bf16-to-f32 gap).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extended_gan_tpu.core import KeySeq
from extended_gan_tpu.models import dcgan as jax_dcgan
from extended_gan_tpu.train import cyclegan_trainer as jax_trainer
from extended_gan_tpu.train.optim import adam
from extended_gan_tpu.train.state import create_net_state
from extended_gan_torch.models import dcgan
from extended_gan_torch.train import cyclegan_trainer
from extended_gan_torch.train.checkpoint import CYCLEGAN_NETS
from test_torch_port_dcgan import (
    FWD_TOL,
    LOSS_TOL,
    PARAM_TOL,
    STATS_TOL,
    jax_tree,
    nhwc,
    port_tree,
)
from test_torch_port_gat_family import one_torch_thread  # noqa: F401 - the autouse fixture
from test_torch_port_gat_smaat import SENS_FACTOR, gap, perturbed
from test_torch_port_precision import hold_to_jax

NC, NDF, IM, B = 4, 8, 64, 4
LR, BETA1, LAMBDA = 2e-4, 0.5, 10.0
LOSSES = cyclegan_trainer.LOSS_KEYS


def jax_models(dtype=jnp.float32):
    return (jax_dcgan.Generator(nc=NC, dropout=0.0, dtype=dtype),
            jax_dcgan.Generator(nc=NC, dropout=0.0, dtype=dtype),
            jax_dcgan.FrameDiscriminator(nc=NC, ndf=NDF, dtype=dtype),
            jax_dcgan.FrameDiscriminator(nc=NC, ndf=NDF, dtype=dtype))


def jax_cyclegan(seed=3, tx=None):
    """Flax models, optax transforms, the initial CycleGANStates and the
    jitted train step, dropout off."""
    models = jax_models()
    txs = tuple((tx or (lambda: adam(LR, b1=BETA1)))() for _ in models)
    keys = KeySeq(seed)
    sample = jnp.zeros((2, IM, IM, NC))
    states = jax_trainer.CycleGANStates(*(
        create_net_state(m, t, keys.next(), sample)
        for m, t in zip(models, txs)))
    step = jax_trainer.make_cyclegan_train_step(*models, *txs,
                                                cycle_lambda=LAMBDA)
    return models, txs, states, step


def port_cyclegan(states, dtype=torch.float32, opt=None):
    """The port's four nets with the flax states' weights and running
    statistics, dropout off, and an optimizer each (Adam as the driver's,
    or ``opt(params)``)."""
    nets = (dcgan.Generator(NC, dropout=0.0, dtype=dtype),
            dcgan.Generator(NC, dropout=0.0, dtype=dtype),
            dcgan.FrameDiscriminator(NC, NDF, dtype=dtype),
            dcgan.FrameDiscriminator(NC, NDF, dtype=dtype))
    for net, name in zip(nets, CYCLEGAN_NETS):
        st = getattr(states, name)
        net.load_state_dict(from_flax(st))
    opts = tuple((opt or (lambda p: torch.optim.Adam(
        p, lr=LR, betas=(BETA1, 0.999), eps=1e-8)))(n.parameters())
        for n in nets)
    return nets, opts


def from_flax(st):
    from extended_gan_torch.models.convert import from_flax_params

    return from_flax_params(jax.device_get(st.params),
                            jax.device_get(st.batch_stats))


@pytest.fixture(scope="module")
def gan():
    return jax_cyclegan()


def frames(rng, b=B):
    return rng.uniform(0, 1, (b, NC, IM, IM)).astype(np.float32)


def test_parameter_names_and_counts_match_flax(gan):
    _, _, states, _ = gan
    nets, _ = port_cyclegan(states)
    for net, name in zip(nets, CYCLEGAN_NETS):
        assert sorted(port_tree(net)) == sorted(jax_tree(getattr(states,
                                                                 name)))
        assert sorted(port_tree(net, True)) == sorted(
            jax_tree(getattr(states, name), True))
    full = (dcgan.Generator(), dcgan.FrameDiscriminator())
    assert [sum(p.numel() for p in n.parameters()) for n in full] == \
        [13_240, 2_766_592]


def _masks():
    return (np.ones(B, np.float32),
            np.array([1, 1, 1, 0], np.float32))


def test_eval_step_matches_jax(gan):
    models, _, states, _ = gan
    nets, _ = port_cyclegan(states)
    j_eval = jax_trainer.make_cyclegan_eval_step(models[0], models[1])
    p_eval = cyclegan_trainer.make_cyclegan_eval_step(nets[0], nets[1])
    rng = np.random.default_rng(1)
    x, y = frames(rng), frames(rng)
    for mask in _masks():
        want_fake, want = j_eval(states, jnp.asarray(nhwc(x)),
                                 jnp.asarray(nhwc(y)), jnp.asarray(mask))
        got_fake, got = p_eval(torch.from_numpy(x), torch.from_numpy(y),
                               torch.from_numpy(mask))
        np.testing.assert_allclose(got_fake.numpy(),
                                   np.moveaxis(np.asarray(want_fake), -1, 1),
                                   rtol=FWD_TOL, atol=FWD_TOL)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=FWD_TOL, err_msg=k)


def _all_trees(nets=None, states=None):
    """{(net, "params" or "stats"): {name: array}} under the port's
    names."""
    if states is not None:
        return {(n, kind): jax_tree(getattr(states, n), kind == "stats")
                for n in CYCLEGAN_NETS for kind in ("params", "stats")}
    return {(n, kind): port_tree(net, kind == "stats")
            for n, net in zip(CYCLEGAN_NETS, nets)
            for kind in ("params", "stats")}


def jax_step(gan, x, y, mask):
    """One JAX step from the initial states: (logs as numpy, trees)."""
    _, _, states, step = gan
    states = jax.tree_util.tree_map(jnp.copy, states)  # the step donates
    new, logs = step(states, jnp.asarray(nhwc(x)), jnp.asarray(nhwc(y)),
                     jnp.asarray(mask), jax.random.PRNGKey(0))
    return ({k: np.asarray(v) for k, v in logs.items()},
            _all_trees(states=new))


def port_step(gan, x, y, mask, frozen=True):
    nets, opts = port_cyclegan(gan[2])
    ctx = contextlib.nullcontext() if frozen else _cycle_updates_stats()
    with ctx:
        step = cyclegan_trainer.make_cyclegan_train_step(
            *nets, *opts, cycle_lambda=LAMBDA)
        logs = step(torch.from_numpy(x), torch.from_numpy(y),
                    torch.from_numpy(mask))
    return ({k: v.numpy() for k, v in logs.items()}, _all_trees(nets=nets))


@contextlib.contextmanager
def _cycle_updates_stats():
    """The planted fault: the cycle forwards update the running statistics,
    as a literal port's would."""
    real = cyclegan_trainer.running_stats_frozen
    cyclegan_trainer.running_stats_frozen = \
        lambda bns: contextlib.nullcontext()
    try:
        yield
    finally:
        cyclegan_trainer.running_stats_frozen = real


def _stats_gap(got, want):
    return max(gap(got[key][k], w) for key in want if key[1] == "stats"
               for k, w in want[key].items())


@pytest.mark.parametrize("mask", ["ones", "padded"])
def test_one_train_step_matches_jax(gan, mask):
    rng = np.random.default_rng(7)
    x, y = frames(rng), frames(rng)
    m = _masks()[mask == "padded"]
    j_logs, j_trees = jax_step(gan, x, y, m)
    p_logs, p_trees = port_step(gan, x, y, m)
    assert sorted(p_logs) == sorted(j_logs) == sorted(LOSSES
                                                      + ("train_mse_nd",))
    for k in j_logs:
        np.testing.assert_allclose(p_logs[k], j_logs[k], rtol=LOSS_TOL,
                                   err_msg=k)
    assert sorted(p_trees) == sorted(j_trees)
    for key in j_trees:
        assert sorted(p_trees[key]) == sorted(j_trees[key]), key
    assert _stats_gap(p_trees, j_trees) <= STATS_TOL
    sens = None
    for key, tree in j_trees.items():
        if key[1] != "params":
            continue
        for k, want in tree.items():
            g = gap(p_trees[key][k], want)
            if g <= PARAM_TOL:
                continue
            if sens is None:  # roundoff sensitivity, where the bound misses
                xp = perturbed(x)
                sens = (jax_step(gan, xp, y, m)[1],
                        port_step(gan, xp, y, m)[1])
            limit = SENS_FACTOR * max(gap(sens[0][key][k], want),
                                      gap(sens[1][key][k],
                                          p_trees[key][k]))
            assert g <= limit, (key, k, g, limit)


def test_cycle_forwards_updating_the_statistics_fail(gan):
    """The fault a literal port makes: the generators' running statistics
    take the cycle forwards' batches too."""
    rng = np.random.default_rng(7)
    x, y = frames(rng), frames(rng)
    m = _masks()[0]
    j_logs, j_trees = jax_step(gan, x, y, m)
    p_logs, p_trees = port_step(gan, x, y, m, frozen=False)
    fault = _stats_gap(p_trees, j_trees)
    print(f"cycle forwards updating the running statistics: gap {fault:.3e} "
          f"of the largest entry (bound {STATS_TOL})")
    assert fault > 100 * STATS_TOL
    # the step's losses are the same: the statistics alone are wrong
    for k in LOSSES:
        np.testing.assert_allclose(p_logs[k], j_logs[k], rtol=LOSS_TOL,
                                   err_msg=k)


def test_bf16_eval_step_matches_jax(gan):
    models, _, states, _ = gan
    models16 = jax_models(jnp.bfloat16)
    nets16, _ = port_cyclegan(states, torch.bfloat16)
    rng = np.random.default_rng(4)
    x, y = frames(rng), frames(rng)
    xj, yj, mj = (jnp.asarray(nhwc(x)), jnp.asarray(nhwc(y)), jnp.ones(B))
    want = {}
    for label, ms in (("f32", models), ("bf16", models16)):
        fake, _ = jax_trainer.make_cyclegan_eval_step(ms[0], ms[1])(
            states, xj, yj, mj)
        cyc = ms[1].apply({"params": states.g_yx.params,
                           "batch_stats": states.g_yx.batch_stats}, fake,
                          train=False)
        want[label] = [np.moveaxis(np.asarray(a, np.float32), -1, 1)
                       for a in (fake, cyc)]
    fake, _ = cyclegan_trainer.make_cyclegan_eval_step(nets16[0], nets16[1])(
        torch.from_numpy(x), torch.from_numpy(y))
    assert fake.dtype == torch.float32
    with torch.no_grad():
        cyc = nets16[1](fake)
    for got, w16, w32 in zip((fake, cyc), want["bf16"], want["f32"]):
        hold_to_jax(got.numpy(), w16, w32)
