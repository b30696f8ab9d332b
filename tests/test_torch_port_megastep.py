"""The port's megastep (``train/megastep.py``) against the JAX package's, on
the CPU, where it runs its K steps eagerly (the CUDA graph is the card's:
``tests/test_torch_port_cuda.py``).

- The log rule: ``*_nd`` pairs summed over the K steps, every other log the
  last step's, as JAX's ``wrap_megastep`` gives them.
- ``make_gat_megastep`` with ``gat_megafeed``, and ``make_dcgan_megastep``
  with ``dcgan_trainer._megafeed``, against JAX's ``make_gat_megastep`` and
  ``make_dcgan_megastep(dedup_g=True)`` with their feeds on a one-device
  mesh, which pads the ragged tail batch to the nominal size as the port
  does: K = 2 over a loader with a batch of one sample (dropped) and a
  short last batch (its own group of one), strict SGD, dropout off, JAX's
  Pallas kernels in interpret mode. Parameters and logs within 2e-5; the
  DCGAN's within ``SENS_FACTOR`` times what one rounding of the input
  moves either side's own result, where that is more
  (:func:`assert_dcgan_runs_match` says why).
- The port's megastep against its own single steps under SGD: equal, every
  step run once and in order, across an epoch boundary where the learning
  rate changes; Adam's step count equals the steps taken.
- The DCGAN step with a mask of ones equals the unmasked step exactly, and
  builds no tensor from host data (which a CUDA graph cannot capture).
- The launch counters' replay rule (``ops.add_launches``).
- ``utils.compare.held_to_reference``, the test a graph's train state is
  held to on the card: run-to-run noise passes, a skipped optimizer step
  or a missed BatchNorm update fails.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from extended_gan_tpu.models.gat.gat3d import Model as FlaxGatModel
from extended_gan_tpu.parallel import MeshContext
from extended_gan_tpu.train import dcgan_trainer as jax_dcgan_trainer
from extended_gan_tpu.train import gat_trainer as jax_gat_trainer
from extended_gan_tpu.train import megastep as jax_megastep
from extended_gan_tpu.train import optim as jax_optim
from extended_gan_tpu.train.dcgan_trainer import GANStates
from extended_gan_tpu.train.state import NetState, create_net_state
from extended_gan_torch import ops
from extended_gan_torch.models.convert import from_flax_params
from extended_gan_torch.models.registry import build_model
from extended_gan_torch.train import dcgan_trainer, gat_trainer, megastep
from extended_gan_torch.train.optim import make_optimizer
from test_torch_port_dcgan import NC, NDF, jax_tree, port_gan, port_tree
from test_torch_port_gat_family import one_torch_thread  # noqa: F401 - the autouse fixture
from test_torch_port_gat_smaat import SENS_FACTOR, gap, perturbed

TOL = 2e-5
K = 2
HW, B, V, T = 8, 4, 6, 4
SIZES = (B, 1, B, 3)  # one batch of one sample, then a short last batch
CPU = torch.device("cpu")


def _loader(rng, shape):
    return [(rng.uniform(0, 1, (n,) + shape).astype(np.float32),
             rng.uniform(0, 1, (n,) + shape).astype(np.float32))
            for n in SIZES]


def _mesh():
    return MeshContext.create(data=1, devices=jax.devices()[:1])


def test_log_rule_matches_wrap_megastep():
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((3, 5)).astype(np.float32)

    def jbody(state, x, y, mask, r):
        return state + 1, {"loss": jnp.sum(x),
                           "a_nd": jnp.stack([jnp.sum(x), jnp.sum(x * x)])}

    z = np.zeros((3, 1), np.float32)
    _, want = jax_megastep.wrap_megastep(jbody)(
        jnp.zeros(()), jnp.asarray(xs), z, z, jnp.zeros((3, 2), jnp.uint32))

    def body(x):
        return {"loss": x.sum(), "a_nd": torch.stack([x.sum(), (x * x).sum()])}

    got = megastep.Megastep(body)(torch.from_numpy(xs))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, err_msg=k)


def _gat_pair(lr):
    fmodel = FlaxGatModel(image_width=HW, image_height=HW, n_vertices=V,
                          attention_type="temporal", mapping_type="conv",
                          use_pallas=True)
    model = build_model("temporal", image_width=HW, image_height=HW,
                        n_vertices=V, mapping_type="conv", use_pallas=True,
                        device="cpu")
    variables = jax.device_get(jax.jit(lambda k: fmodel.init(
        k, jnp.zeros((2, HW, HW, T, V)), train=False))(jax.random.PRNGKey(3)))
    model.load_state_dict(from_flax_params(variables["params"],
                                           variables.get("batch_stats")))
    tx = jax_optim.make_optimizer("sgd", lr)
    state = NetState(params=variables["params"],
                     batch_stats=variables.get("batch_stats", {}),
                     opt_state=tx.init(variables["params"]))
    return fmodel, tx, state, model, make_optimizer("sgd", model.parameters(),
                                                    lr)


def test_gat_megastep_matches_jax():
    batches = _loader(np.random.default_rng(1), (HW, HW, T, V))
    fmodel, tx, state, model, opt = _gat_pair(1e-2)
    jmega = jax_gat_trainer.make_gat_megastep(fmodel, tx)
    want = []
    for consumed, n, k, (xs, ys, ms) in jax_gat_trainer.gat_megafeed(
            iter(batches), _mesh(), K, batch_size=B):
        state, logs = jmega(state, xs, ys, ms,
                            jax.random.split(jax.random.PRNGKey(0), k))
        want.append((consumed, n, k, jax.device_get(logs)))
    mega = gat_trainer.make_gat_megastep(model, opt)
    got = [(consumed, n, k, mega(*staged)) for consumed, n, k, staged
           in gat_trainer.gat_megafeed(batches, CPU, K, batch_size=B)]
    assert [g[:3] for g in got] == [w[:3] for w in want] == [(3, 8, 2),
                                                             (1, 3, 1)]
    for (*_, g), (*_, w) in zip(got, want):
        for key in ("loss", "running_nd"):
            np.testing.assert_allclose(g[key].detach().numpy(),
                                       np.asarray(w[key]), rtol=TOL,
                                       err_msg=key)
    expect = from_flax_params(jax.device_get(state.params),
                              jax.device_get(state.batch_stats))
    for name, t in model.state_dict().items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(t.numpy(), expect[name].numpy(),
                                       rtol=0, atol=TOL, err_msg=name)


def _dcgan_pair(lr):
    """Narrow flax nets (ndf 8, dropout off) under SGD, and the port's with
    their weights."""
    from extended_gan_tpu.core import KeySeq
    from extended_gan_tpu.models import dcgan as jax_dcgan

    models = (jax_dcgan.Generator(nc=NC, dropout=0.0),
              jax_dcgan.FrameDiscriminator(nc=NC, ndf=NDF),
              jax_dcgan.TemporalDiscriminator(nc=NC, ndf=NDF, dropout=0.0))
    txs = tuple(optax.sgd(lr) for _ in models)
    keys = KeySeq(5)
    samples = (jnp.zeros((2, 64, 64, NC)),) * 2 + (
        jnp.zeros((2, 64, 64, 2 * NC)),)
    states = GANStates(*(create_net_state(m, tx, keys.next(), s)
                         for m, tx, s in zip(models, txs, samples)))
    nets, _ = port_gan(states)
    opts = tuple(torch.optim.SGD(n.parameters(), lr=lr) for n in nets)
    return models, txs, states, nets, opts


def dcgan_trees(states=None, nets=None):
    """{net.name: parameters and statistics} of JAX's GANStates or the
    port's nets, under the port's names."""
    if states is not None:
        return {f"{name}.{key}": v for name in ("g", "fd", "td")
                for stats in (False, True)
                for key, v in jax_tree(getattr(states, name), stats).items()}
    return {f"{name}.{key}": v for net, name in zip(nets, ("g", "fd", "td"))
            for stats in (False, True)
            for key, v in port_tree(net, stats).items()}


def assert_dcgan_runs_match(runs, n_groups):
    """``runs[side, inputs]`` = (logs of each group, :func:`dcgan_trees`)
    for side "jax" and "port", inputs "x" and "noisy" (x by
    :func:`perturbed`). The port's within TOL of JAX's, relative to each
    tensor's largest entry, or SENS_FACTOR times what one rounding of x
    moves either side's own result where that is more. A DCGAN step is
    roundoff-sensitive: the data's exact zeros and the padding's zero rows
    sit on LeakyReLU kinks, train-mode BatchNorm couples every row, and the
    adversarial losses feed the updated discriminators back in (1e-7 noise
    on x moves JAX's own errG by about 1e-3 at a padded step)."""
    (want_logs, want), (got_logs, got) = runs["jax", "x"], runs["port", "x"]
    assert len(got_logs) == len(want_logs) == n_groups
    assert sorted(got_logs[0]) == sorted(want_logs[0])
    assert sorted(got) == sorted(want)

    def value(side, n, label):
        logs, trees = runs[side, n]
        if label.startswith("group"):
            _, i, key = label.split()
            return logs[int(i)][key]
        return trees[label]

    labels = [f"group {i} {key}" for i in range(n_groups)
              for key in want_logs[0]] + list(want)
    for label in labels:
        sens = max(gap(value(side, "noisy", label), value(side, "x", label))
                   for side in ("jax", "port"))
        err = gap(value("port", "x", label), value("jax", "x", label))
        assert err <= max(TOL, SENS_FACTOR * sens), (label, err, sens)


def _run_dcgan(batches, side):
    """K = 2 megasteps over ``batches`` from the same narrow nets: (logs of
    each group, :func:`dcgan_trees`) of JAX's or the port's."""
    models, txs, states, nets, opts = _dcgan_pair(1e-2)
    if side == "jax":
        mega = jax_dcgan_trainer.make_dcgan_megastep(*models, *txs,
                                                     dedup_g=True)
        logs = []
        for k, (xs, ys, ms) in jax_dcgan_trainer._megafeed(
                iter(batches), _mesh(), B, K):
            states, out = mega(states, xs, ys, ms,
                               jax.random.split(jax.random.PRNGKey(0), k))
            logs.append({n: np.asarray(v) for n, v in
                         jax.device_get(out).items()})
        return logs, dcgan_trees(states=states)
    mega = dcgan_trainer.make_dcgan_megastep(*nets, *opts)
    logs = [{n: v.detach().numpy() for n, v in mega(*staged).items()}
            for _, staged in dcgan_trainer._megafeed(batches, CPU, B, K)]
    return logs, dcgan_trees(nets=nets)


def test_dcgan_megastep_matches_jax():
    """:func:`assert_dcgan_runs_match`: a full group, then the padded tail
    group."""
    batches = _loader(np.random.default_rng(2), (NC, 64, 64))
    batches = [b for b in batches if len(b[0]) > 1]  # DCGAN drops nothing
    noisy = [(perturbed(x), y) for x, y in batches]
    assert_dcgan_runs_match(
        {(side, n): _run_dcgan(b, side) for side in ("jax", "port")
         for n, b in (("x", batches), ("noisy", noisy))}, 2)


def _twins(optimizer, lr):
    """Two GAT3D models with the same weights, and an optimizer each."""
    gen = torch.Generator().manual_seed(4)
    a = build_model("temporal", image_width=HW, image_height=HW, n_vertices=V,
                    mapping_type="conv", device="cpu", generator=gen)
    b = build_model("temporal", image_width=HW, image_height=HW, n_vertices=V,
                    mapping_type="conv", device="cpu")
    b.load_state_dict(a.state_dict())
    return [(m, make_optimizer(optimizer, m.parameters(), lr))
            for m in (a, b)]


def test_megastep_equals_its_single_steps_across_an_lr_change():
    """Strict SGD: K = 3 steps a call equal 3 single steps, over two epochs
    whose learning rates differ (the second epoch's update uses the second
    epoch's rate)."""
    rng = np.random.default_rng(6)
    (m1, o1), (m2, o2) = _twins("sgd", 1e-2)
    mega = gat_trainer.make_gat_megastep(m1, o1)
    step = gat_trainer.make_gat_train_step(m2, o2)
    for lr in (1e-2, 3e-3):
        for o in (o1, o2):
            o.param_groups[0]["lr"] = lr
        for _ in range(2):
            xs, ys = (torch.from_numpy(rng.uniform(
                0, 1, (3, B, HW, HW, T, V)).astype(np.float32))
                for _ in range(2))
            ms = torch.ones(3, B)
            logs = mega(xs, ys, ms)
            single = [step(xs[i], ys[i], ms[i]) for i in range(3)]
            assert torch.equal(logs["loss"], single[-1][0])
            assert torch.equal(logs["running_nd"],
                               torch.stack([s[1] for s in single]).sum(0))
            for p, q in zip(m1.parameters(), m2.parameters()):
                assert torch.equal(p, q)


def test_every_step_runs_once():
    """Adam's step count after groups of 3, 3 and a tail of 2 is 8, and the
    optimizer was stepped 8 times."""
    ((model, opt),) = _twins("adam", 1e-3)[:1]
    calls = []
    opt.register_step_post_hook(lambda *_: calls.append(1))
    mega = gat_trainer.make_gat_megastep(model, opt)
    for k in (3, 3, 2):
        mega(torch.rand(k, B, HW, HW, T, V), torch.rand(k, B, HW, HW, T, V),
             torch.ones(k, B))
    steps = {float(s["step"]) for s in opt.state.values()}
    assert steps == {8.0} and len(calls) == 8


@pytest.mark.parametrize("mask", ["none", "ones"])
def test_masked_dcgan_step_with_ones_equals_the_unmasked_step(mask):
    rng = np.random.default_rng(7)
    _, _, states, nets_a, opts_a = _dcgan_pair(1e-2)
    nets_b, _ = port_gan(states)
    opts_b = tuple(torch.optim.SGD(n.parameters(), lr=1e-2) for n in nets_b)
    step_a = dcgan_trainer.make_dcgan_train_step(*nets_a, *opts_a)
    step_b = dcgan_trainer.make_dcgan_train_step(*nets_b, *opts_b)
    for _ in range(2):
        x, y = (torch.from_numpy(rng.uniform(0, 1, (B, NC, 64, 64)).astype(
            np.float32)) for _ in range(2))
        got = step_a(x, y, None if mask == "none" else torch.ones(B))
        want = step_b(x, y)
        for key in want:
            assert torch.equal(got[key], want[key]), key
    for a, b in zip(nets_a, nets_b):
        for (name, p), q in zip(a.state_dict().items(),
                                b.state_dict().values()):
            assert torch.equal(p, q), name


def test_masked_dcgan_step_masks_padding_out_of_its_metrics():
    """Padded rows add nothing to the metric pairs: their denominators
    count the real samples only."""
    rng = np.random.default_rng(8)
    _, _, _, nets, opts = _dcgan_pair(1e-2)
    step = dcgan_trainer.make_dcgan_train_step(*nets, *opts)
    x, y = (torch.from_numpy(rng.uniform(0, 1, (B, NC, 64, 64)).astype(
        np.float32)) for _ in range(2))
    logs = step(x, y, torch.tensor([1.0, 1.0, 1.0, 0.0]))
    assert logs["train_mse_nd"][1].item() == 3 * NC * 64 * 64
    assert logs["fd_acc_nd"][1].item() == logs["td_acc_nd"][1].item() == 6
    assert all(bool(v.isfinite().all()) for v in logs.values())


def test_launch_counter_replay_rule():
    """What a capture counted is taken back, then added at each replay;
    the CPU paths launch nothing."""
    start = ops.launch_counts()
    recorded = {"gat_attention_fwd": 16, "gat_mapping_bwd": 16}
    try:
        ops.add_launches(recorded)   # the capture's Python ran once
        ops.add_launches(recorded, -1)  # ... but launched nothing
        assert ops.launch_counts() == start
        for _ in range(3):
            ops.add_launches(recorded)  # three replays
        now = ops.launch_counts()
        assert {k: now[k] - start[k] for k in now} == {
            **dict.fromkeys(start, 0), "gat_attention_fwd": 48,
            "gat_mapping_bwd": 48}
    finally:
        ops.add_launches(ops.launch_counts(), -1)
        ops.add_launches(start)
    ((model, opt),) = _twins("sgd", 1e-3)[:1]
    gat_trainer.make_gat_megastep(model, opt)(
        torch.rand(2, B, HW, HW, T, V), torch.rand(2, B, HW, HW, T, V),
        torch.ones(2, B))
    assert ops.launch_counts() == start


class _Dispatched(TorchDispatchMode):
    """The names of the torch operators dispatched in its block."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func.__name__)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("mask", ["none", "ones"])
def test_dcgan_step_builds_no_tensor_from_host_data(mask):
    """A CUDA graph cannot capture a copy from the host, and a tensor made
    from Python data (``aten.lift_fresh``: ``torch.tensor``,
    ``Tensor.new_tensor``) is one on the card. After the first step (which
    builds the optimizers' state) a DCGAN step makes none: its metric
    denominators come from the mask on the device."""
    from extended_gan_torch.train.dcgan_driver import DEFAULT_PARAMS, build_dcgan

    nets, opts = build_dcgan({**DEFAULT_PARAMS, "ndf": NDF}, seed=0,
                             device="cpu")
    step = dcgan_trainer.make_dcgan_train_step(*nets, *opts)
    rng = np.random.default_rng(9)
    x, y = (torch.from_numpy(rng.uniform(0, 1, (B, NC, 64, 64)).astype(
        np.float32)) for _ in range(2))
    m = None if mask == "none" else torch.ones(B)
    step(x, y, m)
    with _Dispatched() as seen:
        step(x, y, m)
    assert seen.ops and not [op for op in seen.ops
                             if op.startswith("lift_fresh")]


def _unet_run(fault=None, steps=6):
    """The final state (weights, buffers) of a small SmaAt-UNet after 3
    groups of K = 2 SGD steps; ``fault`` plants one in the last step:
    ``"step"`` skips its optimizer step, ``"bn"`` its BatchNorm update."""
    model = build_model("unet", image_width=20, image_height=20,
                        n_vertices=V, mapping_type="linear", device="cpu",
                        generator=torch.Generator().manual_seed(0))
    opt = make_optimizer("sgd", model.parameters(), 1e-3, weight_decay=0.01)
    calls = [0]
    sgd_step = opt.step

    def step(*args, **kw):
        calls[0] += 1
        if fault == "bn" and calls[0] == steps - 1:
            for m in model.modules():
                if isinstance(m, torch.nn.BatchNorm2d):
                    m.momentum = 0.0
        return None if fault == "step" and calls[0] == steps \
            else sgd_step(*args, **kw)
    opt.step = step
    mega = gat_trainer.make_gat_megastep(model, opt)
    gen = torch.Generator().manual_seed(3)
    for _ in range(steps // 2):
        mega(torch.rand((2, 2, 20, 20, T, V), generator=gen),
             torch.rand((2, 2, 20, 20, T, V), generator=gen),
             torch.ones(2, 2))
    return [t.detach().clone() for t in
            list(model.parameters()) + list(model.buffers())]


def _jitter(state, seed, rel=1e-7):
    """``state`` moved by about ``rel`` of each tensor's largest entry, as
    a run whose additions run in another order would be."""
    gen = torch.Generator().manual_seed(seed)
    return [t + rel * t.abs().max() * torch.randn(t.shape, generator=gen)
            if t.is_floating_point() else t for t in state]


@pytest.mark.parametrize("run", ["repeat", "noise", "step", "bn"])
def test_held_to_reference_tells_a_planted_fault_from_run_to_run_noise(run):
    """``utils.compare.held_to_reference``, the test the card holds a
    graph's train state to: a repeated run passes bit for bit; a run that
    differs from the reference by noise of the size of other runs' drift
    passes; a run whose last optimizer step was skipped, or whose last
    BatchNorm update was missed, fails, both with no drift and held to the
    widest of the noisy runs' drifts."""
    from extended_gan_torch.utils.compare import (
        drift,
        held_to_reference,
        widest,
    )

    want = _unet_run()
    floor = widest(drift(_jitter(want, seed), want) for seed in (1, 2))
    if run == "repeat":
        verdict = held_to_reference(_unet_run(), want, limit=1e-6)
        assert verdict["ok"] and verdict["bitwise"], verdict
    elif run == "noise":
        verdict = held_to_reference(_jitter(want, 3), want, floor,
                                    limit=1e-6)
        assert verdict["ok"] and not verdict["bitwise"], verdict
        # a tensor that is zero in the reference is measured against the
        # state's typical entry, so rounding noise there passes
        zero = [torch.zeros(8)]
        assert held_to_reference([torch.full((8,), 1e-12)] + want,
                                 zero + want,
                                 drift(zero + _jitter(want, 1),
                                       zero + want))["ok"]
    else:
        bad = _unet_run(run)
        for noise in (None, floor):
            verdict = held_to_reference(bad, want, noise, limit=1e-6)
            assert not verdict["ok"] and verdict["worst"] > 100, verdict
