"""The DCGAN and the CycleGAN over the port's data axis on the CPU: gloo
ranks against JAX's data mesh and against the port's own one process.

Two ranks (``torch_dp_ranks.run``: spawned processes, a gloo group that
meets through a file store) each take their contiguous rows of one global
batch and run one SGD step (lr 0.1) of the narrow nets (ndf 8, 64x64,
``torch_dp_ranks.gan_nets``) with the data axis. They are held:

- with dropout off, against JAX's ``make_dcgan_train_step`` (each of the
  four bodies, and the packed generator) and ``make_cyclegan_train_step``
  on ``MeshContext.create(data=2)`` over two of the 8 virtual CPU devices
  (``tests/conftest.py``), from the same weights and batch of 8: the
  losses within rtol 5e-3, atol 1e-4 (the bar of
  ``test_torch_port_dcgan_train.py``), the weights after the step and the
  BatchNorm running statistics within ``TRAIN_TOL`` of each tensor's
  largest entry, or ``SENS_FACTOR`` times the widest of the roundoff
  twins: how far the port's one-process float32 step lies from its
  float64 step, from itself on an input under 1e-7 noise and from itself
  on 4 torch threads (another reduction order), and how far
  1e-7 noise on the input moves JAX's own step (the bounds of
  ``test_torch_port_data_parallel.py``); where that bound still misses,
  also how far JAX's step on one device lies from its step on the data=2
  mesh (JAX's own reduction order: the CycleGAN's generator BatchNorm
  biases move by 2e-3 to 4.5e-3 of their largest entry between the two);
- with dropout on, against the port's one process on the same global
  batch (its dropout generator seeded alike, so the same masks, which the
  ranks draw over the global batch and keep their rows of), even (8) and
  ragged (7: rows 4 + 3; 1: a rank with no rows), fused_disc's doubled
  TD batch and the packed generator included: the losses, the weights,
  the gradients (but G's pre-BatchNorm conv biases, whose gradient is 0
  up to roundoff: train-mode BatchNorm subtracts them again) and the
  statistics within the same bounds. Every twin runs the plain path
  alone, none of the data axis's code, so a fault there cannot widen its
  own bound;
- planted faults, each of which must miss its bound by more than 10x:
  each rank drawing its own rows' dropout masks, D's gradients left
  unreduced, and the packed generator's BatchNorm with each rank's own
  statistics;
- cross-rank BatchNorm alone, forward and backward, on a batch whose
  mean (1000) is large against its spread: within 10x of what float32
  ``F.batch_norm`` gives on the same batch less 1000 (the same outputs,
  as precise as float32 can give them); its mean rounded to float32 (a
  past fault, which in the steps above stays within roundoff: 0.1 of the
  bound) must miss by more than 10x.

Every rank ends with the same state, bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import torch_dp_ranks as ranks
from extended_gan_tpu.core import KeySeq
from extended_gan_tpu.models import dcgan as jax_dcgan
from extended_gan_tpu.parallel import MeshContext
from extended_gan_tpu.train import cyclegan_trainer as jax_cyclegan
from extended_gan_tpu.train.dcgan_trainer import (
    GANStates,
    make_dcgan_train_step as jax_dcgan_step,
)
from extended_gan_tpu.train.state import create_net_state
from extended_gan_torch.models.convert import from_flax_params
from extended_gan_torch.parallel import DataAxis
from test_torch_port_dcgan_train import STEP_ATOL, STEP_RTOL
from test_torch_port_gat_family import one_torch_thread  # noqa: F401 - the autouse fixture
from test_torch_port_gat_smaat import SENS_FACTOR, TRAIN_TOL, gap, perturbed

B = 8
NC, NDF, IM = ranks.GAN_NC, ranks.GAN_NDF, ranks.GAN_IM
DROPOUT = 0.01
# the DCGAN's step bodies, and the packed generator (default body)
BODIES = {"default": {}, "fused_disc": dict(fused_disc=True),
          "fused_prop": dict(fused_prop=True),
          "both": dict(fused_disc=True, fused_prop=True), "packed_g": {}}
# G's conv biases followed by BatchNorm: a gradient of 0 up to roundoff
PRE_BN_BIASES = {f"ConvBlock_{i}.Conv_0.bias" for i in range(4)}
NETS = {"dcgan": ("g", "fd", "td"),
        "cyclegan": ("g_xy", "g_yx", "d_x", "d_y")}


@functools.cache
def _flax(kind, packed=False):
    """(flax models, initial states with an SGD transform each, the
    port's state_dicts of them), dropout off."""
    def gen():
        return jax_dcgan.Generator(nc=NC, dropout=0.0, packed=packed)

    if kind == "dcgan":
        models = (gen(), jax_dcgan.FrameDiscriminator(nc=NC, ndf=NDF),
                  jax_dcgan.TemporalDiscriminator(nc=NC, ndf=NDF,
                                                  dropout=0.0))
        samples = (jnp.zeros((2, IM, IM, NC)),) * 2 + (
            jnp.zeros((2, IM, IM, 2 * NC)),)
        holder = GANStates
    else:
        models = (gen(), gen(), jax_dcgan.FrameDiscriminator(nc=NC, ndf=NDF),
                  jax_dcgan.FrameDiscriminator(nc=NC, ndf=NDF))
        samples = (jnp.zeros((2, IM, IM, NC)),) * 4
        holder = jax_cyclegan.CycleGANStates
    tx = optax.sgd(ranks.GAN_SGD_LR)
    keys = KeySeq(5)
    states = holder(*(create_net_state(m, tx, keys.next(), s)
                      for m, s in zip(models, samples)))
    dicts = [from_flax_params(jax.device_get(getattr(states, n).params),
                              jax.device_get(getattr(states, n).batch_stats))
             for n in NETS[kind]]
    return models, tx, states, dicts


def _batch(n, seed=7):
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(0, 1, (n, NC, IM, IM)).astype(np.float32)
                 for _ in range(2))


def _case(kind, n=B, *, body="default", dropout=0.0, fault=None,
          perturb=False):
    x, y = _batch(n)
    if perturb:
        x, y = perturbed(x), perturbed(y)
    packed = body == "packed_g"
    return dict(kind=kind, body=BODIES[body] if kind == "dcgan" else {},
                packed=packed, dropout=dropout, fault=fault,
                states=_flax(kind, packed)[3], x=x, y=y)


CASES = {
    **{f"dcgan {b}": ("dcgan", B, b, 0.0) for b in BODIES},
    "cyclegan": ("cyclegan", B, "default", 0.0),
    "dcgan drop": ("dcgan", B, "default", DROPOUT),
    "dcgan drop n=7": ("dcgan", 7, "default", DROPOUT),
    "dcgan drop n=1": ("dcgan", 1, "default", DROPOUT),
    "dcgan drop fused_disc n=7": ("dcgan", 7, "fused_disc", DROPOUT),
    "dcgan drop packed_g": ("dcgan", B, "packed_g", DROPOUT),
    "cyclegan drop": ("cyclegan", B, "default", DROPOUT),
    "cyclegan drop n=7": ("cyclegan", 7, "default", DROPOUT),
    "cyclegan drop n=1": ("cyclegan", 1, "default", DROPOUT),
}
# (the case it is a fault of, the fault)
FAULTS = {"per-rank dropout masks": ("dcgan drop", "dropout"),
          "D's gradients unreduced": ("dcgan default", "d_unreduced"),
          "packed BatchNorm with local statistics": ("dcgan packed_g",
                                                     "packed_bn")}
# cross-rank BatchNorm alone: its global batch's mean is large against its
# spread (each value exact in float32: the grid's step, 2**-8, is a whole
# number of float32 steps at BN_SHIFT), rank 1's rows 0.25 above rank 0's
BN_SHIFT = 1000.0
BN_FAULTS = {"plain": None, "mean rounded to float32": "bn_mean_f32"}


def _spec(name, perturb=False):
    kind, n, body, dropout = CASES[name]
    return _case(kind, n, body=body, dropout=dropout, perturb=perturb)


@functools.cache
def _bn_case():
    rng = np.random.default_rng(5)
    grid = rng.integers(0, 64, (B, 3, 8, 8)) / 256
    x = BN_SHIFT + grid + 0.25 * (np.arange(B) >= B // 2)[:, None, None, None]
    return dict(x=x.astype(np.float32),
                dy=rng.standard_normal(x.shape).astype(np.float32),
                weight=rng.uniform(0.5, 1.5, 3).astype(np.float32),
                bias=rng.standard_normal(3).astype(np.float32))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both ranks' results of every case and of every planted fault."""
    cases = {name: _spec(name) for name in CASES}
    for fault, (name, what) in FAULTS.items():
        cases[fault] = dict(_spec(name), fault=what)
    bn = {name: dict(_bn_case(), fault=f) for name, f in BN_FAULTS.items()}
    return ranks.run("gan_steps", 2, tmp_path_factory.mktemp("gan_ranks"),
                     {"cases": cases, "bn": bn})


@functools.cache
def _single(name, dtype=torch.float32, perturb=False, threads=1):
    """The port's one-process step of case ``name`` (``perturb``: its input
    under 1e-7 noise; on ``threads`` torch threads)."""
    with ranks.torch_threads(threads):
        return ranks.gan_step(_spec(name, perturb), None, dtype)


@functools.cache
def _jax_program(name):
    kind, _, body, _ = CASES[name]
    models, tx, _, _ = _flax(kind, body == "packed_g")
    if kind == "dcgan":
        return jax_dcgan_step(*models, tx, tx, tx, **BODIES[body])
    return jax_cyclegan.make_cyclegan_train_step(
        *models, tx, tx, tx, tx, cycle_lambda=ranks.CYCLE_LAMBDA)


@functools.cache
def _jax_step(name, perturb=False, devices=2):
    """JAX's SGD step of case ``name`` on a data mesh of ``devices``
    (``perturb``: the input under 1e-7 noise): the logs, and the weights
    and statistics under the port's names."""
    kind, n, body, _ = CASES[name]
    _, _, states, _ = _flax(kind, body == "packed_g")
    mesh = MeshContext.create(data=devices)
    step = _jax_program(name)
    x, y = (np.moveaxis(a, 1, -1) for a in _batch(n))
    if perturb:
        x = perturbed(x)
    states = mesh.put_replicated(jax.tree_util.tree_map(jnp.copy, states))
    xb, yb, mb = mesh.put_batch(x, y, np.ones(n, np.float32))
    new, logs = step(states, xb, yb, mb, jax.random.PRNGKey(0))
    new = jax.device_get(new)
    trees = [from_flax_params(getattr(new, k).params,
                              getattr(new, k).batch_stats)
             for k in NETS[kind]]
    return {"logs": {k: np.asarray(v) for k, v in logs.items()},
            "params": [{k: v.numpy() for k, v in t.items()
                        if not k.endswith(("running_mean", "running_var",
                                           "num_batches_tracked"))}
                       for t in trees],
            "stats": [{k: v.numpy() for k, v in t.items()
                       if k.endswith(("running_mean", "running_var"))}
                      for t in trees]}


def _gaps(got, want, *twins, parts=("params", "grads", "stats")):
    """Each tensor's gap over its bound (the worst first): ``TRAIN_TOL`` or
    SENS_FACTOR times the widest gap of a pair of ``twins`` (the
    one-process float32 step against float64, JAX's step against its
    perturbed twin) on that tensor."""
    out = []
    for part in parts:
        for i, tree in enumerate(want[part]):
            for k, w in tree.items():
                if part == "grads" and k in PRE_BN_BIASES:
                    continue
                sens = max(gap(a[part][i][k], b[part][i][k])
                           for a, b in twins)
                b = max(TRAIN_TOL, SENS_FACTOR * sens)
                out.append((gap(got[part][i][k], w) / b, f"{part} {i} {k}"))
    return sorted(out, reverse=True)


def _twins(name):
    """The one-process step's roundoff, from the plain path alone (none of
    the data axis's code, so a fault there cannot widen its own bound):
    float32 against float64, against its input under 1e-7 noise, and
    against itself on 4 torch threads (another reduction order)."""
    return ((_single(name), _single(name, torch.float64)),
            (_single(name, perturb=True), _single(name)),
            (_single(name, threads=4), _single(name)))


def test_every_rank_ends_with_the_same_state(two_ranks):
    r0, r1 = two_ranks
    assert sorted(r0) == sorted(r1)
    for name in CASES:
        for part in ("logs", "params", "grads", "stats"):
            tree0, tree1 = r0[name][part], r1[name][part]
            for t0, t1 in zip(*((tree0, tree1) if part != "logs"
                                else ([tree0], [tree1]))):
                for k, v in t0.items():
                    assert np.array_equal(v, t1[k]), (name, part, k)


@pytest.mark.parametrize("name", [n for n in CASES if "drop" not in n])
def test_two_ranks_match_the_jax_data_mesh_step(two_ranks, name):
    got, want = two_ranks[0][name], _jax_step(name)
    assert sorted(got["logs"]) == sorted(want["logs"])
    for k, w in want["logs"].items():
        np.testing.assert_allclose(got["logs"][k], w, rtol=STEP_RTOL,
                                   atol=STEP_ATOL, err_msg=k)
    twins = _twins(name) + ((_jax_step(name, True), want),)
    worst = _gaps(got, want, *twins, parts=("params", "stats"))
    if worst[0][0] > 1.0:  # JAX's own reduction order, where it misses
        worst = _gaps(got, want, *twins, (_jax_step(name, devices=1), want),
                      parts=("params", "stats"))
    assert worst[0][0] <= 1.0, worst[:3]


@pytest.mark.parametrize("name", sorted(CASES))
def test_two_ranks_match_one_process(two_ranks, name):
    got, want = two_ranks[0][name], _single(name)
    for k, w in want["logs"].items():
        np.testing.assert_allclose(got["logs"][k], w, rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    for net, grads in zip(got["grads"], want["grads"]):
        for k in PRE_BN_BIASES & set(grads):
            weight = grads[k.replace("bias", "weight")]
            assert np.abs(net[k]).max() <= 1e-3 * np.abs(weight).max(), k
    worst = _gaps(got, want, *_twins(name))
    assert worst[0][0] <= 1.0, worst[:3]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_faults_miss_the_bound(two_ranks, fault):
    name = FAULTS[fault][0]
    worst = _gaps(two_ranks[0][fault], _single(name), *_twins(name))
    assert worst[0][0] > 10.0, worst[:3]


def test_a_draw_under_the_axis_needs_the_global_batch():
    class Two(DataAxis):
        size = property(lambda self: 2)
        rank = property(lambda self: 1)

    axis = Two(torch.device("cpu"))
    with pytest.raises(RuntimeError, match="global_batch"):
        axis.draw_rows(torch.rand)
    draws = torch.arange(14)
    with axis.global_batch(7):  # rows 4 + 3
        assert axis.draw_rows(lambda n: draws[:n]).tolist() == [4, 5, 6]
    with axis.global_batch(7, copies=2):  # [real; fake]
        assert axis.draw_rows(lambda n: draws[:n]).tolist() == \
            [4, 5, 6, 11, 12, 13]
    with axis.global_batch(1):  # rank 1 holds none, and draws all the same
        assert axis.draw_rows(lambda n: draws[:n]).tolist() == []


def _bn_plain(dtype, shift=0.0):
    """``F.batch_norm`` of :func:`_bn_case` over the whole batch less
    ``shift`` (which moves none of its outputs), in ``dtype``: what
    :func:`torch_dp_ranks.bn_layer` returns, as float64."""
    case = _bn_case()
    x, dy, w, b = (torch.from_numpy(case[k]).to(dtype)
                   for k in ("x", "dy", "weight", "bias"))
    x = (x - shift).requires_grad_(True)
    w.requires_grad_(True)
    b.requires_grad_(True)
    rm, rv = torch.zeros(3, dtype=dtype), torch.ones(3, dtype=dtype)
    y = F.batch_norm(x, rm, rv, w, b, True, 0.1, 1e-5)
    y.backward(dy)
    out = dict(y=y, dx=x.grad, dw=w.grad, db=b.grad, running_mean=rm,
               running_var=rv)
    out = {k: v.detach().double().numpy() for k, v in out.items()}
    out["running_mean"] += 0.1 * shift
    return out


def _bn_gaps(got):
    """Each output's gap from float64 over 10x the plain path's own:
    ``F.batch_norm`` in float32 on the batch less BN_SHIFT for the outputs
    and gradients (as precise as float32 can give them: no mean's size to
    lose), on the batch itself for the running statistics."""
    want = _bn_plain(torch.float64)
    shifted, plain = _bn_plain(torch.float32, BN_SHIFT), \
        _bn_plain(torch.float32)
    out = []
    for k, w in want.items():
        witness = plain if k.startswith("running") else shifted
        bound = SENS_FACTOR * max(gap(witness[k], w), 1e-9)
        out.append((gap(got[k].astype(np.float64), w) / bound, k))
    return sorted(out, reverse=True)


def test_cross_rank_batch_norm_matches_float64(two_ranks):
    for r in two_ranks:
        worst = _bn_gaps(r["bn plain"])
        assert worst[0][0] <= 1.0, worst


def test_a_batch_norm_mean_rounded_to_float32_misses_the_bound(two_ranks):
    worst = _bn_gaps(two_ranks[0]["bn mean rounded to float32"])
    assert worst[0][0] > 10.0, worst
