"""The port's data axis on the CPU: gloo ranks against JAX's data mesh and
against the port's own single-process step.

Two ranks (``torch_dp_ranks.run``: spawned processes, a gloo group that
meets through a file store) each take their contiguous rows of one global
batch and run one SGD step of the conv-GAT trainer with the data axis
(``parallel/``); the narrow UNet (base 8, 16x16, T = 4, V = 3) has
cross-rank BatchNorm, GAT3D (conv mapping) has none. They are held:

- against JAX's ``make_gat_train_step`` on ``MeshContext.create(data=2)``
  over two of the 8 virtual CPU devices (``tests/conftest.py``), from the
  same weights and batch of 8: the loss and ``running_nd`` within
  ``LOSS_TOL`` relative, the gradients (JAX's captured by an optax
  transformation that keeps them as its state) and the BatchNorm running
  statistics within ``TRAIN_TOL`` of each tensor's largest entry, or
  ``SENS_FACTOR`` times the larger of what 1e-7 noise on the input moves
  either side's own result and how far the port's one-process float32
  step lies from its float64 step, where that is more. Train-mode
  BatchNorm amplifies float32 roundoff (``test_torch_port_gat_smaat.py``),
  and a reordered reduction moves the UNet's gradients about 8x what the
  input noise moves (measured here), while in float64 the two ranks equal
  one process to 1e-15;
- against the port's one-process step on the same global batch, even (8)
  and ragged (7: rows 4 + 3; 1: a rank with no rows), at the same bounds:
  the two differ only in the order of the reductions;
- a planted fault, each rank's BatchNorm normalising with its own rows'
  statistics, must miss both by more than 10x.

Every rank ends with the same state, bit for bit. The CLI, the launcher
environment and the refusals: ``test_torch_port_data_parallel_cli.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_dp_ranks as ranks
from extended_gan_tpu.models.gat.gat3d import Model as FlaxGatModel
from extended_gan_tpu.parallel import MeshContext
from extended_gan_tpu.train import gat_trainer as jax_trainer
from extended_gan_tpu.train.state import NetState
from extended_gan_torch.models.convert import from_flax_params
from test_torch_port_gat_family import one_torch_thread  # noqa: F401 - the autouse fixture
from test_torch_port_gat_smaat import SENS_FACTOR, TRAIN_TOL, gap, perturbed
from test_torch_port_train import _FlaxNarrowUnetModel

B = 8
LOSS_TOL = 1e-5
KINDS = ("unet", "gat")


def bound(*sens):
    return max(TRAIN_TOL, SENS_FACTOR * max(sens))


@functools.cache
def _flax(kind):
    """(flax model, its variables, the port's state_dict of them)."""
    x0 = jnp.zeros((2, ranks.HW, ranks.HW, ranks.T, ranks.V))
    fmodel = _FlaxNarrowUnetModel() if kind == "unet" else FlaxGatModel(
        image_width=ranks.HW, image_height=ranks.HW, n_vertices=ranks.V,
        attention_type="temporal", mapping_type="conv")
    variables = jax.device_get(jax.jit(lambda k: fmodel.init(
        k, x0, train=False))(jax.random.PRNGKey(3)))
    state = from_flax_params(variables["params"],
                             variables.get("batch_stats"))
    model = ranks.make_model(kind)
    model.load_state_dict(state)  # every key: the trees match
    return fmodel, variables, model.state_dict()


def _case(kind, n, seed=1, fault=False):
    x, y = ranks.batch(n, seed)
    return dict(kind=kind, state=_flax(kind)[2], x=x, y=y, fault=fault)


CASES = {"unet": ("unet", B), "gat": ("gat", B), "unet n=7": ("unet", 7),
         "unet n=1": ("unet", 1), "gat n=7": ("gat", 7)}


def _capture_grads():
    """An optax transformation that leaves the parameters and keeps the
    gradients as its state."""
    zeros = functools.partial(jax.tree_util.tree_map, jnp.zeros_like)
    return optax.GradientTransformation(
        lambda p: zeros(p), lambda g, s, p=None: (zeros(g), g))


@functools.cache
def _jax_program(kind):
    """JAX's jitted train step (compiled once a kind) and its optax
    transformation."""
    tx = _capture_grads()
    return jax_trainer.make_gat_train_step(_flax(kind)[0], tx), tx


@functools.cache
def _jax_step(kind, perturb=False):
    """JAX's train step on a data=2 mesh: loss, running_nd, the gradients
    and the running statistics, as the port's names."""
    _, variables, _ = _flax(kind)
    x, y = ranks.batch(B, 1)
    if perturb:
        x = perturbed(x)
    step, tx = _jax_program(kind)
    mesh = MeshContext.create(data=2)
    state = mesh.put_replicated(NetState(
        params=variables["params"],
        batch_stats=variables.get("batch_stats", {}),
        opt_state=tx.init(variables["params"])))
    xb, yb, mb = mesh.put_batch(x, y, np.ones(B, np.float32))
    state, logs = step(state, xb, yb, mb, jax.random.PRNGKey(0))
    state = jax.device_get(state)
    grads = {k: v.numpy() for k, v in from_flax_params(
        state.opt_state).items()}
    stats = {k: v.numpy() for k, v in from_flax_params(
        state.params, state.batch_stats).items()
        if k.endswith(("running_mean", "running_var"))}
    return dict(loss=float(logs["loss"]),
                nd=np.asarray(logs["running_nd"]), grads=grads,
                state=stats)


@functools.cache
def _single(name, perturb=False, dtype=torch.float32):
    """The port's one-process step of case ``name``."""
    case = _case(*CASES[name])
    if perturb:
        case = dict(case, x=perturbed(case["x"]))
    return ranks.one_step(case, None, dtype)


def _roundoff(name):
    """The one-process step's own roundoff: 1e-7 noise on the input, and
    float32 against float64."""
    return [_single(name, True), _single(name, dtype=torch.float64)]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both ranks' results of every case, and of the planted fault."""
    cases = {name: _case(*spec) for name, spec in CASES.items()}
    cases["unet fault"] = _case("unet", B, fault=True)
    return ranks.run("steps", 2, tmp_path_factory.mktemp("ranks"),
                     {"cases": cases})


def _gaps(got, want, sens):
    """Each tensor's gap over its bound (the worst first): gradients and
    running statistics."""
    out = []
    for part in ("grads", "state"):
        for k, w in want[part].items():
            if k.endswith("num_batches_tracked"):
                continue
            b = bound(*(gap(s[part][k], w) for s in sens))
            out.append((gap(got[part][k], w) / b, f"{part} {k}"))
    return sorted(out, reverse=True)


def _stats_only(result):
    return dict(result, state={k: v for k, v in result["state"].items()
                               if k.endswith(("running_mean",
                                              "running_var"))})


def test_every_rank_ends_with_the_same_state(two_ranks):
    r0, r1 = two_ranks
    assert sorted(r0) == sorted(r1)
    for name in (n for n in r0 if "fault" not in n):
        assert r0[name]["loss"] == r1[name]["loss"], name
        for part in ("grads", "state"):
            for k, v in r0[name][part].items():
                assert np.array_equal(v, r1[name][part][k]), (name, k)


@pytest.mark.parametrize("kind", KINDS)
def test_two_ranks_match_the_jax_data_mesh_step(two_ranks, kind):
    got, want = two_ranks[0][kind], _jax_step(kind)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_TOL)
    np.testing.assert_allclose(got["nd"], want["nd"], rtol=LOSS_TOL)
    worst = _gaps(_stats_only(got), want, [
        _stats_only(r) for r in _roundoff(kind)] + [_jax_step(kind, True)])
    assert worst[0][0] <= 1.0, worst[:3]


@pytest.mark.parametrize("name", sorted(CASES))
def test_two_ranks_match_one_process(two_ranks, name):
    got, want = two_ranks[0][name], _single(name)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_TOL)
    np.testing.assert_allclose(got["nd"], want["nd"], rtol=LOSS_TOL)
    worst = _gaps(got, want, _roundoff(name))
    assert worst[0][0] <= 1.0, worst[:3]


def test_per_rank_statistics_miss_the_bounds(two_ranks):
    got = two_ranks[0]["unet fault"]
    worst = _gaps(got, _single("unet"), _roundoff("unet"))
    assert worst[0][0] > 10.0, worst[:3]
    worst = _gaps(_stats_only(got), _jax_step("unet"),
                  [_stats_only(r) for r in _roundoff("unet")]
                  + [_jax_step("unet", True)])
    assert worst[0][0] > 10.0, worst[:3]
