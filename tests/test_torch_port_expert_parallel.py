"""Expert parallelism (``parallel/expert.py``) on gloo ranks on the CPU,
against the JAX package and the port's one-process path.

The ranks start once for each axis size (``torch_dp_ranks.run``: 4 ranks
for the explicit program and both sizes for the train steps).

- ``make_moe_ep_apply`` on 4 ranks against JAX's ``make_moe_ep_apply`` on
  4 of the 8 virtual CPU devices (``tests/test_moe.py``'s setup: E 8, C
  16, H 32, 64 tokens, capacity 16 a shard): output and aux within
  MOE_TOL; against the port's dense path bit for bit where nothing drops;
  each rank holds E/D of each expert leaf and of its Adam moments and the
  router whole; E = 6 over 4 ranks raises.
- The narrow MoE UNet's train step (``torch_dp_ranks.make_moe_model``:
  base 8, 32x32, E 4, capacity factor 0.5, so tokens drop), on the
  default path and under ``per_vertex_bn``, on 2 and 4 ranks with the
  experts sharded (2 and 1 a rank), computes what one process computes on
  the global batch:
  - in float64 it meets the witness of ``test_torch_port_moe_train.py``
    (JAX's forward-mode derivative of its float64 loss) within JVP_TOL of
    each tensor's scale, and the port's one-process float64 step within
    F64_TOL;
  - in float32 each gradient lies within ``bound`` of the witness of that
    file's ``roundoff_witness`` from the float64 step (a witness that
    runs none of the axis's code);
  - three planted faults miss the witness: routing on each rank's tokens
    with a per-rank capacity, the expert shards' gradients also
    all-reduced, the aux counted on every rank.
- remat's step over the axis (the exchange recomputed in the backward)
  equals the plain step's, as ``test_torch_port_moe_train.py`` holds it
  in one process.
- A megastep of K = 2 SGD steps over the axis (eager on the CPU) equals
  two one-process steps in float64 within F64_TOL.

The driver, checkpoints, ``model.pt``, the vanilla GAN and the data
axis's default: ``test_torch_port_expert_parallel_cli.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import extended_gan_tpu.models.unet_model as jax_unet_model
import extended_gan_torch.models.unet_model as unet_model
import torch_dp_ranks as ranks
from extended_gan_tpu.models.moe import moe_apply_dense as jax_dense
from extended_gan_tpu.models.smaat_unet import SmaAt_UNet as FlaxUNet
from extended_gan_tpu.parallel import MeshContext
from extended_gan_tpu.parallel.expert import (
    make_moe_ep_apply as jax_ep_apply,
    shard_moe_params_ep as jax_shard,
)
from extended_gan_torch.models import moe
from extended_gan_torch.models.smaat_unet import SmaAt_UNet
from test_torch_port_gat_family import one_torch_thread  # noqa: F401 - the autouse fixture
from test_torch_port_gat_smaat import bound
from test_torch_port_moe import (  # noqa: F401 - the narrow fixture
    BASE,
    CF,
    E,
    MOE_TOL,
    _unet_pair,
    narrow,
)
from test_torch_port_moe_train import (
    _batch,
    _entry_floor,
    _port_train,
    _witness,
    roundoff_witness,
    witness_misses,
)

F64_TOL = 1e-9
EP_E, EP_C, EP_H, EP_N, EP_D = 8, 16, 32, 64, 4
PATHS = {"default": False, "per_vertex_bn": True}


def _apply_payload():
    rng = np.random.default_rng(6)
    params = {"router": rng.standard_normal((EP_C, EP_E)),
              "w1": rng.standard_normal((EP_E, EP_C, EP_H)) / 4,
              "b1": rng.normal(0, 0.1, (EP_E, EP_H)),
              "w2": rng.standard_normal((EP_E, EP_H, EP_C)) / 6,
              "b2": rng.normal(0, 0.1, (EP_E, EP_C))}
    return {"params": {k: v.astype(np.float32) for k, v in params.items()},
            "tokens": rng.standard_normal((EP_N, EP_C)).astype(np.float32),
            "x": rng.standard_normal((8, EP_C, 2, 2)).astype(np.float32)}


def _states():
    """The narrow MoE UNet's weights (the moe tests' own), by path."""
    assert ranks.MOE_E == E and ranks.MOE_CF == 0.5
    return {name: _unet_pair(pv)[2].state_dict()
            for name, pv in PATHS.items()}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Every rank's results: {axis size: [rank 0's, rank 1's, ...]}, and
    the payload's steps. JAX's witnesses are computed while the ranks
    run."""
    with pytest.MonkeyPatch.context() as mp:
        # the narrow fixture's patch, for this module-scoped fixture
        mp.setattr(unet_model, "SmaAt_UNet", functools.partial(
            SmaAt_UNet, base=BASE, moe_capacity_factor=CF))
        mp.setattr(jax_unet_model, "SmaAt_UNet", functools.partial(
            FlaxUNet, base=BASE, moe_capacity_factor=CF))
        states = _states()
        x, y = _batch()
        finish = _start_ranks(tmp_path_factory, states, x, y)
        for pv in PATHS.values():
            _witness(pv)
        return finish()


def _start_ranks(tmp_path_factory, states, x, y):
    steps, megasteps = {}, {}
    for name, pv in PATHS.items():
        base = dict(per_vertex=pv, state=states[name], x=x, y=y)
        steps[f"{name} f32"] = dict(base, dtype=torch.float32)
        steps[f"{name} f64"] = dict(base, dtype=torch.float64)
        for fault in ranks.EP_FAULTS:
            steps[f"{name} {fault}"] = dict(base, dtype=torch.float64,
                                            fault=fault)
    steps["default f32 remat"] = dict(steps["default f32"], remat=True)
    rng = np.random.default_rng(12)
    megasteps["megastep"] = dict(
        per_vertex=False, state=states["default"],
        xs=rng.random((2,) + x.shape, np.float32),
        ys=rng.random((2,) + y.shape, np.float32))
    started = {}
    for size in (2, 4):
        payload = {"steps": steps, "megasteps": megasteps}
        if size == EP_D:
            payload["apply"] = _apply_payload()
        started[size] = ranks.start("ep_cases", size,
                                    tmp_path_factory.mktemp(f"ep{size}"),
                                    payload)
    return lambda: ({size: finish() for size, finish in started.items()},
                    steps, megasteps)


# ------------------------------------------------- the explicit program
def test_ep_apply_matches_jax(results):
    got = results[0][EP_D][0]["apply"]
    p = _apply_payload()
    mesh = MeshContext.create(data=EP_D, model=2)
    params = {k: jnp.asarray(v) for k, v in p["params"].items()}
    ep = jax_ep_apply(mesh, n_experts=EP_E, capacity=EP_N // EP_D)
    out, aux = jax.jit(ep)(jax_shard(params, mesh, EP_E),
                           jax.device_put(jnp.asarray(p["tokens"]),
                                          mesh.sharding("data")))
    out = np.asarray(out)
    np.testing.assert_allclose(got["out"], out, rtol=0,
                               atol=MOE_TOL * np.abs(out).max())
    assert got["aux"] == pytest.approx(float(aux), rel=MOE_TOL)
    assert all(r["apply"]["aux"] == got["aux"] for r in results[0][EP_D])


def test_ep_apply_equals_dense_where_nothing_drops(results):
    got = results[0][EP_D][0]["apply"]
    p = _apply_payload()
    params = {k: torch.from_numpy(v) for k, v in p["params"].items()}
    out, _, load = moe.moe_apply_dense(params, torch.from_numpy(p["tokens"]),
                                       EP_N)
    np.testing.assert_array_equal(got["out"], out.numpy())
    # and so JAX's dense path, within its roundoff of the port's
    jout = np.asarray(jax_dense({k: jnp.asarray(v) for k, v in
                                 p["params"].items()},
                                jnp.asarray(p["tokens"]), EP_N)[0])
    np.testing.assert_allclose(got["out"], jout, rtol=0,
                               atol=MOE_TOL * np.abs(jout).max())


def test_ep_shards_the_experts_and_their_moments(results):
    per = EP_E // EP_D
    for r in results[0][EP_D]:
        a = r["apply"]
        assert a["bytes"] == {"w1": per * EP_C * 2 * EP_C * 4,
                              "b1": per * 2 * EP_C * 4,
                              "w2": per * 2 * EP_C * EP_C * 4,
                              "b2": per * EP_C * 4,
                              "router": EP_C * EP_E * 4}
        # Adam's two moments of each leaf: twice its bytes, sharded alike
        assert a["moments"] == {k: 2 * v for k, v in a["bytes"].items()}
        assert a["forward"] == (8 // EP_D, EP_C, 2, 2)


def test_ep_needs_experts_divisible_by_the_axis(results):
    assert all("not divisible" in r["apply"]["raised"]
               for r in results[0][EP_D])


# ------------------------------------------------------ the train step
def _full_grads(rank_results):
    """The ranks agree on every gradient (the experts gathered)."""
    first = rank_results[0]["grads"]
    for other in rank_results[1:]:
        assert other["grads"].keys() == first.keys()
        for k, g in first.items():
            np.testing.assert_array_equal(other["grads"][k], g, err_msg=k)
    return first


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("path", list(PATHS))
def test_ep_train_step_matches_one_process_and_jax(results, size, path,
                                                   narrow):
    pv = PATHS[path]
    res = [r for r in results[0][size]]
    x, y = _batch()
    w = _witness(pv)
    g64 = _full_grads([r[f"{path} f64"] for r in res])
    l64 = res[0][f"{path} f64"]["loss"]
    assert l64 == pytest.approx(w["loss"], rel=1e-10)
    assert witness_misses(pv, g64) == {}
    one_loss, one64 = _port_train(pv, x, y, dtype=torch.float64)
    assert l64 == pytest.approx(one_loss, rel=F64_TOL)
    floor = _entry_floor(one64)
    for k, want in one64.items():
        err = np.abs(g64[k] - want).max() / max(np.abs(want).max(), floor)
        assert err <= F64_TOL, (k, err)
    # float32 over the axis, against the float64 step, by the roundoff
    # witness of the one-process file (no code of the axis in it)
    g32 = _full_grads([r[f"{path} f32"] for r in res])
    witness = roundoff_witness(pv, x, y)
    for k, want in g64.items():
        err = np.abs(g32[k] - want).max() / max(np.abs(want).max(), floor)
        assert err <= bound(witness[k]), (k, err, witness[k])


@pytest.mark.parametrize("fault", ranks.EP_FAULTS)
@pytest.mark.parametrize("path", list(PATHS))
def test_planted_ep_faults_miss_the_witness(results, fault, path, narrow):
    pv = PATHS[path]
    for size in (2, 4):
        got = results[0][size][0][f"{path} {fault}"]
        misses = witness_misses(pv, got["grads"])
        assert misses, (size, fault)
        if fault != "reduced":  # it moves the gradients, not the loss
            assert got["loss"] != pytest.approx(_witness(pv)["loss"],
                                                rel=1e-6)


@pytest.mark.parametrize("size", [2, 4])
def test_ep_remat_step_equals_the_plain_step(results, size):
    """remat recomputes the forward, its exchange included, in the
    backward: the same loss and gradients."""
    for r in results[0][size]:
        plain, remat = r["default f32"], r["default f32 remat"]
        assert remat["loss"] == plain["loss"]
        for k, g in plain["grads"].items():
            np.testing.assert_allclose(remat["grads"][k], g, rtol=0,
                                       atol=1e-6 * np.abs(g).max(),
                                       err_msg=k)


@pytest.mark.parametrize("size", [2, 4])
def test_ep_megastep_equals_one_process_steps(results, size, narrow):
    case = results[2]["megastep"]
    model = _unet_pair(case["per_vertex"])[2].to(torch.float64)
    opt = torch.optim.SGD(model.parameters(), lr=0.01)
    from extended_gan_torch.train import gat_trainer

    step = gat_trainer.make_gat_train_step(model, opt,
                                           moe_aux_weight=ranks.MOE_AUX_W)
    for x, y in zip(case["xs"], case["ys"]):
        loss, _ = step(*(torch.from_numpy(a).double()
                         for a in (x, y, np.ones(len(x)))))
    want = {k: v.double().numpy() for k, v in model.state_dict().items()}
    for r in results[0][size]:
        got = r["megastep"]
        assert got["loss"] == pytest.approx(loss.item(), rel=F64_TOL)
        for k, v in want.items():
            scale = max(np.abs(v).max(), 1e-30)
            assert np.abs(got["state"][k] - v).max() <= F64_TOL * scale, k

