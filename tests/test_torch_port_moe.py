"""The Switch-MoE bottleneck in the port (``models/moe.py``) against the
JAX package's (``extended_gan_tpu/models/moe.py``), on the CPU.

- ``route_top1`` and ``moe_apply_dense`` on the same tokens and weights,
  one group and three groups routed apart (JAX vmapped), with a capacity
  that drops tokens and one that does not: dispatch and load equal, the
  combine tensor, the loss and the outputs within 1e-6 (the router's
  softmax may round one ulp apart). bf16: the outputs equal.
- ``SwitchMoE`` with JAX's weights carried across (``from_flax_params``):
  output within 1e-6, the sown loss and load equal to JAX's ``"losses"``
  and ``"routing"``; its initial weights' spread is flax's lecun_normal,
  which counts the expert axis in the fan in.
- The UNet with ``moe_experts``: narrow (``base=8``) at 32x32, so the
  bottleneck is 2x2 and the token order shows, with capacity factor 0.5
  so tokens overflow; the eval forward within 2e-5 on the default path and
  under ``per_vertex_bn`` (each vertex routed apart, as JAX's vmap does),
  each with the routing (expert and kept mask of every token) equal and
  the smallest top-1 margin reported beside it; the bf16 forward against
  JAX's bf16 by the precision tests' rule (root-mean-square gap at most
  twice JAX's own bf16-to-float32 gap).
- Serving: w8 (``quantize_state_dict_w8``) against ``make_w8_apply``'s
  dequantised tree (the experts' per-(expert, output channel) scales, the
  router f32), the w8 forward within 2e-5 of JAX's; a served batch of 3
  equal to three batch-1 forwards and to JAX's batch-1 forwards, and, as
  a planted fault, the same batch routed as one group is not.
- The parameter counts of JAX's probe (8,235,044 at E = 4 and 12,437,540
  at E = 8 on the 20x20 UnetModel), the state leaf for leaf.

``test_torch_port_moe_train.py`` holds the train step and the driver.
JAX's flax UNet is narrowed as in ``test_torch_port_unet_variants.py``,
and its variables are the port's, drawn with numpy and carried across with
``to_flax``. The JAX programs of the UNet are compiled once each.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call
from flax import traverse_util

import extended_gan_tpu.models.unet_model as jax_unet_model
import extended_gan_torch.models.unet_model as unet_model
from extended_gan_tpu.models import moe as jmoe
from extended_gan_tpu.models.smaat_unet import SmaAt_UNet as FlaxUNet
from extended_gan_tpu.serve import quantize as jq
from extended_gan_torch.models import moe
from extended_gan_torch.models.convert import from_flax_params
from extended_gan_torch.models.registry import build_model
from extended_gan_torch.models.smaat_unet import SmaAt_UNet
from extended_gan_torch.serve import quantize as q
from extended_gan_torch.serve.export import save_exported
from extended_gan_torch.serve.server import ModelServer
from extended_gan_torch.train.state import param_count
from test_torch_port_gat_family import (  # noqa: F401 - the autouse fixture
    one_torch_thread,
    to_flax,
)

TOL, MOE_TOL, LOSS_RTOL = 2e-5, 1e-6, 1e-4
BASE, HW, T, V, B, E = 8, 32, 4, 3, 4, 4
CF = 0.5  # capacity factor: a quarter of an expert's fair share overflows
AUX_W = 0.01  # gat_driver.train's default moe_aux_weight
GAP_FACTOR = 2.0


@pytest.fixture
def narrow(monkeypatch):
    """Both packages' UnetModel build a base-8 SmaAt-UNet with capacity
    factor CF."""
    monkeypatch.setattr(jax_unet_model, "SmaAt_UNet", functools.partial(
        FlaxUNet, base=BASE, moe_capacity_factor=CF))
    monkeypatch.setattr(unet_model, "SmaAt_UNet", functools.partial(
        SmaAt_UNet, base=BASE, moe_capacity_factor=CF))


def _margin(tokens, router):
    """The smallest gap between a token's two largest router
    probabilities."""
    probs = np.asarray(jax.nn.softmax(
        jnp.asarray(tokens, jnp.float32) @ jnp.asarray(router), axis=-1))
    top2 = np.sort(probs, axis=-1)[..., -2:]
    return float((top2[..., 1] - top2[..., 0]).min())


def _routing(dispatch):
    """(expert of each kept token or -1, kept mask) of a dispatch tensor."""
    d = np.asarray(dispatch)
    kept = d.sum(axis=(-2, -1)) > 0
    return np.where(kept, d.sum(-1).argmax(-1), -1), kept


# ------------------------------------------------------------ the math core
def _core_inputs(groups, n=48, c=16, seed=0):
    rng = np.random.default_rng(seed)
    shape = (groups, n, c) if groups else (n, c)
    params = {"router": rng.standard_normal((c, E)),
              "w1": rng.standard_normal((E, c, 2 * c)) / np.sqrt(c),
              "b1": rng.normal(0, 0.1, (E, 2 * c)),
              "w2": rng.standard_normal((E, 2 * c, c)) / np.sqrt(2 * c),
              "b2": rng.normal(0, 0.1, (E, c))}
    return (rng.standard_normal(shape).astype(np.float32),
            {k: v.astype(np.float32) for k, v in params.items()})


@pytest.mark.parametrize("groups,cf", [(0, 0.5), (0, 2.0), (3, 0.5)])
def test_route_and_dense_apply_match_jax(groups, cf):
    tokens, params = _core_inputs(groups)
    cap = moe.expert_capacity(tokens.shape[-2], E, cf)
    assert cap == jmoe.expert_capacity(tokens.shape[-2], E, cf)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    route = functools.partial(jmoe.route_top1, router_w=jp["router"],
                              capacity=cap)
    apply = functools.partial(jmoe.moe_apply_dense, jp, capacity=cap)
    if groups:
        route, apply = jax.vmap(route), jax.vmap(apply)
    route, apply = jax.jit(route), jax.jit(apply)
    jd, jc, ja = route(jnp.asarray(tokens))
    d, c, a = moe.route_top1(torch.from_numpy(tokens), tp["router"], cap)
    margin = _margin(tokens, params["router"])
    for got, want in zip(_routing(d), _routing(jd)):
        np.testing.assert_array_equal(got, want, err_msg=f"routing (smallest "
                                      f"top-1 margin {margin:.3e})")
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=0,
                               atol=MOE_TOL)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=MOE_TOL)
    jo, jaux, jl = apply(jnp.asarray(tokens))
    o, aux, load = moe.moe_apply_dense(tp, torch.from_numpy(tokens), cap)
    np.testing.assert_array_equal(load.numpy(), np.asarray(jl))
    np.testing.assert_allclose(aux.numpy(), np.asarray(jaux), rtol=MOE_TOL)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=0,
                               atol=MOE_TOL * np.abs(np.asarray(jo)).max())
    kept = load.sum().item()
    n_all = tokens.shape[-2] * max(groups, 1)
    assert (kept < n_all) == (cf < 1), (kept, n_all)  # overflow when small
    # bf16: dispatch, FFN and combine in bfloat16, the router float32
    jo16 = functools.partial(jmoe.moe_apply_dense, jp, capacity=cap,
                             dtype=jnp.bfloat16)
    jo16 = jax.jit(jax.vmap(jo16) if groups else jo16)(
        jnp.asarray(tokens))[0]
    o16 = moe.moe_apply_dense(tp, torch.from_numpy(tokens), cap,
                              dtype=torch.bfloat16)[0]
    assert o16.dtype == torch.bfloat16
    np.testing.assert_array_equal(o16.float().numpy(),
                                  np.asarray(jo16, np.float32))


def test_onehots_past_the_capacity_are_zero_rows():
    """A queue position past the capacity one-hots to zeros (F.one_hot
    would raise), and the routing takes no host sync (no ``.item()``)."""
    assert moe._onehot(torch.tensor([0, 2, 5]), 3).tolist() == \
        [[1, 0, 0], [0, 0, 1], [0, 0, 0]]
    tokens = torch.ones(10, 4)  # every token to one expert, cap 2
    d, _, _ = moe.route_top1(tokens, torch.eye(4), 2)
    assert d.sum().item() == 2 and d[:2].sum().item() == 2


def test_switch_moe_module_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 3, 16)).astype(np.float32)  # NHWC
    fm = jmoe.SwitchMoE(num_experts=E, capacity_factor=1.0)
    # (init sows too: keep only the params)
    variables = {"params": jax.jit(fm.init)(jax.random.PRNGKey(0),
                                            jnp.asarray(x))["params"]}
    y, state = jax.jit(functools.partial(fm.apply, mutable=[
        "losses", "routing"]))(variables, jnp.asarray(x))
    m = moe.SwitchMoE(16, E, capacity_factor=1.0)
    m.load_state_dict(from_flax_params(variables["params"]))
    with moe.sow_moe([m]) as sown:
        got = m(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y),
                               rtol=0, atol=MOE_TOL)
    (aux, load), = sown
    np.testing.assert_allclose(aux.item(),
                               float(state["losses"]["moe_aux"]),
                               rtol=MOE_TOL)
    np.testing.assert_array_equal(
        load.numpy(), np.asarray(state["routing"]["expert_load"]))
    assert load.sum().item() < 18  # capacity 5 a expert: tokens dropped
    # outside sow_moe nothing is kept
    m(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert m.sown is None and len(sown) == 1


def test_switch_moe_init_is_flax_lecun_normal():
    """Each leaf's spread within 5% of flax's on the same shapes: the
    router's fan in C, the experts' E*C and E*H."""
    fm = jmoe.SwitchMoE(num_experts=8)
    flax_params = jax.jit(fm.init)(jax.random.PRNGKey(0),
                                   jnp.zeros((1, 1, 1, 256)))["params"]
    m = moe.SwitchMoE(256, 8, generator=torch.Generator().manual_seed(0))
    for name in ("router", "w1", "w2"):
        want = float(np.std(np.asarray(flax_params[name])))
        got = getattr(m, name).detach().std().item()
        assert got == pytest.approx(want, rel=0.05), name
    assert not m.b1.any() and not m.b2.any()


@pytest.mark.parametrize("per_vertex,per_sample,rows", [
    (False, False, [[0, 1, 2, 3, 4, 5]]),
    (True, False, [[0, 3], [1, 4], [2, 5]]),
    (False, True, [[0, 1, 2], [3, 4, 5]]),
    (True, True, [[0], [1], [2], [3], [4], [5]]),
], ids=["batch", "vertex", "sample", "sample_vertex"])
def test_unet_sets_its_routing_groups(per_vertex, per_sample, rows):
    """UnetModel's b-major rows (b * V + v, here B 2, V 3) grouped as JAX
    routes them: the batch; each vertex (per_vertex_bn); each sample
    (serving); each row (both). Tokens in (row, h, w) order."""
    model = unet_model.UnetModel(8, 8, 3, time_steps=T, moe_experts=E,
                                 per_vertex_bn=per_vertex)
    (layer,) = moe.moe_layers(model.route_per_sample(per_sample))
    c = layer.router.shape[0]
    x = torch.randn(6, c, 2, 2, generator=torch.Generator().manual_seed(0))
    want = torch.stack([torch.cat([x[r].permute(1, 2, 0).reshape(-1, c)
                                   for r in group]) for group in rows])
    assert torch.equal(layer.grouped_tokens(x), want)
    # and back: each token's output lands on its own row and pixel
    params = dict(layer.named_parameters())
    cap = moe.expert_capacity(len(rows[0]) * 4, E, layer.capacity_factor)
    with torch.no_grad():
        grouped, _, _ = moe.moe_apply_dense(params, want, cap)
        out = layer(x) - x
    for g, group in enumerate(rows):
        for i, r in enumerate(group):
            torch.testing.assert_close(
                out[r].permute(1, 2, 0).reshape(-1, c),
                grouped[g, 4 * i:4 * i + 4], rtol=0, atol=1e-6)


# ------------------------------------------------------------ the MoE UNet
def _compiled(fn, *args):
    """``jax.jit(fn)`` compiled once for ``args``' shapes."""
    jitted = fn if hasattr(fn, "lower") else jax.jit(fn)
    return jitted.lower(*args).compile()


def _randomize(model, seed):
    """Every float of ``model``'s state drawn from ``seed`` with numpy:
    kernels and the MoE's stacks N(0, 1/fan_in), the router N(0, 1/C),
    biases N(0, 0.1^2), BatchNorm scales U(0.5, 1.5), running means
    N(0, 0.3^2) and variances U(0.2, 1), so eval-mode BatchNorm does more
    than divide by sqrt(1 + eps)."""
    rng = np.random.default_rng(seed)
    bns = {n for n, m in model.named_modules()
           if isinstance(m, torch.nn.BatchNorm2d)}
    with torch.no_grad():
        for name, t in model.state_dict().items():
            owner, leaf = name.rsplit(".", 1)
            if not t.is_floating_point():
                continue
            if leaf == "running_mean":
                a = rng.normal(0.0, 0.3, t.shape)
            elif leaf == "running_var":
                a = rng.uniform(0.2, 1.0, t.shape)
            elif owner in bns and leaf == "weight":
                a = rng.uniform(0.5, 1.5, t.shape)
            elif leaf in ("router", "w1", "w2") or leaf.endswith("weight"):
                fan_in = t.shape[-2] if leaf in ("router", "w1", "w2") \
                    else int(np.prod(t.shape[1:]))
                a = rng.standard_normal(t.shape) / np.sqrt(fan_in)
            else:
                a = rng.normal(0.0, 0.1, t.shape)
            t.copy_(torch.from_numpy(a.astype(np.float32)))


@functools.cache
def _flax_unet(per_vertex):
    """JAX's UnetModel and its variables: the port's narrow model's state,
    drawn by ``_randomize``, through ``to_flax`` (flax's own init traces
    the UNet for seconds)."""
    fmodel = jax_unet_model.UnetModel(image_width=HW, image_height=HW,
                                      n_vertices=V, moe_experts=E,
                                      per_vertex_bn=per_vertex)
    model = unet_model.UnetModel(HW, HW, V, time_steps=T, moe_experts=E,
                                 per_vertex_bn=per_vertex)
    _randomize(model, 4)
    params, stats = to_flax(model)
    return fmodel, {"params": params, "batch_stats": stats}


def _unet_pair(per_vertex, dtype=torch.float32):
    fmodel, variables = _flax_unet(per_vertex)
    model = unet_model.UnetModel(HW, HW, V, time_steps=T, moe_experts=E,
                                 per_vertex_bn=per_vertex, dtype=dtype)
    model.load_state_dict(from_flax_params(variables["params"],
                                           variables["batch_stats"]))
    return fmodel, variables, model


def _captured_moe_input(fn):
    """``fn()``'s result and the input of its SwitchMoE call (flax)."""
    seen = []

    def interceptor(next_fn, args, kwargs, context):
        if isinstance(context.module, jmoe.SwitchMoE) and \
                context.method_name == "__call__":
            seen.append(args[0])
        return next_fn(*args, **kwargs)

    with fnn.intercept_methods(interceptor):
        out = fn()
    return out, seen[0]


@functools.cache
def _jax_eval(per_vertex, batch=B, dtype=jnp.float32):
    """Compiled ``(variables, x) -> (eval output, bottleneck tokens grouped
    as JAX routes them)``: (1, B*V*h*w, C) from JAX's UnetModel, or, under
    per_vertex_bn, (V, B*h*w, C) from its vmap over the vertices, written
    out here with the shared SmaAt-UNet (the flax vmap hides its
    intermediates; its output is held to JAX's UnetModel's)."""
    fmodel, variables = _flax_unet(per_vertex)
    x0 = jnp.zeros((batch, HW, HW, T, V))
    if not per_vertex:
        fmodel = fmodel.clone(dtype=dtype)

        def run(v, x):
            y, tok = _captured_moe_input(
                lambda: fmodel.apply(v, x, train=False))
            return y, tok.reshape(1, -1, tok.shape[-1])

        return _compiled(run, variables, x0)
    unet = functools.partial(FlaxUNet, base=BASE, moe_capacity_factor=CF)(
        n_channels=T, n_classes=T, moe_experts=E)

    def one(params, batch_stats, xb):  # one vertex: (B, H, W, T)
        y, tok = _captured_moe_input(lambda: unet.apply(
            {"params": params, "batch_stats": batch_stats}, xb,
            train=False))
        return y, tok.reshape(-1, tok.shape[-1])

    def run(v, x):
        y, tok = jax.vmap(one, in_axes=(None, 0, 0))(
            v["params"]["shared"]["unet"], v["batch_stats"]["shared"]["unet"],
            x.transpose(4, 0, 1, 2, 3))
        real = fmodel.apply(v, x, train=False)
        return y.transpose(1, 2, 3, 4, 0), tok, real

    return _compiled(run, variables, x0)


def _port_tokens(model, x):
    """The port's output and its bottleneck tokens as its MoE groups
    them."""
    (layer,) = moe.moe_layers(model)
    seen = []
    hook = layer.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0]))
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    hook.remove()
    return out, layer.grouped_tokens(seen[0]), layer


def _assert_same_routing(tokens, jtok, layer, per_vertex):
    """Expert and kept mask of every token equal; returns the smallest
    top-1 margin."""
    cap = moe.expert_capacity(tokens.shape[1], E, CF)
    router = layer.router.detach().numpy()
    jd, _, _ = jax.jit(jax.vmap(lambda t: jmoe.route_top1(
        t, jnp.asarray(router), cap)))(jtok)
    d, _, _ = moe.route_top1(tokens, layer.router, cap)
    margin = _margin(np.asarray(jtok), router)
    for got, want in zip(_routing(d.detach()), _routing(jd)):
        np.testing.assert_array_equal(
            got, want, err_msg=f"routing (smallest top-1 margin "
                               f"{margin:.3e})")
    assert tokens.shape[:2] == jtok.shape[:2] == (
        (V, B * 4) if per_vertex else (1, B * V * 4))  # 2x2 bottleneck
    assert d.sum().item() < d.shape[0] * d.shape[1], "no token dropped"
    return margin


@pytest.mark.parametrize("per_vertex", [False, True],
                         ids=["default", "per_vertex_bn"])
def test_moe_unet_eval_forward_matches_jax(per_vertex, narrow):
    _, variables, model = _unet_pair(per_vertex)
    x = np.random.default_rng(5).random((B, HW, HW, T, V), np.float32)
    want, jtok, *real = _jax_eval(per_vertex)(variables, jnp.asarray(x))
    if per_vertex:  # the vmap written out is JAX's UnetModel's
        np.testing.assert_allclose(np.asarray(want), np.asarray(real[0]),
                                   rtol=1e-6, atol=1e-6)
    out, tokens, layer = _port_tokens(model.eval(), x)
    margin = _assert_same_routing(tokens, jtok, layer, per_vertex)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL, err_msg=f"top-1 margin {margin:.3e}")


def test_moe_unet_bf16_forward_matches_jax(narrow):
    """bf16 eval forward, default path: routing equal, and the RMS gap to
    JAX's bf16 at most GAP_FACTOR x JAX's own bf16-to-f32 RMS gap."""
    _, variables, model = _unet_pair(False, torch.bfloat16)
    x = np.random.default_rng(6).random((B, HW, HW, T, V), np.float32)
    want16, jtok = _jax_eval(False, B, jnp.bfloat16)(variables,
                                                     jnp.asarray(x))
    want32 = _jax_eval(False)(variables, jnp.asarray(x))[0]
    want16, want32 = (np.asarray(a, np.float32) for a in (want16, want32))
    out, tokens, layer = _port_tokens(model.eval(), x)
    margin = _assert_same_routing(tokens, jtok, layer, False)
    assert out.dtype == torch.float32
    rms = lambda a: float(np.sqrt(np.mean(a ** 2)))  # noqa: E731
    assert rms(out.numpy() - want16) <= GAP_FACTOR * rms(want16 - want32), \
        (rms(out.numpy() - want16), rms(want16 - want32), margin)


# ------------------------------------------------------------ serving
def test_w8_quantizes_the_experts_like_jax(narrow):
    """The port's w8 state dequantised equals JAX's ``make_w8_apply`` tree
    (the experts' scales per (expert, output channel), the router f32),
    and the w8 forward is within 2e-5 of JAX's on that tree."""
    _, variables, model = _unet_pair(False)
    seen = []
    x = np.random.default_rng(9).random((B, HW, HW, T, V), np.float32)
    fwd, jmeta = jq.make_w8_apply(lambda v, xx: seen.append(v), variables)
    fwd(x)
    jdeq = jax.device_get(seen[0])
    want = np.asarray(_jax_eval(False)(jdeq, jnp.asarray(x))[0])
    packed, meta = q.quantize_state_dict_w8(model.state_dict())
    assert meta == jmeta
    deq = q.dequantize_state_dict(packed)
    expect = from_flax_params(jdeq["params"], jdeq["batch_stats"])
    for name, v in expect.items():
        torch.testing.assert_close(deq[name], v, rtol=0, atol=0, msg=name)
    c = 16 * BASE // 2  # the bottleneck's width
    assert packed["unet.moe.w1"]["scale"].shape == (E, 1, 2 * c)
    assert packed["unet.moe.w2"]["scale"].shape == (E, 1, c)
    assert not isinstance(packed["unet.moe.router"], dict)
    got_fwd, _ = q.make_w8_apply(
        lambda sd, xx: functional_call(model.eval(), sd, (xx,)),
        model.state_dict())
    with torch.no_grad():
        got = got_fwd(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_served_batch_answers_as_batch_one(narrow, tmp_path):
    """A batch of 3 (padded to 4 by the server) through an MoE artifact:
    each answer that sample's batch-1 answer (up to the convolutions'
    roundoff at another batch size) and within 2e-5 of JAX's batch-1
    forward; routed as one group (the planted fault), the padded batch's
    answers move by far more."""
    _, variables, model = _unet_pair(False)
    spec = {"workload": "gat", "model_type": "unet",
            "mapping_type": "linear", "image_width": HW,
            "image_height": HW, "n_vertices": V, "time_steps": T,
            "moe_experts": E}
    path = str(tmp_path / "moe.pt")
    save_exported(spec, model.state_dict(), path)
    server = ModelServer(path, device="cpu")
    model = server.artifact.model
    assert all(m.group == (1, V) for m in moe.moe_layers(model))
    x = np.random.default_rng(10).random((3, HW, HW, T, V), np.float32)
    batch = server.predict(x)
    ones = np.concatenate([server.predict(x[i:i + 1]) for i in range(3)])
    np.testing.assert_allclose(batch, ones, rtol=1e-5, atol=1e-5)
    jax_one = _jax_eval(False, 1)
    want = np.concatenate([np.asarray(jax_one(variables,
                                              jnp.asarray(x[i:i + 1]))[0])
                           for i in range(3)])
    np.testing.assert_allclose(batch, want, rtol=TOL, atol=TOL)
    model.route_per_sample(False)
    fault = server.predict(x)
    assert np.abs(fault - ones).max() > 100 * 1e-5


@pytest.mark.parametrize("experts,count", [(4, 8_235_044), (8, 12_437_540)])
def test_parameter_counts_and_tree_match_jax(experts, count):
    fmodel = jax_unet_model.UnetModel(image_width=20, image_height=20,
                                      n_vertices=6, moe_experts=experts)
    shapes = jax.eval_shape(lambda: fmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 20, 20, 4, 6)), train=False))
    assert sum(int(np.prod(s.shape)) for s in
               jax.tree_util.tree_leaves(shapes["params"])) == count
    model = build_model("unet", image_width=20, image_height=20,
                        n_vertices=6, mapping_type="linear", device="cpu",
                        moe_experts=experts)
    assert param_count(model) == count
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   shapes)
    converted = from_flax_params(zeros["params"], zeros["batch_stats"])
    state = model.state_dict()
    assert sorted(converted) == sorted(state)
    assert all(v.shape == state[k].shape for k, v in converted.items())
    flat = traverse_util.flatten_dict(zeros["params"], sep=".")
    assert flat["unet.moe.w1"].shape == (experts, 512, 1024)


def test_registry_notes_a_family_without_moe(capsys):
    model = build_model("temporal", image_width=8, image_height=8,
                        n_vertices=2, mapping_type="linear", device="cpu",
                        moe_experts=4)
    assert "has no MoE bottleneck; moe_experts ignored" in \
        capsys.readouterr().out
    assert not moe.moe_layers(model)
