"""The UNet's leftovers in the port against the JAX package, on the CPU:
``UnetModel(per_vertex_bn=True)`` and ``SmaAt_UNet(bilinear=False)``.

Narrow UNets (``base=8``, 20x20, T = 4; V = 3 vertices of B = 8 windows
for ``per_vertex_bn``, 4 images for ``bilinear=False``), their flax trees
drawn from a numpy seed (running statistics away from their start) and
carried across with ``from_flax_params``; inputs from
``np.random.default_rng``. JAX's ``UnetModel`` builds its SmaAt-UNet at the
published width, so both packages' ``SmaAt_UNet`` are narrowed here by
patching the name their ``unet_model`` modules call (the module under test
is JAX's own). The bounds are the SmaAt-UNet tests':

- eval mode: the forward within 2e-5; the gradients of an MSE loss within
  1e-4 of each gradient's largest entry;
- train mode: the forward and the running statistics (and the
  ``bilinear=False`` UNet's gradients) within 1e-3 of their largest entry,
  or ``SENS_FACTOR`` times what 1e-7 noise on the input moves either
  side's own result where that is more (``test_torch_port_gat_smaat.py``);
  the loss before and after one SGD step within 1e-4 relative; one
  per-vertex BatchNorm alone against JAX's (its train-mode gradients
  within 1e-5).

Also: the flax trees at the published width leaf for leaf (the
per-vertex running statistics (V, C) under ``shared.unet``; ``upconv``'s
kernels), and a planted fault for each: BatchNorm statistics pooled over
the vertices, and the transposed conv's kernel carried across unflipped,
must miss the bounds by far. The per-vertex BatchNorms are found by
``state.batchnorms`` and frozen by ``running_stats_frozen``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import extended_gan_tpu.models.unet_model as jax_unet_model
import extended_gan_torch.models.unet_model as unet_model
from extended_gan_tpu.models.smaat_unet import SmaAt_UNet as FlaxUNet
from extended_gan_torch.models.convert import from_flax_params
from extended_gan_torch.models.smaat_unet import SmaAt_UNet
from extended_gan_torch.train import state
from test_torch_port_gat_family import one_torch_thread  # noqa: F401 - the autouse fixture
from test_torch_port_gat_smaat import SENS_FACTOR, TRAIN_TOL, gap, perturbed

TOL, GRAD_TOL, LOSS_RTOL = 2e-5, 1e-4, 1e-4
BASE, HW, T, V, B = 8, 20, 4, 3, 4
B_PV = 8  # windows of the per-vertex UNet: 8 samples a vertex's statistics
SGD_LR = 0.01


def bound(*sens):
    return max(TRAIN_TOL, SENS_FACTOR * max(sens))


@pytest.fixture(scope="module")
def narrow():
    """Both packages' UnetModel build a base-8 SmaAt-UNet."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_unet_model, "SmaAt_UNet",
                   functools.partial(FlaxUNet, base=BASE))
        mp.setattr(unet_model, "SmaAt_UNet",
                   functools.partial(SmaAt_UNet, base=BASE))
        yield


def _random_variables(fmodel, x0, seed):
    """flax variables of ``fmodel``'s tree drawn from ``seed`` with numpy
    (the tree from ``jax.eval_shape``: flax's init compiles or runs op by
    op for tens of seconds): kernels N(0, 1/fan_in), biases N(0, 0.1^2),
    BatchNorm scales U(0.5, 1.5), running means N(0, 0.3^2) and variances
    U(0.2, 1), so eval-mode BatchNorm does more than divide by
    sqrt(1 + eps)."""
    shapes = jax.eval_shape(lambda: fmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.asarray(x0), train=False))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name.endswith("kernel"):
            fan_in = int(np.prod(s.shape[:-1]))
            a = rng.standard_normal(s.shape) / np.sqrt(fan_in)
        elif name == "scale":
            a = rng.uniform(0.5, 1.5, s.shape)
        elif name == "mean":
            a = rng.normal(0.0, 0.3, s.shape)
        elif name == "var":
            a = rng.uniform(0.2, 1.0, s.shape)
        else:
            a = rng.normal(0.0, 0.1, s.shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, {
        "params": shapes["params"], "batch_stats": shapes["batch_stats"]})


@functools.cache
def _flax_per_vertex():
    fmodel = jax_unet_model.UnetModel(image_width=HW, image_height=HW,
                                      n_vertices=V, per_vertex_bn=True)
    x0 = np.random.default_rng(0).random((B_PV, HW, HW, T, V), np.float32)
    return fmodel, _random_variables(fmodel, x0, 0)


@functools.cache
def _flax_bilinear_false():
    fmodel = FlaxUNet(n_channels=T, n_classes=T, base=BASE, bilinear=False)
    x0 = np.random.default_rng(0).random((B, HW, HW, T), np.float32)
    return fmodel, _random_variables(fmodel, x0, 2)


def _per_vertex_pair(per_vertex_bn=True):
    """JAX's UnetModel(per_vertex_bn=True), its variables, and the port's
    model from them."""
    fmodel, variables = _flax_per_vertex()
    model = unet_model.UnetModel(HW, HW, V, time_steps=T,
                                 per_vertex_bn=per_vertex_bn)
    sd = from_flax_params(variables["params"], variables["batch_stats"])
    if not per_vertex_bn:  # the planted fault: one pooled set of statistics
        sd = {k.replace("shared.unet.", "unet."):
              (v[0] if k.endswith(("running_mean", "running_var")) else v)
              for k, v in sd.items()}
    model.load_state_dict(sd)
    return fmodel, variables, model


def _bilinear_false_pair(flip=True):
    fmodel, variables = _flax_bilinear_false()
    model = SmaAt_UNet(n_channels=T, n_classes=T, base=BASE, bilinear=False)
    sd = from_flax_params(variables["params"], variables["batch_stats"])
    if not flip:  # the planted fault: HWIO -> IOHW without the flip
        flat = traverse_util.flatten_dict(variables["params"], sep=".")
        for k, v in flat.items():
            if k.endswith("upconv.kernel"):
                sd[k[:-len("kernel")] + "weight"] = torch.from_numpy(
                    np.ascontiguousarray(v.transpose(2, 3, 0, 1)))
    model.load_state_dict(sd)
    return fmodel, variables, model


# each case: how to build the pair, the input's shape, the port's input
# from the JAX one and the port's output back
CASES = {
    "per_vertex_bn": (_per_vertex_pair, (B_PV, HW, HW, T, V),
                      lambda a: a, lambda a: a),
    "bilinear_false": (_bilinear_false_pair, (B, HW, HW, T),
                       lambda a: a.permute(0, 3, 1, 2),
                       lambda a: a.permute(0, 2, 3, 1)),
}


def _inputs(case, seed=3):
    shape = CASES[case][1]
    rng = np.random.default_rng(seed)
    return rng.random(shape, np.float32), rng.random(shape, np.float32)


def jax_run(fmodel, variables, x, y, train, tree=False):
    """(output, new running statistics, loss, grads as port names) of an
    MSE loss, or with ``tree`` (loss, the flax tree of the grads). Only the
    gradient is jitted, once a model and mode."""
    (val, (out, upd)), grads = _jit_grad(fmodel, train)(
        variables["params"], variables["batch_stats"], jnp.asarray(x),
        jnp.asarray(y))
    if tree:
        return float(val), grads
    stats = {k: v.numpy() for k, v in from_flax_params(
        {}, jax.device_get(upd["batch_stats"])).items()
        if not k.endswith("num_batches_tracked")}
    return (np.asarray(out), stats, float(val),
            {k: v.numpy() for k, v in from_flax_params(
                jax.device_get(grads)).items()})


_JITTED = {}


def _jit_grad(fmodel, train):
    key = (type(fmodel).__name__, train)
    if key not in _JITTED:
        def loss(params, batch_stats, x, y):
            out, upd = fmodel.apply(
                {"params": params, "batch_stats": batch_stats}, x,
                train=train, mutable=["batch_stats"])
            return jnp.mean((out - y) ** 2), (out, upd)

        _JITTED[key] = jax.jit(jax.value_and_grad(loss, has_aux=True))
    return _JITTED[key]


def port_run(case, model, x, y, train):
    to_port, from_port = CASES[case][2:]
    model.train(train).zero_grad()
    out = from_port(model(to_port(torch.from_numpy(x))))
    loss = ((out - torch.from_numpy(y)) ** 2).mean()
    loss.backward()
    stats = {k: v.numpy().copy() for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    return (out.detach().numpy(), stats, loss.item(),
            {k: p.grad.numpy().copy() for k, p in model.named_parameters()})


def _max_gap(got, want, skip=()):
    assert sorted(got) == sorted(want)
    return max(gap(got[k], w) for k, w in want.items()
               if not k.endswith(skip))


@pytest.mark.parametrize("case", sorted(CASES))
def test_eval_forward_and_gradients_match_jax(case, narrow):
    fmodel, variables, model = CASES[case][0]()
    x, y = _inputs(case)
    j_out, _, j_loss, j_grads = jax_run(fmodel, variables, x, y, False)
    p_out, _, p_loss, p_grads = port_run(case, model, x, y, False)
    np.testing.assert_allclose(p_out, j_out, rtol=TOL, atol=TOL)
    assert p_loss == pytest.approx(j_loss, rel=LOSS_RTOL)
    assert _max_gap(p_grads, j_grads) <= GRAD_TOL


# BatchNorm follows every DSC and upconv: in train mode a bias added before
# it shifts a whole channel, which BatchNorm subtracts again, so its
# gradient is zero up to roundoff on both sides
PRE_BN_BIASES = ("depthwise_bias", "pointwise_bias")


def _train_runs(case):
    """JAX's and the port's train-mode runs on the batch and on its x
    perturbed by 1e-7 noise, each from the pair's state."""
    fmodel, variables, model = CASES[case][0]()
    x, y = _inputs(case)
    state0 = {k: v.clone() for k, v in model.state_dict().items()}
    runs = {}
    for label, xs in (("", x), ("moved", perturbed(x))):
        model.load_state_dict(state0)
        runs["jax" + label] = jax_run(fmodel, variables, xs, y, True)
        runs["port" + label] = port_run(case, model, xs, y, True)
    return runs


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_forward_and_statistics_match_jax(case, narrow):
    runs = _train_runs(case)
    (j_out, j_stats, j_loss, _), (p_out, p_stats, p_loss, _) = \
        runs["jax"], runs["port"]
    jm, pm = runs["jaxmoved"], runs["portmoved"]
    assert sorted(p_stats) == sorted(j_stats)
    if case == "per_vertex_bn":
        assert p_stats["shared.unet.inc.bn0.running_mean"].shape == (V, BASE)
        assert p_stats["shared.unet.cbam1.spatial.bn.running_var"].shape == \
            (V, 1)
    g_out = gap(p_out, j_out)
    assert g_out <= bound(gap(jm[0], j_out), gap(pm[0], p_out)), g_out
    for k, want in j_stats.items():
        g = gap(p_stats[k], want)
        assert g <= bound(gap(jm[1][k], want), gap(pm[1][k], p_stats[k])), k
    assert p_loss == pytest.approx(j_loss, rel=LOSS_RTOL)


# BatchNorm follows every DSC: in train mode a bias added before it shifts a
# whole channel, which BatchNorm subtracts again, so its gradient is zero
# up to roundoff on both sides
PRE_BN_BIASES = ("depthwise_bias", "pointwise_bias")


def test_bilinear_false_train_gradients_match_jax(narrow):
    """Entry by entry, within TRAIN_TOL or SENS_FACTOR x what 1e-7 noise
    moves either side. (The per-vertex UNet's train-mode gradients are held
    through the SGD step's loss below and its BatchNorm alone: there JAX's
    jitted gradient lies 2.5% from the port's float64 twin at cbam3's
    spatial gate, the port's 8.1e-5, and 1e-7 noise moves neither by as
    much.)"""
    runs = _train_runs("bilinear_false")
    j_grads, p_grads = runs["jax"][3], runs["port"][3]
    g = _max_gap(p_grads, j_grads, PRE_BN_BIASES)
    sens = max(_max_gap(runs["jaxmoved"][3], j_grads, PRE_BN_BIASES),
               _max_gap(runs["portmoved"][3], p_grads, PRE_BN_BIASES))
    assert g <= bound(sens), (g, sens)


def test_per_vertex_batchnorm_matches_jax_vmapped_batchnorm():
    """One PerVertexBatchNorm2d against JAX's per-vertex BatchNorm (its
    ``TorchBatchNorm`` under ``nn.vmap`` with per-vertex ``batch_stats``,
    as ``UnetModel(per_vertex_bn=True)`` maps it) on (V, B, H, W, C) =
    (3, 4, 5, 5, 6): train and eval forwards, the (V, C) running
    statistics, and the gradients of input, weight and bias, within 1e-5
    of their largest entry."""
    import flax.linen as fnn

    from extended_gan_tpu.ops.norm import TorchBatchNorm

    nv, b, hw, c = 3, 4, 5, 6
    rng = np.random.default_rng(8)
    xv = (rng.standard_normal((nv, b, hw, hw, c)) * 2 + 1).astype(np.float32)
    ct = rng.standard_normal(xv.shape).astype(np.float32)

    class Shim(fnn.Module):
        train: bool

        @fnn.compact
        def __call__(self, x):
            return TorchBatchNorm(use_running_average=not self.train)(x)

    def flax_bn(train):
        return fnn.vmap(Shim, in_axes=0, out_axes=0,
                        variable_axes={"params": None, "batch_stats": 0},
                        split_rngs={"params": False})(train=train)

    variables = flax_bn(False).init(jax.random.PRNGKey(0), jnp.asarray(xv))
    (key,) = variables["batch_stats"]
    assert jax.tree_util.tree_map(jnp.shape, variables["batch_stats"]) == \
        {key: {"mean": (nv, c), "var": (nv, c)}}
    scale = jnp.asarray(rng.uniform(0.5, 2, c), jnp.float32)
    bias = jnp.asarray(rng.standard_normal(c), jnp.float32)
    stats = {"mean": jnp.asarray(rng.standard_normal((nv, c)), jnp.float32),
             "var": jnp.asarray(rng.uniform(0.5, 2, (nv, c)), jnp.float32)}
    bn = unet_model.PerVertexBatchNorm2d(c, nv)
    bn.load_state_dict({
        "weight": torch.from_numpy(np.array(scale)),
        "bias": torch.from_numpy(np.array(bias)),
        "running_mean": torch.from_numpy(np.array(stats["mean"])),
        "running_var": torch.from_numpy(np.array(stats["var"])),
        "num_batches_tracked": torch.tensor(0)})
    # port layout: b-major (B*V, C, H, W)
    xp = torch.from_numpy(np.ascontiguousarray(
        xv.transpose(1, 0, 4, 2, 3).reshape(b * nv, c, hw, hw)))
    xp.requires_grad_()
    ctp = torch.from_numpy(np.ascontiguousarray(
        ct.transpose(1, 0, 4, 2, 3).reshape(b * nv, c, hw, hw)))
    for train in (True, False):
        module = flax_bn(train)

        def f(x, scale, bias):
            tree = {"params": {key: {"scale": scale, "bias": bias}},
                    "batch_stats": {key: stats}}
            return module.apply(tree, x, mutable=["batch_stats"])

        out, upd = f(jnp.asarray(xv), scale, bias)
        grads = jax.grad(lambda *a: jnp.sum(f(*a)[0] * jnp.asarray(ct)),
                         argnums=(0, 1, 2))(jnp.asarray(xv), scale, bias)
        bn.train(train)
        bn.weight.grad = bn.bias.grad = xp.grad = None
        got = bn(xp)
        (got * ctp).sum().backward()
        want = np.asarray(out).transpose(1, 0, 4, 2, 3).reshape(got.shape)
        assert gap(got.detach().numpy(), want) <= 1e-5, train
        want_dx = np.asarray(grads[0]).transpose(1, 0, 4, 2, 3).reshape(
            got.shape)
        assert gap(xp.grad.numpy(), want_dx) <= 1e-5, train
        assert gap(bn.weight.grad.numpy(), np.asarray(grads[1])) <= 1e-5
        assert gap(bn.bias.grad.numpy(), np.asarray(grads[2])) <= 1e-5
        if train:
            new = upd["batch_stats"][key]
            assert gap(bn.running_mean.numpy(), np.asarray(new["mean"])) \
                <= 1e-5
            assert gap(bn.running_var.numpy(), np.asarray(new["var"])) \
                <= 1e-5
            assert not np.allclose(np.asarray(new["mean"]),
                                   np.asarray(stats["mean"]))
            # the next (eval) pass reads the statistics this one left
            stats = {"mean": new["mean"], "var": new["var"]}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sgd_step_loss_matches_jax(case, narrow):
    """The train-mode loss before and after one SGD step of lr 0.01 (a
    train-mode forward normalises by the batch's statistics, so the
    running statistics do not enter it). The loss after the step carries
    the gradients' roundoff times lr: with 4 windows a vertex JAX's lies
    3.6e-4 from the port's float64 twin (the port's 4.5e-7), with 8 (as
    here) 2.6e-5."""
    fmodel, variables, model = CASES[case][0]()
    x, y = _inputs(case)
    j_before, j_tree = jax_run(fmodel, variables, x, y, True, tree=True)
    stepped = {"params": jax.tree_util.tree_map(
        lambda p, g: p - SGD_LR * g, variables["params"], j_tree),
        "batch_stats": variables["batch_stats"]}
    j_after = jax_run(fmodel, stepped, x, y, True)[2]
    opt = torch.optim.SGD(model.parameters(), lr=SGD_LR)
    p_before = port_run(case, model, x, y, True)[2]
    opt.step()
    p_after = port_run(case, model, x, y, True)[2]
    assert p_before == pytest.approx(j_before, rel=LOSS_RTOL)
    assert p_after == pytest.approx(j_after, rel=LOSS_RTOL)
    assert abs(p_after - p_before) > 100 * LOSS_RTOL * p_before


def test_pooled_statistics_fail_the_per_vertex_bounds(narrow):
    """The planted fault: one set of BatchNorm statistics over the B*V
    images (``per_vertex_bn=False``) in place of one a vertex."""
    fmodel, variables, _ = _per_vertex_pair()
    _, _, pooled = _per_vertex_pair(per_vertex_bn=False)
    x, y = _inputs("per_vertex_bn")
    j_out = jax_run(fmodel, variables, x, y, True)[0]
    jm_out = jax_run(fmodel, variables, perturbed(x), y, True)[0]
    out = port_run("per_vertex_bn", pooled, x, y, True)[0]
    limit = bound(gap(jm_out, j_out))
    print(f"pooled statistics: train forward gap {gap(out, j_out):.3e} "
          f"(bound {limit:.3e})")
    assert gap(out, j_out) > 10 * limit


def test_unflipped_upconv_kernel_fails_the_forward_bound(narrow):
    fmodel, variables, _ = _bilinear_false_pair()
    _, _, model = _bilinear_false_pair(flip=False)
    x, y = _inputs("bilinear_false")
    j_out = jax_run(fmodel, variables, x, y, False)[0]
    out = port_run("bilinear_false", model, x, y, False)[0]
    print(f"unflipped upconv kernel: eval forward gap {gap(out, j_out):.3e}")
    assert np.abs(out - j_out).max() > 100 * TOL


def test_published_width_trees_match_flax_leaf_for_leaf():
    """At base 64: UnetModel(per_vertex_bn=True) over 6 vertices and
    SmaAt_UNet(bilinear=False); the parameter counts too."""
    with pytest.MonkeyPatch.context() as mp:  # the published width
        mp.setattr(jax_unet_model, "SmaAt_UNet", FlaxUNet)
        mp.setattr(unet_model, "SmaAt_UNet", SmaAt_UNet)
        _published_width_trees()


def _published_width_trees():
    pairs = (
        (jax_unet_model.UnetModel(image_width=20, image_height=20,
                                  n_vertices=6, per_vertex_bn=True),
         unet_model.UnetModel(20, 20, 6, per_vertex_bn=True),
         jnp.zeros((1, 20, 20, 4, 6))),
        (FlaxUNet(n_channels=4, n_classes=4, bilinear=False),
         SmaAt_UNet(n_channels=4, n_classes=4, bilinear=False),
         jnp.zeros((1, 20, 20, 4))))
    for fmodel, model, x in pairs:
        shapes = jax.eval_shape(lambda: fmodel.init(
            {"params": jax.random.PRNGKey(0),
             "dropout": jax.random.PRNGKey(1)}, x, train=False))
        zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                       shapes)
        converted = from_flax_params(zeros["params"], zeros["batch_stats"])
        mine = model.state_dict()
        assert sorted(converted) == sorted(mine)
        for k, v in converted.items():
            assert v.shape == mine[k].shape, k
        n_flax = sum(np.prod(s.shape) for s in
                     jax.tree_util.tree_leaves(shapes["params"]))
        assert sum(p.numel() for p in model.parameters()) == n_flax
    assert mine["up1.upconv.weight"].shape == (1024, 512, 2, 2)
    assert mine["down4.conv.dsc1.pointwise_weight"].shape == (1024, 2048, 1,
                                                              1)
    per_vertex = pairs[0][1].state_dict()
    assert per_vertex["shared.unet.up4.conv.bn1.running_var"].shape == (6, 64)
    assert per_vertex["shared.unet.up4.conv.bn1.weight"].shape == (64,)


def test_per_vertex_batchnorms_are_batchnorms_and_freeze(narrow):
    _, _, model = _per_vertex_pair()
    bns = state.batchnorms(model)
    assert len(bns) == 23 and all(
        isinstance(m, unet_model.PerVertexBatchNorm2d) for m in bns)
    x = torch.from_numpy(_inputs("per_vertex_bn")[0])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with state.running_stats_frozen(bns), torch.no_grad():
        model.train()(x)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    with torch.no_grad():
        model(x)
    after = model.state_dict()
    assert int(after["shared.unet.inc.bn0.num_batches_tracked"]) == 1
    assert not torch.equal(after["shared.unet.inc.bn0.running_mean"],
                           before["shared.unet.inc.bn0.running_mean"])
