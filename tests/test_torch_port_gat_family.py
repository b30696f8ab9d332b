"""The rest of the port's conv-GAT family against the JAX package.

- The four graph-attention layers of the baseline models, at ``TOL``.
- Every registry key with the linear and conv mappings (the smaat_unet
  mapping has its own file, ``test_torch_port_gat_smaat.py``), built by
  both registries: the forward in eval and in train mode at ``TOL``, and
  the gradients of an MSE loss with respect to every parameter and the
  input against ``jax.grad``, within ``GRAD_TOL`` of the largest entry of
  all the parameters' gradients (of the input's, for the input). The
  largest entry is the scale because the adjacency ``B`` starts with tied
  entries, whose gradient is zero up to roundoff. These models hold no
  BatchNorm, so train and eval mode compute the same function, whose
  gradient ``jax.grad`` computes once.
- The parameter count of each family at full width against JAX's
  ``eval_shape``, and the port's tree against flax's, leaf for leaf.
- A checkpoint in the reference's ``state_dict`` schema loads into the
  port's baseline models with ``strict=True`` and then matches the JAX
  model that ``scripts/import_torch_checkpoint.py`` builds from it.

The JAX side gets the port's weights, seeded, through :func:`to_flax`,
the converter's inverse (so no flax init is compiled); the round trip
through ``from_flax_params`` is checked exactly. Inputs come from
``np.random.default_rng``.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from extended_gan_tpu.models.gat import layers as jax_layers
from extended_gan_tpu.models.registry import build_model as jax_build_model
from extended_gan_torch.models.convert import from_flax_params
from extended_gan_torch.models.gat import layers
from extended_gan_torch.models.gat.baseline import BaselineModel, BaselineModel2D
from extended_gan_torch.models.registry import build_model

TOL = 2e-5
GRAD_TOL = 1e-5
B, T, V = 2, 4, 3
_UNROLLED_HEAD = re.compile(r"(^|\.)head_\d+$")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread a test: these tests run thousands of small ops,
    and the tier's workers share the host's cores, where torch's thread
    pools spin against each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def to_flax(model):
    """The port's state_dict as flax ``(params, batch_stats)`` trees: the
    inverse of ``from_flax_params``."""
    params, stats = {}, {}
    modules = dict(model.named_modules())
    for name, t in model.state_dict().items():
        *path, leaf = name.split(".")
        owner = ".".join(path)
        arr, tree = t.detach().numpy().copy(), params
        if leaf == "num_batches_tracked":
            continue
        if leaf in ("running_mean", "running_var"):
            tree, leaf = stats, leaf[len("running_"):]
        elif isinstance(modules[owner], nn.BatchNorm2d) and leaf == "weight":
            leaf = "scale"
        elif isinstance(modules[owner], nn.Linear) and leaf == "weight":
            arr, leaf = arr.T, "kernel"
        elif leaf.endswith("weight"):  # (..., O, I, kh, kw) -> (..., kh, kw, I, O)
            nd = arr.ndim
            arr = arr.transpose(*range(nd - 4), nd - 2, nd - 1, nd - 3, nd - 4)
            leaf = leaf[:-len("weight")] + "kernel"
        elif leaf.startswith(("a_", "B_")) and _UNROLLED_HEAD.search(owner):
            arr = arr[0]
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return params, stats


def randomize_bn_stats(model, seed):
    """Running statistics away from their (0, 1) start, so an eval-mode
    BatchNorm does more than divide by sqrt(1 + eps)."""
    rng = np.random.default_rng(seed)
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            n = m.running_mean.numel()
            m.running_mean.copy_(torch.from_numpy(
                rng.normal(0.0, 0.3, n).astype(np.float32)))
            m.running_var.copy_(torch.from_numpy(
                rng.uniform(0.2, 1.0, n).astype(np.float32)))


def models(model_type, mapping_type, hw, use_pallas=False, seed=0):
    """(flax model, its variables, the port's model) with the port's seeded
    weights on both sides."""
    kw = dict(image_width=hw, image_height=hw, n_vertices=V,
              mapping_type=mapping_type, use_pallas=use_pallas)
    model = build_model(model_type, device="cpu",
                        generator=torch.Generator().manual_seed(seed), **kw)
    with torch.no_grad():
        randomize_bn_stats(model, seed)
    params, stats = to_flax(model)
    back = from_flax_params(params, stats)
    state = model.state_dict()
    assert sorted(back) == sorted(state)
    for k, v in back.items():
        torch.testing.assert_close(v, state[k], rtol=0, atol=0, msg=k)
    variables = {"params": params, **({"batch_stats": stats} if stats else {})}
    return jax_build_model(model_type, **kw), variables, model


def inputs(hw, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.random((B, hw, hw, T, V), np.float32) for _ in range(2))


def jax_forwards(fmodel, variables, x):
    """The eval-mode forward, and the train-mode forward with its updated
    batch_stats (empty without BatchNorm), run op by op: the SmaAt-UNet
    compiles slowly, and its ops repeat from head to head."""
    want_eval = np.asarray(fmodel.apply(variables, x, train=False))
    if "batch_stats" not in variables:
        return want_eval, np.asarray(fmodel.apply(variables, x, train=True)), {}
    out, upd = fmodel.apply(variables, x, train=True, mutable=["batch_stats"])
    return want_eval, np.asarray(out), jax.device_get(upd["batch_stats"])


def jax_grads(fmodel, variables, x, y, train, *more_x):
    """Gradients of the MSE loss with respect to the params and x, jitted,
    in train or eval mode: ``(param tree, dx)``; with ``more_x``, a list of
    them, one an input, from one compile."""
    def loss(params, x):
        v = {**variables, "params": params}
        if train and "batch_stats" in variables:
            out = fmodel.apply(v, x, train=True, mutable=["batch_stats"])[0]
        else:
            out = fmodel.apply(v, x, train=train)
        return jnp.mean((out - y) ** 2)

    fn = jax.jit(jax.grad(loss, argnums=(0, 1)))
    got = [jax.device_get(fn(variables["params"], xi)) for xi in (x, *more_x)]
    return got if more_x else got[0]


def port_run(model, x, y, train, dtype=torch.float32):
    """The port's forward in ``train`` or eval mode and its gradients, in
    the model's ``dtype``."""
    model.train(train).zero_grad()
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    out = model(xt)
    ((out - torch.from_numpy(y).to(dtype)) ** 2).mean().backward()
    grads = {n: p.grad.float() for n, p in model.named_parameters()}
    return out.detach().float().numpy(), grads, xt.grad.float().numpy()


def grad_gaps(got, got_dx, want_tree, want_dx):
    """The largest gap of the parameters' gradients over the largest entry
    of all of them, and the input gradient's over its own largest."""
    want = from_flax_params(want_tree)
    assert sorted(want) == sorted(got)
    largest = max(np.abs(w.numpy()).max() for w in want.values())
    gap = max(np.abs(got[k].numpy() - w.numpy()).max()
              for k, w in want.items())
    scale_dx = np.abs(want_dx).max()
    return gap / largest, np.abs(got_dx - want_dx).max() / scale_dx


FAMILIES = [(k, m) for k in (
    "temporal", "spatial", "multi_stream", "temporal_1block", "temporal4h",
    "temporal2l", "spatial_1block", "multi_stream_2block")
    for m in ("linear", "conv")] + [("baseline", "linear"),
                                    ("baseline2d", "linear")]


@pytest.mark.parametrize("model_type,mapping_type", FAMILIES)
def test_family_matches_jax(model_type, mapping_type):
    hw = 8
    fmodel, variables, model = models(model_type, mapping_type, hw)
    x, y = inputs(hw)
    want_out = jax_forwards(fmodel, variables, x)[:2]
    want = jax_grads(fmodel, variables, x, y, train=True)
    for train in (False, True):
        out, grads, dx = port_run(model, x, y, train)
        np.testing.assert_allclose(out, want_out[train], rtol=TOL, atol=TOL,
                                   err_msg=f"train={train}")
        # no BatchNorm: one gradient in both modes
        gap, gap_dx = grad_gaps(grads, dx, *want)
        assert gap <= GRAD_TOL and gap_dx <= GRAD_TOL, (train, gap, gap_dx)


# full width: the published configs' geometries (20x20, or 80x80 for
# final_temp_conv_4heads), V = 6
COUNTS = [
    ("baseline", "linear", 20, 5_126_472),
    ("baseline2d", "linear", 20, 120),
    ("temporal4h", "conv", 80, 43_936),
    ("temporal_1block", "linear", 20, 144),
    ("temporal", "smaat_unet", 20, 569_036),
    ("spatial_1block", "smaat_unet", 20, 426_825),
    ("multi_stream_2block", "smaat_unet", 20, 284_606),
]


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tuple(v.shape)


@pytest.mark.parametrize("model_type,mapping_type,hw,count", COUNTS)
def test_parameter_counts_and_tree_match_jax_eval_shape(model_type,
                                                        mapping_type, hw,
                                                        count):
    kw = dict(image_width=hw, image_height=hw, n_vertices=6,
              mapping_type=mapping_type)
    fmodel = jax_build_model(model_type, **kw)
    shapes = jax.eval_shape(lambda k: fmodel.init(
        k, jnp.zeros((2, hw, hw, T, 6)), train=False), jax.random.PRNGKey(0))
    model = build_model(model_type, device="cpu", **kw)
    assert model.mapping_type == mapping_type
    assert sum(p.numel() for p in model.parameters()) == count
    assert sum(int(np.prod(s)) for _, s in _leaves(shapes["params"])) == count
    params, stats = to_flax(model)
    assert sorted(_leaves(params)) == sorted(_leaves(shapes["params"]))
    assert sorted(_leaves(stats)) == sorted(
        _leaves(shapes.get("batch_stats", {})))


def _flax_layer(module, x, seed):
    variables = module.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    params = jax.device_get(variables["params"])
    return params, np.asarray(module.apply(variables, jnp.asarray(x)))


@pytest.mark.parametrize("kind,shape", [
    ("GraphAttentionLayer", (B, V, 12)),
    ("GraphAttentionLayer", (B, 3, 4, V)),
    ("GATMultiHead", (B, V, 12)),
    ("GraphAttentionLayer2D", (B, 5, 4, V)),
    ("GATMultiHead2D", (B, 5, 4, V)),
])
def test_layers_match_jax(kind, shape):
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    nfeat = shape[2] if kind.endswith("2D") else 12  # 1-D: C * T = 12
    heads = dict(nheads=2) if kind.startswith("GATMultiHead") else {}
    names = (("nfeat", "nhid") if heads else ("in_features", "out_features"))
    fmod = getattr(jax_layers, kind)(**{names[0]: nfeat, names[1]: 5},
                                     n_vertices=V, **heads)
    params, want = _flax_layer(fmod, x, seed=len(shape))
    mod = getattr(layers, kind)(nfeat, 5, V, **heads)
    mod.load_state_dict(from_flax_params(params))  # strict: the same leaves
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("model_type,port_cls", [
    ("baseline", BaselineModel), ("baseline2d", BaselineModel2D)])
def test_reference_checkpoint_loads_and_matches_jax(model_type, port_cls):
    from test_import_torch import _importer, _torch_baseline

    hw = 8
    n_features = T * hw * hw if model_type == "baseline" else T
    state = _torch_baseline(n_features, V, seed=3).state_dict()
    model = port_cls(hw, hw, V, time_steps=T)
    model.load_state_dict(state, strict=True)
    fmodel = jax_build_model(model_type, image_width=hw, image_height=hw,
                             n_vertices=V, mapping_type="linear")
    template = fmodel.init(jax.random.PRNGKey(0),
                           jnp.zeros((2, hw, hw, T, V)), train=False)
    params = _importer().translate_state_dict(state, template["params"])
    x, _ = inputs(hw, seed=4)
    want = np.asarray(fmodel.apply({"params": params}, x, train=False))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_use_pallas_is_ignored_with_a_note_where_there_is_no_kernel(capsys):
    kw = dict(image_width=8, image_height=8, n_vertices=V,
              mapping_type="linear", device="cpu")
    build_model("temporal_1block", use_pallas=True, **kw)
    assert "use_pallas ignored" in capsys.readouterr().out
    build_model("temporal_1block", **kw)  # None: the default, no note
    build_model("baseline", use_pallas=False, **kw)
    assert capsys.readouterr().out == ""
