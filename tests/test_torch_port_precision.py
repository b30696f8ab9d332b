"""bf16 in the port (``core/precision.py``) against the JAX package's
``dtype`` policy, on the CPU.

- Which products run in bfloat16 and which in float32, per model family:
  every convolution and matrix product the port's forward calls is
  recorded with its input's dtype (a ``TorchFunctionMode``); the kinds
  that run in bfloat16 are those of the JAX module's jaxpr
  (``conv_general_dilated`` and ``dot_general`` with a bfloat16 first
  operand), and every other one runs in float32. (The float32 ones need
  not pair up: K1's plain twin, for one, mixes with broadcast sums where
  JAX contracts.) BatchNorm's input is float32 everywhere, as the JAX
  modules' ``TorchBatchNorm(dtype=float32)`` is, and so are the parameters
  and the output. K2's switched mapping is fed float32 and runs in float32 under
  bf16 (JAX ``gat3d.py:157``). The planted faults (BatchNorm run in
  bf16, parameters stored in bf16) fail this check.
- Each family's bf16 forward against JAX's bf16 forward from the same
  weights (``to_flax``), eval mode: the root-mean-square gap to JAX's is
  at most ``GAP_FACTOR`` = 2 times the root-mean-square gap JAX's own bf16
  forward has to its float32 forward on the same inputs. (Two frameworks
  round the same float32 values to bfloat16 after sums in different
  orders, so a value near a rounding boundary lands one ulp apart, and
  deep nets amplify that: through the SmaAt-UNet the gap grows to about
  0.8 of JAX's own. The root mean square measures the whole output, where
  the largest entry would measure one such flip.) The families: GAT3D
  with the conv, linear and smaat_unet mappings, the fused attention on
  (K1's plain twin); the switched mapping (K2's twin: float32 inside, so
  held to JAX's float32 forward at the float32 tolerance); UnetModel with
  K3's twin; the DCGAN's G, FD and TD.
- One bf16 train step a driver: finite losses, float32 parameters and
  Adam moments.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from extended_gan_tpu.models import dcgan as jax_dcgan
from extended_gan_tpu.models.registry import build_model as jax_build_model
from extended_gan_torch.core.precision import BF16, F32, resolve_dtype
from extended_gan_torch.models import dcgan
from extended_gan_torch.models.gat.gat3d import Model as GatModel
from extended_gan_torch.models.registry import build_model
from extended_gan_torch.train import dcgan_driver, gat_driver
from test_torch_port_dcgan import jax_gan, nhwc, port_gan
from test_torch_port_gat_family import (  # noqa: F401 - the autouse fixture
    TOL,
    one_torch_thread,
    randomize_bn_stats,
    to_flax,
)

GAP_FACTOR = 2.0
HW, B, T, V = 16, 2, 4, 2

# the port's families: (registry key, mapping, use_pallas)
GAT_FAMILIES = {
    "GAT3D conv (K1)": ("temporal", "conv"),
    "GAT3D linear (K1)": ("temporal", "linear"),
    "GAT3D smaat_unet (K1)": ("temporal", "smaat_unet"),
    "UnetModel (K3)": ("unet", "conv"),
}

_CONV = {torch.nn.functional.conv2d, torch.conv2d}
_DOT = {torch.nn.functional.linear, torch.matmul, torch.Tensor.__matmul__,
        torch.einsum, torch.bmm, torch.mm}
_BN = {torch.nn.functional.batch_norm, torch.batch_norm}


class _Ops(TorchFunctionMode):
    """Records (kind, input dtype) of every conv, product and BatchNorm."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kind = ("conv" if func in _CONV else "dot" if func in _DOT
                else "batch_norm" if func in _BN else None)
        if kind:
            first = next(a for a in (*args, *(kwargs or {}).values())
                         if torch.is_tensor(a)) if func is not torch.einsum \
                else args[1]
            self.seen.append((kind, str(first.dtype).split(".")[-1]))
        return func(*args, **(kwargs or {}))


def port_ops(model, x):
    with torch.no_grad(), _Ops() as ops:
        out = model(x)
    return set(ops.seen), out


def _jaxpr_ops(jaxpr, out):
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name in ("conv_general_dilated", "dot_general"):
            out.add(("conv" if name.startswith("conv") else "dot",
                     str(eqn.invars[0].aval.dtype)))
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else (v,)):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    _jaxpr_ops(inner, out)
    return out


def jax_ops(fmodel, variables, x):
    closed = jax.make_jaxpr(
        lambda v, a: fmodel.apply(v, a, train=False))(variables, x)
    return _jaxpr_ops(closed.jaxpr, set())


def jax_forward(fmodel, variables, x):
    """The eval-mode forward, jitted: one compile costs less than the
    SmaAt-UNet's ops one by one."""
    fn = jax.jit(lambda v, a: fmodel.apply(v, a, train=False))
    return np.asarray(fn(variables, x), np.float32)


def check_policy(model, x, want_ops=None):
    """The port's dtype policy on one forward: its (kind, dtype) set equals
    ``want_ops`` (JAX's, where given), every BatchNorm input and every
    parameter is float32, and so is the output."""
    assert all(p.dtype == torch.float32 for p in model.parameters()), \
        "a parameter is not float32"
    ops, out = port_ops(model, x)
    assert ("batch_norm", "bfloat16") not in ops, "BatchNorm ran in bf16"
    assert out.dtype == torch.float32
    assert {d for _, d in ops} <= {"float32", "bfloat16"}, ops
    if want_ops is not None:
        assert {o for o in ops if o[1] == "bfloat16"} == \
            {o for o in want_ops if o[1] == "bfloat16"}, (ops, want_ops)
    return ops


def gat_models(name, seed=0):
    """(the port's f32 and bf16 models from one seed, BatchNorm statistics
    randomised, and the flax variables of the same weights)."""
    model_type, mapping = GAT_FAMILIES[name]
    kw = dict(image_width=HW, image_height=HW, n_vertices=V,
              mapping_type=mapping, use_pallas=True, device="cpu")
    m32 = build_model(model_type, generator=torch.Generator().manual_seed(
        seed), **kw)
    with torch.no_grad():
        randomize_bn_stats(m32, seed)
    m16 = build_model(model_type, dtype=torch.bfloat16, **kw)
    m16.load_state_dict(m32.state_dict())
    params, stats = to_flax(m32)
    variables = {"params": params, **({"batch_stats": stats} if stats
                                      else {})}
    return m32.eval(), m16.eval(), variables


def jax_gat(name, dtype):
    model_type, mapping = GAT_FAMILIES[name]
    return jax_build_model(model_type, image_width=HW, image_height=HW,
                           n_vertices=V, mapping_type=mapping, dtype=dtype)


def rms(a, b):
    return float(np.sqrt(np.mean((np.asarray(a, np.float64) - b) ** 2)))


def hold_to_jax(got, want16, want32):
    """The bound of the module docstring: (port's gap, JAX's own gap)."""
    own = rms(want16, want32)
    gap = rms(got, want16)
    assert own > 0 and gap <= GAP_FACTOR * own, (gap, own)
    return gap, own


def test_precision_policy_objects():
    assert (F32.compute_dtype, BF16.compute_dtype) == (torch.float32,
                                                       torch.bfloat16)
    assert F32.param_dtype == BF16.param_dtype == torch.float32
    x = torch.ones(2)
    assert BF16.cast_in(x).dtype == torch.bfloat16
    assert BF16.cast_out(BF16.cast_in(x)).dtype == torch.float32
    assert resolve_dtype("bf16") == torch.bfloat16
    with pytest.raises(ValueError, match="precision"):
        resolve_dtype("fp16")


@pytest.mark.parametrize("name", list(GAT_FAMILIES))
def test_gat_family_bf16_matches_jax(name):
    m32, m16, variables = gat_models(name)
    rng = np.random.default_rng(1)
    x = rng.random((B, HW, HW, T, V), np.float32)
    want = {n: jax_forward(jax_gat(name, dt), variables, x)
            for n, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16))}
    ops = check_policy(m16, torch.from_numpy(x),
                       jax_ops(jax_gat(name, jnp.bfloat16), variables, x))
    assert ("conv", "bfloat16") in ops or ("dot", "bfloat16") in ops
    with torch.no_grad():
        got = m16(torch.from_numpy(x)).numpy()
        got32 = m32(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got32, want["f32"], rtol=TOL, atol=TOL)
    hold_to_jax(got, want["bf16"], want["f32"])


def test_switched_mapping_runs_float32_under_bf16():
    """K2's path is fed float32 under bf16 (JAX ``gat3d.py:157``): the
    mapping's convs run in float32, the forward equals the float32 one bit
    for bit, and JAX's float32 forward at the float32 tolerance."""
    g = torch.Generator().manual_seed(3)
    m32 = GatModel(HW, HW, V, "temporal", "conv", use_pallas=True,
                   generator=g, use_pallas_mapping=True).eval()
    m16 = GatModel(HW, HW, V, "temporal", "conv", use_pallas=True,
                   use_pallas_mapping=True, dtype=torch.bfloat16).eval()
    m16.load_state_dict(m32.state_dict())
    x = np.random.default_rng(4).random((B, HW, HW, T, V), np.float32)
    ops = check_policy(m16, torch.from_numpy(x))
    assert ("conv", "float32") in ops and ("conv", "bfloat16") not in ops
    with torch.no_grad():
        got = m16(torch.from_numpy(x))
        assert torch.equal(got, m32(torch.from_numpy(x)))
    params, _ = to_flax(m32)
    want = jax_build_model("temporal", image_width=HW, image_height=HW,
                           n_vertices=V, mapping_type="conv").apply(
        {"params": params}, x, train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.fixture(scope="module")
def gans():
    """The JAX GAN (dropout off) in float32 and bf16 from the same states,
    and the port's nets in float32 and bf16 with their weights."""
    models32, _, states = jax_gan()
    models16 = (jax_dcgan.Generator(nc=4, dropout=0.0, dtype=jnp.bfloat16),
                jax_dcgan.FrameDiscriminator(nc=4, ndf=8, dtype=jnp.bfloat16),
                jax_dcgan.TemporalDiscriminator(nc=4, ndf=8, dropout=0.0,
                                                dtype=jnp.bfloat16))
    nets32, _ = port_gan(states)
    nets16 = (dcgan.Generator(4, dropout=0.0, dtype=torch.bfloat16),
              dcgan.FrameDiscriminator(4, 8, dtype=torch.bfloat16),
              dcgan.TemporalDiscriminator(4, 8, dropout=0.0,
                                          dtype=torch.bfloat16))
    for a, b in zip(nets32, nets16):
        b.load_state_dict(a.state_dict())
    return models32, models16, states, nets32, nets16


@pytest.mark.parametrize("i,name", [(0, "g"), (1, "fd"), (2, "td")])
def test_dcgan_nets_bf16_match_jax(gans, i, name):
    models32, models16, states, nets32, nets16 = gans
    rng = np.random.default_rng(i)
    x = rng.uniform(0, 1, (4, 8 if name == "td" else 4, 64, 64)).astype(
        np.float32)
    st = getattr(states, name)
    variables = {"params": st.params,
                 **({"batch_stats": st.batch_stats} if st.batch_stats
                    else {})}
    xj = jnp.asarray(nhwc(x))
    want = [np.asarray(m.apply(variables, xj, train=False), np.float32)
            for m in (models32[i], models16[i])]
    if name == "g":
        want = [np.moveaxis(w, -1, 1) for w in want]
    net = nets16[i].eval()
    check_policy(net, torch.from_numpy(x),
                 jax_ops(models16[i], variables, xj))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    hold_to_jax(got, want[1], want[0])


def _bn_in_bf16(monkeypatch):
    """Eval-mode BatchNorm computed in bf16, its parameters kept float32."""
    def forward(self, x):
        bf = [t.to(torch.bfloat16) for t in (
            x, self.running_mean, self.running_var, self.weight, self.bias)]
        return torch.nn.functional.batch_norm(
            bf[0], bf[1], bf[2], bf[3], bf[4], False, 0.0, self.eps)
    monkeypatch.setattr(torch.nn.BatchNorm2d, "forward", forward)


def _params_in_bf16(model):
    model.to(torch.bfloat16)


@pytest.mark.parametrize("fault", ["batchnorm in bf16", "params in bf16"])
def test_a_planted_fault_fails_the_policy_check(monkeypatch, fault):
    _, m16, variables = gat_models("UnetModel (K3)")
    x = np.random.default_rng(1).random((1, HW, HW, T, V), np.float32)
    want = jax_ops(jax_gat("UnetModel (K3)", jnp.bfloat16), variables, x)
    check_policy(m16, torch.from_numpy(x), want)  # as built: passes
    if fault == "batchnorm in bf16":
        _bn_in_bf16(monkeypatch)
    else:
        _params_in_bf16(m16)
    with pytest.raises(AssertionError):
        check_policy(m16, torch.from_numpy(x), want)


def _float32_state(modules, opts):
    for m in modules:
        assert all(p.dtype == torch.float32 for p in m.parameters())
        assert all(b.dtype in (torch.float32, torch.int64)
                   for b in m.buffers())
    for opt in opts:
        for st in opt.state.values():
            assert st and all(v.dtype == torch.float32 for v in st.values())


def test_gat_driver_bf16_step(monkeypatch):
    kept = {}
    real = gat_driver.make_optimizer

    def keep(*args, **kwargs):
        kept["opt"] = real(*args, **kwargs)
        return kept["opt"]
    monkeypatch.setattr(gat_driver, "make_optimizer", keep)
    model, history = gat_driver.train(
        model_type="temporal", mapping_type="conv", dataset="synthetic",
        downsample_size=(HW, HW), train_batch_size=4, test_batch_size=8,
        epochs=1, max_batches=2, precision="bf16", device="cpu")
    assert model.hidden_layer.heads.mapping.dtype == torch.bfloat16
    assert np.isfinite(history["train_loss"]).all()
    assert np.isfinite(history["val_loss"]).all()
    _float32_state([model], [kept["opt"]])


def test_dcgan_driver_bf16_step(tmp_path):
    nets, history = dcgan_driver.train(
        device="cpu", epochs=1, max_batches=2, synthetic=True,
        train_batch_size=4, test_batch_size=8, precision="bf16",
        params={"ndf": 8}, out_dir=str(tmp_path))
    assert nets[0].ConvBlock_0.dtype == torch.bfloat16
    assert all(np.isfinite(v).all() for v in history.history.values())
    ckpts = tmp_path / "checkpoints"
    last = max(f for f in os.listdir(ckpts) if f.startswith("step_"))
    restored = torch.load(ckpts / last, weights_only=True)
    for name in ("g", "fd", "td"):
        opt_state = restored["states"][name]["optimizer"]["state"]
        assert all(v.dtype == torch.float32 for st in opt_state.values()
                   for v in st.values())
    _float32_state(nets, [])


@pytest.mark.parametrize("family", ["GAT3D conv (K1)", "UnetModel (K3)",
                                    "DCGAN"])
def test_a_float64_twin_stays_float64(family):
    """Under the float32 policy the models cast nothing, so a float64 twin
    (the card's checks hold float32 runs against one) runs in float64."""
    if family == "DCGAN":
        nets = (dcgan.Generator(4, dropout=0.0), dcgan.FrameDiscriminator(4, 8),
                dcgan.TemporalDiscriminator(4, 8, dropout=0.0))
        x = torch.rand(2, 4, 64, 64, dtype=torch.float64)
        outs = [nets[0].double().train()(x), nets[1].double().train()(x),
                nets[2].double().train()(torch.cat([x, x], 1))]
    else:
        m32, _, _ = gat_models(family)
        x = torch.rand(B, HW, HW, T, V, dtype=torch.float64)
        outs = [m32.double().train()(x)]
    assert all(o.dtype == torch.float64 for o in outs)
