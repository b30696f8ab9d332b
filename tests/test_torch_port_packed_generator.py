"""The port's 2x2 space-to-depth generator (``ops/space_to_depth.py``,
``Generator(packed=True)``) against the JAX package's, on the CPU.

- ``pack2``, ``unpack2`` and ``pack_conv_weights`` equal JAX's bit for bit
  on the same arrays (NCHW against NHWC, OIHW against HWIO), and
  ``pack_conv_weights``' gradient equals JAX's; ``packed_conv_same`` is
  within 1e-5 of the direct 4x4 "same" conv and of JAX's packed conv.
- The packed generator (nc 4, 64x64, B = 4, weights from flax through
  ``from_flax_params``): its forward within 2e-5 of JAX
  ``Generator(packed=True)`` in train and in eval mode (the bar of
  ``tests/test_e2e_torch_parity.py``), its running statistics after a
  train forward within 1e-5 of JAX's; within 1e-5 of the port's unpacked
  generator with dropout on, from the same dropout generator state (the
  same masks); the unpacked generator's state_dict, names and shapes, and
  checkpoints that go either way; its BatchNorms found by
  ``state.batchnorms`` and frozen by ``running_stats_frozen``; bf16.
- The packed CycleGAN: one train step against JAX ``build_cyclegan(
  packed_g=True)``'s: losses within 1e-5 relative, running statistics
  within 1e-5 (the generators' moved by their one forward, the cycle
  forwards' dropped), the updated parameters within 1e-4 of JAX's on the
  batch in its row order or another, or, where a tensor misses that,
  within ``SENS_FACTOR`` times what 1e-7 noise on x moves either side's
  own result (``test_torch_port_cyclegan.py``'s rule); its CLI with
  ``--packed-g``, and its checkpoint exported in either layout.
- ``serve export --packed-g``: ``layout`` ``packed2`` in the spec and the
  sidecar, a ``Generator(packed=True)`` rebuilt from it, ``--check``
  passing on the CPU, the same outputs as the default layout, served by
  ``ModelServer``; the JAX
  script's refusals of ``gat`` and of ``--quantize`` with ``--packed-g``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extended_gan_tpu.models import dcgan as jax_dcgan
from extended_gan_tpu.ops import space_to_depth as jax_s2d
from extended_gan_tpu.train import cyclegan_driver as jax_cyclegan_driver
from extended_gan_torch.cycle_gan.__main__ import main as cyclegan_cli
from extended_gan_torch.models import dcgan
from extended_gan_torch.models.convert import from_flax_params
from extended_gan_torch.ops import space_to_depth as s2d
from extended_gan_torch.serve.__main__ import main as serve_cli
from extended_gan_torch.serve.export import load_exported
from extended_gan_torch.serve.server import ModelServer
from extended_gan_torch.train import cyclegan_trainer, state
from extended_gan_torch.train.checkpoint import CYCLEGAN_NETS
from test_torch_port_cyclegan import _all_trees, _stats_gap
from test_torch_port_dcgan import (
    LOSS_TOL,
    PARAM_TOL,
    STATS_TOL,
    nhwc,
    port_tree,
)
from test_torch_port_gat_family import one_torch_thread  # noqa: F401 - the autouse fixture
from test_torch_port_gat_smaat import SENS_FACTOR, gap, perturbed

NC, IM, B = 4, 64, 4
FWD_TOL = 2e-5
PAIR_TOL = 1e-5
LR = 2e-4


def nchw(a):
    return np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1))


@pytest.mark.parametrize("shape", [(2, 3, 8, 6), (1, 32, 64, 64)])
def test_pack2_and_unpack2_match_jax(shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    got = s2d.pack2(torch.from_numpy(x))
    want = jax_s2d.pack2(jnp.asarray(nhwc(x)))
    np.testing.assert_array_equal(got.numpy(), nchw(want))
    assert torch.equal(s2d.unpack2(got), torch.from_numpy(x))
    np.testing.assert_array_equal(
        s2d.unpack2(torch.from_numpy(nchw(want))).numpy(),
        nchw(jax_s2d.unpack2(want)))


@pytest.mark.parametrize("cin,cout", [(4, 32), (8, 4)])
def test_pack_conv_weights_and_its_gradient_match_jax(cin, cout):
    rng = np.random.default_rng(1)
    w = rng.standard_normal((cout, cin, 4, 4)).astype(np.float32)
    w_hwio = np.ascontiguousarray(w.transpose(2, 3, 1, 0))
    wt = torch.from_numpy(w).requires_grad_()
    got = s2d.pack_conv_weights(wt)
    want, vjp = jax.vjp(jax_s2d.pack_conv_weights, jnp.asarray(w_hwio))
    assert got.shape == (4 * cout, 4 * cin, 3, 3)
    np.testing.assert_array_equal(
        got.detach().numpy(), np.asarray(want).transpose(3, 2, 0, 1))
    ct = rng.standard_normal(got.shape).astype(np.float32)
    (g,) = torch.autograd.grad(got, wt, torch.from_numpy(ct))
    (want_g,) = vjp(jnp.asarray(np.ascontiguousarray(ct.transpose(2, 3, 1,
                                                                  0))))
    np.testing.assert_allclose(g.numpy(),
                               np.asarray(want_g).transpose(3, 2, 0, 1),
                               rtol=1e-6, atol=1e-6)


def test_packed_conv_same_is_the_direct_conv():
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 1, (2, 8, 64, 64)).astype(np.float32)
    w = rng.uniform(-0.1, 0.1, (16, 8, 4, 4)).astype(np.float32)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    direct = torch.nn.functional.conv2d(
        torch.nn.functional.pad(xt, (1, 2, 1, 2)), wt)
    got = s2d.unpack2(s2d.packed_conv_same(s2d.pack2(xt),
                                           s2d.pack_conv_weights(wt)))
    want = jax_s2d.unpack2(jax_s2d.packed_conv_same(
        jax_s2d.pack2(jnp.asarray(nhwc(x))),
        jax_s2d.pack_conv_weights(jnp.asarray(w.transpose(2, 3, 1, 0)))))
    assert gap(got.numpy(), direct.numpy()) <= PAIR_TOL
    assert gap(got.numpy(), nchw(want)) <= PAIR_TOL


@pytest.fixture(scope="module")
def flax_g():
    """JAX's packed generator (dropout off) and its variables."""
    model = jax_dcgan.Generator(nc=NC, dropout=0.0, packed=True)
    variables = jax.device_get(jax.jit(lambda k, x: model.init(
        {"params": k, "dropout": k}, x, train=False))(
        jax.random.PRNGKey(3), jnp.zeros((2, IM, IM, NC))))
    return model, variables


def port_g(variables, packed=True, dropout=0.0, **kw):
    g = dcgan.Generator(NC, dropout, packed=packed, **kw)
    g.load_state_dict(from_flax_params(variables["params"],
                                       variables["batch_stats"]))
    return g


def frames(seed, b=B):
    return np.random.default_rng(seed).uniform(
        0, 1, (b, NC, IM, IM)).astype(np.float32)


@pytest.mark.parametrize("train", [True, False])
def test_packed_generator_matches_jax(flax_g, train):
    model, variables = flax_g
    x = frames(4)
    want, upd = jax.jit(lambda v, x: model.apply(
        v, x, train=train, mutable=["batch_stats"]))(
        variables, jnp.asarray(nhwc(x)))
    g = port_g(variables).train(train)
    with torch.no_grad():
        got = g(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, nchw(want), rtol=FWD_TOL, atol=FWD_TOL)
    if train:
        stats = {k: v.numpy() for k, v in from_flax_params(
            {}, jax.device_get(upd["batch_stats"])).items()
            if "running" in k}
        mine = port_tree(g, True)
        assert sorted(mine) == sorted(stats) and len(stats) == 8
        for k, want_s in stats.items():
            assert gap(mine[k], want_s) <= STATS_TOL, k
            # not vacuous: the statistics moved off their start
            assert not np.allclose(want_s, 0.0 if "mean" in k else 1.0)


def test_packed_matches_unpacked_with_dropout_on(flax_g):
    _, variables = flax_g
    x = torch.from_numpy(frames(5))
    outs, stats = [], []
    for packed in (True, False):
        drop = torch.Generator().manual_seed(17)
        g = port_g(variables, packed, dropout=0.25,
                   dropout_generator=drop).train()
        with torch.no_grad():
            outs.append(g(x).numpy())
        stats.append(port_tree(g, True))
    assert gap(outs[0], outs[1]) <= PAIR_TOL
    for k, v in stats[1].items():
        assert gap(stats[0][k], v) <= PAIR_TOL, k
    # the masks took effect: dropout 0.25 of 4 channels zeroes some outputs'
    # inputs, so the output differs from dropout off
    with torch.no_grad():
        plain = port_g(variables, True).train()(x).numpy()
    assert gap(outs[0], plain) > 100 * PAIR_TOL


def test_state_dict_is_the_unpacked_generators_and_interchanges(tmp_path):
    a = dcgan.Generator(NC, packed=True, generator=torch.Generator()
                        .manual_seed(3))
    b = dcgan.Generator(NC, packed=False, generator=torch.Generator()
                        .manual_seed(3))
    sa, sb = a.state_dict(), b.state_dict()
    assert list(sa) == list(sb)
    for k in sa:
        assert sa[k].shape == sb[k].shape, k
        assert torch.equal(sa[k], sb[k]), k  # the same seeded draws
    assert sa["ConvBlock_0.Conv_0.weight"].shape == (32, 4, 4, 4)
    assert sa["ConvBlock_0.BatchNorm_0.running_mean"].shape == (32,)
    # a train forward, saved from one layout and loaded into the other
    x = torch.from_numpy(frames(6))
    with torch.no_grad():
        b.train()(x)
    path = tmp_path / "g.pt"
    torch.save(b.state_dict(), path)
    a.load_state_dict(torch.load(path, weights_only=True))
    with torch.no_grad():
        got, want = a.eval()(x).numpy(), b.eval()(x).numpy()
    assert gap(got, want) <= PAIR_TOL
    b.load_state_dict(a.state_dict())


def test_batchnorms_finds_the_packed_ones_and_freezes_them(flax_g):
    _, variables = flax_g
    g = port_g(variables).train()
    bns = state.batchnorms(g)
    assert len(bns) == 4 and all(isinstance(m, dcgan._PackedBN) for m in bns)
    before = {k: v.clone() for k, v in g.state_dict().items()}
    with state.running_stats_frozen(bns), torch.no_grad():
        g(torch.from_numpy(frames(7)))
    for k, v in g.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_bf16_packed_generator(flax_g):
    _, variables = flax_g
    x = torch.from_numpy(frames(8))
    g16 = port_g(variables, dtype=torch.bfloat16).eval()
    g32 = port_g(variables).eval()
    with torch.no_grad():
        got, want = g16(x), g32(x)
    assert got.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in g16.parameters())
    assert 0 < gap(got.numpy(), want.numpy()) <= 3e-2


def _cyclegan_pair():
    """JAX's packed CycleGAN (dropout off) and the port's nets from its
    states, Adam each."""
    models, txs, states, step, _, _ = jax_cyclegan_driver.build_cyclegan(
        nc=NC, ndf=8, imsize=IM, seed=3, packed_g=True)
    models = tuple(
        jax_dcgan.Generator(nc=NC, dropout=0.0, packed=True) if i < 2 else m
        for i, m in enumerate(models))
    step = jax_cyclegan_driver.make_cyclegan_train_step(
        *models, *txs, cycle_lambda=10.0)
    return step, states


def _port_cyclegan(states):
    nets = (dcgan.Generator(NC, 0.0, packed=True),
            dcgan.Generator(NC, 0.0, packed=True),
            dcgan.FrameDiscriminator(NC, 8), dcgan.FrameDiscriminator(NC, 8))
    for net, name in zip(nets, CYCLEGAN_NETS):
        st = getattr(states, name)
        net.load_state_dict(from_flax_params(jax.device_get(st.params),
                                             jax.device_get(st.batch_stats)))
    opts = tuple(torch.optim.Adam(n.parameters(), lr=LR,
                                  betas=(0.5, 0.999), eps=1e-8)
                 for n in nets)
    return nets, opts


ROW_ORDER = np.array([2, 0, 3, 1])


def test_packed_cyclegan_step_matches_jax():
    jstep, states = _cyclegan_pair()
    mask = np.ones(B, np.float32)

    def jax_run(x, y):
        new, logs = jstep(jax.tree_util.tree_map(jnp.copy, states),
                          jnp.asarray(nhwc(x)), jnp.asarray(nhwc(y)),
                          jnp.asarray(mask), jax.random.PRNGKey(0))
        return ({k: np.asarray(v) for k, v in logs.items()},
                _all_trees(states=new))

    def port_run(x, y, out=None):
        nets, opts = _port_cyclegan(states)
        if out is not None:
            out.update(nets=nets,
                       before=[port_tree(g, True) for g in nets[:2]])
        logs = cyclegan_trainer.make_cyclegan_train_step(
            *nets, *opts, cycle_lambda=10.0)(
            torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(mask))
        if out is not None:
            out["logs"] = logs
        return _all_trees(nets=nets)

    x, y = frames(9), frames(10)
    j_logs, j_trees = jax_run(x, y)
    _, j_other = jax_run(x[ROW_ORDER], y[ROW_ORDER])
    run = {}
    p_trees = port_run(x, y, run)
    nets, before, logs = run["nets"], run["before"], run["logs"]
    assert all(isinstance(m, dcgan._PackedBN)
               for m in state.batchnorms(nets[0], nets[1]))
    for k in j_logs:
        np.testing.assert_allclose(logs[k].numpy(), j_logs[k], rtol=LOSS_TOL,
                                   err_msg=k)
    assert _stats_gap(p_trees, j_trees) <= STATS_TOL
    # the generators' statistics took the forward of their own input:
    # they moved, and by JAX's one update (the cycle forwards dropped)
    for name, b in zip(("g_xy", "g_yx"), before):
        assert any(not np.array_equal(p_trees[name, "stats"][k], b[k])
                   for k in b)
    # the updated parameters within PARAM_TOL of JAX's on the batch in its
    # row order or another (the same step), or within SENS_FACTOR x what
    # 1e-7 noise on x moves either side's own result: Adam turns a gradient
    # entry within roundoff of zero into a step of lr either way, and which
    # way depends on the reductions' order (G_yx's ConvBlock_3 kernel: 4.5e-3
    # of its largest entry from the port's float64 twin in JAX's row order,
    # 4.5e-8 in the other)
    sens = None
    for key, tree in j_trees.items():
        if key[1] != "params":
            continue
        for k, want in tree.items():
            mine = p_trees[key][k]
            g = min(gap(mine, want), gap(mine, j_other[key][k]))
            if g <= PARAM_TOL:
                continue
            if sens is None:
                xp = perturbed(x)
                sens = (jax_run(xp, y)[1], port_run(xp, y))
            limit = SENS_FACTOR * max(gap(sens[0][key][k], want),
                                      gap(sens[1][key][k], mine))
            assert g <= limit, (key, k, g, limit)


def test_cyclegan_cli_trains_packed_generators(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "cg"
    nets, history = cyclegan_cli([
        "--device", "cpu", "--epochs", "1", "--max-batches", "2",
        "--synthetic", "--train-batch-size", "4", "--test-batch-size", "8",
        "--ndf", "8", "--out-dir", str(out), "--save-epoch", "1",
        "--packed-g"])
    assert nets[0].packed and nets[1].packed
    assert all(np.isfinite(v[0]) for v in history.history.values())
    assert sorted(os.listdir(out)) == ["checkpoints", "history.json",
                                       "imgs", "training_plots"]
    # the packed run's checkpoint exports as either layout, with the same
    # outputs
    arts = {}
    for layout, extra in (("packed2", ["--packed-g"]), ("default", [])):
        path = str(tmp_path / f"{layout}.pt")
        serve_cli(["export", str(out), "--workload", "cyclegan", "--ndf", "8",
                   "--out", path, "--check", "--device", "cpu", *extra])
        with open(path + ".json") as f:
            meta = json.load(f)
        assert meta["layout"] == meta["spec"]["layout"] == layout
        arts[layout] = load_exported(path, device="cpu")
    assert arts["packed2"].model.packed and not arts["default"].model.packed
    x = torch.from_numpy(np.random.default_rng(0).random((3, IM, IM, NC),
                                                         np.float32))
    with torch.no_grad():
        got, want = arts["packed2"].fn(x), arts["default"].fn(x)
    assert gap(got.numpy(), want.numpy()) <= PAIR_TOL


def test_export_packed_dcgan_generator(tmp_path, capsys):
    path = str(tmp_path / "g.pt")
    info = serve_cli(["export", str(tmp_path), "--workload", "dcgan",
                      "--init-seed", "0", "--packed-g", "--out", path,
                      "--check", "--device", "cpu"])
    assert "check OK" in capsys.readouterr().out
    assert info["spec"]["layout"] == info["layout"] == "packed2"
    art = load_exported(path, device="cpu")
    assert art.model.packed and art.window_shape == (IM, IM, NC)
    plain = str(tmp_path / "plain.pt")
    serve_cli(["export", str(tmp_path), "--workload", "dcgan",
               "--init-seed", "0", "--out", plain])
    other = load_exported(plain, device="cpu")
    assert list(other.model.state_dict()) == list(art.model.state_dict())
    x = torch.from_numpy(np.random.default_rng(1).random((2, IM, IM, NC),
                                                         np.float32))
    with torch.no_grad():
        assert gap(art.fn(x).numpy(), other.fn(x).numpy()) <= PAIR_TOL
        want = art.fn(x).numpy()
    # served as it is, by the HTTP server's predict path
    got = ModelServer(path, device="cpu").predict(
        np.ascontiguousarray(x[:1].numpy()))
    np.testing.assert_allclose(got, want[:1], rtol=0, atol=1e-6)


@pytest.mark.parametrize("argv,match", [
    (["--packed-g"], "dcgan/cyclegan generator workloads only"),
    (["--workload", "dcgan", "--packed-g", "--quantize", "w8"],
     "combine with --packed-g is unsupported"),
    (["--workload", "cyclegan", "--packed-g", "--quantize", "w8a8"],
     "combine with --packed-g is unsupported"),
])
def test_export_refuses_as_jax_does(tmp_path, argv, match):
    with pytest.raises(SystemExit, match=match):
        serve_cli(["export", str(tmp_path), "--init-seed", "0", "--out",
                   str(tmp_path / "x.pt"), "--device", "cpu", *argv])
    assert not os.path.exists(tmp_path / "x.pt")
