"""The port's vanilla MLP GAN (``models/vanilla_gan.py``,
``train/adversarial.py``, ``data/mnist.py``, ``train/module.py``, ``python
-m extended_gan_torch.vanilla_gan``) against the JAX package's, on the CPU.

- The MLPs at the published widths (latent 100, 28x28): parameter names
  and counts equal the flax trees'; weights carried by ``from_flax_params``
  give the same eval and train-mode forwards (and the same running
  statistics after the train-mode one) within FWD_TOL; the weights of the
  port's own init lie in torch's ``nn.Linear`` bounds.
- One default and one FusedProp step against JAX's, fed JAX's z: losses
  within LOSS_TOL, running statistics within STATS_TOL, parameters within
  PARAM_TOL of each tensor's largest entry or within ``SENS_FACTOR`` times
  roundoff's scale (:func:`assert_step_matches_jax`). A planted fault, the
  D-fake gradients dropped from the fused step, fails it.
- FusedProp against the default step in the port, JAX's
  ``tests/test_vanilla_fused_prop.py``: strict SGD (losses within 1e-6,
  parameters within 2e-6) and Adam (its sign-resolution budget).
- bf16: the products in bfloat16 where JAX's jaxpr has them, BatchNorm and
  the heads in float32, the forwards held by
  ``test_torch_port_precision.hold_to_jax``'s rule.
- The MNIST sources byte for byte (idx, gzipped idx with a resize, npz,
  the synthetic digits) and ``iterate_batches``' order.
- ``Trainer.fit`` on JAX's toy regression from the same initial weights:
  the same validation history within 1e-4 relative, and converged.
- The CLI on the CPU: its PNG grids decode to the generator's samples of
  the fixed latents, min-max normalised; ``--channels 3`` is refused.
"""

import gzip
import os
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extended_gan_tpu.core import KeySeq as JaxKeySeq
from extended_gan_tpu.data import mnist as jax_mnist
from extended_gan_tpu.models import vanilla_gan as jax_vanilla
from extended_gan_tpu.train.adversarial import (
    make_vanilla_gan_step as jax_vanilla_step,
)
from extended_gan_tpu.train.module import Trainer as JaxTrainer
from extended_gan_tpu.train.optim import adam
from extended_gan_tpu.train.state import create_net_state
from extended_gan_torch.data import mnist
from extended_gan_torch.models import vanilla_gan
from extended_gan_torch.models.convert import from_flax_params
from extended_gan_torch.train import adversarial
from extended_gan_torch.train.module import Trainer, TrainModule
from extended_gan_torch.vanilla_gan.__main__ import image_grid
from extended_gan_torch.vanilla_gan.__main__ import main as cli
from test_torch_port_dcgan import FWD_TOL, LOSS_TOL, PARAM_TOL, STATS_TOL
from test_torch_port_gat_family import one_torch_thread  # noqa: F401 - the autouse fixture
from test_torch_port_gat_smaat import SENS_FACTOR, gap, perturbed
from test_torch_port_precision import check_policy, hold_to_jax, jax_ops
from test_trainer_module import ToyRegression

LATENT, IMG, B = 100, (1, 28, 28), 8
LR, B1 = 2e-4, 0.5


def jax_state_tree(st):
    """A NetState's parameters and statistics under the port's names."""
    sd = from_flax_params(jax.device_get(st.params),
                          jax.device_get(st.batch_stats))
    return {k: v.numpy() for k, v in sd.items()
            if not k.endswith("num_batches_tracked")}


def port_state_tree(net):
    return {k: v.detach().numpy().copy() for k, v in net.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def jax_pair(img=IMG, latent=LATENT, tx=None, **widths):
    """The flax MLPs, their transforms and initial states."""
    keys = JaxKeySeq(0)
    g = jax_vanilla.MLPGenerator(img_shape=img, latent_dim=latent,
                                 **widths.get("g", {}))
    d = jax_vanilla.MLPDiscriminator(img_shape=img, **widths.get("d", {}))
    txs = tuple((tx or (lambda: adam(LR, b1=B1)))() for _ in range(2))
    gs = create_net_state(g, txs[0], keys.next(), jnp.zeros((2, latent)),
                          train=False)
    ds = create_net_state(d, txs[1], keys.next(), jnp.zeros((2, *img)),
                          train=False)
    return g, d, txs, gs, ds


def port_pair(gs, ds, img=IMG, latent=LATENT, opt=None, dtype=torch.float32,
              **widths):
    g = vanilla_gan.MLPGenerator(img, latent, **widths.get("g", {}),
                                 dtype=dtype)
    d = vanilla_gan.MLPDiscriminator(img, **widths.get("d", {}), dtype=dtype)
    g.load_state_dict(from_flax_params(jax.device_get(gs.params),
                                       jax.device_get(gs.batch_stats)))
    d.load_state_dict(from_flax_params(jax.device_get(ds.params)))
    opts = tuple((opt or (lambda p: torch.optim.Adam(
        p, lr=LR, betas=(B1, 0.999), eps=1e-8)))(n.parameters())
        for n in (g, d))
    return g, d, opts


@pytest.fixture(scope="module")
def published():
    """The published MLPs (JAX), with jitted default and fused steps."""
    g, d, txs, gs, ds = jax_pair()
    steps = {fused: jax_vanilla_step(g, d, *txs, latent_dim=LATENT,
                                     fused_prop=fused)
             for fused in (False, True)}
    return g, d, txs, gs, ds, steps


def test_names_counts_and_init(published):
    g, d, _, gs, ds, _ = published
    pg, pd, _ = port_pair(gs, ds)
    assert sorted(port_state_tree(pg)) == sorted(jax_state_tree(gs))
    assert sorted(port_state_tree(pd)) == sorted(jax_state_tree(ds))
    count = lambda tree: sum(x.size for x in jax.tree_util.tree_leaves(tree))  # noqa: E731
    assert sum(p.numel() for p in pg.parameters()) == count(gs.params)
    assert sum(p.numel() for p in pd.parameters()) == count(ds.params)
    assert [m.eps for m in pg.modules()
            if isinstance(m, torch.nn.BatchNorm1d)] == [0.8] * 3
    # the port's own init: U(-1/sqrt(fan_in), 1/sqrt(fan_in)), from the
    # generator it is given
    gen = torch.Generator().manual_seed(1)
    own = vanilla_gan.MLPDiscriminator(IMG, generator=gen)
    again = vanilla_gan.MLPDiscriminator(
        IMG, generator=torch.Generator().manual_seed(1))
    for (name, p), q in zip(own.named_parameters(), again.parameters()):
        assert torch.equal(p, q), name
        bound = 1 / np.sqrt(own.get_submodule(name.split(".")[0])
                            .in_features)
        top = float(p.detach().abs().max())
        assert top <= bound and (p.numel() < 100 or top > 0.8 * bound), name


def test_forwards_match_flax(published):
    g, d, _, gs, ds, _ = published
    pg, pd, _ = port_pair(gs, ds)
    rng = np.random.default_rng(0)
    z = rng.standard_normal((B, LATENT)).astype(np.float32)
    img = rng.uniform(-1, 1, (B, *IMG)).astype(np.float32)
    # eval mode
    want_g = np.asarray(g.apply({"params": gs.params,
                                 "batch_stats": gs.batch_stats}, z,
                                train=False))
    want_d = np.asarray(d.apply({"params": ds.params}, img, train=False))
    got_g = adversarial.apply_eval(pg, torch.from_numpy(z)).numpy()
    got_d = adversarial.apply_eval(pd, torch.from_numpy(img)).numpy()
    assert got_g.shape == want_g.shape == (B, *IMG)
    assert got_d.shape == want_d.shape == (B, 1)
    np.testing.assert_allclose(got_g, want_g, rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(got_d, want_d, rtol=FWD_TOL, atol=FWD_TOL)
    # train mode, and the statistics it leaves
    want, mut = g.apply({"params": gs.params, "batch_stats": gs.batch_stats},
                        z, train=True, mutable=["batch_stats"])
    with torch.no_grad():
        got = pg.train()(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=FWD_TOL,
                               atol=FWD_TOL)
    stats = {k: v.numpy() for k, v in from_flax_params(
        {}, jax.device_get(mut["batch_stats"])).items()
        if not k.endswith("num_batches_tracked")}
    for k, w in stats.items():
        assert gap(pg.state_dict()[k].numpy(), w) <= STATS_TOL, k


def _z(rng_key, b, latent):
    """The z that JAX's step draws from ``rng_key``."""
    rng_z, _ = jax.random.split(rng_key)
    return np.asarray(jax.random.normal(rng_z, (b, latent), jnp.float32))


def _jax_vanilla(published, real, fused, z_noise=None):
    _, _, _, gs, ds, steps = published
    gs, ds = jax.tree_util.tree_map(jnp.copy, (gs, ds))  # the step donates
    key = jax.random.PRNGKey(3)
    gs, ds, logs = steps[fused](gs, ds, jnp.asarray(real), key)
    return ([float(logs["g_loss"]), float(logs["d_loss"])],
            {**{f"g.{k}": v for k, v in jax_state_tree(gs).items()},
             **{f"d.{k}": v for k, v in jax_state_tree(ds).items()}})


def _port_vanilla(published, real, fused, z, dtype=torch.float32):
    _, _, _, gs, ds, _ = published
    pg, pd, _ = port_pair(gs, ds)
    pg, pd = pg.to(dtype), pd.to(dtype)
    opts = tuple(torch.optim.Adam(n.parameters(), lr=LR, betas=(B1, 0.999),
                                  eps=1e-8) for n in (pg, pd))
    step = adversarial.make_vanilla_gan_step(pg, pd, *opts,
                                             latent_dim=LATENT,
                                             fused_prop=fused)
    logs = step(*(torch.from_numpy(np.array(a)).to(dtype) for a in (real, z)))
    return ([float(logs["g_loss"]), float(logs["d_loss"])],
            {**{f"g.{k}": v for k, v in port_state_tree(pg).items()},
             **{f"d.{k}": v for k, v in port_state_tree(pd).items()}})


def assert_step_matches_jax(published, fused):
    """One step of the port against JAX's, fed JAX's z. Each parameter
    within PARAM_TOL of JAX's, relative to its largest entry, or within
    SENS_FACTOR times roundoff's scale: the most that 1e-7 noise moves
    either side's own result (JAX's step draws its z inside, so its side is
    perturbed through the real batch only; the port's through both), or
    the port's float32 lies from its float64 twin. None of these grows with
    a fault that the port's float32 and float64 share. (Adam's first step
    is lr * g / (|g| + 1e-8): where a gradient entry is a near-cancellation
    of 1e-7, as in the generator's second BatchNorm bias, its roundoff
    moves the step by 1e-4 of the tensor's largest entry, which the noise
    does not show and the float64 twin does.)"""
    rng = np.random.default_rng(1)
    real = rng.uniform(-1, 1, (B, *IMG)).astype(np.float32)
    z = _z(jax.random.PRNGKey(3), B, LATENT)
    j_loss, j_tree = _jax_vanilla(published, real, fused)
    p_loss, p_tree = _port_vanilla(published, real, fused, z)
    np.testing.assert_allclose(p_loss, j_loss, rtol=LOSS_TOL)
    assert sorted(p_tree) == sorted(j_tree)
    scale = None
    for k, want in j_tree.items():
        g = gap(p_tree[k], want)
        if "running" in k:
            assert g <= STATS_TOL, k
            continue
        if g <= PARAM_TOL:
            continue
        if scale is None:
            runs = (_jax_vanilla(published, perturbed(real), fused)[1],
                    _port_vanilla(published, perturbed(real), fused,
                                  perturbed(z))[1],
                    _port_vanilla(published, real, fused, z,
                                  torch.float64)[1])
            scale = {name: max(gap(runs[0][name], j_tree[name]),
                               gap(runs[1][name], p_tree[name]),
                               gap(p_tree[name], runs[2][name]))
                     for name in j_tree}
        assert g <= SENS_FACTOR * scale[k], (k, g, scale[k])


@pytest.mark.parametrize("fused", [False, True])
def test_one_step_matches_jax_with_its_z(published, fused):
    assert_step_matches_jax(published, fused)


def test_a_fused_step_without_its_d_fake_gradients_fails(published,
                                                         monkeypatch):
    """A planted fault, in the port's float32 and float64 steps alike: the
    fused step's D-fake gradients come back as zeros, so D learns from the
    real batch alone while its logged loss is unchanged."""
    pulls = adversarial.fused_prop_grads

    def dropped(*args):
        g_grads, d_grads = pulls(*args)
        return g_grads, [torch.zeros_like(t) for t in d_grads]

    monkeypatch.setattr(adversarial, "fused_prop_grads", dropped)
    with pytest.raises(AssertionError, match=r"\('d\."):
        assert_step_matches_jax(published, True)


def _fused_run(fused, opt, n_steps=3):
    """JAX's test_vanilla_fused_prop.py setup in the port: 8x8 images,
    latent 16, G widths (32, 64), D widths (32, 16)."""
    widths = {"g": {"widths": (32, 64)}, "d": {"widths": (32, 16)}}
    _, _, _, gs, ds = jax_pair(img=(1, 8, 8), latent=16, **widths)
    g, d, opts = port_pair(gs, ds, img=(1, 8, 8), latent=16, opt=opt,
                           **widths)
    step = adversarial.make_vanilla_gan_step(
        g, d, *opts, latent_dim=16, fused_prop=fused,
        generator=torch.Generator().manual_seed(7))
    rng = np.random.RandomState(1)
    for _ in range(n_steps):
        real = torch.from_numpy((rng.rand(4, 1, 8, 8) * 2 - 1)
                                .astype(np.float32))
        logs = step(real)
    return ([float(logs["g_loss"]), float(logs["d_loss"])],
            [p.detach().clone() for n in (g, d) for p in n.parameters()],
            [b.clone() for b in g.buffers()])


def test_fused_prop_matches_the_default_step():
    sgd = lambda p: torch.optim.SGD(p, lr=1e-3)  # noqa: E731
    la, pa, ba = _fused_run(False, sgd)
    lb, pb, bb = _fused_run(True, sgd)
    np.testing.assert_allclose(lb, la, rtol=1e-6, atol=1e-7)
    for a, b in zip(pa + ba, pb + bb):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=2e-6)
    n = 3
    adam_ = lambda p: torch.optim.Adam(p, lr=2e-4)  # noqa: E731
    _, pa, _ = _fused_run(False, adam_, n)
    _, pb, _ = _fused_run(True, adam_, n)
    for a, b in zip(pa, pb):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-3,
                                   atol=2 * 2e-4 * n)


@pytest.mark.parametrize("which", ["g", "d"])
def test_bf16_forwards_match_jax(published, which):
    g, d, _, gs, ds, _ = published
    g16 = jax_vanilla.MLPGenerator(dtype=jnp.bfloat16)
    d16 = jax_vanilla.MLPDiscriminator(dtype=jnp.bfloat16)
    pg, pd, _ = port_pair(gs, ds, dtype=torch.bfloat16)
    rng = np.random.default_rng(2)
    if which == "g":
        x = rng.standard_normal((B, LATENT)).astype(np.float32)
        variables = {"params": gs.params, "batch_stats": gs.batch_stats}
        models, net = (g, g16), pg.eval()
    else:
        x = rng.uniform(-1, 1, (B, *IMG)).astype(np.float32)
        variables = {"params": ds.params}
        models, net = (d, d16), pd.eval()
    want = [np.asarray(m.apply(variables, x, train=False), np.float32)
            for m in models]
    check_policy(net, torch.from_numpy(x), jax_ops(models[1], variables,
                                                   jnp.asarray(x)))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    hold_to_jax(got, want[1], want[0])


def _write_idx(path, images, gz=False):
    n, r, c = images.shape
    data = struct.pack(">IIII", 2051, n, r, c) + images.tobytes()
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(data)


@pytest.mark.parametrize("source,size", [
    ("idx", 28), ("gz", 14), ("npz", 20), ("synthetic", 28),
    ("synthetic", 16)])
def test_mnist_sources_are_byte_identical(tmp_path, source, size):
    imgs = (np.random.default_rng(5).random((7, 28, 28)) * 255).astype(
        np.uint8)
    root = str(tmp_path)
    if source == "idx":
        _write_idx(os.path.join(root, "train-images-idx3-ubyte"), imgs)
    elif source == "gz":
        os.makedirs(os.path.join(root, "MNIST", "raw"))
        _write_idx(os.path.join(root, "MNIST", "raw",
                                "train-images-idx3-ubyte.gz"), imgs, gz=True)
    elif source == "npz":
        np.savez(os.path.join(root, "mnist.npz"), x_train=imgs)
    else:
        root = ""
    got = mnist.load_images(root, img_size=size, n_synthetic=24)
    want = jax_mnist.load_images(root, img_size=size, n_synthetic=24)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == ((24 if source == "synthetic" else 7),
                                       1, size, size)
    assert got.tobytes() == want.tobytes()
    assert -1.0 <= got.min() and got.max() <= 1.0


def test_iterate_batches_order():
    x = np.arange(70, dtype=np.float32).reshape(70, 1, 1, 1)
    got = list(mnist.iterate_batches(x, 16, rng=np.random.RandomState(4)))
    want = list(jax_mnist.iterate_batches(x, 16,
                                          rng=np.random.RandomState(4)))
    assert [len(b) for b in got] == [16, 16, 16, 16, 6]
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert len(got) == len(want)


class TorchToyRegression(TrainModule):
    """JAX's ToyRegression (y = Wx by SGD 0.1) in the port."""

    def configure(self, generator, device):
        w = torch.randn(4, 1, generator=generator, device=device)
        return self.state_from(w)

    @staticmethod
    def state_from(w):
        w = torch.nn.Parameter(w.clone())
        return {"w": w, "opt": torch.optim.SGD([w], lr=0.1)}

    def training_step(self, state, batch, generator):
        x, y = batch
        loss = torch.mean((x @ state["w"] - y) ** 2)
        state["opt"].zero_grad()
        loss.backward()
        state["opt"].step()
        return state, {"loss": loss.detach()}

    def validation_step(self, state, batch):
        x, y = batch
        return {"val_loss": torch.mean((x @ state["w"] - y) ** 2)}


def test_trainer_fit_matches_jax_on_its_toy_regression():
    rng = np.random.RandomState(0)
    w_true = rng.randn(4, 1).astype(np.float32)
    x = rng.randn(64, 4).astype(np.float32)
    y = x @ w_true

    def data():
        for i in range(0, 64, 8):
            yield (x[i: i + 8], y[i: i + 8])

    jax_module = ToyRegression()
    init = jax_module.configure(jax.random.PRNGKey(0))
    w0 = np.array(init["w"])  # the JAX trainer donates its state
    _, want = JaxTrainer(seed=0, log_every=100).fit(
        jax_module, data, data, epochs=30, state=init)
    module = TorchToyRegression()
    state = module.state_from(torch.from_numpy(w0))
    _, got = Trainer(device="cpu", seed=0, log_every=100).fit(
        module, data, data, epochs=30, state=state)
    assert len(got) == len(want) == 30
    np.testing.assert_allclose([h["val_loss"] for h in got],
                               [h["val_loss"] for h in want], rtol=1e-4,
                               atol=1e-9)
    assert got[-1]["val_loss"] < 1e-2
    # configure draws from the trainer's seeded generator
    s1 = Trainer(device="cpu", seed=5).fit(module, data, epochs=0)[0]
    s2 = Trainer(device="cpu", seed=5).fit(module, data, epochs=0)[0]
    assert torch.equal(s1["w"], s2["w"])


def read_png(path):
    """(H, W) uint8 of an 8-bit grayscale PNG without interlace or
    filters, as ``write_png`` writes it."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF
        chunks[kind] = chunks.get(kind, b"") + body
        pos += 12 + n
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert (depth, color) == (8, 0)
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = rows.reshape(h, w + 1)
    assert not rows[:, 0].any()
    return rows[:, 1:]


def test_cli_writes_the_sample_grids(tmp_path):
    out = str(tmp_path / "images")
    g, d = cli(["--n_epochs", "1", "--batch_size", "32", "--img_size", "8",
                "--latent_dim", "8", "--max_batches", "3", "--data_root", "",
                "--out_dir", out, "--sample_interval", "2", "--device",
                "cpu"])
    assert sorted(os.listdir(out)) == ["0.png", "2.png"]
    # 2.png: after the third and last step, the generator's eval forward of
    # the 25 fixed latents, the first draws of the seed's stream
    from extended_gan_torch.core.prng import KeySeq

    fixed = torch.randn(25, 8, generator=KeySeq(369).generator)
    want = np.rint(image_grid(adversarial.apply_eval(g, fixed).numpy())
                   * 255).astype(np.uint8)
    pixels = read_png(os.path.join(out, "2.png"))
    assert pixels.shape == (40, 40) and pixels.min() == 0 \
        and pixels.max() == 255
    np.testing.assert_array_equal(pixels, want)
    # fewer than 25 images leave white tiles
    grid = image_grid(np.zeros((3, 1, 8, 8), np.float32))
    assert grid.shape == (40, 40) and (grid[8:, :] == 1).all()
    with pytest.raises(SystemExit, match="channels"):
        cli(["--channels", "3", "--device", "cpu", "--out_dir", out])
