"""Remat in the port's conv-GAT trainer (the port's side of
``tests/test_remat.py``): ``remat=True`` recomputes the forward during the
backward (non-reentrant ``torch.utils.checkpoint``) and must change memory,
never numerics.

- A remat train step against the plain step from the same weights on the
  same batch, bit for bit: the loss, every gradient, the parameters after
  Adam and the BatchNorm running statistics (and their batch counts). The
  models: final_temp_conv's GAT3D with the fused attention switched on
  (K1's plain twin on the CPU), the same with ``use_pallas_mapping=True``
  (K2's twin), the UnetModel with K3's twin, and the smaat_unet mapping.
- The megastep body (eager on the CPU): two groups of K = 2 steps.
- The recompute runs each kernel twin's forward a second time, and its
  backward once.
- A plain ``checkpoint`` without the port's BatchNorm rule updates the
  running statistics twice a step, and the bitwise check sees it.
"""

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from extended_gan_torch.models.gat.gat3d import Model as GatModel
from extended_gan_torch.models.registry import build_model
from extended_gan_torch.ops import dsconv as k3
from extended_gan_torch.ops import gat_attention as k1
from extended_gan_torch.ops import gat_mapping as k2
from extended_gan_torch.train import gat_trainer
from extended_gan_torch.train.gat_trainer import (
    make_gat_megastep,
    make_gat_train_step,
)
from test_torch_port_gat_family import one_torch_thread  # noqa: F401 - the autouse fixture

HW, B, T, V = 16, 3, 4, 2

MODELS = {
    "final_temp_conv (K1)": lambda g: build_model(
        "temporal", image_width=HW, image_height=HW, n_vertices=V,
        mapping_type="conv", use_pallas=True, device="cpu", generator=g),
    "switched mapping (K1, K2)": lambda g: GatModel(
        HW, HW, V, "temporal", "conv", use_pallas=True, generator=g,
        use_pallas_mapping=True),
    "UnetModel (K3)": lambda g: build_model(
        "unet", image_width=HW, image_height=HW, n_vertices=V,
        mapping_type="conv", use_pallas=True, device="cpu", generator=g),
    "smaat mapping (K1)": lambda g: build_model(
        "temporal", image_width=HW, image_height=HW, n_vertices=V,
        mapping_type="smaat_unet", use_pallas=True, device="cpu",
        generator=g),
}


def _pair(name, seed=0):
    """Two copies of the model from one seed, each with its Adam."""
    nets = [MODELS[name](torch.Generator().manual_seed(seed)).train()
            for _ in range(2)]
    opts = [torch.optim.Adam(n.parameters(), lr=1e-3, weight_decay=0.01)
            for n in nets]
    return nets, opts


def _batch(seed=1, n=B):
    rng = np.random.default_rng(seed)
    x, y = (torch.from_numpy(rng.random((n, HW, HW, T, V), np.float32))
            for _ in range(2))
    return x, y, torch.ones(n)


def _assert_state_equal(a, b):
    """Parameters, buffers (BatchNorm statistics and batch counts) and
    Adam's state, bit for bit."""
    sa, sb = a[0].state_dict(), b[0].state_dict()
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    for pa, pb in zip(a[1].param_groups[0]["params"],
                      b[1].param_groups[0]["params"]):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(a[1].state[pa][key], b[1].state[pb][key])


@pytest.mark.parametrize("name", list(MODELS))
def test_remat_step_equals_the_plain_step_bit_for_bit(name):
    (plain, remat), (o_plain, o_remat) = _pair(name)
    steps = (make_gat_train_step(plain, o_plain),
             make_gat_train_step(remat, o_remat, remat=True))
    for seed in (1, 2):
        batch = _batch(seed)
        (l0, nd0), (l1, nd1) = (s(*batch) for s in steps)
        assert torch.equal(l0, l1) and torch.equal(nd0, nd1)
        for p0, p1 in zip(plain.parameters(), remat.parameters()):
            assert torch.equal(p0.grad, p1.grad)
        _assert_state_equal((plain, o_plain), (remat, o_remat))
    bns = [m for m in remat.modules()
           if isinstance(m, torch.nn.BatchNorm2d)]
    if "UnetModel" in name or "smaat" in name:
        assert bns and all(int(m.num_batches_tracked) == 2 for m in bns)


def test_remat_megastep_equals_the_plain_megastep():
    (plain, remat), (o_plain, o_remat) = _pair("UnetModel (K3)")
    megas = (make_gat_megastep(plain, o_plain),
             make_gat_megastep(remat, o_remat, remat=True))
    for seed in (3, 4):
        batches = [_batch(seed * 10 + i) for i in range(2)]
        staged = tuple(torch.stack(a) for a in zip(*batches))
        l0, l1 = (m(*staged) for m in megas)
        assert torch.equal(l0["running_nd"], l1["running_nd"])
        assert torch.equal(l0["loss"], l1["loss"])
    _assert_state_equal((plain, o_plain), (remat, o_remat))


def _counting(monkeypatch, module, name):
    calls = [0]
    real = getattr(module, name)

    def counted(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)
    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("name,twins", [
    ("switched mapping (K1, K2)",
     [(k1, "reference_impl", 2, 2), (k2, "reference_bottleneck", 2, 2)]),
    ("UnetModel (K3)", [(k3, "reference_dsc", 18, 18)]),
])
def test_remat_runs_each_forward_twice_and_its_backward_once(
        monkeypatch, name, twins):
    """On the CPU the wrappers run their plain twins: a plain step calls
    each forward twin ``fwd`` times; a remat step twice that. K2's plain
    backward recomputes its forward (``fused_conv_bottleneck``'s CPU
    backward), and K3's backward and K1's are their own functions, once a
    launch either way."""
    bwd_twins = {k1: "reference_backward", k3: "reference_dsc_backward"}
    (plain, remat), (o_plain, o_remat) = _pair(name)
    batch = _batch()
    for net, opt, flag, factor in ((plain, o_plain, False, 1),
                                   (remat, o_remat, True, 2)):
        step = make_gat_train_step(net, opt, remat=flag)
        counters = [(_counting(monkeypatch, mod, fn), fwd, bwd, mod)
                    for mod, fn, fwd, bwd in twins]
        bwds = {mod: _counting(monkeypatch, mod, bwd_twins[mod])
                for mod, *_ in twins if mod in bwd_twins}
        step(*batch)
        for calls, fwd, bwd, mod in counters:
            # K2's CPU backward is its plain forward again, under autograd
            extra = bwd if mod is k2 else 0
            assert calls[0] == fwd * factor + extra, (mod.__name__, calls)
            if mod in bwds:
                assert bwds[mod][0] == bwd, (mod.__name__, bwds[mod])
        monkeypatch.undo()


def test_a_checkpoint_without_the_batchnorm_rule_double_counts(monkeypatch):
    """The planted fault: ``checkpoint`` alone reruns train-mode BatchNorm
    in the recompute, so the running statistics take two updates a step
    and the bitwise check fails."""
    def naive(model):
        return lambda x: checkpoint(model, x, use_reentrant=False,
                                    preserve_rng_state=False)

    monkeypatch.setattr(gat_trainer, "remat_forward", naive)
    (plain, remat), (o_plain, o_remat) = _pair("UnetModel (K3)")
    make_gat_train_step(plain, o_plain)(*_batch())
    make_gat_train_step(remat, o_remat, remat=True)(*_batch())
    bn = next(m for m in remat.modules()
              if isinstance(m, torch.nn.BatchNorm2d))
    assert int(bn.num_batches_tracked) == 2
    with pytest.raises(AssertionError):
        _assert_state_equal((plain, o_plain), (remat, o_remat))
