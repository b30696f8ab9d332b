"""GAT3D's smaat_unet mapping in the port against the JAX package: the
registry's ``temporal`` model, with the plain attention and with the fused
one (K1's plain versions on the CPU against the Pallas kernel in interpret
mode): forwards in both modes and the running statistics. The
``spatial`` and ``multi_stream`` models and one block of each attention
type are in ``test_torch_port_gat_smaat_blocks.py``, the stacked wrappers
in ``test_torch_port_gat_smaat_wrappers.py`` (files of their own, so the
JAX compiles spread over the workers).

Each head's mapping is a SmaAt-UNet with BatchNorm, at 16x16 (the UNet's
least size), B = 2, V = 3; the port's seeded weights reach flax through
``to_flax``, with running statistics away from their start. Tolerances:

- eval mode: the forward at ``TOL``; the gradients of an MSE loss with
  respect to every parameter and the input within ``GRAD_TOL`` of the
  largest entry, as in ``test_torch_port_gat_family.py``;
- train mode: BatchNorm normalises by the statistics of the batch, which
  amplifies f32 roundoff, and JAX and torch round differently. The forward,
  the running statistics and the gradients are held within ``TRAIN_TOL``
  of their largest entry (the SmaAt-UNet tests' bar), or within
  ``SENS_FACTOR`` times what roundoff alone moves either side's own result
  where that is more: the gap between its result on x and on x scaled by
  1 + 1e-7 noise, about one rounding of each entry. The JAX package's
  train-mode gradients move by 1-2% of the largest entry so (its autodiff
  of the BatchNorm statistics cancels), the port's by about 1e-4. Through
  two stacked blocks at their initial weights both move by several
  percent, so gradients are compared on one block, in both modes
  (``test_torch_port_gat_smaat_blocks.py``; the stacking's gradients are
  held with the linear and conv mappings in ``test_torch_port_gat_family.py``
  and the train-step tests hold the model on losses and SGD updates).
"""

import numpy as np
import pytest

from extended_gan_torch.models.convert import from_flax_params
from test_torch_port_gat_family import (
    TOL,
    inputs,
    jax_forwards,
    models,
    one_torch_thread,  # noqa: F401 - the autouse fixture
    port_run,
)

TRAIN_TOL = 1e-3
SENS_FACTOR = 10
HW = 16


def gap(got, want):
    """max |got - want| over the largest entry of want."""
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def perturbed(x):
    """x scaled by 1 + 1e-7 noise: about one rounding of each entry."""
    noise = np.random.default_rng(99).standard_normal(x.shape)
    return (x * (1 + 1e-7 * noise)).astype(np.float32)


def bound(*sens):
    return max(TRAIN_TOL, SENS_FACTOR * max(sens))


def running_stats(model):
    return {k: v.numpy().copy() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def stats_gap(got, want):
    assert sorted(got) == sorted(want)
    return max(gap(got[k], w) for k, w in want.items())


def flax_stats(tree):
    return {k: v.numpy() for k, v in from_flax_params({}, tree).items()
            if not k.endswith("num_batches_tracked")}


def check_smaat_case(model_type, use_pallas=False):
    """Eval- and train-mode forwards and the running statistics against
    flax."""
    fmodel, variables, model = models(model_type, "smaat_unet", HW,
                                      use_pallas)
    x, y = inputs(HW)
    want_eval, want_train, want_stats = jax_forwards(fmodel, variables, x)
    out = port_run(model, x, y, train=False)[0]
    np.testing.assert_allclose(out, want_eval, rtol=TOL, atol=TOL)
    # train mode, from the same state, on x and on x perturbed
    _, want_train2, want_stats2 = jax_forwards(fmodel, variables, perturbed(x))
    want_stats, want_stats2 = flax_stats(want_stats), flax_stats(want_stats2)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    out2 = port_run(model, perturbed(x), y, train=True)[0]
    stats2 = running_stats(model)
    model.load_state_dict(state)
    out = port_run(model, x, y, train=True)[0]
    stats = running_stats(model)
    assert gap(out, want_train) <= bound(gap(out2, out),
                                         gap(want_train2, want_train))
    assert stats_gap(stats, want_stats) <= bound(
        stats_gap(stats2, stats), stats_gap(want_stats2, want_stats))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_smaat_temporal_model_matches_jax(use_pallas):
    check_smaat_case("temporal", use_pallas)
