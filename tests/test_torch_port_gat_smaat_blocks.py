"""GAT3D's smaat_unet mapping in the port against the JAX package, held as
``test_torch_port_gat_smaat.py`` sets out:

- the ``spatial`` and ``multi_stream`` models: eval- and train-mode
  forwards and the running statistics the train-mode forward leaves;
- one block of each attention type: the gradients of an MSE loss with
  respect to every parameter and the input, in eval mode within
  ``GRAD_TOL`` of the largest entry and in train mode within ``TRAIN_TOL``,
  or ``SENS_FACTOR`` times what roundoff alone moves either side's result.
"""

import numpy as np
import pytest
import torch

from extended_gan_tpu.models.gat.gat3d import GATMultiHead3D as FlaxBlock
from extended_gan_torch.models.convert import from_flax_params
from extended_gan_torch.models.gat.gat3d import GATMultiHead3D
from test_torch_port_gat_family import (
    GRAD_TOL,
    V,
    grad_gaps,
    inputs,
    jax_grads,
    one_torch_thread,  # noqa: F401 - the autouse fixture
    port_run,
    randomize_bn_stats,
    to_flax,
)
from test_torch_port_gat_smaat import (
    HW,
    bound,
    check_smaat_case,
    gap,
    perturbed,
)


@pytest.mark.parametrize("model_type", ["spatial", "multi_stream"])
def test_smaat_model_matches_jax(model_type):
    check_smaat_case(model_type)


@pytest.mark.parametrize("type_,nheads", [
    ("temporal", 2), ("spatial", 1), ("multi_stream", 1)])
def test_smaat_block_gradients_match_jax(type_, nheads):
    block = GATMultiHead3D(4, 4, V, nheads=nheads, type_=type_,
                           mapping_type="smaat_unet",
                           generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        randomize_bn_stats(block, 5)
    params, stats = to_flax(block)
    variables = {"params": params, "batch_stats": stats}
    fblock = FlaxBlock(nfeat=4, nhid=4, nheads=nheads, type_=type_,
                       mapping_type="smaat_unet", n_vertices=V)
    x, y = inputs(HW, seed=5)
    _, got, dx = port_run(block, x, y, train=False)
    g, g_dx = grad_gaps(got, dx, *jax_grads(fblock, variables, x, y,
                                            train=False))
    assert g <= GRAD_TOL and g_dx <= GRAD_TOL, ("eval", g, g_dx)

    want = [({k: v.numpy() for k, v in from_flax_params(tree).items()}, d)
            for tree, d in jax_grads(fblock, variables, x, y, True,
                                     perturbed(x))]
    state = {k: v.clone() for k, v in block.state_dict().items()}
    _, got2, dx2 = port_run(block, perturbed(x), y, train=True)
    block.load_state_dict(state)
    _, got, dx = port_run(block, x, y, train=True)
    got, got2 = ({k: v.numpy() for k, v in d.items()} for d in (got, got2))
    g = _gaps((got, dx), want[0])
    sens_port, sens_jax = _gaps((got2, dx2), (got, dx)), _gaps(*want[::-1])
    assert g[0] <= bound(sens_port[0], sens_jax[0]), (g, sens_port, sens_jax)
    assert g[1] <= bound(sens_port[1], sens_jax[1]), (g, sens_port, sens_jax)


def _gaps(a, b):
    """(parameter gradients, dx) pairs: the parameters' largest gap over
    the largest entry of all of b's, and dx's over b's dx."""
    assert sorted(a[0]) == sorted(b[0])
    largest = max(np.abs(v).max() for v in b[0].values())
    return (max(np.abs(a[0][k] - v).max() for k, v in b[0].items()) / largest,
            gap(a[1], b[1]))
