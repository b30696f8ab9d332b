"""The Switch-MoE UNet's bf16 train step in the port against the JAX
package's, on the CPU (the narrow UNet, its weights and batch of
``test_torch_port_moe_train.py``).

One step of ``make_gat_train_step`` with ``moe_aux_weight`` 0.01 and the
modules' dtype bf16 (parameters float32), each package's from the same
weights, on the default path and under ``per_vertex_bn``. Both are held
to the float64 truth: the port's float64 step, which that file holds to
JAX's float64 forward-mode derivatives. bf16 rounds each gradient tensor
to a draw of its own (one tensor's error is 20x JAX's or a tenth of it),
so the rule is the precision tests' rule for the forwards, over the whole
gradient: the port's loss error at most GAP_FACTOR x JAX's, and the root
mean square over the tensors of each tensor's root-mean-square error (in
units of its largest entry, or the whole gradient's RMS entry where that
is more) at most GAP_FACTOR x JAX's. The tensors are those where JAX's
reverse-mode gradient is the derivative of its loss: every one under
``per_vertex_bn``; from the bottleneck on (the MoE, cbam5, the decoder)
on the default path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from extended_gan_tpu.train import gat_trainer as jtrainer
from extended_gan_tpu.train.state import NetState as JaxNetState
from extended_gan_torch.train import gat_trainer
from test_torch_port_gat_family import one_torch_thread  # noqa: F401 - the autouse fixture
from test_torch_port_moe import (  # noqa: F401 - the narrow fixture
    AUX_W,
    GAP_FACTOR,
    _flax_unet,
    _unet_pair,
    narrow,
)
from test_torch_port_moe_train import (
    _batch,
    _entry_floor,
    _from_flax64,
    _grad_recorder,
    _port_train,
    from_the_bottleneck,
)


def _jax_bf16_train(per_vertex, x, y):
    """JAX's step with its UnetModel in bf16 (parameters float32): the loss
    and the gradient (float64 arrays, the port's names)."""
    fmodel, variables = _flax_unet(per_vertex)
    fmodel = fmodel.clone(dtype=jnp.bfloat16)
    tx = _grad_recorder()
    step = jax.jit(jtrainer.make_gat_train_step(fmodel, tx,
                                                moe_aux_weight=AUX_W))
    new, logs = step(JaxNetState(params=variables["params"],
                                 batch_stats=variables["batch_stats"],
                                 opt_state=tx.init(variables["params"])),
                     jnp.asarray(x), jnp.asarray(y), jnp.ones(len(x)),
                     jax.random.PRNGKey(0))
    return float(logs["loss"]), _from_flax64(jax.device_get(new.opt_state))


def _port_bf16_train(per_vertex, x, y):
    _, _, model = _unet_pair(per_vertex, torch.bfloat16)
    opt = torch.optim.SGD(model.parameters(), lr=0.0)
    step = gat_trainer.make_gat_train_step(model, opt, moe_aux_weight=AUX_W)
    loss, _ = step(*(torch.from_numpy(a)
                     for a in (x, y, np.ones(len(x), np.float32))))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    return loss.item(), {k: p.grad.double().numpy()
                         for k, p in model.named_parameters()}


@pytest.mark.parametrize("per_vertex", [False, True],
                         ids=["default", "per_vertex_bn"])
def test_moe_bf16_train_step_matches_jax(per_vertex, narrow):
    """The module docstring's rule."""
    x, y = _batch()
    l64, g64 = _port_train(per_vertex, x, y, dtype=torch.float64)
    j_loss, j_grads = _jax_bf16_train(per_vertex, x, y)
    p_loss, p_grads = _port_bf16_train(per_vertex, x, y)
    assert abs(p_loss - l64) <= GAP_FACTOR * abs(j_loss - l64), \
        (p_loss, j_loss, l64)
    sound = [k for k in g64 if per_vertex or from_the_bottleneck(k)]
    assert sum(".moe." in k for k in sound) == 5
    floor = _entry_floor(g64)

    def error(grads):
        return np.sqrt(np.mean([
            np.mean((grads[k] - g64[k]) ** 2)
            / max(np.abs(g64[k]).max(), floor) ** 2 for k in sound]))
    assert error(p_grads) <= GAP_FACTOR * error(j_grads), \
        (error(p_grads), error(j_grads))
