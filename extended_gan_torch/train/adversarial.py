"""The vanilla GAN's train step (port of the vanilla half of
``extended_gan_tpu/train/adversarial.py``).

The reference's order (``gan_examples/vanilla_gan.py:163-188``): G updates
first, against the current D; D then updates on the real batch and on the
pre-update G's images, detached.

``fused_prop=True`` (FusedProp, arxiv 2004.03335) runs the fake batch's
G -> D chain once and pulls two cotangents back through it: the G loss's
(BCE against 1) for G's gradients, and the D-fake loss's (BCE against 0,
over 2) for D's. Both losses see the same pre-update D at the same fake
batch and the vanilla D holds no state, so this is the default step's math
reassociated. JAX pulls both in one vmapped backward; the port makes two
pulls with ``retain_graph``, each asking autograd for the leaves it needs:
the first for G's parameters (through D's input gradients), the second for
D's parameters (which stops at D). ``is_grads_batched=True`` would push
both cotangents through both nets under ``vmap``, twice the work of the
pulls it replaces, for gradients the step throws away.
"""

from __future__ import annotations

import torch

from .losses import bce


def apply_eval(model, *args):
    """``model(*args)`` in eval mode, without gradients."""
    model.eval()
    with torch.no_grad():
        return model(*args)


def _set_grads(params, grads):
    for p, g in zip(params, grads):
        p.grad = g


def fused_prop_grads(p_fake, g_params, d_params, **mean):
    """FusedProp's two pulls back from ``p_fake = D(G(z))``: G's gradients
    of the G loss (BCE against 1) and D's of the D-fake loss (BCE against
    0, over 2), the two losses' cotangents at ``p_fake`` taken as JAX's
    ``jax.grad`` takes them. ``mean``: :func:`losses.bce`'s ``mask`` and
    ``count``."""
    p = p_fake.detach().requires_grad_()
    (ct_g,) = torch.autograd.grad(bce(p, 1.0, **mean), p)
    (ct_d,) = torch.autograd.grad(bce(p, 0.0, **mean) / 2.0, p)
    g_grads = torch.autograd.grad(p_fake, g_params, ct_g, retain_graph=True)
    return g_grads, torch.autograd.grad(p_fake, d_params, ct_d)


def make_vanilla_gan_step(g, d, g_opt, d_opt, *, latent_dim: int,
                          fused_prop: bool = False, generator=None,
                          axis=None):
    """``step(real, z=None, n=None) -> {"g_loss", "d_loss"}`` (device
    tensors): one G then D update on a (B, C, H, W) batch of real images.
    Without ``z`` the step draws z ~ N(0, 1), (B, latent_dim), from
    ``generator`` (a ``torch.Generator`` on the batch's device; None:
    torch's default).

    With a data ``axis`` of more than one rank (G's BatchNorm attached to it
    by ``parallel.attach_data_axis``), ``real`` is this rank's rows of a
    global batch of ``n`` (default: this rank's times the axis size): z is
    this rank's rows of the global batch's draw, each loss is a mean over
    the global batch, and G's and D's gradients (each with its loss) are
    summed over the ranks in one flat all-reduce before their Adam step, as
    JAX's psum over its all-devices mesh. The returned losses are the
    global ones."""
    g_params, d_params = list(g.parameters()), list(d.parameters())
    dp = axis is not None and axis.parallel

    def step(real, z=None, n=None):
        g.train()
        d.train()
        mean = {}
        if dp:
            n = len(real) * axis.size if n is None else n
            mean = dict(mask=real.new_ones(len(real)),
                        count=real.new_tensor(float(n)))
        if z is None:
            def draw(rows):  # float32 draws, in the batch's dtype
                return torch.randn(rows, latent_dim, device=real.device,
                                   generator=generator).to(real.dtype)
            if dp:
                with axis.global_batch(n):
                    z = axis.draw_rows(draw)
            else:
                z = draw(real.shape[0])

        def reduced(params, loss):
            return axis.all_reduce_grads(params, loss) if dp else loss

        gen = g(z)
        p_fake = d(gen)
        g_loss = bce(p_fake, 1.0, **mean)
        if fused_prop:
            g_grads, d_fake_grads = fused_prop_grads(p_fake, g_params,
                                                     d_params, **mean)
            _set_grads(g_params, g_grads)
            g_loss = reduced(g_params, g_loss.detach())
            g_opt.step()
            d_opt.zero_grad(set_to_none=True)
            d_real = bce(d(real), 1.0, **mean) / 2.0
            d_real.backward()
            for param, grad in zip(d_params, d_fake_grads):
                param.grad += grad
            d_loss = reduced(d_params, d_real.detach()
                             + bce(p_fake.detach(), 0.0, **mean) / 2.0)
            d_opt.step()
            return {"g_loss": g_loss, "d_loss": d_loss}
        _set_grads(g_params, torch.autograd.grad(g_loss, g_params))
        g_loss = reduced(g_params, g_loss.detach())
        g_opt.step()
        d_opt.zero_grad(set_to_none=True)
        d_loss = (bce(d(real), 1.0, **mean)
                  + bce(d(gen.detach()), 0.0, **mean)) / 2.0
        d_loss.backward()
        d_loss = reduced(d_params, d_loss.detach())
        d_opt.step()
        return {"g_loss": g_loss, "d_loss": d_loss}

    return step


def make_sampler(g):
    """``sample(z)``: the generator in eval mode (BatchNorm's running
    statistics), without gradients."""
    return lambda z: apply_eval(g, z)
