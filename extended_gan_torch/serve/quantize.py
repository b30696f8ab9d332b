"""Post-training int8 quantisation for serving (port of
``extended_gan_tpu/serve/quantize.py``).

The same pipeline, functions and meta dicts as the JAX package's:

1. :func:`fold_generator_bn` folds inference BatchNorm into the DCGAN
   generator's convs (f32 algebra), leaving five conv + activation layers.
2. Kernels are quantised per output channel, symmetric int8 (scale =
   absmax / 127); in ``w8a8`` mode the activations per tensor too, with
   static scales calibrated on a representative batch
   (:func:`calibrate_activation_scales`).
3. ``w8`` stores int8 kernels and dequantises them once, when the forward
   is built (the JAX package dequantises inside its compiled forward: the
   same arithmetic); ``w8a8`` multiplies int8 by int8 with exact int32
   accumulation (``ops/int8_conv.py``).

:func:`make_w8_apply` is the generic weight-only path of the GAT and UNet
families. It quantises the leaves that the JAX package quantises, flax's
``kernel`` and ``W`` with two or more axes, which in the port's state_dict
are a conv's ``weight`` (OIHW behind any head axis, so the output channel
sits at ``ndim - 4``), a Linear's ``weight`` (output channel first) and the
GAT ``W`` (flax's layout, output channel last). Biases, BatchNorm, the
attention vectors ``a``, the adjacency ``B`` and the SmaAt-UNet's
``depthwise_kernel`` and ``pointwise_kernel`` stay f32, as in JAX. Scales
are grouped as JAX groups them: one for each output channel, shared across
a vmapped head axis.

Layouts at these functions are the JAX package's: the generator's
activations NHWC and its folded kernels HWIO.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.int8_conv import int8_conv2d

_BN_EPS = 1e-5  # torch.nn.BatchNorm2d's, as the JAX package's TorchBatchNorm

_ACTS = {"relu": torch.relu, "sigmoid": torch.sigmoid}


def fold_generator_bn(state_dict: dict) -> list:
    """Fold inference-mode BatchNorm into the conv layers of the port's
    ``Generator`` state_dict.

    Returns ``[(kernel, bias, act), ...]`` in layer order (the
    ``ConvBlock_{i}`` suffix): ``kernel`` f32 (kh, kw, cin, cout), ``bias``
    f32 (cout,), and ``act(conv(x, kernel) + bias)`` layer by layer equals
    the generator's eval forward (BN with running statistics is the affine
    ``(x - mean) * gamma / sqrt(var + eps) + beta``). The last block gets
    sigmoid, the others relu."""
    blocks: dict[int, dict] = {}
    for key, value in state_dict.items():
        block, rest = key.split(".", 1)  # "ConvBlock_{i}", "Conv_0.weight"
        blocks.setdefault(int(block.rsplit("_", 1)[1]), {})[rest] = value
    layers = []
    order = sorted(blocks)
    for i in order:
        blk = blocks[i]
        k = blk["Conv_0.weight"].float().permute(2, 3, 1, 0)  # OIHW -> HWIO
        b = blk.get("Conv_0.bias")
        b = (torch.zeros(k.shape[-1], device=k.device) if b is None
             else b.float())
        if "BatchNorm_0.weight" in blk:
            inv = blk["BatchNorm_0.weight"].float() * torch.rsqrt(
                blk["BatchNorm_0.running_var"].float() + _BN_EPS)
            k = k * inv  # broadcasts over the cout axis
            b = (b - blk["BatchNorm_0.running_mean"].float()) * inv + \
                blk["BatchNorm_0.bias"].float()
        act = "sigmoid" if i == order[-1] else "relu"
        layers.append((k.contiguous(), b, act))
    return layers


def _f32(x, device) -> torch.Tensor:
    """A tensor or an array (copied: numpy's may be read-only) as f32 on
    ``device``."""
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.array(x, np.float32))
    return x.to(device, torch.float32)


def _same_pad(kernel: torch.Tensor) -> tuple[int, int, int, int]:
    """F.pad widths of XLA's SAME for a stride-1 HWIO kernel: (k - 1) // 2
    before and k // 2 after (1 and 2 for 4x4)."""
    kh, kw = kernel.shape[:2]
    return ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2)


def _conv_nchw(h: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    return F.conv2d(F.pad(h, _same_pad(kernel)), kernel.permute(3, 2, 0, 1))


def folded_apply(layers: Sequence, x, dtype: Any = torch.float32,
                 on_input: Callable | None = None) -> torch.Tensor:
    """Run the folded layers on NHWC ``x``: the quantisation-free oracle.

    ``dtype`` sets the compute dtype (bf16 for the half-precision serving
    variant); the result is f32 NHWC. ``on_input`` is called with each
    layer's input (an NHWC view) before the conv: the one hook that
    calibration and any consumer of intermediate statistics share."""
    device = layers[0][0].device
    h = _f32(x, device).to(dtype).permute(0, 3, 1, 2)
    for k, b, act in layers:
        if on_input is not None:
            on_input(h.permute(0, 2, 3, 1))
        h = _conv_nchw(h, k.to(dtype))
        h = _ACTS[act](h + b.to(dtype)[:, None, None])
    return h.permute(0, 2, 3, 1).float()


def quantize_weight_int8(k: torch.Tensor, *,
                         keep_leading: bool = False) -> tuple:
    """Per-out-channel symmetric int8 (the output channel is the last
    axis): ``k ~= q * scale`` with ``q`` int8 in [-127, 127] and ``scale``
    f32 (cout,).

    ``keep_leading=True`` (stacked expert weights, (E, ..., cout)): one
    scale per (expert, out-channel), stored broadcast-ready as
    (E, 1, ..., cout)."""
    k = k.float()
    first = 1 if keep_leading else 0
    amax = k.abs().amax(dim=tuple(range(first, k.dim() - 1)))
    # divide by a tensor on amax's device: the card multiplies by the
    # reciprocal of a host float, which can round otherwise than XLA
    scale = torch.where(amax > 0, amax / amax.new_tensor(127.0),
                        torch.ones_like(amax))
    if keep_leading:
        scale = scale.reshape((k.shape[0],) + (1,) * (k.dim() - 2)
                              + (k.shape[-1],))
    q = torch.clamp(torch.round(k / scale), -127, 127).to(torch.int8)
    return q, scale


def calibrate_activation_scales(layers: Sequence, calib_x) -> list[float]:
    """Per-tensor absmax / 127 of each layer's input on a representative
    batch, from the folded f32 forward (host floats). Symmetric, as in the
    JAX package, though every folded-generator activation is
    non-negative."""
    scales = []

    def record(h):
        amax = float(h.abs().max())
        scales.append(max(amax, 1e-8) / 127.0)

    folded_apply(layers, calib_x, on_input=record)
    return scales


_W8_LEAF_NAMES = ("weight", "W")  # flax kernel (conv and Dense) and GAT W


def _w8_out_axis(key: str, a: torch.Tensor) -> int | None:
    """The output-channel axis of a leaf :func:`make_w8_apply` quantises,
    or None for one it keeps f32."""
    name = key.rsplit(".", 1)[-1]
    if name not in _W8_LEAF_NAMES or a.dim() < 2 or \
            not a.is_floating_point():
        return None
    if name == "W":
        return a.dim() - 1
    return 0 if a.dim() == 2 else a.dim() - 4  # Linear; conv (heads, O, ...)


def quantize_state_dict_w8(state_dict: dict) -> tuple[dict, dict]:
    """The weight-only int8 form of a state_dict: each quantised leaf
    becomes ``{"q": int8, "scale": f32}`` (the scale broadcast-ready, one
    value an output channel), every other entry stays as it is. Returns
    ``(packed, meta)``."""
    packed, n_q, bytes_q, bytes_f32 = {}, 0, 0, 0
    for key, a in state_dict.items():
        axis = _w8_out_axis(key, a)
        if axis is None:
            packed[key] = a
            continue
        q, s = quantize_weight_int8(a.movedim(axis, -1))
        shape = [1] * a.dim()
        shape[axis] = s.numel()
        packed[key] = {"q": q.movedim(-1, axis).contiguous(),
                       "scale": s.reshape(shape)}
        n_q += 1
        bytes_q += q.numel() + s.numel() * 4
        bytes_f32 += a.numel() * 4
    meta = {"quantize": "w8", "quantized_leaves": n_q,
            "weight_bytes_int8": int(bytes_q),
            "weight_bytes_f32": int(bytes_f32)}
    return packed, meta


def dequantize_state_dict(packed: dict) -> dict:
    """``q * scale`` in f32 for each int8 leaf of :func:`quantize_state_dict_w8`."""
    return {k: v["q"].float() * v["scale"] if isinstance(v, dict) else v
            for k, v in packed.items()}


def make_w8_apply(apply_fn: Callable, state_dict: dict
                  ) -> tuple[Callable, dict]:
    """Generic weight-only int8 for any model (the path of the GAT and UNet
    families). ``apply_fn(state_dict, x)`` is the model's inference
    closure (``torch.func.functional_call`` of an eval-mode module, say).
    The kernels are quantised and dequantised once, here. Returns
    ``(fwd, meta)``."""
    packed, meta = quantize_state_dict_w8(state_dict)
    weights = dequantize_state_dict(packed)

    def fwd(x):
        return apply_fn(weights, x)

    return fwd, meta


def quantize_generator(state_dict: dict, mode: str = "w8", calib_x=None,
                       reference_apply: Callable | None = None
                       ) -> tuple[dict, dict]:
    """The int8 form of a ``Generator`` state_dict: ``({"mode", "layers":
    [{"q", "scale", "bias", "act"}], "activation_scales"?}, meta)``, on the
    state_dict's device. :func:`make_quantized_generator` documents the
    arguments."""
    if mode not in ("w8", "w8a8"):
        raise ValueError(f"unknown quantization mode {mode!r}")
    layers = fold_generator_bn(state_dict)
    device = layers[0][0].device
    if reference_apply is not None:
        # guard the by-convention fold (block order, act by position, eps,
        # stride) against model drift: every later check compares the
        # folded forward with itself
        probe = (_f32(calib_x[:2], device)
                 if calib_x is not None
                 else torch.full((1, 8, 8, layers[0][0].shape[2]), 0.5,
                                 device=device))
        drift = float((folded_apply(layers, probe)
                       - reference_apply(probe)).abs().max())
        if drift > 1e-3:
            raise ValueError(
                f"BN fold diverges from the reference apply (max err "
                f"{drift:.2e}); the Generator structure no longer matches "
                f"fold_generator_bn's conventions")
    qlayers = []
    for k, b, act in layers:
        q, s = quantize_weight_int8(k)
        qlayers.append({"q": q, "scale": s, "bias": b, "act": act})
    state = {"mode": mode, "layers": qlayers}
    meta = {"quantize": mode, "n_layers": len(qlayers)}
    if mode == "w8a8":
        if calib_x is None:
            raise ValueError("w8a8 needs calib_x (a representative batch) "
                             "for static activation scales")
        a_scales = calibrate_activation_scales(layers, calib_x)
        state["activation_scales"] = a_scales
        meta["activation_scales"] = [float(s) for s in a_scales]
    return state, meta


def quantize_activation(h: torch.Tensor, s_a: torch.Tensor) -> torch.Tensor:
    """round(h / s_a) clipped to [-127, 127], int8. ``s_a`` is an f32
    tensor on ``h``'s device, so the card divides (with a host float it
    would multiply by the reciprocal, which rounds otherwise); round is
    half to even, as jnp.round."""
    return torch.clamp(torch.round(h / s_a), -127, 127).to(torch.int8)


def w8a8_layers(state: dict, device) -> list:
    """Each w8a8 layer as (q, s_a, s_w * s_a, bias, act) on ``device``."""
    out = []
    for layer, s in zip(state["layers"], state["activation_scales"]):
        s_a = torch.tensor(s, dtype=torch.float32, device=device)
        out.append((layer["q"].to(device), s_a,
                    layer["scale"].to(device) * s_a,
                    layer["bias"].to(device), layer["act"]))
    return out


def w8a8_layer(h: torch.Tensor, layer: tuple) -> tuple:
    """One w8a8 layer on NHWC f32 ``h``: (the int8 input, the int32
    accumulators, the layer's f32 output)."""
    q, s_a, s_out, b, act = layer
    xi = quantize_activation(h, s_a)
    acc = int8_conv2d(xi, q)
    return xi, acc, _ACTS[act](acc.float() * s_out + b)


def generator_apply(state: dict, device=None,
                    compute_dtype: Any = torch.float32) -> Callable:
    """The forward of :func:`quantize_generator`'s state on ``device``
    (default: where the state lies), NHWC f32 in and out."""
    device = device or state["layers"][0]["q"].device
    if state["mode"] == "w8":
        layers = [((l["q"].float() * l["scale"]).to(device),
                   l["bias"].to(device), l["act"]) for l in state["layers"]]
        return lambda x: folded_apply(layers, x, dtype=compute_dtype)
    layers = w8a8_layers(state, device)

    def fwd(x):
        h = _f32(x, device)
        for layer in layers:
            h = w8a8_layer(h, layer)[2]
        return h

    return fwd


def make_quantized_generator(
    state_dict: dict,
    mode: str = "w8",
    calib_x=None,
    compute_dtype: Any = torch.float32,
    reference_apply: Callable | None = None,
) -> tuple[Callable, dict]:
    """Build the quantised inference forward of a ``Generator`` state_dict.

    Returns ``(fwd, meta)``; ``fwd`` maps NHWC f32 to NHWC f32.

    ``mode="w8"``: weight-only, int8 kernels dequantised to
    ``compute_dtype``. ``mode="w8a8"``: int8 convs with int32
    accumulation; needs ``calib_x`` (a representative NHWC batch) for the
    static per-tensor activation scales. ``reference_apply`` (the
    generator's own NHWC forward) guards the BN fold: a gap above 1e-3
    raises."""
    state, meta = quantize_generator(state_dict, mode, calib_x,
                                     reference_apply)
    return generator_apply(state, compute_dtype=compute_dtype), meta
