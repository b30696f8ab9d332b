"""SmaAt-UNet (Trebing, Stanczyk, Mehrkanoon 2021).

Port of ``extended_gan_tpu/models/smaat_unet.py``: a U-Net whose double
convs are depthwise-separable and whose skip connections pass through CBAM
(channel + spatial attention); bilinear upsampling with
``align_corners=True``. At ``base=64``, ``kernels_per_layer=2`` it has the
reference's 4,032,548 parameters.

Modules take and return NCHW tensors, as torch's layers do. The
depthwise-separable convs hand the fused kernel an NHWC view of their input
(``ops/dsconv.py``, the JAX package's layout), so the activations end up in
channels-last memory and the view costs no copy after the first layer.

Parameter names follow the flax tree (``dsc0``, ``bn0``, ``cbam1.channel.fc1``,
...), so ``models/convert.py`` carries a flax tree across leaf for leaf. The
JAX package's BatchNorm (``ops/norm.py::TorchBatchNorm``) reproduces torch's
``BatchNorm2d`` with flax's momentum convention: flax 0.9 is torch 0.1, and
the spatial gate's flax 0.99 is torch 0.01.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dsconv import fused_dsconv, reference_dsc
from .gat.layers import lecun_normal_


def _conv(in_ch, out_ch, k, bias, generator):
    """flax ``nn.Conv`` init: lecun_normal kernel, zero bias."""
    conv = nn.Conv2d(in_ch, out_ch, k, padding=k // 2, bias=bias)
    lecun_normal_(conv.weight, in_ch * k * k, generator)
    if bias:
        nn.init.zeros_(conv.bias)
    return conv


def _dense(in_f, out_f, generator):
    """flax ``nn.Dense`` init: lecun_normal kernel, zero bias."""
    fc = nn.Linear(in_f, out_f)
    lecun_normal_(fc.weight, in_f, generator)
    nn.init.zeros_(fc.bias)
    return fc


class DepthwiseSeparableConv(nn.Module):
    """Depthwise 3x3 (``kernels_per_layer`` filters per input channel, +bias)
    then pointwise 1x1 (+bias). ``use_pallas`` runs the fused kernel
    (``fused_dsconv``); otherwise the plain composition runs, as the JAX
    package's ``shift_add_dsc`` path does. Weights are stored in torch's
    layouts: (C*kpl, 1, 3, 3) and (nout, C*kpl, 1, 1)."""

    def __init__(self, nin, nout, kernels_per_layer=1, use_pallas=False,
                 generator=None):
        super().__init__()
        ckpl = nin * kernels_per_layer
        self.use_pallas = use_pallas
        self.depthwise_weight = nn.Parameter(torch.empty(ckpl, 1, 3, 3))
        self.depthwise_bias = nn.Parameter(torch.zeros(ckpl))
        self.pointwise_weight = nn.Parameter(torch.empty(nout, ckpl, 1, 1))
        self.pointwise_bias = nn.Parameter(torch.zeros(nout))
        lecun_normal_(self.depthwise_weight, 9, generator)
        lecun_normal_(self.pointwise_weight, ckpl, generator)

    def forward(self, x):  # (N, C, H, W) -> (N, nout, H, W)
        dw = self.depthwise_weight[:, 0].permute(1, 2, 0).contiguous()
        pw = self.pointwise_weight[:, :, 0, 0].t().contiguous()
        fn = fused_dsconv if self.use_pallas else reference_dsc
        y = fn(x.permute(0, 2, 3, 1).contiguous(), dw, self.depthwise_bias,
               pw, self.pointwise_bias)
        return y.permute(0, 3, 1, 2)


class DoubleConvDS(nn.Module):
    def __init__(self, in_ch, out_ch, mid_ch=None, kernels_per_layer=1,
                 use_pallas=False, generator=None):
        super().__init__()
        mid_ch = mid_ch or out_ch
        self.dsc0 = DepthwiseSeparableConv(in_ch, mid_ch, kernels_per_layer,
                                           use_pallas, generator)
        self.bn0 = nn.BatchNorm2d(mid_ch, eps=1e-5, momentum=0.1)
        self.dsc1 = DepthwiseSeparableConv(mid_ch, out_ch, kernels_per_layer,
                                           use_pallas, generator)
        self.bn1 = nn.BatchNorm2d(out_ch, eps=1e-5, momentum=0.1)

    def forward(self, x):
        x = F.relu(self.bn0(self.dsc0(x)))
        return F.relu(self.bn1(self.dsc1(x)))


class ChannelAttention(nn.Module):
    """CBAM channel gate: shared MLP over avg- and max-pooled descriptors."""

    def __init__(self, ch, reduction=16, generator=None):
        super().__init__()
        hidden = max(1, ch // reduction)
        self.fc1 = _dense(ch, hidden, generator)
        self.fc2 = _dense(hidden, ch, generator)

    def forward(self, x):
        def mlp(v):
            return self.fc2(F.relu(self.fc1(v)))

        scale = torch.sigmoid(mlp(x.mean(dim=(2, 3))) + mlp(x.amax(dim=(2, 3))))
        return x * scale[:, :, None, None]


class SpatialAttention(nn.Module):
    """CBAM spatial gate: 7x7 conv over [max, mean] channel pools + BN."""

    def __init__(self, generator=None):
        super().__init__()
        self.conv = _conv(2, 1, 7, False, generator)
        self.bn = nn.BatchNorm2d(1, eps=1e-5, momentum=0.01)

    def forward(self, x):
        pooled = torch.stack([x.amax(dim=1), x.mean(dim=1)], dim=1)
        return x * torch.sigmoid(self.bn(self.conv(pooled)))


class CBAM(nn.Module):
    def __init__(self, ch, reduction=16, generator=None):
        super().__init__()
        self.channel = ChannelAttention(ch, reduction, generator)
        self.spatial = SpatialAttention(generator)

    def forward(self, x):
        return self.spatial(self.channel(x))


class DownDS(nn.Module):
    def __init__(self, in_ch, out_ch, kernels_per_layer=1, use_pallas=False,
                 generator=None):
        super().__init__()
        self.conv = DoubleConvDS(in_ch, out_ch, None, kernels_per_layer,
                                 use_pallas, generator)

    def forward(self, x):
        return self.conv(F.max_pool2d(x, 2))


class UpDS(nn.Module):
    """Bilinear x2 upsample of ``x1`` (``align_corners=True``), zero-pad to
    ``x2``'s size, concatenate ``[x2, x1]`` and double-conv."""

    def __init__(self, in1_ch, in2_ch, out_ch, kernels_per_layer=1,
                 use_pallas=False, generator=None):
        super().__init__()
        cat = in1_ch + in2_ch
        self.conv = DoubleConvDS(cat, out_ch, cat // 2, kernels_per_layer,
                                 use_pallas, generator)

    def forward(self, x1, x2):
        h, w = x1.shape[2], x1.shape[3]
        x1 = F.interpolate(x1, size=(2 * h, 2 * w), mode="bilinear",
                           align_corners=True)
        # odd-size inputs: the JAX split, the smaller half first
        dh, dw = x2.shape[2] - 2 * h, x2.shape[3] - 2 * w
        if dh or dw:
            x1 = F.pad(x1, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
        return self.conv(torch.cat([x2, x1], dim=1))


class SmaAt_UNet(nn.Module):  # noqa: N801 - the JAX package's name
    """(N, n_channels, H, W) -> (N, n_classes, H, W). H, W >= 16."""

    def __init__(self, n_channels=4, n_classes=4, kernels_per_layer=2,
                 reduction_ratio=16, base=64, use_pallas=False, moe_experts=0,
                 generator=None):
        super().__init__()
        if moe_experts:
            raise NotImplementedError(
                "the Switch-MoE bottleneck (moe_experts) is not ported yet "
                "(ROADMAP: queue 1, parallelism and MoE)")
        kw = dict(kernels_per_layer=kernels_per_layer, use_pallas=use_pallas,
                  generator=generator)
        b, r = base, reduction_ratio
        self.inc = DoubleConvDS(n_channels, b, **kw)
        self.cbam1 = CBAM(b, r, generator)
        self.down1 = DownDS(b, 2 * b, **kw)
        self.cbam2 = CBAM(2 * b, r, generator)
        self.down2 = DownDS(2 * b, 4 * b, **kw)
        self.cbam3 = CBAM(4 * b, r, generator)
        self.down3 = DownDS(4 * b, 8 * b, **kw)
        self.cbam4 = CBAM(8 * b, r, generator)
        self.down4 = DownDS(8 * b, 8 * b, **kw)  # 16b // factor, factor 2
        self.cbam5 = CBAM(8 * b, r, generator)
        self.up1 = UpDS(8 * b, 8 * b, 4 * b, **kw)
        self.up2 = UpDS(4 * b, 4 * b, 2 * b, **kw)
        self.up3 = UpDS(2 * b, 2 * b, b, **kw)
        self.up4 = UpDS(b, b, b, **kw)
        self.outc = _conv(b, n_classes, 1, True, generator)

    def forward(self, x):
        x1 = self.inc(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        x5 = self.down4(x4)
        x = self.up1(self.cbam5(x5), self.cbam4(x4))
        x = self.up2(x, self.cbam3(x3))
        x = self.up3(x, self.cbam2(x2))
        x = self.up4(x, self.cbam1(x1))
        # the 1x1 output conv as one product over channels-last x, written
        # (N, n_classes, H, W) contiguous: a GAT3D head's attention reads
        # that in place (a cuDNN conv would write channels-last)
        n, c, h, w = x.shape
        y = self.outc.weight[:, :, 0, 0] @ x.permute(0, 2, 3, 1).reshape(
            n, h * w, c).transpose(1, 2)
        return (y + self.outc.bias[:, None]).view(n, -1, h, w)


def dsc_shapes(batch=32, hw=20, vertices=6, device="cuda"):
    """(N, H, W, C, CK, Cout) of every depthwise-separable conv of one
    forward of the registry's ``unet`` (final_smaatunet's model) on
    ``batch`` windows of ``hw`` x ``hw``, in order, read off the model by
    forward pre-hooks."""
    from .registry import build_model

    model = build_model("unet", image_width=hw, image_height=hw,
                        n_vertices=vertices, mapping_type="linear",
                        use_pallas=False, device=device)
    shapes = []

    def record(mod, args):
        n, c, h, w = args[0].shape
        shapes.append((n, h, w, c, mod.depthwise_weight.shape[0],
                       mod.pointwise_weight.shape[0]))

    hooks = [m.register_forward_pre_hook(record) for m in model.modules()
             if isinstance(m, DepthwiseSeparableConv)]
    with torch.no_grad():
        model(torch.rand(batch, hw, hw, 4, vertices, device=device))
    for h in hooks:
        h.remove()
    return shapes
