"""HNeRV-Boost building blocks in PyTorch (port of the parts of
boosting_nerv_tpu/models/blocks.py that HNeRV-Boost uses).

Modules run NCHW inside; the model's public tensors keep the JAX layout
(see models/hnerv.py).  Conv and Linear layers use torch's default init,
which is the distribution the JAX package reproduces
(``models/initializers.py``: U(+-1/sqrt(fan_in)) for weights and biases);
ConvNeXt layers use trunc_normal(0.02) and zero biases.  ``init_weights``
draws all of them from one explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.activations import get_activation


class TConv(nn.Conv2d):
    """Square conv with integer symmetric padding and torch-default init."""

    def __init__(self, in_ch: int, features: int, kernel: int, stride: int = 1,
                 pad: int = 0, use_bias: bool = True, groups: int = 1):
        super().__init__(in_ch, features, kernel, stride=stride, padding=pad,
                         groups=groups, bias=use_bias)


class TDense(nn.Linear):
    """Dense layer with torch-default init."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True):
        super().__init__(in_features, features, bias=use_bias)


class MLP(nn.Module):
    """Dense stack; ``act`` after every layer, the last included
    (NeRV_MLP semantics)."""

    def __init__(self, in_dim: int, dims: Sequence[int], act: str = "relu"):
        super().__init__()
        self.act = get_activation(act)
        ins = [in_dim, *dims[:-1]]
        self.layers = nn.ModuleList(TDense(i, d) for i, d in zip(ins, dims))

    def forward(self, x):
        for layer in self.layers:
            x = self.act(layer(x))
        return x


class UpConv(nn.Module):
    """``pshuffel_3x3`` upsampling conv: conv (kernel clamped to 3) ->
    PixelShuffle(strd), torch channel order."""

    def __init__(self, conv_type: str, ngf: int, new_ngf: int, ks: int,
                 strd: int):
        super().__init__()
        if conv_type != "pshuffel_3x3":
            raise NotImplementedError(
                f"UpConv {conv_type!r} is not ported yet (ROADMAP queue 1: "
                "other model families)")
        ks = min(ks, 3)
        self.strd = strd
        self.conv = TConv(ngf, new_ngf * strd * strd, ks, 1, (ks - 1) // 2)

    def forward(self, x):
        return F.pixel_shuffle(self.conv(x), self.strd)


class DownConv(nn.Module):
    """``conv`` downsampling conv: kernel ks+strd, stride strd,
    pad ceil(ks/2).  HNeRV-Boost's decoder stem is this with ks=0, strd=1:
    a 1x1 conv."""

    def __init__(self, conv_type: str, ngf: int, new_ngf: int, ks: int,
                 strd: int):
        super().__init__()
        if conv_type != "conv":
            raise NotImplementedError(
                f"DownConv {conv_type!r} is not ported yet (ROADMAP queue 1: "
                "other model families)")
        self.conv = TConv(ngf, new_ngf, ks + strd, strd, math.ceil(ks / 2))

    def forward(self, x):
        return self.conv(x)


class SFTLayer(nn.Module):
    """Temporal-aware affine transform x * (scale(t) + 1) + shift(t), with
    scale = scale_out(act(scale_in(cond))) and likewise for shift.  (The
    flax module numbers these TDense_0 = scale_out, TDense_1 = scale_in,
    TDense_2 = shift_out, TDense_3 = shift_in.)"""

    def __init__(self, cond_ch: int, out_ch: int, factor: int = 1,
                 act: str = "relu"):
        super().__init__()
        self.act = get_activation(act)
        self.scale_in = TDense(cond_ch, cond_ch // factor)
        self.scale_out = TDense(cond_ch // factor, out_ch)
        self.shift_in = TDense(cond_ch, cond_ch // factor)
        self.shift_out = TDense(cond_ch // factor, out_ch)

    def vectors(self, cond):
        """cond [B, cond_ch] -> (scale, shift), each [B, out_ch]."""
        return (self.scale_out(self.act(self.scale_in(cond))),
                self.shift_out(self.act(self.shift_in(cond))))

    def forward(self, x, cond):
        scale, shift = self.vectors(cond)
        return x * (scale[:, :, None, None] + 1.0) + shift[:, :, None, None]


class ResBlockSFT(nn.Module):
    """SFT -> conv3x3 -> gelu -> SFT -> conv3x3, residual add; relu inside
    the SFTs."""

    def __init__(self, cond_ch: int, ch: int, in_act: str = "relu",
                 out_act: str = "gelu"):
        super().__init__()
        self.act = get_activation(out_act)
        self.sft0 = SFTLayer(cond_ch, ch, act=in_act)
        self.conv0 = TConv(ch, ch, 3, 1, 1)
        self.sft1 = SFTLayer(cond_ch, ch, act=in_act)
        self.conv1 = TConv(ch, ch, 3, 1, 1)

    def forward(self, x, cond):
        fea = self.act(self.conv0(self.sft0(x, cond)))
        fea = self.conv1(self.sft1(fea, cond))
        return x + fea


class NeRVBlock(nn.Module):
    """Upsample (decoder) or downsample (stem) conv -> activation ->
    optional TAT block.  Only norm 'none' is ported (every Boost config)."""

    def __init__(self, dec_block: bool, conv_type: str, ngf: int,
                 new_ngf: int, ks: int, strd: int, norm: str = "none",
                 act: str = "gelu", cond_ch: int = 0):
        super().__init__()
        if norm != "none":
            raise NotImplementedError(
                f"norm {norm!r} is not ported yet (ROADMAP queue 1: other "
                "model families)")
        conv_cls = UpConv if dec_block else DownConv
        self.conv = conv_cls(conv_type, ngf, new_ngf, ks, strd)
        self.act = get_activation(act)
        self.rsft = ResBlockSFT(cond_ch, new_ngf) if cond_ch else None

    def forward(self, x, t_embed=None):
        y = self.act(self.conv(x))
        if self.rsft is None or t_embed is None:
            return y
        return self.rsft(y, t_embed)


def _layer_norm_channels(norm: nn.LayerNorm, x):
    """LayerNorm over the channels of an NCHW tensor."""
    return norm(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class ConvNeXtBlock(nn.Module):
    """dwconv7x7 -> LN -> 4x MLP (exact GELU) -> layer-scale, residual;
    drop-path 0."""

    def __init__(self, dim: int, layer_scale_init_value: float = 1e-6):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.fc2 = nn.Linear(4 * dim, dim)
        self.gamma = (nn.Parameter(torch.full((dim,), layer_scale_init_value))
                      if layer_scale_init_value > 0 else None)

    def forward(self, x):
        y = self.norm(self.dwconv(x).permute(0, 2, 3, 1))
        y = self.fc2(F.gelu(self.fc1(y)))
        if self.gamma is not None:
            y = self.gamma * y
        return x + y.permute(0, 3, 1, 2)


class ConvNeXtEncoder(nn.Module):
    """Stride-configurable ConvNeXt content encoder.  Stage i downsamples
    with a strd x strd conv (stage 0: conv then LN; later stages: LN then
    conv) followed by ``stage_blocks`` ConvNeXt blocks.  ``convs``,
    ``norms`` and ``blocks`` are numbered as the flax module numbers them."""

    def __init__(self, in_ch: int, stage_blocks: int, strds: Sequence[int],
                 dims: Sequence[int]):
        super().__init__()
        ins = [in_ch, *dims[:-1]]
        self.strds = list(strds)
        self.stage_blocks = stage_blocks
        self.convs = nn.ModuleList(nn.Conv2d(i, d, s, stride=s)
                                   for i, d, s in zip(ins, dims, strds))
        self.norms = nn.ModuleList(
            nn.LayerNorm(d if k == 0 else i, eps=1e-6)
            for k, (i, d) in enumerate(zip(ins, dims)))
        self.blocks = nn.ModuleList(ConvNeXtBlock(d) for d in dims
                                    for _ in range(stage_blocks))

    def forward(self, x):
        for i in range(len(self.strds)):
            if i == 0:
                x = _layer_norm_channels(self.norms[i], self.convs[i](x))
            else:
                x = self.convs[i](_layer_norm_channels(self.norms[i], x))
            for blk in self.blocks[i * self.stage_blocks:
                                   (i + 1) * self.stage_blocks]:
                x = blk(x)
        return x


def _trunc_normal_(t: torch.Tensor, std: float, g: torch.Generator):
    """N(0, std) truncated at +-2 std (timm's trunc_normal_), by inverse
    CDF from uniforms drawn with ``g``."""
    with torch.no_grad():
        lo, hi = (1.0 + math.erf(-2.0 / math.sqrt(2.0))) / 2.0, \
            (1.0 + math.erf(2.0 / math.sqrt(2.0))) / 2.0
        t.uniform_(2 * lo - 1, 2 * hi - 1, generator=g)
        t.erfinv_().mul_(std * math.sqrt(2.0)).clamp_(-2 * std, 2 * std)


def init_weights(module: nn.Module, g: torch.Generator) -> None:
    """Re-draw every parameter of ``module`` from ``g``: torch-default
    U(+-1/sqrt(fan_in)) for TConv/TDense, trunc_normal(0.02) and zero bias
    for the ConvNeXt encoder's convs and dense layers, LayerNorm 1/0, and
    layer-scale gamma 1e-6."""
    convnext = set()
    for m in module.modules():
        if isinstance(m, ConvNeXtEncoder):
            convnext.update(id(c) for c in m.modules())
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                if id(m) in convnext:
                    _trunc_normal_(m.weight, 0.02, g)
                    m.bias.zero_()
                    continue
                fan_in = m.weight[0].numel()
                bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
                m.weight.uniform_(-bound, bound, generator=g)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=g)
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, ConvNeXtBlock) and m.gamma is not None:
                m.gamma.fill_(1e-6)
