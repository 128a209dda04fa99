"""Model building blocks in PyTorch (port of
boosting_nerv_tpu/models/blocks.py): every block of the five model
families.

Modules run NCHW inside; the models' public tensors keep the JAX layout
(see models/hnerv.py).  Conv and Linear layers use torch's default init,
which is the distribution the JAX package reproduces
(``models/initializers.py``: U(+-1/sqrt(fan_in)) for weights and biases;
a transposed conv's fan_in is its input channels times its taps, as
there); ConvNeXt layers use trunc_normal(0.02) and zero biases.
``init_weights`` draws all of them from one explicit ``torch.Generator``.

Split forms (the mesh's 'spatial' axis, ``parallel/spatial.py``): a block
that a row-split map runs through has one body, ``forward_rows(x, split,
rows, ...)``, taking whether ``x`` is split and returning (the result,
whether it is split); ``rows`` (a ``parallel.spatial.Rows``) does the
halos and moves maps between whole and split by its plan.  The stride-1
convs receive their halo; PixelShuffle, SFT, LayerNorm over the channels
and the activations are local; 'in' / 'bn' sum their moments over the
ranks; ConvNeXt's patchify convs run local where the stride divides a
shard's rows; every other layer runs on the gathered map.  ``forward`` is
``forward_rows`` under ``WHOLE`` (sp 1, no groups), where each of those
steps is the plain layer: the unsplit forward, with the same modules and
parameters.

Where a block rearranges channels its torch channel order is torch's own:
``UpConv``'s PixelShuffle and ``DownConv``'s PixelUnshuffle pack the
r x r block positions inside each channel, (c, r1, r2), where the JAX
package packs them outside, (r1, r2, c); ``bridge.py`` reorders the convs'
output (or input) channels once when flax weights are loaded.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.activations import get_activation
from ..parallel.spatial import WHOLE


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


def _resize_weights(n_in: int, n_out: int) -> torch.Tensor:
    """[n_out, n_in] float32 weights of ``jax.image.resize``'s "bilinear"
    along one axis (jax/_src/image/scale.py::compute_weight_mat): half-pixel
    centres, the triangle kernel widened by the downsampling factor
    (antialias), each output's weights normalised to sum 1."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float64) + 0.5) * inv_scale \
        - 0.5
    x = (sample[:, None] - torch.arange(n_in, dtype=torch.float64)[None, :]
         ).abs() / kernel_scale
    w = (1.0 - x).clamp(min=0.0)
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[:, None], w, 0.0).to(torch.float32)


def resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """NCHW x resized to h x w as ``jax.image.resize(..., "bilinear")``
    resizes NHWC (antialiased when it downsamples)."""
    wy = _resize_weights(x.shape[2], h).to(x.device, x.dtype)
    wx = _resize_weights(x.shape[3], w).to(x.device, x.dtype)
    return torch.einsum("nchw,yh,xw->ncyx", x, wy, wx)


class TConvTranspose(nn.ConvTranspose2d):
    """Transposed conv with torch ConvTranspose2d geometry, out = (in - 1)
    * stride - 2 * pad + kernel (the flax module applies its (k, k, in,
    out) kernel flipped to the stride-dilated input: the same function,
    whose torch weight is ``kernel.transpose(2, 3, 0, 1)``)."""

    def __init__(self, in_ch: int, features: int, kernel: int, stride: int,
                 pad: int):
        super().__init__(in_ch, features, kernel, stride=stride, padding=pad)


class UpConv(nn.Module):
    """Upsampling conv.  ``pshuffel`` / ``pshuffel_3x3`` (kernel clamped
    to 3; every Boost config): conv -> PixelShuffle(strd), torch channel
    order; ``conv``: the transposed conv of kernel ks + strd, stride strd,
    pad ceil(ks / 2); ``interpolate``: bilinear upsampling by strd, then a
    conv of kernel strd + ks, pad ceil((ks + strd - 1) / 2)."""

    def __init__(self, conv_type: str, ngf: int, new_ngf: int, ks: int,
                 strd: int):
        super().__init__()
        self.conv_type, self.strd = conv_type, strd
        if conv_type in ("pshuffel", "pshuffel_3x3"):
            if conv_type == "pshuffel_3x3":
                ks = min(ks, 3)
            self.conv = TConv(ngf, new_ngf * strd * strd, ks, 1,
                              (ks - 1) // 2)
        elif conv_type == "conv":
            self.conv = TConvTranspose(ngf, new_ngf, ks + strd, strd,
                                       math.ceil(ks / 2))
        elif conv_type == "interpolate":
            self.conv = TConv(ngf, new_ngf, strd + ks, 1,
                              math.ceil((ks + strd - 1) / 2))
        else:
            raise KeyError(f"unknown upconv type {conv_type}")

    def forward(self, x):
        return self.forward_rows(x, False, WHOLE)[0]

    def forward_rows(self, x, split: bool, rows):
        if self.conv_type in ("conv", "interpolate"):
            return rows.whole(self._resample, x, split, "upconv")
        x, split = rows.conv(self.conv, x, split, "upconv")
        return rows.pixel_shuffle(x, self.strd, split, "upconv")

    def _resample(self, x):
        """The transposed conv, or the bilinear upsampling and its conv."""
        if self.conv_type == "conv":
            return self.conv(x)
        return self.conv(resize_bilinear(x, x.shape[2] * self.strd,
                                         x.shape[3] * self.strd))


class DownConv(nn.Module):
    """Downsampling conv.  ``conv``: kernel ks + strd, stride strd, pad
    ceil(ks / 2) (HNeRV-Boost's decoder stem is this with ks 0, strd 1: a
    1x1 conv); ``pshuffel``: PixelUnshuffle(strd), torch channel order,
    then a conv of kernel ks, pad (ks - 1) // 2; ``interpolate``: bilinear
    (antialiased) downsampling by strd, then a conv of kernel ks + strd,
    pad ceil((ks + strd - 1) / 2)."""

    def __init__(self, conv_type: str, ngf: int, new_ngf: int, ks: int,
                 strd: int):
        super().__init__()
        self.conv_type, self.strd = conv_type, strd
        if conv_type == "conv":
            self.conv = TConv(ngf, new_ngf, ks + strd, strd,
                              math.ceil(ks / 2))
        elif conv_type == "pshuffel":
            self.conv = TConv(ngf * strd * strd, new_ngf, ks, 1,
                              (ks - 1) // 2)
        elif conv_type == "interpolate":
            self.conv = TConv(ngf, new_ngf, ks + strd, 1,
                              math.ceil((ks + strd - 1) / 2))
        else:
            raise KeyError(f"unknown downconv type {conv_type}")

    def forward(self, x):
        return self.forward_rows(x, False, WHOLE)[0]

    def forward_rows(self, x, split: bool, rows):
        """"conv" by ``Rows.conv`` (HNeRV-Boost's 1x1 stem split, a
        strided one gathered); the others on the gathered map."""
        if self.conv_type == "conv":
            return rows.conv(self.conv, x, split, "downconv")
        return rows.whole(self._resample, x, split, "downconv")

    def _resample(self, x):
        """PixelUnshuffle or the antialiased downsampling, then the
        conv."""
        if self.conv_type == "pshuffel" and self.strd != 1:
            x = F.pixel_unshuffle(x, self.strd)
        elif self.conv_type == "interpolate":
            x = resize_bilinear(x, x.shape[2] // self.strd,
                                x.shape[3] // self.strd)
        return self.conv(x)


def norm_layer(norm: str, x: torch.Tensor, rows=WHOLE,
               split: bool = False) -> torch.Tensor:
    """none | in (InstanceNorm, no affine) | bn (batch-statistics norm, no
    running statistics, as the JAX package's) of NCHW x; biased variance,
    (x - mean) * rsqrt(var + 1e-5).  The moments are the whole map's and,
    for bn, the global batch's: ``rows`` sums them over its ranks
    (``Rows.normalize``) where ``x`` does not hold them all."""
    if norm == "none":
        return x
    if norm not in ("in", "bn"):
        raise NotImplementedError(norm)
    y = rows.normalize(norm, x, split)
    if y is not None:
        return y
    dims = (2, 3) if norm == "in" else (0, 2, 3)
    mean = x.mean(dim=dims, keepdim=True)
    var = x.var(dim=dims, keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + 1e-5)


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
        return self.forward_rows(x, False, WHOLE, cond)[0]

    def forward_rows(self, x, split: bool, rows, cond):
        # a map's state is its height's, which the stride-1 convs keep
        fea, _ = rows.conv(self.conv0, self.sft0(x, cond), split, "rsft")
        fea, _ = rows.conv(self.conv1, self.sft1(self.act(fea), cond), split,
                           "rsft")
        return x + fea, split


class NeRVBlock(nn.Module):
    """Upsample (decoder) or downsample (stem, encoder) conv -> norm ->
    activation -> optional TAT block (``cond_ch`` > 0).  With ``fc_hw``
    (an encoder-less stem, ``has_encoder`` False) the activation's
    channels are rearranged into an fc_h x fc_w pixel block before the TAT
    block, whose width is then new_ngf / (fc_h fc_w)."""

    def __init__(self, dec_block: bool, conv_type: str, ngf: int,
                 new_ngf: int, ks: int, strd: int, norm: str = "none",
                 act: str = "gelu", cond_ch: int = 0,
                 has_encoder: bool = True, fc_hw=None):
        super().__init__()
        if norm not in ("none", "in", "bn"):
            raise NotImplementedError(norm)
        conv_cls = UpConv if dec_block else DownConv
        self.conv = conv_cls(conv_type, ngf, new_ngf, ks, strd)
        self.norm = norm
        self.act = get_activation(act)
        self.fc_hw = (None if dec_block or has_encoder else tuple(fc_hw))
        ch = new_ngf // (self.fc_hw[0] * self.fc_hw[1]) if self.fc_hw \
            else new_ngf
        self.rsft = ResBlockSFT(cond_ch, ch) if cond_ch else None

    def forward(self, x, t_embed=None):
        return self.forward_rows(x, False, WHOLE, t_embed)[0]

    def _fc_block(self, y):
        """Channel (i fc_w + j) c' + k -> pixel (i, j), k."""
        fh, fw = self.fc_hw
        b, c, h, w = y.shape
        return y.reshape(b, fh, fw, c // (fh * fw), h, w).permute(
            0, 3, 4, 1, 5, 2).reshape(b, c // (fh * fw), h * fh, w * fw)

    def forward_rows(self, x, split: bool, rows, t_embed=None):
        y, split = self.conv.forward_rows(x, split, rows)
        y = self.act(norm_layer(self.norm, y, rows, split))
        if self.rsft is None or t_embed is None:
            return y, split
        if self.fc_hw:
            y, split = rows.whole(self._fc_block, y, split, "fc_hw")
        return self.rsft.forward_rows(y, split, rows, t_embed)


class ConvUpBlock(nn.Module):
    """E-NeRV's stage 0, a factorised conv and upsample: with ngf <=
    new_ngf an UpConv to ngf // 4 channels then a 3x3 conv to new_ngf,
    else a 3x3 conv to new_ngf then an UpConv at new_ngf; norm,
    activation, optional TAT block (``cond_ch`` > 0)."""

    def __init__(self, conv_type: str, ngf: int, new_ngf: int, ks: int,
                 strd: int, norm: str = "none", act: str = "gelu",
                 cond_ch: int = 0):
        super().__init__()
        self.up_first = ngf <= new_ngf
        if self.up_first:
            self.upconv = UpConv(conv_type, ngf, ngf // 4, ks, strd)
            self.conv = TConv(ngf // 4, new_ngf, 3, 1, 1)
        else:
            self.conv = TConv(ngf, new_ngf, 3, 1, 1)
            self.upconv = UpConv(conv_type, new_ngf, new_ngf, ks, strd)
        self.norm = norm
        self.act = get_activation(act)
        self.rsft = ResBlockSFT(cond_ch, new_ngf) if cond_ch else None

    def forward(self, x, t_embed=None):
        return self.forward_rows(x, False, WHOLE, t_embed)[0]

    def forward_rows(self, x, split: bool, rows, t_embed=None):
        if self.up_first:
            x, split = self.upconv.forward_rows(x, split, rows)
            x, split = rows.conv(self.conv, x, split, "convup")
        else:
            x, split = rows.conv(self.conv, x, split, "convup")
            x, split = self.upconv.forward_rows(x, split, rows)
        x = self.act(norm_layer(self.norm, x, rows, split))
        if self.rsft is not None and t_embed is not None:
            x, split = self.rsft.forward_rows(x, split, rows, t_embed)
        return x, split


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
        return self.forward_rows(x, False, WHOLE)[0]

    def forward_rows(self, x, split: bool, rows):
        y, _ = rows.conv(self.dwconv, x, split, "convnext")
        y = self.norm(y.permute(0, 2, 3, 1))
        y = self.fc2(F.gelu(self.fc1(y)))
        if self.gamma is not None:
            y = self.gamma * y
        return x + y.permute(0, 3, 1, 2), split


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
        return self.forward_rows(x, False, WHOLE)[0]

    def forward_rows(self, x, split: bool, rows):
        for i in range(len(self.strds)):
            if i == 0:
                x, split = rows.patchify(self.convs[i], x, split, "encoder")
                x = _layer_norm_channels(self.norms[i], x)
            else:
                x, split = rows.patchify(
                    self.convs[i], _layer_norm_channels(self.norms[i], x),
                    split, "encoder")
            for blk in self.blocks[i * self.stage_blocks:
                                   (i + 1) * self.stage_blocks]:
                x, split = blk.forward_rows(x, split, rows)
        return x, split


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
    U(+-1/sqrt(fan_in)) for TConv/TDense/TConvTranspose (fan_in of the
    last: its input channels times its taps), trunc_normal(0.02) and zero
    bias
    for the ConvNeXt encoder's convs and dense layers, LayerNorm 1/0, and
    layer-scale gamma 1e-6."""
    convnext = set()
    for m in module.modules():
        if isinstance(m, ConvNeXtEncoder):
            convnext.update(id(c) for c in m.modules())
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear, nn.ConvTranspose2d)):
                if id(m) in convnext:
                    _trunc_normal_(m.weight, 0.02, g)
                    m.bias.zero_()
                    continue
                fan_in = (m.weight[:, 0].numel()
                          if isinstance(m, nn.ConvTranspose2d)
                          else m.weight[0].numel())
                bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
                m.weight.uniform_(-bound, bound, generator=g)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=g)
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, ConvNeXtBlock) and m.gamma is not None:
                m.gamma.fill_(1e-6)
