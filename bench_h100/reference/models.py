"""Plain PyTorch forward passes of HNeRV-Boost and NeRV-Boost, written as
functions of a parameter dict (name -> tensor, the names of the models'
``state_dict``), so that they share no code with the program they judge.

The equations are the Boosting-NeRV paper's (arXiv:2404.06707) as the
reference repository implements them:

- PE(t) = [sin(pi 1.25^l t), cos(pi 1.25^l t)], l < levels; the bases are
  1.25^l rounded from float64 to float32, times pi, as the reference
  computes them in float32;
- an MLP applies its activation after every layer, the last included;
- SFT(x | c) = x (scale(c) + 1) + shift(c), scale = W2 relu(W1 c) + b;
- ResBlockSFT(x | c) = x + conv1(SFT1(gelu(conv0(SFT0(x | c))) | c));
- a decoder stage: conv (k x k, k = min(ks, 3)), PixelShuffle(stride), sin,
  ResBlockSFT conditioned on stem_t(PE(t));
- the head: conv, then tanh(x) / 2 + 1/2;
- HNeRV-Boost's ConvNeXt encoder: per stage a stride x stride patchify
  conv (stage 0: conv then LayerNorm; later stages: LayerNorm then conv)
  and ConvNeXt blocks (7x7 depthwise conv, LayerNorm, 4x MLP with exact
  GELU, layer scale, residual); its decoder stem is a 1x1 conv, sin and a
  ResBlockSFT; NeRV-Boost's stem is an MLP on PE(t) reshaped to the
  fc_h x fc_w grid (channels last).

``quant`` runs chosen stages with symmetric per-channel integer weights
and activations (``Quant``): the W8A8 serving rule, worked out here again
from the calibration frames, or the same at fewer bits for a control.
Tensors at the API are channels last ([B, H, W, C]), as the program's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class Stage:
    ngf: int
    new_ngf: int
    ks: int
    strd: int


def stage_plan(model: dict) -> List[Stage]:
    """The decoder's stages from the configuration's ``model`` section:
    HNeRV-Boost divides the width by ``reduce`` (rounded) at every stage,
    NeRV-Boost keeps stage 0's width and floor-divides at every stride-2
    stage; a stage of n blocks upsamples in its first; the kernel of
    stage i is min(ks1 + 2 i, ks2)."""
    _, ks1, ks2 = (int(v) for v in model["ks"].split("_"))
    hnerv = model["model"] == "HNeRV_Boost"
    plan, ngf = [], model["fc_dim"]
    for i, strd in enumerate(model["dec_strds"]):
        if hnerv:
            new = int(max(round(ngf / model["reduce"]), model["lower_width"]))
        elif i == 0:
            new = ngf
        else:
            new = int(max(ngf // (1 if strd == 1 else model["reduce"]),
                          model["lower_width"]))
        for j in range(model["dec_blks"][i]):
            plan.append(Stage(ngf, new, min(ks1 + 2 * i, ks2),
                              1 if j else strd))
            ngf = new
    return plan


def stage_heights(model: dict, plan: List[Stage]) -> List[Tuple[int, int]]:
    h, w = (int(v) for v in model["fc_hw"].split("_"))
    out = []
    for s in plan:
        h, w = h * s.strd, w * s.strd
        out.append((h, w))
    return out


def planar_tail(model: dict, plan: List[Stage], from_h: int = 200) -> int:
    """First stage of the serving decode's kernel tail: the first stride-2
    stage of a 3x3 conv whose output is ``from_h`` rows or more, from
    which every stage is a 3x3 conv of stride 1 or 2."""
    hw = stage_heights(model, plan)
    for i, s in enumerate(plan):
        if (s.strd == 2 and min(s.ks, 3) == 3 and hw[i][0] >= from_h
                and all(p.strd in (1, 2) and min(p.ks, 3) == 3
                        for p in plan[i:])):
            return i
    raise ValueError("no kernel tail in this configuration")


def w8a8_stages(model: dict, plan: List[Stage]) -> List[int]:
    """Tail stages served in int8: padded output width (to 16) a multiple
    of 32, and for a stride-2 stage the padded input width too."""
    def r16(c):
        return (c + 15) // 16 * 16
    return [i for i in range(planar_tail(model, plan), len(plan))
            if r16(plan[i].new_ngf) % 32 == 0
            and (plan[i].strd == 1 or r16(plan[i].ngf) % 32 == 0)]


def position_encoding(t: torch.Tensor, embed: str,
                      dtype=torch.float32) -> torch.Tensor:
    _, base, levels = embed.split("_")
    powers = torch.tensor([float(base) ** i for i in range(int(levels))],
                          dtype=torch.float64, device=t.device)
    vals = t[..., None].to(dtype) * (powers.to(dtype) * math.pi)
    return torch.cat([torch.sin(vals), torch.cos(vals)], dim=-1)


def _lin(x, p: Params, name: str):
    return F.linear(x, p[name + ".weight"], p[name + ".bias"])


def mlp(x, p: Params, name: str, layers: int):
    for i in range(layers):
        x = torch.sin(_lin(x, p, f"{name}.layers.{i}"))
    return x


def _sft(x, p: Params, name: str, cond):
    scale = _lin(F.relu(_lin(cond, p, name + ".scale_in")), p,
                 name + ".scale_out")
    shift = _lin(F.relu(_lin(cond, p, name + ".shift_in")), p,
                 name + ".shift_out")
    return x * (scale[:, :, None, None] + 1.0) + shift[:, :, None, None]


@dataclass
class Quant:
    """Low-precision stages of a decode.  Integer (``fp8`` False):
    ``stages`` run every conv on codes clip(round(x b / bound), -b, b)
    (b = 2^(bits-1) - 1, per input channel) against per-output-channel
    weight codes of the weight with the input's scale folded in.  fp8
    (e4m3): each conv input scaled per channel to +-448 at its bound and
    each weight per output channel to +-448 at its largest magnitude, both
    rounded to float8_e4m3fn.  ``bounds`` holds the per-channel |x| maxima
    at each conv input ("{stage}.x", ".t0", ".t1", ".h"), from a
    calibration pass, times ``margin``."""
    stages: Tuple[int, ...]
    bits: int = 8
    bounds: Dict[str, torch.Tensor] = field(default_factory=dict)
    margin: float = 1.05
    fp8: bool = False

    @property
    def levels(self) -> float:
        return float(2 ** (self.bits - 1) - 1)

    def conv(self, x, w, b, key, pad):
        if self.fp8:
            return self._conv_fp8(x, w, b, key, pad)
        q = self.levels
        bound = self.bounds[key]
        inv = torch.where(bound > 1e-12, q / bound.clamp_min(1e-12),
                          torch.zeros_like(bound))
        xq = torch.clamp(torch.round(x * inv[None, :, None, None]), -q, q)
        kf = w * (bound / q)[None, :, None, None]
        scale = kf.abs().amax(dim=(1, 2, 3)).clamp_min(1e-12) / q
        wq = torch.clamp(torch.round(kf / scale[:, None, None, None]), -q, q)
        return (F.conv2d(xq, wq, padding=pad) * scale[None, :, None, None]
                + b[None, :, None, None])

    def _conv_fp8(self, x, w, b, key, pad):
        def e4m3(v, scale):
            v = torch.clamp(v * scale, -448.0, 448.0)
            return v.to(torch.float8_e4m3fn).to(v.dtype) / scale

        bound = self.bounds[key].clamp_min(1e-12)
        xq = e4m3(x, (448.0 / bound)[None, :, None, None])
        wmax = w.abs().amax(dim=(1, 2, 3)).clamp_min(1e-12)
        wq = e4m3(w, (448.0 / wmax)[:, None, None, None])
        return F.conv2d(xq, wq, b, padding=pad)


class _Calib:
    """Records per-channel |x| maxima at the conv inputs of stages."""

    def __init__(self, stages):
        self.stages = set(stages)
        self.bounds: Dict[str, torch.Tensor] = {}

    def see(self, key, x):
        m = x.abs().amax(dim=(0, 2, 3))
        old = self.bounds.get(key)
        self.bounds[key] = m if old is None else torch.maximum(old, m)


def _conv(x, p, name, pad, stage=None, key=None, quant=None, calib=None):
    w, b = p[name + ".weight"], p[name + ".bias"]
    if calib is not None and stage in calib.stages:
        calib.see(f"{stage}.{key}", x)
    if quant is not None and stage in quant.stages:
        return quant.conv(x, w, b, f"{stage}.{key}", pad)
    return F.conv2d(x, w, b, padding=pad)


def _rsft(x, p, name, cond, **q):
    t0 = _sft(x, p, name + ".sft0", cond)
    a = F.gelu(_conv(t0, p, name + ".conv0", 1, key="t0", **q))
    t1 = _sft(a, p, name + ".sft1", cond)
    return x + _conv(t1, p, name + ".conv1", 1, key="t1", **q)


def decode_stages(x, t_embed, p: Params, model: dict, quant=None,
                  calib=None):
    """The decoder stages and head of NCHW ``x`` -> NHWC frame."""
    plan = stage_plan(model)
    for i, s in enumerate(plan):
        q = {"stage": i, "quant": quant, "calib": calib}
        k = min(s.ks, 3)
        y = _conv(x, p, f"blocks.{i}.conv.conv", (k - 1) // 2, key="x", **q)
        if s.strd > 1:
            y = F.pixel_shuffle(y, s.strd)
        x = _rsft(torch.sin(y), p, f"blocks.{i}.rsft", t_embed, **q)
    head = p["head.weight"]
    y = _conv(x, p, "head", head.shape[-1] // 2, stage=len(plan) - 1,
              key="h", quant=quant, calib=calib)
    return (torch.tanh(y) * 0.5 + 0.5).permute(0, 2, 3, 1)


def hnerv_decode(embed, t, p: Params, model: dict, quant=None, calib=None):
    """HNeRV-Boost: embedding [B, h, w, C] + index [B] -> [B, H, W, 3]."""
    dtype = p["head.weight"].dtype
    t_embed = mlp(position_encoding(t, model["embed"], dtype), p, "stem_t", 2)
    x = torch.sin(_conv(embed.permute(0, 3, 1, 2).to(dtype), p,
                        "stem.conv.conv", 0))
    x = _rsft(x, p, "stem.rsft", t_embed)
    return decode_stages(x, t_embed, p, model, quant, calib)


def nerv_decode(t, p: Params, model: dict, quant=None, calib=None):
    """NeRV-Boost: index [B] -> [B, H, W, 3]."""
    dtype = p["head.weight"].dtype
    pe = position_encoding(t, model["embed"], dtype)
    fh, fw = (int(v) for v in model["fc_hw"].split("_"))
    x = mlp(pe, p, "stem", 2).reshape(t.shape[0], fh, fw, -1)
    x = x.permute(0, 3, 1, 2)
    return decode_stages(x, mlp(pe, p, "stem_t", 2), p, model, quant, calib)


def _ln_channels(x, p, name):
    y = F.layer_norm(x.permute(0, 2, 3, 1), (x.shape[1],),
                     p[name + ".weight"], p[name + ".bias"], eps=1e-6)
    return y.permute(0, 3, 1, 2)


def encode(img, p: Params, model: dict):
    """ConvNeXt encoder: frame [B, H, W, 3] -> embedding [B, h, w, C]."""
    x = img.permute(0, 3, 1, 2)
    for i, s in enumerate(model["enc_strds"]):
        conv = lambda v: F.conv2d(v, p[f"encoder.convs.{i}.weight"],  # noqa
                                  p[f"encoder.convs.{i}.bias"], stride=s)
        if i == 0:
            x = _ln_channels(conv(x), p, "encoder.norms.0")
        else:
            x = conv(_ln_channels(x, p, f"encoder.norms.{i}"))
        for j in range(i * model["enc_blks"], (i + 1) * model["enc_blks"]):
            n = f"encoder.blocks.{j}"
            c = x.shape[1]
            y = F.conv2d(x, p[n + ".dwconv.weight"], p[n + ".dwconv.bias"],
                         padding=3, groups=c)
            y = F.layer_norm(y.permute(0, 2, 3, 1), (c,), p[n + ".norm.weight"],
                             p[n + ".norm.bias"], eps=1e-6)
            y = _lin(F.gelu(_lin(y, p, n + ".fc1")), p, n + ".fc2")
            x = x + (p[n + ".gamma"] * y).permute(0, 3, 1, 2)
    return x.permute(0, 2, 3, 1)


def hnerv_forward(img, t, p: Params, model: dict):
    """HNeRV-Boost's training forward: frame [B, H, W, 3] + index [B] ->
    reconstructed frame [B, H, W, 3]."""
    return hnerv_decode(encode(img, p, model), t, p, model)


def calibrate(decode, frames, stages, margin=1.05) -> Dict[str, torch.Tensor]:
    """Per-channel conv-input bounds of ``stages`` over ``frames`` (the
    arguments of ``decode``), times ``margin``."""
    calib = _Calib(stages)
    with torch.no_grad():
        for args in frames:
            decode(*args, calib=calib)
    return {k: v * margin for k, v in calib.bounds.items()}


def param_shapes(model: dict, embed_ch: Optional[int] = None
                 ) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """Every parameter of the model: name -> (shape, init), init one of
    "fan_in" (U(+-1/sqrt(fan_in)) for a conv's or linear's weight and
    bias), "trunc02" (std 0.02, the ConvNeXt encoder's weights), "zero",
    "one" or "gamma" (layer scale 1e-6)."""
    out: Dict[str, Tuple[Tuple[int, ...], str]] = {}

    def lin(name, i, o):
        out[name + ".weight"] = ((o, i), "fan_in")
        out[name + ".bias"] = ((o,), "fan_in")

    def conv(name, i, o, k):
        out[name + ".weight"] = ((o, i, k, k), "fan_in")
        out[name + ".bias"] = ((o,), "fan_in")

    def rsft(name, c, ch_t):
        for s in ("sft0", "sft1"):
            for part in ("scale", "shift"):
                lin(f"{name}.{s}.{part}_in", ch_t, ch_t)
                lin(f"{name}.{s}.{part}_out", ch_t, c)
        conv(name + ".conv0", c, c, 3)
        conv(name + ".conv1", c, c, 3)

    ch_t = model["ch_t"]
    levels = int(model["embed"].split("_")[-1])
    plan = stage_plan(model)
    if model["model"] == "HNeRV_Boost":
        dims = [int(model["enc_dim"].split("_")[0])] * len(model["enc_strds"])
        dims[-1] = int(model["enc_dim"].split("_")[1])
        ins = [3, *dims[:-1]]
        for i, (ci, d, s) in enumerate(zip(ins, dims, model["enc_strds"])):
            out[f"encoder.convs.{i}.weight"] = ((d, ci, s, s), "trunc02")
            out[f"encoder.convs.{i}.bias"] = ((d,), "zero")
        for i, (ci, d) in enumerate(zip(ins, dims)):
            c = d if i == 0 else ci
            out[f"encoder.norms.{i}.weight"] = ((c,), "one")
            out[f"encoder.norms.{i}.bias"] = ((c,), "zero")
        for j, d in enumerate(d for d in dims
                              for _ in range(model["enc_blks"])):
            n = f"encoder.blocks.{j}"
            out[n + ".gamma"] = ((d,), "gamma")
            out[n + ".dwconv.weight"] = ((d, 1, 7, 7), "trunc02")
            out[n + ".dwconv.bias"] = ((d,), "zero")
            out[n + ".norm.weight"] = ((d,), "one")
            out[n + ".norm.bias"] = ((d,), "zero")
            out[n + ".fc1.weight"] = ((4 * d, d), "trunc02")
            out[n + ".fc1.bias"] = ((4 * d,), "zero")
            out[n + ".fc2.weight"] = ((d, 4 * d), "trunc02")
            out[n + ".fc2.bias"] = ((d,), "zero")
        lin("stem_t.layers.0", 2 * levels, 2 * ch_t)
        lin("stem_t.layers.1", 2 * ch_t, ch_t)
        conv("stem.conv.conv", embed_ch or dims[-1], model["fc_dim"], 1)
        rsft("stem.rsft", model["fc_dim"], ch_t)
        head_k = 3
    else:
        fh, fw = (int(v) for v in model["fc_hw"].split("_"))
        lin("stem.layers.0", 2 * levels, 256)
        lin("stem.layers.1", 256, fh * fw * model["fc_dim"])
        lin("stem_t.layers.0", 2 * levels, 2 * ch_t)
        lin("stem_t.layers.1", 2 * ch_t, ch_t)
        head_k = 1
    for i, s in enumerate(plan):
        k = min(s.ks, 3)
        conv(f"blocks.{i}.conv.conv", s.ngf, s.new_ngf * s.strd ** 2, k)
        rsft(f"blocks.{i}.rsft", s.new_ngf, ch_t)
    conv("head", plan[-1].new_ngf, 3, head_k)
    return out
