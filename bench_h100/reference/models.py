"""What the model families of the plain reference share: the positional
encoding, MLPs, SFT and ResBlockSFT, the decoder stages and head, the
integer stages, and the arithmetic of parameter shapes and multiply-adds.
Everything is a function of a parameter dict (name -> tensor, the names of
the models' ``state_dict``), so that it shares no code with the program it
judges.

A family lives in a file of its own, ``reference/<model>.py`` with the
configuration's ``model`` in lower case, which ``harness.family`` finds
by that name.  A family file defines:

- ``stage_plan(model)``: the decoder's stages (``Stage``), from the shared
  ``stage_plan`` below fed by the family's width rule;
- ``param_shapes(model)``: every parameter, name -> (shape, init), in the
  order ``inputs.make_weights`` draws them (the order is part of the
  weights);
- ``frame_inputs(model, n, seed, device)``: the per-frame inputs besides
  the index t, [n, ...], made from the seed, or None;
- ``decode(x, t, p, model, quant=None, calib=None)``: the serving
  reference, frame input (a row of ``frame_inputs``, or None) and index
  [B] -> frame [B, H, W, 3];
- ``forward(img, t, p, model)`` and ``encoder_layers(model, clip)``: the
  training reference and its encoder's multiply-adds, in the families the
  reference trains only;
- ``front_layers(model)``: one frame's multiply-adds ahead of stage 0,
  [(name, macs)];
- ``stage_layers(model, i, stage, h, w)``: stage i's multiply-adds ahead of
  its activation, on an h x w input (the shared ``stage_layers`` below
  for a conv and PixelShuffle);
- ``HEAD_K``: the head conv's kernel size.

The equations are the Boosting-NeRV paper's (arXiv:2404.06707) as the
reference repository implements them:

- PE(t) = [sin(pi 1.25^l t), cos(pi 1.25^l t)], l < levels; the bases are
  1.25^l rounded from float64 to float32, times pi, as the reference
  computes them in float32;
- an MLP applies its activation after every layer, the last included;
- SFT(x | c) = x (scale(c) + 1) + shift(c), scale = W2 relu(W1 c) + b;
- ResBlockSFT(x | c) = x + conv1(SFT1(gelu(conv0(SFT0(x | c))) | c));
- a decoder stage: conv (k x k, k = min(ks, 3)), PixelShuffle(stride), sin,
  ResBlockSFT conditioned on the family's time embedding;
- the head: conv, then tanh(x) / 2 + 1/2.

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
Shapes = Dict[str, Tuple[Tuple[int, ...], str]]
Macs = List[Tuple[str, int]]


@dataclass(frozen=True)
class Stage:
    ngf: int
    new_ngf: int
    ks: int
    strd: int


def stage_plan(model: dict, expansion: Optional[int] = None) -> List[Stage]:
    """The decoder's stages from the configuration's ``model`` section.
    With ``expansion`` None every stage divides the width by ``reduce``
    (rounded); else stage 0 multiplies it by ``expansion`` and every
    stride-2 stage floor-divides it.  A stage of n blocks upsamples in its
    first; the kernel of stage i is min(ks1 + 2 i, ks2)."""
    _, ks1, ks2 = (int(v) for v in model["ks"].split("_"))
    plan, ngf = [], model["fc_dim"]
    for i, strd in enumerate(model["dec_strds"]):
        if expansion is None:
            new = int(max(round(ngf / model["reduce"]), model["lower_width"]))
        elif i == 0:
            new = int(ngf * expansion)
        else:
            new = int(max(ngf // (1 if strd == 1 else model["reduce"]),
                          model["lower_width"]))
        for j in range(model["dec_blks"][i]):
            plan.append(Stage(ngf, new, min(ks1 + 2 * i, ks2),
                              1 if j else strd))
            ngf = new
    return plan


def grid_hw(model: dict) -> Tuple[int, int]:
    """The fc_h x fc_w grid that stage 0 upsamples."""
    fh, fw = (int(v) for v in model["fc_hw"].split("_"))
    return fh, fw


def stage_heights(model: dict, plan: List[Stage]) -> List[Tuple[int, int]]:
    h, w = grid_hw(model)
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


def lin(x, p: Params, name: str):
    return F.linear(x, p[name + ".weight"], p[name + ".bias"])


def mlp(x, p: Params, name: str, layers: int):
    for i in range(layers):
        x = torch.sin(lin(x, p, f"{name}.layers.{i}"))
    return x


def _sft(x, p: Params, name: str, cond):
    scale = lin(F.relu(lin(cond, p, name + ".scale_in")), p,
                name + ".scale_out")
    shift = lin(F.relu(lin(cond, p, name + ".shift_in")), p,
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


def conv(x, p, name, pad, stage=None, key=None, quant=None, calib=None):
    """The conv ``name`` of NCHW ``x``, in ``quant``'s precision where its
    stage is one of ``quant``'s, its input's bounds seen by ``calib``."""
    w, b = p[name + ".weight"], p[name + ".bias"]
    if calib is not None and stage in calib.stages:
        calib.see(f"{stage}.{key}", x)
    if quant is not None and stage in quant.stages:
        return quant.conv(x, w, b, f"{stage}.{key}", pad)
    return F.conv2d(x, w, b, padding=pad)


def rsft(x, p, name, cond, **q):
    t0 = _sft(x, p, name + ".sft0", cond)
    a = F.gelu(conv(t0, p, name + ".conv0", 1, key="t0", **q))
    t1 = _sft(a, p, name + ".sft1", cond)
    return x + conv(t1, p, name + ".conv1", 1, key="t1", **q)


def upsample(x, p: Params, i: int, s: Stage, q: dict):
    """Stage i's conv and PixelShuffle: its map before the activation."""
    k = min(s.ks, 3)
    y = conv(x, p, f"blocks.{i}.conv.conv", (k - 1) // 2, key="x", **q)
    return F.pixel_shuffle(y, s.strd) if s.strd > 1 else y


def decode_stages(x, t_embed, p: Params, plan: List[Stage], quant=None,
                  calib=None, up=upsample):
    """The decoder stages and head of NCHW ``x`` -> NHWC frame; ``up`` is
    a stage's map before its activation (``upsample``'s signature)."""
    for i, s in enumerate(plan):
        q = {"stage": i, "quant": quant, "calib": calib}
        x = rsft(torch.sin(up(x, p, i, s, q)), p, f"blocks.{i}.rsft",
                 t_embed, **q)
    head = p["head.weight"]
    y = conv(x, p, "head", head.shape[-1] // 2, stage=len(plan) - 1,
             key="h", quant=quant, calib=calib)
    return (torch.tanh(y) * 0.5 + 0.5).permute(0, 2, 3, 1)


def calibrate(decode, frames, stages, margin=1.05) -> Dict[str, torch.Tensor]:
    """Per-channel conv-input bounds of ``stages`` over ``frames`` (the
    arguments of ``decode``), times ``margin``."""
    calib = _Calib(stages)
    with torch.no_grad():
        for args in frames:
            decode(*args, calib=calib)
    return {k: v * margin for k, v in calib.bounds.items()}


# -- parameter shapes: name -> (shape, init), init one of "fan_in"
# (U(+-1/sqrt(fan_in)) for a conv's or linear's weight and bias, each bias
# after its weight), "trunc02" (std 0.02), "zero", "one" or "gamma" (layer
# scale 1e-6) ------------------------------------------------------------ #
def add_linear(out: Shapes, name: str, i: int, o: int, bias: bool = True):
    out[name + ".weight"] = ((o, i), "fan_in")
    if bias:
        out[name + ".bias"] = ((o,), "fan_in")


def add_conv(out: Shapes, name: str, i: int, o: int, k: int):
    out[name + ".weight"] = ((o, i, k, k), "fan_in")
    out[name + ".bias"] = ((o,), "fan_in")


def add_rsft(out: Shapes, name: str, c: int, ch_t: int):
    for s in ("sft0", "sft1"):
        for part in ("scale", "shift"):
            add_linear(out, f"{name}.{s}.{part}_in", ch_t, ch_t)
            add_linear(out, f"{name}.{s}.{part}_out", ch_t, c)
    add_conv(out, name + ".conv0", c, c, 3)
    add_conv(out, name + ".conv1", c, c, 3)


def add_stage(out: Shapes, i: int, s: Stage, ch_t: int):
    """A stage of ``upsample``: its conv, then its ResBlockSFT."""
    add_conv(out, f"blocks.{i}.conv.conv", s.ngf, s.new_ngf * s.strd ** 2,
             min(s.ks, 3))
    add_rsft(out, f"blocks.{i}.rsft", s.new_ngf, ch_t)


# -- multiply-adds of one frame ----------------------------------------- #
def conv_macs(h: int, w: int, cin: int, cout: int, k: int,
              groups: int = 1) -> int:
    """A k x k conv's multiply-adds producing an h x w map."""
    return h * w * cout * k * k * (cin // groups)


def mlp_macs(dims: List[int]) -> int:
    """An MLP's multiply-adds on one vector through widths ``dims``."""
    return sum(a * b for a, b in zip(dims, dims[1:]))


def rsft_layers(prefix: str, h: int, w: int, c: int, ch_t: int) -> Macs:
    """A ResBlockSFT's work: its two SFTs' linears (the in-layers
    ch_t x ch_t, the out-layers ch_t x c, for scale and shift), then its
    two 3x3 convs."""
    sft = 2 * ch_t * ch_t  # scale_in + shift_in of one SFT
    return [(prefix + ".sft", 2 * (sft + 2 * ch_t * c)),
            (prefix + ".conv0", conv_macs(h, w, c, c, 3)),
            (prefix + ".conv1", conv_macs(h, w, c, c, 3))]


def stage_layers(model: dict, i: int, s: Stage, h: int, w: int) -> Macs:
    """``upsample``'s conv of stage i on an h x w input."""
    return [(f"blocks.{i}.conv",
             conv_macs(h, w, s.ngf, s.new_ngf * s.strd ** 2, min(s.ks, 3)))]
