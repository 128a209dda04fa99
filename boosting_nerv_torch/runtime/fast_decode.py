"""Serving decodes of the Boost families (port of
boosting_nerv_tpu/runtime/fast_decode.py: ``build_serving_decode``,
``build_fast_decode_v5`` in its bf16, W8A8 and hybrid forms, for
HNeRV-Boost, NeRV-Boost and E-NeRV-Boost; ``build_fast_decode_v3``,
``build_fast_decode_v2`` and the v1 ``build_fast_decode``, for HNeRV-Boost
alone, as in JAX).

Every builder returns ``decode(embed, t)``: embedding [1, h, w, C] +
normalised index [1] -> frame [1, H, W, 3] bf16, batch 1, as the JAX
serving path (the decode-fps convention: the encoder is not part of it).
The index-only families ignore ``embed`` (None is allowed) and run their
stem in the decode, as in JAX.

- The prefix runs in plain PyTorch (F.linear / F.conv2d through the model's
  own modules, in bf16), as the JAX package leaves it to XLA: the PE and
  the time MLP (stem_t; E-NeRV-Boost's t_branch), the stem (HNeRV-Boost's
  1x1 stem + sin + ResBlockSFT; NeRV-Boost's stem MLP on PE(t), reshaped
  NHWC; E-NeRV-Boost's transformer trunk), and the decoder stages before
  the kernel tail (E-NeRV-Boost's stage-0 ConvUpBlock among them).  The
  per-stage SFT scale/shift vectors come from F.linear, on the time MLP's
  output.
- v5 (``build_fast_decode_v5``): the tail is every stage from the first
  stride-2 3x3 stage whose fine output height reaches ``planar_from_h``
  (``_planar_tail_span``, the JAX selection rule).  Each tail stage is one
  call of a stage wrapper of ``ops.kernels.planar``: ``fused_upconv_rsft``
  for stride 2, ``fused_conv_rsft`` for stride 1 (with the RGB head on the
  last stage).  With ``fine_from_h`` (the hybrid) the stages whose fine
  output height reaches it run on the fine-grid tile wrappers instead, as
  in v3, head included.
- W8A8 (v5 with ``w8a8_calib``, an iterable of (embed, t) frames): the
  decode first calibrates per-channel activation bounds at every conv
  input of the planar stages (``calibrate_planar_bounds``, plain bf16
  decode, margin 1.05), then serves the int8-eligible stages
  (``w8a8_stage_plan``) on ``fused_upconv_rsft_i8`` / ``fused_conv_rsft_i8``.
  Every int8 stage but the first tail stage receives int8 codes: its
  producer, bf16 or int8, stores its output quantised at the consumer's
  input bound (``out_inv``, the zero-convert chain).
- v3 (``build_fast_decode_v3``): from the first stage whose fine output
  height reaches ``tile_from_h``, that stage's upconv, PixelShuffle and sin
  run in plain torch (the JAX decode leaves them to XLA), then its
  ResBlockSFT and every later stage run on ``ops.kernels.tile_conv``:
  ``conv_tile_v3`` (act sin), F.pixel_shuffle for stride > 1,
  ``resblock_sft_tile_v3``; the head is ``conv_tile_v3`` with act outimg.
- v2 (``build_fast_decode_v2``): the same with ``conv_tile`` (no
  activation), then PixelShuffle and sin in torch, and
  ``resblock_sft_tile``; the head is ``conv_tile``, then tanh * 0.5 + 0.5.
- v1 (``build_fast_decode``): from the first stage whose fine output
  height reaches ``pallas_from_h`` and from which every fine width is a
  multiple of 128 (``v1_switch``, the JAX rule), that stage's upconv and
  PixelShuffle run in torch and its ResBlockSFT on ``resblock_sft_chw``
  with the sin fused in; every later stage on ``conv3x3_act_chw`` (then
  F.pixel_shuffle for stride > 1) and ``resblock_sft_chw``; the head on
  ``head_conv_chw`` (``ops.kernels.conv_chw`` / ``fused_sft``).
- ``build_serving_decode`` returns the v5 decode, or for a config with no
  planar tail the v3 decode at ``tile_from_h=45``, as the JAX one does
  (fast_decode.py:591-598).  W8A8 on such a config raises ValueError: the
  JAX one prints a message and serves bf16, the port serves what was asked
  or raises.
- Every decode's head is tanh * 0.5 + 0.5 whatever ``cfg.out_bias``, as
  every JAX decode's is (a reference quirk, kept).
- On a CUDA tensor the wrappers launch the hand-written kernels or raise;
  there is no fallback, and a calibration that fails raises.
  ``ops.kernels.LAUNCHES`` counts their launches and
  ``decode.launches_per_frame`` says how many one frame makes.
- While a torch profiler records, the v5 decode records spans
  (``utils/tracing.py``): ``decode`` (a unit: one frame) holds
  ``decode.prefix`` (``decode.pe``, ``decode.time_mlp``, ``decode.stem``,
  ``decode.block<i>``; the prefix's NHWC copy in the last of them),
  ``decode.tail`` (``decode.stage<i>``, each a ``decode.sft`` and a
  ``decode.kernel`` leaf; the hybrid's fine-grid tail one more
  ``decode.kernel``) and, where the head runs in plain torch,
  ``decode.head``.  The other decodes share the prefix and record its
  spans outside any unit.

The TPU-only machinery of the JAX decode (tile policies, chunking, the
deviceless AOT gate, the kernel modes, the BNT_DECODE_W8A8 and BNT_I8_CP32
switches) has no counterpart here.
"""

from __future__ import annotations

import copy
from collections import Counter
from dataclasses import dataclass
from typing import (Callable, Dict, Iterable, List, Mapping, Optional, Tuple,
                    Union)

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import BoostConfig, model_stage_plan
from ..models.enerv import ENeRVBoost
from ..models.hnerv import HNeRVBoost
from ..models.nerv import NeRVBoost, grid_nchw
from ..ops.kernels import conv_chw, fused_sft, planar, quant, tile_conv
from ..ops.kernels.planar import nchw, nhwc
from ..ops.pe import position_encoding
from ..utils.tracing import span

DT = torch.bfloat16
NO_FINE = 10 ** 9   # fine_from_h that no stage reaches: no hybrid tail
# the families each decode serves: v5 (and its calibration) the three
# Boost families, v1 / v2 / v3 HNeRV-Boost (as the JAX builders)
V5_MODELS = {"HNeRV_Boost": HNeRVBoost, "NeRV_Boost": NeRVBoost,
             "ENeRV_Boost": ENeRVBoost}
TILE_MODELS = ("HNeRV_Boost",)
Model = Union[HNeRVBoost, NeRVBoost, ENeRVBoost]


def _planar_tail_span(cfg, plan, out_hw, planar_from_h,
                      fine_from_h=NO_FINE) -> Tuple[int, int]:
    """(switch_at, fine_at): the first stage of the planar kernel tail and
    the first stage of the hybrid fine-grid tail (``len(plan)`` for none),
    by the JAX rule (fast_decode.py:321-343), so that both packages put the
    same stages on the same kernels."""
    switch_at = len(plan)
    first = 1 if cfg.model == "ENeRV_Boost" else 0
    for start in range(first, len(plan)):
        if plan[start].strd != 2 or min(plan[start].ks, 3) != 3:
            continue
        if out_hw[start][0] < planar_from_h:
            continue
        if all(plan[j].strd in (1, 2) and min(plan[j].ks, 3) == 3
               for j in range(start, len(plan))):
            switch_at = start
            break
    if switch_at == len(plan):
        raise ValueError("no planar-eligible tail for this config")
    fine_at = next((bi for bi in range(switch_at, len(plan))
                    if out_hw[bi][0] >= fine_from_h), len(plan))
    return switch_at, fine_at


def stage_out_hw(cfg: BoostConfig, plan) -> List[Tuple[int, int]]:
    """Fine output (H, W) of every decoder stage, from the fc grid."""
    out, h, w = [], cfg.fc_h, cfg.fc_w
    for spec in plan:
        h, w = h * spec.strd, w * spec.strd
        out.append((h, w))
    return out


def _plan(cfg: BoostConfig):
    plan = model_stage_plan(cfg)
    return plan, stage_out_hw(cfg, plan)


def _tail(cfg: BoostConfig, planar_from_h: int, fine_from_h: int = NO_FINE):
    """(stage plan, fine output sizes, first planar stage, first fine
    stage)."""
    plan, out_hw = _plan(cfg)
    return (plan, out_hw,
            *_planar_tail_span(cfg, plan, out_hw, planar_from_h, fine_from_h))


def has_planar_tail(cfg: BoostConfig, planar_from_h: int = 200) -> bool:
    """True when ``cfg``'s decoder has a v5 planar tail at
    ``planar_from_h`` (``_planar_tail_span``)."""
    plan, out_hw = _plan(cfg)
    try:
        _planar_tail_span(cfg, plan, out_hw, planar_from_h)
    except ValueError:
        return False
    return True


def _round16(c: int) -> int:
    return (c + 15) // 16 * 16


def w8a8_stage_plan(cfg: BoostConfig, planar_from_h: int = 200,
                    fine_from_h: int = NO_FINE
                    ) -> Tuple[List[int], List[int]]:
    """(stages served W8A8, stages that receive int8 codes) of the planar
    tail [switch_at, fine_at); the fine-grid stages stay bf16, so no stage
    hands codes to one of them.

    A stage goes int8 when its padded output channels round16(new_ngf)
    are a multiple of 32 and, for a stride-2 stage, so are its padded
    input channels (``_i8_bounds``, fast_decode.py:833-842).  That is the
    TPU's int8 sublane tiling, kept so that both packages serve the same
    stages in int8.  Every int8 stage but the first tail stage receives
    its input as int8 codes (fast_decode.py:895-910: the port has no
    chunked producer that could not emit them)."""
    plan, _, switch_at, fine_at = _tail(cfg, planar_from_h, fine_from_h)
    stages = [bi for bi in range(switch_at, fine_at)
              if _round16(plan[bi].new_ngf) % 32 == 0
              and (plan[bi].strd == 1 or _round16(plan[bi].ngf) % 32 == 0)]
    return stages, [bi for bi in stages if bi != switch_at]


def _sft_vectors(sft0: nn.Module, sft1: nn.Module,
                 t_embed: torch.Tensor) -> torch.Tensor:
    """[4, C] float32 (scale0, shift0, scale1, shift1) of frame 0."""
    (s0, h0), (s1, h1) = sft0.vectors(t_embed), sft1.vectors(t_embed)
    return torch.stack([s0[0], h0[0], s1[0], h1[0]]).float()


@dataclass(frozen=True)
class TailStage:
    """One decoder stage served by a planar stage wrapper."""
    index: int                 # decoder stage number
    strd: int                  # 2: fused_upconv_rsft, 1: fused_conv_rsft
    head: bool                 # the RGB head is fused into this stage
    in_shape: Tuple[int, int, int, int]  # NHWC input on the fc_hw grid
    weights: Union[planar.StageWeights, planar.StageWeightsI8]
    sft0: nn.Module            # bf16 SFT layers: per-frame scale/shift
    sft1: nn.Module
    out_inv: Optional[torch.Tensor] = None  # int8 output for the next stage

    @property
    def kernel(self) -> str:
        """The name of the wrapper that serves this stage."""
        name = "fused_upconv_rsft" if self.strd == 2 else "fused_conv_rsft"
        i8 = isinstance(self.weights, planar.StageWeightsI8)
        return name + "_i8" if i8 else name

    def sft(self, t_embed: torch.Tensor) -> torch.Tensor:
        return _sft_vectors(self.sft0, self.sft1, t_embed)


@dataclass(frozen=True)
class FineStage:
    """One decoder stage on the fine-grid tile wrappers."""
    index: int                 # decoder stage number
    strd: int
    out_hw: Tuple[int, int]    # fine output (H, W)
    conv_w: torch.Tensor       # OHWI [C * strd^2, k, k, Cin] bf16
    conv_b: torch.Tensor
    rsft: Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
    sft0: nn.Module
    sft1: nn.Module
    upconv: Optional[nn.Module] = None  # the switch stage: upconv in torch

    def sft(self, t_embed: torch.Tensor) -> torch.Tensor:
        return _sft_vectors(self.sft0, self.sft1, t_embed)


def _ohwi(m: nn.Module) -> torch.Tensor:
    return m.weight.detach().permute(0, 2, 3, 1).to(DT).contiguous()


def _bias(m: nn.Module) -> torch.Tensor:
    return m.bias.detach().to(DT).contiguous()


def _shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """torch PixelShuffle(r) of NHWC x."""
    return x if r == 1 else nhwc(F.pixel_shuffle(nchw(x), r))


@dataclass(frozen=True)
class FineTail:
    """The fine-grid tail: ``stages`` on the v3 (or v2) tile wrappers, then
    the head conv + OutImg; with ``plain`` on their plain versions."""
    stages: Tuple[FineStage, ...]
    head_w: torch.Tensor
    head_b: torch.Tensor
    v3: bool
    plain: bool = False

    @property
    def wrappers(self) -> Tuple[str, str]:
        """(conv wrapper, ResBlockSFT wrapper)."""
        return (("conv_tile_v3", "resblock_sft_tile_v3") if self.v3
                else ("conv_tile", "resblock_sft_tile"))

    def launches_per_frame(self) -> Dict[str, int]:
        conv, rsft = self.wrappers
        n_conv = sum(st.upconv is None for st in self.stages) + 1
        return {conv: n_conv, rsft: len(self.stages)}

    def __call__(self, x: torch.Tensor, t_embed: torch.Tensor
                 ) -> torch.Tensor:
        """NHWC bf16 input of the first stage -> [1, H, W, 3] bf16 frame."""
        suffix = "_plain" if self.plain else ""
        conv, rsft = (getattr(tile_conv, n + suffix) for n in self.wrappers)
        for st in self.stages:
            if st.upconv is not None:
                x = nhwc(torch.sin(st.upconv(nchw(x))))
            elif self.v3:
                x = _shuffle(conv(x, st.conv_w, st.conv_b,
                                  k=st.conv_w.shape[1], act="sin"), st.strd)
            else:
                x = torch.sin(_shuffle(conv(x, st.conv_w, st.conv_b,
                                            k=st.conv_w.shape[1]), st.strd))
            x = rsft(x, *st.rsft, st.sft(t_embed))
        k = self.head_w.shape[1]
        if self.v3:
            return conv(x, self.head_w, self.head_b, k=k, act="outimg")
        y = conv(x, self.head_w, self.head_b, k=k)
        return (torch.tanh(y.float()) * 0.5 + 0.5).to(DT)


def _fine_stages(model: Model, first: int, out_hw, *,
                 switch: bool) -> Tuple[FineStage, ...]:
    """Stages ``first``.. of ``model`` in bf16 with OHWI weights; with
    ``switch`` the first one's upconv (conv + PixelShuffle) runs in
    torch."""
    stages = []
    for bi in range(first, len(model.blocks)):
        blk = model.blocks[bi]
        stages.append(FineStage(
            bi, blk.conv.strd, out_hw[bi], _ohwi(blk.conv.conv),
            _bias(blk.conv.conv),
            (_ohwi(blk.rsft.conv0), _bias(blk.rsft.conv0),
             _ohwi(blk.rsft.conv1), _bias(blk.rsft.conv1)),
            _bf16(blk.rsft.sft0), _bf16(blk.rsft.sft1),
            _bf16(blk.conv) if switch and bi == first else None))
    return tuple(stages)


def _fine_tail(model: Model, first: int, out_hw, *, switch: bool,
               v3: bool, plain: bool) -> FineTail:
    """Stages ``first``.. of ``model`` on the tile wrappers; with
    ``switch`` the first one's upconv runs in torch."""
    return FineTail(_fine_stages(model, first, out_hw, switch=switch),
                    _ohwi(model.head), _bias(model.head), v3, plain)


def _as_model(cfg: BoostConfig, params_or_model) -> Model:
    cls = V5_MODELS[cfg.model]
    if isinstance(params_or_model, cls):
        return params_or_model
    if not isinstance(params_or_model, Mapping):
        raise TypeError(f"pass a {cls.__name__} or its state dict, got "
                        f"{type(params_or_model).__name__}")
    model = cls(cfg)
    res = model.load_state_dict(params_or_model, strict=False)
    missing = [k for k in res.missing_keys if not k.startswith("encoder.")]
    if missing or res.unexpected_keys:
        raise KeyError(f"state dict does not fit the decoder: missing "
                       f"{missing}, unexpected {res.unexpected_keys}")
    return model.to(next(iter(params_or_model.values())).device)


def check_config(cfg: BoostConfig, models=tuple(V5_MODELS)) -> None:
    """Raise ValueError unless the decodes serve ``cfg``: one of ``models``
    (by default the v5 decode's: HNeRV-Boost, NeRV-Boost, E-NeRV-Boost) in
    the paper's decoder config."""
    if not (cfg.model in models and cfg.conv_type[1] == "pshuffel_3x3"
            and cfg.act == "sin" and cfg.sft_block == "res_sft"
            and cfg.norm == "none" and cfg.ch_t):
        names = " / ".join(m.replace("_", "-").replace("ENeRV", "E-NeRV")
                           for m in models)
        raise ValueError(f"fast decode supports the {names} paper config "
                         "(pshuffel_3x3 / sin / res_sft / no norm), not "
                         f"{cfg.model}")


def _bf16(m: nn.Module) -> nn.Module:
    return copy.deepcopy(m).to(DT).eval()


def _prefix(model: Model, switch_at: int):
    """(time_embed(t), prefix(embed, t_embed, t, out) -> NCHW bf16 output
    of stage ``switch_at - 1`` (the stem for 0), passed through ``out``
    inside its last span), both in bf16 on the model's device.
    t_embed is the SFT condition: stem_t(PE(t)), or E-NeRV-Boost's
    t_branch(PE(t)); the index-only families ignore ``embed`` and take
    their stem from t.  Spans: ``decode.pe`` (each positional encoding:
    NeRV-Boost's stem makes a second), ``decode.time_mlp``,
    ``decode.stem``, ``decode.block<i>``."""
    cfg = model.cfg
    blocks = [(f"decode.block{bi}", _bf16(model.blocks[bi]))
              for bi in range(switch_at)]
    device = model.head.weight.device
    if cfg.model == "ENeRV_Boost":
        trunk, t_mlp = _bf16(model.trunk), _bf16(model.t_branch)
        pe = model.trunk.pe
    else:
        stem, t_mlp, pe = _bf16(model.stem), _bf16(model.stem_t), model.pe

    def encode_t(t: torch.Tensor) -> torch.Tensor:
        with span("decode.pe"):
            return position_encoding(t.to(device), pe).to(DT)

    def time_embed(t: torch.Tensor) -> torch.Tensor:
        p = encode_t(t)
        with span("decode.time_mlp"):
            return t_mlp(p)

    def prefix(embed: Optional[torch.Tensor], t_embed: torch.Tensor,
               t: Optional[torch.Tensor] = None,
               out: Callable = lambda x: x) -> torch.Tensor:
        if t_embed.shape[0] != 1 or (cfg.model == "HNeRV_Boost"
                                     and embed.shape[0] != 1):
            raise ValueError("the serving decode runs batch 1: embed "
                             "[1, h, w, C] and t [1]")
        if cfg.model == "NeRV_Boost":
            p = encode_t(t)
        with span("decode.stem"):
            if cfg.model == "HNeRV_Boost":
                x = stem(embed.to(device, DT).permute(0, 3, 1, 2), t_embed)
            elif cfg.model == "NeRV_Boost":
                x = grid_nchw(stem(p), cfg.fc_h, cfg.fc_w)
            else:
                x = trunk(t.to(device))[0]
            if not blocks:
                x = out(x)
        for k, (name, blk) in enumerate(blocks, 1):
            with span(name):
                x = blk(x, t_embed)
                if k == len(blocks):
                    x = out(x)
        return x

    return time_embed, prefix


def _check_batch(t: torch.Tensor) -> None:
    if t.shape != (1,):
        raise ValueError("the serving decode runs batch 1: embed "
                         "[1, h, w, C] and t [1]")


def build_planar_bounds_fn(cfg: BoostConfig, params_or_model,
                           planar_from_h: int = 200,
                           fine_from_h: int = NO_FINE) -> Callable:
    """The W8A8 calibration pass (port of fast_decode.py:346-447):
    ``calib(embed, t)`` decodes one frame with the plain bf16 modules and
    returns the per-channel |x| maxima (float32) at every conv input of
    every planar tail stage [switch_at, fine_at), keyed "{bi}.x" (the
    stage input), "{bi}.t0" = SFT0(y), "{bi}.t1" = SFT1(gelu(conv0)) and,
    on a last stage of stride 1 (the fused head), "{bi}.h" (the head
    input)."""
    check_config(cfg)
    model = _as_model(cfg, params_or_model)
    plan, _, switch_at, fine_at = _tail(cfg, planar_from_h, fine_from_h)
    time_embed, prefix = _prefix(model, switch_at)
    blocks = {bi: _bf16(model.blocks[bi]) for bi in range(switch_at, fine_at)}
    head_at = len(plan) - 1 if plan[-1].strd == 1 else None

    def chmax(v: torch.Tensor) -> torch.Tensor:
        return v.float().abs().amax(dim=(0, 2, 3))

    @torch.no_grad()
    def calib(embed: Optional[torch.Tensor], t: torch.Tensor
              ) -> Dict[str, torch.Tensor]:
        t_embed = time_embed(t)
        x = prefix(embed, t_embed, t)
        bounds = {}
        for bi, blk in blocks.items():
            rs = blk.rsft
            bounds[f"{bi}.x"] = chmax(x)
            y = blk.act(blk.conv(x))
            t0 = rs.sft0(y, t_embed)
            bounds[f"{bi}.t0"] = chmax(t0)
            t1 = rs.sft1(rs.act(rs.conv0(t0)), t_embed)
            bounds[f"{bi}.t1"] = chmax(t1)
            x = y + rs.conv1(t1)
            if bi == head_at:
                bounds[f"{bi}.h"] = chmax(x)
        return bounds

    return calib


def calibrate_planar_bounds(cfg: BoostConfig, params_or_model,
                            frames: Iterable, planar_from_h: int = 200,
                            fine_from_h: int = NO_FINE,
                            margin: float = 1.0) -> Dict[str, torch.Tensor]:
    """Run the calibration pass over ``frames`` ((embed, t) pairs) and
    return the per-key maxima times ``margin`` (port of
    fast_decode.py:450-467).  Raises ValueError for an empty or malformed
    ``frames``."""
    calib = build_planar_bounds_fn(cfg, params_or_model, planar_from_h,
                                   fine_from_h)
    try:
        items = list(frames)
    except TypeError as e:
        raise ValueError(f"w8a8_calib must be an iterable of (embed, t) "
                         f"pairs: {e}") from None
    acc = None
    for item in items:
        if not (isinstance(item, (tuple, list)) and len(item) == 2):
            raise ValueError("w8a8_calib must hold (embed, t) pairs, got "
                             f"{type(item).__name__}")
        b = calib(None if item[0] is None else torch.as_tensor(item[0]),
                  torch.as_tensor(item[1]))
        acc = b if acc is None else {k: torch.maximum(acc[k], b[k])
                                     for k in acc}
    if acc is None:
        raise ValueError("w8a8_calib holds no frame to calibrate on")
    return {k: v * margin for k, v in acc.items()}


def v1_switch(cfg: BoostConfig, pallas_from_h: int) -> int:
    """The first stage of the v1 kernel tail (``len(plan)`` for none), by
    the JAX rule on its chip (fast_decode.py:629-644): the first stage
    whose fine height reaches ``pallas_from_h`` from which every stage has
    a fine width that is a multiple of 128 and, after the first, a 3x3
    conv.  The 128 is the TPU's lane tiling; the port keeps it so that both
    packages serve the same stages on the kernels (at UVG-1080p widths 480
    and 960 fail it: stage 6 for any ``pallas_from_h`` up to 1080)."""
    plan, out_hw = _plan(cfg)
    return next((start for start in range(len(plan))
                 if out_hw[start][0] >= pallas_from_h
                 and all(out_hw[j][1] % 128 == 0
                         and (j == start or min(plan[j].ks, 3) == 3)
                         for j in range(start, len(plan)))), len(plan))


@dataclass(frozen=True)
class ChwTail:
    """The v1 tail: the switch stage's upconv and PixelShuffle in torch,
    then its ResBlockSFT on ``resblock_sft_chw`` with the sin fused in
    (``input_sin``); every later stage on ``conv3x3_act_chw`` (PixelShuffle
    in torch for stride > 1) and ``resblock_sft_chw``; the head on
    ``head_conv_chw``.  With ``plain`` on their plain versions."""
    stages: Tuple[FineStage, ...]
    head_w: torch.Tensor
    head_b: torch.Tensor
    plain: bool = False

    def launches_per_frame(self) -> Dict[str, int]:
        return {"conv3x3_act_chw": len(self.stages) - 1,
                "resblock_sft_chw": len(self.stages), "head_conv_chw": 1}

    def switch(self, x: torch.Tensor, t_embed: torch.Tensor
               ) -> torch.Tensor:
        """NCHW bf16 input of the switch stage -> its NHWC bf16 output."""
        rsft = getattr(fused_sft, "resblock_sft_chw"
                       + ("_plain" if self.plain else ""))
        st = self.stages[0]
        return rsft(nhwc(st.upconv(x)), *st.rsft, st.sft(t_embed),
                    input_sin=True)

    def __call__(self, x: torch.Tensor, t_embed: torch.Tensor
                 ) -> torch.Tensor:
        """NCHW bf16 input of the switch stage -> [1, H, W, 3] bf16 frame."""
        suffix = "_plain" if self.plain else ""
        conv = getattr(conv_chw, "conv3x3_act_chw" + suffix)
        head = getattr(conv_chw, "head_conv_chw" + suffix)
        rsft = getattr(fused_sft, "resblock_sft_chw" + suffix)
        x = self.switch(x, t_embed)
        for st in self.stages[1:]:
            x = _shuffle(conv(x, st.conv_w, st.conv_b), st.strd)
            x = rsft(x, *st.rsft, st.sft(t_embed))
        return head(x, self.head_w, self.head_b)


def build_fast_decode(cfg: BoostConfig,
                      params_or_model: Union[HNeRVBoost,
                                             Mapping[str, torch.Tensor]],
                      pallas_from_h: int = 10 ** 9, *,
                      plain: bool = False) -> Callable:
    """The v1 decode (port of fast_decode.py:605-703): the stages before
    ``v1_switch(cfg, pallas_from_h)`` in plain bf16 torch, the rest on the
    ``ChwTail`` wrappers; with no such stage (the default threshold) the
    whole decode in plain torch, as in JAX.  The head is tanh * 0.5 + 0.5
    whatever ``cfg.out_bias``, as the JAX v1 decode computes it.
    ``decode.switch_at`` is the switch stage (``len(plan)`` for none),
    ``decode.prefix(embed, t_embed)`` the NCHW input of that stage,
    ``decode.chw`` the tail (None without one); ``plain`` and
    ``decode.launches_per_frame`` as in v5."""
    check_config(cfg, TILE_MODELS)
    model = _as_model(cfg, params_or_model)
    plan, out_hw = _plan(cfg)
    switch_at = v1_switch(cfg, pallas_from_h)
    time_embed, prefix = _prefix(model, switch_at)
    chw = (ChwTail(_fine_stages(model, switch_at, out_hw, switch=True),
                   _ohwi(model.head), _bias(model.head), plain)
           if switch_at < len(plan) else None)
    head = None if chw else _bf16(model.head)

    @torch.no_grad()
    def decode(embed: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        _check_batch(t)
        t_embed = time_embed(t)
        x = prefix(embed, t_embed)
        if chw is None:  # no stage qualifies: all in torch
            return nhwc(torch.tanh(head(x)) * 0.5 + 0.5)
        return chw(x, t_embed)

    decode.time_embed = time_embed
    decode.prefix = prefix
    decode.switch_at = switch_at
    decode.chw = chw
    decode.launches_per_frame = chw.launches_per_frame() if chw else {}
    return decode


def build_fast_decode_v5(cfg: BoostConfig,
                         params_or_model: Union[Model,
                                                Mapping[str, torch.Tensor]],
                         w8a8_calib: Optional[Iterable] = None, *,
                         planar_from_h: int = 200,
                         fine_from_h: int = NO_FINE,
                         plain: bool = False) -> Callable:
    """The planar-tail decode for ``cfg`` (HNeRV-Boost, NeRV-Boost or
    E-NeRV-Boost) on the device that holds the parameters: bf16, or W8A8
    on the int8-eligible planar stages when ``w8a8_calib`` gives
    calibration frames ((embed, t) pairs; embed None for the index-only
    families); the stages
    whose fine output height reaches ``fine_from_h`` and the head on the v3
    tile wrappers (the hybrid).  With ``plain`` every wrapper runs its
    plain version: for measurements and checks of the kernels, not for
    serving.  Raises ValueError for a config with no planar tail.

    ``decode.tail`` / ``decode.fine`` hold the planar stages and the fine
    tail (None without one); ``decode.w8a8_stages`` / ``decode.w8a8_zc``
    list the stages served in W8A8 and those that receive int8 codes;
    ``decode.launches_per_frame`` the wrapper calls one frame makes."""
    check_config(cfg)
    model = _as_model(cfg, params_or_model)
    plan, out_hw, switch_at, fine_at = _tail(cfg, planar_from_h,
                                             fine_from_h)
    head_fused = fine_at == len(plan) and plan[-1].strd == 1
    i8_stages, zc = [], []
    if w8a8_calib is not None:
        bounds = calibrate_planar_bounds(cfg, model, w8a8_calib,
                                         planar_from_h, fine_from_h,
                                         margin=1.05)
        i8_stages, zc = w8a8_stage_plan(cfg, planar_from_h, fine_from_h)
    device = model.head.weight.device
    time_embed, prefix = _prefix(model, switch_at)
    fine = (_fine_tail(model, fine_at, out_hw, switch=False, v3=True,
                       plain=plain) if fine_at < len(plan) else None)
    head = None if head_fused or fine else _bf16(model.head)

    tail = []
    for bi in range(switch_at, fine_at):
        blk = model.blocks[bi]
        is_head = head_fused and bi == len(plan) - 1
        convs = (blk.conv.conv, blk.rsft.conv0, blk.rsft.conv1,
                 model.head if is_head else None)
        if bi in i8_stages:
            keys = ("x", "t0", "t1") + (("h",) if is_head else ())
            weights = planar.StageWeightsI8.from_oihw(
                *convs, bounds={k: bounds[f"{bi}.{k}"] for k in keys},
                dtype=DT)
        else:
            weights = planar.StageWeights.from_oihw(*convs, dtype=DT)
        out_inv = (quant.out_quant_vec(bounds[f"{bi + 1}.x"]).to(device)
                   if bi + 1 in zc else None)
        h, w = out_hw[bi]
        tail.append(TailStage(
            bi, plan[bi].strd, is_head,
            (1, h // plan[bi].strd, w // plan[bi].strd, plan[bi].ngf),
            weights, _bf16(blk.rsft.sft0), _bf16(blk.rsft.sft1), out_inv))
    fns = {name: getattr(planar, name + ("_plain" if plain else ""))
           for name in planar.WRAPPERS}
    stage_spans = [f"decode.stage{st.index}" for st in tail]

    @torch.no_grad()
    def decode(embed: Optional[torch.Tensor], t: torch.Tensor
               ) -> torch.Tensor:
        _check_batch(t)
        with span("decode", unit=True):
            with span("decode.prefix"):
                t_embed = time_embed(t)
                x = prefix(embed, t_embed, t, out=nhwc)
            with span("decode.tail"):
                for st, name in zip(tail, stage_spans):
                    kw = {"head": True} if st.head else {}
                    if st.out_inv is not None:
                        kw["out_inv"] = st.out_inv
                    with span(name):
                        with span("decode.sft"):
                            sft = st.sft(t_embed)
                        with span("decode.kernel"):
                            x = fns[st.kernel](x, st.weights, sft, **kw)
                if fine is not None:
                    with span("decode.kernel"):
                        return fine(x, t_embed)
            if head is not None:  # stride-2 final stage: head in plain torch
                with span("decode.head"):
                    x = nhwc(torch.tanh(head(nchw(x))) * 0.5 + 0.5)
            return x

    decode.time_embed = time_embed
    decode.tail = tail
    decode.fine = fine
    decode.w8a8_stages = i8_stages
    decode.w8a8_zc = zc
    decode.launches_per_frame = {
        **Counter(st.kernel for st in tail),
        **(fine.launches_per_frame() if fine else {})}
    return decode


def _build_fine_decode(cfg: BoostConfig, params_or_model, tile_from_h: int,
                       v3: bool, plain: bool) -> Callable:
    check_config(cfg, TILE_MODELS)
    model = _as_model(cfg, params_or_model)
    plan, out_hw = _plan(cfg)
    switch = next((bi for bi in range(len(plan))
                   if out_hw[bi][0] >= tile_from_h), len(plan))
    time_embed, prefix = _prefix(model, switch)
    fine = (_fine_tail(model, switch, out_hw, switch=True, v3=v3,
                       plain=plain) if switch < len(plan) else None)
    head = None if fine else _bf16(model.head)

    @torch.no_grad()
    def decode(embed: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        _check_batch(t)
        t_embed = time_embed(t)
        x = prefix(embed, t_embed)
        if fine is None:  # no stage reaches tile_from_h: all in torch
            return nhwc(torch.tanh(head(x)) * 0.5 + 0.5)
        return fine(nhwc(x), t_embed)

    decode.time_embed = time_embed
    decode.fine = fine
    decode.launches_per_frame = fine.launches_per_frame() if fine else {}
    return decode


def build_fast_decode_v3(cfg: BoostConfig,
                         params_or_model: Union[HNeRVBoost,
                                                Mapping[str, torch.Tensor]],
                         tile_from_h: int = 200, *,
                         plain: bool = False) -> Callable:
    """The v3 fine-grid decode (port of fast_decode.py:217-318): stages
    from the first whose fine output height reaches ``tile_from_h`` on
    ``conv_tile_v3`` / ``resblock_sft_tile_v3``, the head on
    ``conv_tile_v3`` with act outimg; the switch stage's upconv,
    PixelShuffle and sin in torch.  ``decode.fine`` holds the tail (None
    when no stage reaches ``tile_from_h``: the whole decode runs in
    torch); ``plain`` and ``decode.launches_per_frame`` as in v5."""
    return _build_fine_decode(cfg, params_or_model, tile_from_h, True, plain)


def build_fast_decode_v2(cfg: BoostConfig,
                         params_or_model: Union[HNeRVBoost,
                                                Mapping[str, torch.Tensor]],
                         tile_from_h: int = 200, *,
                         plain: bool = False) -> Callable:
    """The v2 fine-grid decode (port of fast_decode.py:114-214): as v3
    with ``conv_tile`` (no activation) followed by PixelShuffle and sin in
    torch, ``resblock_sft_tile``, and a ``conv_tile`` head followed by
    tanh * 0.5 + 0.5."""
    return _build_fine_decode(cfg, params_or_model, tile_from_h, False, plain)


def build_serving_decode(cfg: BoostConfig,
                         params_or_model: Union[Model,
                                                Mapping[str, torch.Tensor]],
                         w8a8_calib: Optional[Iterable] = None, *,
                         planar_from_h: int = 200,
                         plain: bool = False) -> Callable:
    """The serving decode for ``cfg`` (port of fast_decode.py:470-602):
    ``build_fast_decode_v5``, bf16 or W8A8 (``w8a8_calib``); for a config
    with no planar tail ``build_fast_decode_v3(tile_from_h=45)``, in bf16
    only: W8A8 there raises ValueError.  HNeRV-Boost, NeRV-Boost and
    E-NeRV-Boost in the paper config; any other model raises ValueError
    (the JAX builder's v3 fallback refuses it too)."""
    check_config(cfg)
    if not has_planar_tail(cfg, planar_from_h):
        if w8a8_calib is not None:
            raise ValueError("W8A8 serving needs a planar tail (a stride-2 "
                             "3x3 stage): this config serves bf16 on the v3 "
                             "decode; pass w8a8_calib=None") from None
        return build_fast_decode_v3(cfg, params_or_model, tile_from_h=45,
                                    plain=plain)
    return build_fast_decode_v5(cfg, params_or_model, w8a8_calib,
                                planar_from_h=planar_from_h, plain=plain)
