"""Serving decode of HNeRV-Boost (port of
boosting_nerv_tpu/runtime/fast_decode.py::build_serving_decode, bf16 form).

``build_serving_decode(cfg, model)`` returns ``decode(embed, t)``:
embedding [1, h, w, C] + normalised index [1] -> frame [1, H, W, 3] bf16,
batch 1, as the JAX serving path (the decode-fps convention: the encoder is
not part of it).

- The prefix runs in plain PyTorch (F.linear / F.conv2d through the model's
  own modules, in bf16), as the JAX package leaves it to XLA: the PE, the
  stem_t sin MLP, the 1x1 stem + sin + ResBlockSFT, and the decoder stages
  before the tail.
- The tail is every stage from the first stride-2 3x3 stage whose fine
  output height reaches ``planar_from_h`` (``_planar_tail_span``, the JAX
  selection rule).  Each tail stage is one call of a kernel wrapper of
  ``ops.kernels.planar``: ``fused_upconv_rsft`` for stride 2,
  ``fused_conv_rsft`` for stride 1 (with the RGB head on the last stage).
  Their per-frame SFT scale/shift vectors come from F.linear.
- On a CUDA tensor the wrappers launch the hand-written kernels or raise;
  there is no fallback.  ``planar.LAUNCHES`` counts their launches and
  ``decode.launches_per_frame`` says how many one frame makes.

The TPU-only machinery of the JAX decode (tile policies, chunking, the
deviceless AOT gate) has no counterpart here.  W8A8 serving is a later
slice.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Callable, List, Mapping, Tuple, Union

import torch
import torch.nn as nn

from ..config import BoostConfig, decoder_stage_plan
from ..models.hnerv import HNeRVBoost
from ..ops.kernels import planar
from ..ops.losses import out_img
from ..ops.pe import position_encoding

DT = torch.bfloat16


def _planar_tail_span(cfg, plan, out_hw, planar_from_h) -> int:
    """First decoder stage of the kernel tail: the JAX rule
    (fast_decode.py::_planar_tail_span without its hybrid ``fine_from_h``
    split, which serving never sets), so that both packages put the same
    stages on their kernels."""
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
    return switch_at


def stage_out_hw(cfg: BoostConfig, plan) -> List[Tuple[int, int]]:
    """Fine output (H, W) of every decoder stage, from the fc grid."""
    out, h, w = [], cfg.fc_h, cfg.fc_w
    for spec in plan:
        h, w = h * spec.strd, w * spec.strd
        out.append((h, w))
    return out


@dataclass(frozen=True)
class TailStage:
    """One decoder stage served by a kernel wrapper."""
    index: int                 # decoder stage number
    strd: int                  # 2: fused_upconv_rsft, 1: fused_conv_rsft
    head: bool                 # the RGB head is fused into this stage
    in_shape: Tuple[int, int, int, int]  # NHWC input on the fc_hw grid
    weights: planar.StageWeights
    sft0: nn.Module            # bf16 SFT layers: per-frame scale/shift
    sft1: nn.Module

    def sft(self, t_embed: torch.Tensor) -> torch.Tensor:
        """[4, C] float32 (scale0, shift0, scale1, shift1) of frame 0."""
        (s0, h0), (s1, h1) = self.sft0.vectors(t_embed), \
            self.sft1.vectors(t_embed)
        return torch.stack([s0[0], h0[0], s1[0], h1[0]]).float()


def _as_model(cfg: BoostConfig, params_or_model) -> HNeRVBoost:
    if isinstance(params_or_model, HNeRVBoost):
        return params_or_model
    if not isinstance(params_or_model, Mapping):
        raise TypeError("pass an HNeRVBoost or its state dict, got "
                        f"{type(params_or_model).__name__}")
    model = HNeRVBoost(cfg)
    res = model.load_state_dict(params_or_model, strict=False)
    missing = [k for k in res.missing_keys if not k.startswith("encoder.")]
    if missing or res.unexpected_keys:
        raise KeyError(f"state dict does not fit the decoder: missing "
                       f"{missing}, unexpected {res.unexpected_keys}")
    return model.to(next(iter(params_or_model.values())).device)


def build_serving_decode(cfg: BoostConfig,
                         params_or_model: Union[HNeRVBoost,
                                                Mapping[str, torch.Tensor]],
                         w8a8_calib=None, *, planar_from_h: int = 200,
                         stage_fns: Tuple[Callable, Callable] = (
                             planar.fused_upconv_rsft,
                             planar.fused_conv_rsft)) -> Callable:
    """The serving decode for ``cfg`` on the device that holds the
    parameters.  ``stage_fns`` are the stride-2 and stride-1 stage
    functions: the kernel wrappers by default; measurements pass the plain
    versions to time the same decode without the kernels."""
    if w8a8_calib is not None:
        raise NotImplementedError("W8A8 serving is not ported yet (ROADMAP "
                                  "queue 2, item 3)")
    if cfg.model != "HNeRV_Boost":
        raise NotImplementedError(f"serving decode of {cfg.model} is not "
                                  "ported yet (ROADMAP queue 1, item 7)")
    if not (cfg.conv_type[1] == "pshuffel_3x3" and cfg.act == "sin"
            and cfg.sft_block == "res_sft" and cfg.norm == "none"
            and cfg.ch_t):
        raise ValueError("fast decode supports the HNeRV-Boost paper config "
                         "(pshuffel_3x3 / sin / res_sft / no norm)")
    model = _as_model(cfg, params_or_model)
    plan = decoder_stage_plan(cfg, cfg.fc_dim, hnerv_style=True)
    out_hw = stage_out_hw(cfg, plan)
    switch_at = _planar_tail_span(cfg, plan, out_hw, planar_from_h)
    head_fused = plan[-1].strd == 1

    def bf16(m):
        return copy.deepcopy(m).to(DT).eval()

    stem_t, stem = bf16(model.stem_t), bf16(model.stem)
    prefix = [bf16(model.blocks[bi]) for bi in range(switch_at)]
    head = None if head_fused else bf16(model.head)
    tail = []
    for bi in range(switch_at, len(plan)):
        blk = model.blocks[bi]
        is_head = head_fused and bi == len(plan) - 1
        h, w = out_hw[bi]
        tail.append(TailStage(
            bi, plan[bi].strd, is_head,
            (1, h // plan[bi].strd, w // plan[bi].strd, plan[bi].ngf),
            planar.StageWeights.from_oihw(
                blk.conv.conv, blk.rsft.conv0, blk.rsft.conv1,
                model.head if is_head else None, dtype=DT),
            bf16(blk.rsft.sft0), bf16(blk.rsft.sft1)))
    upconv_fn, conv_fn = stage_fns
    device = model.head.weight.device

    def time_embed(t: torch.Tensor) -> torch.Tensor:
        return stem_t(position_encoding(t.to(device), model.pe).to(DT))

    @torch.no_grad()
    def decode(embed: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        if embed.shape[0] != 1 or t.shape != (1,):
            raise ValueError("the serving decode runs batch 1: embed "
                             "[1, h, w, C] and t [1]")
        t_embed = time_embed(t)
        x = stem(embed.to(device, DT).permute(0, 3, 1, 2), t_embed)
        for blk in prefix:
            x = blk(x, t_embed)
        x = x.permute(0, 2, 3, 1).contiguous()
        for st in tail:
            sft = st.sft(t_embed)
            if st.strd == 2:
                x = upconv_fn(x, st.weights, sft)
            else:
                x = conv_fn(x, st.weights, sft, head=st.head)
        if head is not None:  # stride-2 final stage: head in plain torch
            x = out_img(head(x.permute(0, 3, 1, 2)), cfg.out_bias)
            x = x.permute(0, 2, 3, 1)
        return x

    decode.time_embed = time_embed
    decode.tail = tail
    decode.launches_per_frame = {
        "fused_upconv_rsft": sum(st.strd == 2 for st in tail),
        "fused_conv_rsft": sum(st.strd == 1 for st in tail)}
    return decode
