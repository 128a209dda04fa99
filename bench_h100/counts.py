"""Operations and bytes of the cells' work, counted from the
configuration's shapes (not from any kernel's arguments, so the count
stays the same whatever implements a layer), and the chip's peaks.

The peaks are NVIDIA's H100 SXM data sheet's, dense, at the full 700 W
power limit: 989 T/s bf16, 1979 T/s int8, 495 T/s TF32, 3.35 TB/s of
HBM.  A multiply-add counts as two operations.

``stage_bound`` is the arithmetic of the stage bound the port's smoke run
used (``bound`` / ``_bound`` of the repository's chip smoke script, copied
here so that the yardstick does not move with the program): each input,
weight and output byte moved once at the HBM rate, against the stage's
multiply-adds at the tensor-core peak of its operand type; the larger of
the two is the least time the card could take.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from . import harness
from .reference.models import (conv_macs, grid_hw, planar_tail,
                               rsft_layers, stage_heights, w8a8_stages)

PEAK_OPS_S = {"bf16": 989e12, "int8": 1979e12, "tf32": 495e12}
HBM_BYTES_S = 3.35e12


@dataclass(frozen=True)
class Layer:
    name: str
    macs: int      # multiply-adds of one frame
    stage: Optional[int]  # decoder stage, None outside the stages


def decoder_layers(cfg: dict) -> List[Layer]:
    """The decoder's convs and linears for one frame, from the family's
    front (its ``front_layers``: the time MLP, the stem) through each
    stage's own layers and ResBlockSFT to the head."""
    m = cfg["model"]
    fam = harness.family(m["model"])
    plan = fam.stage_plan(m)
    hw = stage_heights(m, plan)
    out = [Layer(name, macs, None) for name, macs in fam.front_layers(m)]
    h, w = grid_hw(m)
    for i, s in enumerate(plan):
        out += [Layer(name, macs, i)
                for name, macs in fam.stage_layers(m, i, s, h, w)]
        h, w = hw[i]
        out += [Layer(name, macs, i) for name, macs in
                rsft_layers(f"blocks.{i}.rsft", h, w, s.new_ngf, m["ch_t"])]
    out.append(Layer("head", conv_macs(h, w, plan[-1].new_ngf, 3, fam.HEAD_K),
                     len(plan) - 1))
    return out


def encoder_layers(cfg: dict) -> List[Layer]:
    """The family's encoder on one frame of the clip (its
    ``encoder_layers``)."""
    m = cfg["model"]
    return [Layer(name, macs, None) for name, macs in
            harness.family(m["model"]).encoder_layers(m, cfg["clip"])]


def decode_precisions(cfg: dict, precision: str) -> List[str]:
    """The precision each of ``decoder_layers`` is served in: int8 in the
    W8A8 stages (their convs and the head of an int8 last stage), bf16
    everywhere else."""
    m = cfg["model"]
    int8 = (set(w8a8_stages(m, harness.family(m["model"]).stage_plan(m)))
            if precision == "w8a8" else set())
    return ["int8" if (layer.stage in int8 and not layer.name.endswith(".sft"))
            else "bf16" for layer in decoder_layers(cfg)]


def decode_least_s(cfg: dict, precision: str) -> float:
    """Least seconds of one frame's multiply-adds, each at the peak of the
    precision it is served in."""
    return sum(2 * layer.macs / PEAK_OPS_S[p] for layer, p in
               zip(decoder_layers(cfg), decode_precisions(cfg, precision)))


def train_flops(cfg: dict, batch: int) -> float:
    """3x the forward's multiply-adds (as operations) of ``batch`` frames:
    the model's training work, no recomputation counted."""
    macs = sum(layer.macs for layer in encoder_layers(cfg)
               + decoder_layers(cfg))
    return 3 * 2 * macs * batch


def stage_bound(ops: float, nbytes: float, kind: str):
    """(least ms, "operations" or "bytes")."""
    t_ops, t_bytes = ops / PEAK_OPS_S[kind], nbytes / HBM_BYTES_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def tail_bounds(cfg: dict, precision: str) -> List[tuple]:
    """(stage, least ms, what bounds it) of every stage of the serving
    decode's kernel tail, one frame (batch 1), as the stage wrappers see
    it: a bf16 stage moves bf16 activations and weights; an int8 stage
    int8 codes and weights with float32 scales, biases and input
    multipliers; a stage whose consumer is int8 (other than the tail's
    first) stores int8 codes; every stage reads its [4, C] float32 SFT
    vectors."""
    m = cfg["model"]
    fam = harness.family(m["model"])
    plan = fam.stage_plan(m)
    hw = stage_heights(m, plan)
    first = planar_tail(m, plan)
    i8 = set(w8a8_stages(m, plan)) if precision == "w8a8" else set()
    codes_in = i8 - {first}
    last = len(plan) - 1
    head = plan[-1].strd == 1   # the head is fused into the last stage
    head_k = fam.HEAD_K
    out = []
    for i in range(first, len(plan)):
        s = plan[i]
        hf, wf = hw[i]
        h, w = hf // s.strd, wf // s.strd
        cin, c, cconv = s.ngf, s.new_ngf, s.new_ngf * s.strd ** 2
        taps = head_k * head_k if (head and i == last) else 0
        ops = 2 * (9 * (h * w * cin * cconv + 2 * hf * wf * c * c)
                   + taps * hf * wf * c * 3)
        x_bytes = h * w * cin * (1 if i in codes_in else 2)
        if taps:
            out_bytes = hf * wf * 3 * 2
        else:
            out_bytes = hf * wf * c * (1 if i + 1 in codes_in else 2)
        wts = cconv * 9 * cin + 2 * c * 9 * c + (3 * taps * c if taps else 0)
        outs = cconv + 2 * c + (3 if taps else 0)   # output channels
        if i in i8:   # codes, then float32 scale and bias a channel, inv
            w_bytes = wts + 8 * outs + 4 * (cin + 2 * c + (c if taps else 0))
        else:
            w_bytes = 2 * (wts + outs)
        inv_bytes = 4 * c if (i + 1 in codes_in and not taps) else 0
        nbytes = x_bytes + out_bytes + 16 * c + w_bytes + inv_bytes
        ms, what = stage_bound(ops, nbytes, "int8" if i in i8 else "bf16")
        out.append((i, ms, what))
    return out
