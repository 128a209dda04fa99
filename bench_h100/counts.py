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

from .reference.models import (planar_tail, stage_heights, stage_plan,
                               w8a8_stages)

PEAK_OPS_S = {"bf16": 989e12, "int8": 1979e12, "tf32": 495e12}
HBM_BYTES_S = 3.35e12


@dataclass(frozen=True)
class Layer:
    name: str
    macs: int      # multiply-adds of one frame
    stage: Optional[int]  # decoder stage, None outside the stages


def _conv(name, h, w, cin, cout, k, stage=None, groups=1):
    return Layer(name, h * w * cout * k * k * (cin // groups), stage)


def decoder_layers(cfg: dict) -> List[Layer]:
    """The decoder's convs and linears for one frame, from the time MLP
    and the stem to the head."""
    m = cfg["model"]
    plan = stage_plan(m)
    hw = stage_heights(m, plan)
    fh, fw = (int(v) for v in m["fc_hw"].split("_"))
    levels, ch_t = int(m["embed"].split("_")[-1]), m["ch_t"]
    out = [Layer("stem_t", 2 * levels * 2 * ch_t + 2 * ch_t * ch_t, None)]
    sft = 2 * ch_t * ch_t  # scale_in + shift_in of one SFT

    def rsft(prefix, h, w, c, stage):
        return [Layer(prefix + ".sft", 2 * (sft + 2 * ch_t * c), stage),
                _conv(prefix + ".conv0", h, w, c, c, 3, stage),
                _conv(prefix + ".conv1", h, w, c, c, 3, stage)]

    if m["model"] == "HNeRV_Boost":
        emb = int(m["enc_dim"].split("_")[1])
        out.append(_conv("stem.conv", fh, fw, emb, m["fc_dim"], 1))
        out += rsft("stem.rsft", fh, fw, m["fc_dim"], None)
        head_k = 3
    else:
        out.append(Layer("stem", 2 * levels * 256
                         + 256 * fh * fw * m["fc_dim"], None))
        head_k = 1
    h, w = fh, fw
    for i, s in enumerate(plan):
        k = min(s.ks, 3)
        out.append(_conv(f"blocks.{i}.conv", h, w, s.ngf,
                         s.new_ngf * s.strd ** 2, k, i))
        h, w = hw[i]
        out += rsft(f"blocks.{i}.rsft", h, w, s.new_ngf, i)
    out.append(_conv("head", h, w, plan[-1].new_ngf, 3, head_k,
                     len(plan) - 1))
    return out


def encoder_layers(cfg: dict) -> List[Layer]:
    """HNeRV-Boost's ConvNeXt encoder on one frame."""
    m, clip = cfg["model"], cfg["clip"]
    dims = [int(m["enc_dim"].split("_")[0])] * len(m["enc_strds"])
    dims[-1] = int(m["enc_dim"].split("_")[1])
    h, w, cin, out = clip["height"], clip["width"], 3, []
    for i, (d, s) in enumerate(zip(dims, m["enc_strds"])):
        h, w = h // s, w // s
        out.append(_conv(f"encoder.convs.{i}", h, w, cin, d, s))
        for _ in range(m["enc_blks"]):
            out.append(_conv(f"encoder.dwconv.{i}", h, w, d, d, 7, groups=d))
            out.append(Layer(f"encoder.mlp.{i}", h * w * d * 4 * d * 2, None))
        cin = d
    return out


def decode_precisions(cfg: dict, precision: str) -> List[str]:
    """The precision each of ``decoder_layers`` is served in: int8 in the
    W8A8 stages (their convs and the head of an int8 last stage), bf16
    everywhere else."""
    int8 = (set(w8a8_stages(cfg["model"], stage_plan(cfg["model"])))
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
    plan = stage_plan(m)
    hw = stage_heights(m, plan)
    first = planar_tail(m, plan)
    i8 = set(w8a8_stages(m, plan)) if precision == "w8a8" else set()
    codes_in = i8 - {first}
    last = len(plan) - 1
    head = plan[-1].strd == 1   # the head is fused into the last stage
    head_k = 3 if m["model"] == "HNeRV_Boost" else 1
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
