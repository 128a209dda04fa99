#!/usr/bin/env python3
"""Smoke run of the PyTorch port (boosting_nerv_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line of output each (or one line per shape):

1. requires CUDA (exits non-zero before anything else without it) and
   prints the card's name and power limit as nvidia-smi reports them;
2. builds the hand-written kernels from ``boosting_nerv_torch/ops/csrc``
   and prints ptxas's register and spill report of every kernel instance;
3. builds HNeRV-Boost at the UVG-1080p serving config of bench.py with
   seeded random weights, encodes one synthetic 1080x1920 frame, and builds
   the decodes: the bf16 serving decode (v5) and the W8A8 one (calibrated
   on that frame at t in {0.01, 0.25, 0.5, 0.75, 1.0}, margin 1.05, as
   bench.py does), the v3 and v2 fine-grid decodes (``tile_from_h=45``),
   the hybrid (v5 with ``fine_from_h=1000``) and the v1 decode
   (``pallas_from_h=512``, as tools/fast_decode_probe.py runs it), each
   also on its wrappers' plain versions but the hybrid;
4. holds each kernel wrapper against its plain PyTorch version on the card
   at every tail shape of the decodes that serve it (stage wrappers: bf16
   stages 2-7; W8A8: stage 4's bf16 launch with int8-code output, stages
   5-7 in int8; tile wrappers: the v3 decode's stages 0-7 and head, the v2
   decode's the same with act none; v1 wrappers: resblock_sft_chw with
   input_sin at stage 6 and without at stage 7, conv3x3_act_chw at stage 7
   and head_conv_chw, all at 1080x1920x51; the planar wrappers at the
   planar form of stage 7, C 51 -> Cp 64, Hc 540, wc_real 960, Wd 1024,
   conv_planar with act sin and as the outimg head) and at one small
   ragged shape each (width 50 and 9 rows; k = 1 for conv_tile_v3, k = 5
   for conv_tile, also at 128 -> 80 channels, which the Hopper kernel
   takes only at its narrowest N slice; wc_real 50 for the planar ones;
   conv_tile, resblock_sft_tile_v3 and the bf16 fused_upconv_rsft and
   fused_conv_rsft on the Hopper kernel conv_sm90.cu, the others on the
   stage kernels): max abs error within
   2e-2 * max(|plain|, 1), int8 codes compared after dequantising with
   1/inv; prints the share of codes that differ; times both with CUDA
   events, and F.conv2d for conv_tile; then checks that a conv with more
   than 128 input channels, which the kernel does not take, raises
   ValueError on the card from the tile, v1 and planar wrappers; and
   times the stage kernel's chain (stage_conv.cu) beside conv_sm90.cu in
   turns (old, new, new, old) at conv_tile's v2 stage-6 call, at
   fused_upconv_rsft's bf16 stages 2, 4 and 6, at fused_conv_rsft's
   stages 3, 5 and 7 + head and at every resblock_sft_tile_v3 call of
   the v3 decode (the same-call A/B), after checking conv_sm90.cu's
   shared-memory plan of every conv shape it serves against its Python
   mirror and printing the plan;
5. the bf16 slice: serves 8 frame indices through ``build_serving_decode``;
   checks the frames (shape, finite, [0, 1], max abs error <= 1e-2 against
   the fp32 plain decode with TF32 off) and the launch counts; times the
   decode (encoder excluded) with the kernels and with the plain stages;
6. the W8A8 slice: checks that stages 5-7 serve int8 and receive int8
   codes, serves the 8 indices, checks the frames (shape, finite, [0, 1],
   max abs error <= 2e-2 against the same decode on the plain stage
   versions, PSNR >= 35 dB against the bf16 kernel decode at t = 0.37, as
   bench.py gates it) and the launch counts; times it against the bf16
   decode in turns (bf16, W8A8, W8A8, bf16);
7. the v3, v2, hybrid and v1 slices: each serves the 8 indices with the
   frame checks of phase 5 and its launch counts (v3: conv_tile_v3 8 and
   resblock_sft_tile_v3 8 a frame; v2: conv_tile 8, resblock_sft_tile 8;
   hybrid: fused_upconv_rsft 2, fused_conv_rsft 2, conv_tile_v3 3,
   resblock_sft_tile_v3 2; v1, which switches at stage 6:
   conv3x3_act_chw 1, resblock_sft_chw 2, head_conv_chw 1), and is timed
   in turns against the bf16 v5 decode (v5, X, X, v5) and, v3, v2 and v1,
   against its plain version;
8. the serving fallback: a small config with no planar tail (no stride-2
   stage) on the card; ``build_serving_decode`` must return the v3 decode,
   whose launches name only tile wrappers, and its frame must match its
   plain version and the fp32 decode;
9. the planar phase, the path of the two standalone planar wrappers (no
   decode serves them): for each of the 8 indices, the v1 decode's stage 6
   output in planar form (``to_planar``, Wd 1024) goes through stage 7 and
   the head as conv_planar (sin), rsft_planar and conv_planar (outimg);
   the frames must match the v1 slice's and the fp32 decode's, and the
   launches must be conv_planar 2 and rsft_planar 1 a frame, no other;
10. the probe phase, the path of the four probe wrappers
   (``boosting_nerv_torch/tools/probes.py``, the counterparts of the TPU
   probes in ``tools/``): prints each probe instance's registers, spills
   and HMMA/IMMA count from ``cuobjdump -sass`` (a no-GEMM instance must
   have none, every other K1-K3 instance some, the staging kernels none);
   holds every probe variant against its plain version at full size and
   at a small ragged one (2e-2 * max(|plain|, 1), or exact where the
   variant computes the production launch's function: "all" against the
   production wrapper, DIRECT, PACK and ASYNC, the staging modes against
   their plain staging, no STORE against its untouched output); then times
   every variant through the entry point and prints one line per TPU site
   and the phase breakdown of each stage (K1 on the stage kernel, K5 on
   conv_sm90.cu).

The launch counts are set to 0 just before each slice's frames (the
planar phase's stage-7 calls, the probe phase's timed run) and read just
after.  The line before the
last is a JSON object with one entry per kernel; the last line is
{"ok": true, "device": {...}}.  Any failed phase exits non-zero without
printing either.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time

import numpy as np
import torch

N_FRAMES = 8
STAGE_TOL = 2e-2    # x max(|plain|, 1): bf16 storage on both sides
SLICE_TOL = 1e-2    # max abs vs the fp32 decode (JAX's bf16 decode: 2.6e-3)
W8A8_TOL = 2e-2     # max abs of the W8A8 decode vs its plain stage versions
PSNR_GATE = 35.0    # W8A8 vs bf16 at the held index, bench.py:206-213
T_HOLD = 0.37
CALIB_TS = (0.01, 0.25, 0.5, 0.75, 1.0)
TILE_FROM_H = 45    # the serving fallback's switch (fast_decode.py:597)
FINE_FROM_H = 1000  # hybrid: stages 6-7 and the head on the v3 wrappers
PALLAS_FROM_H = 512  # v1: the switch stage is 6 (widths 480, 960 fail 128)
PLANAR_WD = 1024    # the planar width of the 1080p stages (960 real)
PLANAR = "boosting_nerv_tpu/ops/pallas/planar.py"
TILE = "boosting_nerv_tpu/ops/pallas/tile_conv.py"
CHW = "boosting_nerv_tpu/ops/pallas/conv_chw.py"
STAGE_CU = "boosting_nerv_torch/ops/csrc/stage_conv.cu"
SM90_CU = "boosting_nerv_torch/ops/csrc/conv_sm90.cu"
KERNELS = {  # wrapper: (source, replaces)
    "fused_upconv_rsft": (SM90_CU, f"{PLANAR}:1308"),
    "fused_conv_rsft": (SM90_CU, f"{PLANAR}:1541"),
    "fused_upconv_rsft_i8": ("boosting_nerv_torch/ops/csrc/stage_conv_i8.cu",
                             f"{PLANAR}:1308 (W8A8 prep {PLANAR}:707)"),
    "fused_conv_rsft_i8": ("boosting_nerv_torch/ops/csrc/stage_conv_i8.cu",
                           f"{PLANAR}:1541 (W8A8 prep {PLANAR}:673)"),
    "conv_tile": (SM90_CU, f"{TILE}:144"),
    "conv_tile_v3": (STAGE_CU, f"{TILE}:473"),
    "resblock_sft_tile": (STAGE_CU, f"{TILE}:951"),
    "resblock_sft_tile_v3": (SM90_CU, f"{TILE}:788"),
    "conv3x3_act_chw": (STAGE_CU, f"{CHW}:88"),
    "head_conv_chw": (STAGE_CU, f"{CHW}:95"),
    "resblock_sft_chw": ("boosting_nerv_torch/ops/csrc/stage_conv_sin.cu",
                         "boosting_nerv_tpu/ops/pallas/fused_sft.py:138"),
    "conv_planar": (STAGE_CU, f"{PLANAR}:398"),
    "rsft_planar": (STAGE_CU, f"{PLANAR}:484"),
}
LIBRARY = {"conv_tile"}  # one PyTorch call computes it: F.conv2d
V3_LAUNCHES = {"conv_tile_v3": 8, "resblock_sft_tile_v3": 8}
V2_LAUNCHES = {"conv_tile": 8, "resblock_sft_tile": 8}
HYBRID_LAUNCHES = {"fused_upconv_rsft": 2, "fused_conv_rsft": 2,
                   "conv_tile_v3": 3, "resblock_sft_tile_v3": 2}
V1_LAUNCHES = {"conv3x3_act_chw": 1, "resblock_sft_chw": 2,
               "head_conv_chw": 1}
PLANAR_LAUNCHES = {"conv_planar": 2, "rsft_planar": 1}
# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): HBM bytes/s and
# tensor-core operations/s of the kernels' operand types
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "int8": 1979e12}


class SmokeFailure(Exception):
    pass


def bench_config():
    """The UVG-1080p serving config of bench.py (HNeRV-Boost, ~3M params)."""
    from boosting_nerv_torch.config import BoostConfig, resolve_sizes

    cfg = BoostConfig(
        model="HNeRV_Boost", embed="pe_1.25_80", enc_strds=[5, 3, 2, 2, 2],
        enc_dim="64_16", dec_strds=[5, 3, 2, 2, 2], dec_blks=[1, 1, 2, 2, 2],
        ks="0_1_5", reduce=1.2, lower_width=12, modelsize=2.8,
        conv_type=["convnext", "pshuffel_3x3"], act="sin", norm="none",
        sft_block="res_sft", ch_t=32)
    return resolve_sizes(cfg, final_size=1920 * 1080, full_data_length=120)


def no_planar_config():
    """A small HNeRV-Boost with no stride-2 stage, hence no planar tail
    (tests/test_torch_tile.py): stage heights 16, 48, 48 on a 48x48
    frame."""
    from boosting_nerv_torch.config import BoostConfig

    return BoostConfig(
        model="HNeRV_Boost", embed="pe_1.25_20", fc_dim=12, fc_hw="4_4",
        dec_strds=[4, 3], dec_blks=[1, 2], ks="0_1_5",
        conv_type=["convnext", "pshuffel_3x3"], act="sin", norm="none",
        sft_block="res_sft", ch_t=8, reduce=1.2, lower_width=4,
        enc_strds=[4, 3], enc_dim="8_4")


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 5, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound(name, args, kw, out):
    """(least ms the card could take for one call, "bytes" or
    "operations"): each input and weight read once and the output written
    once at the HBM rate, against the convolutions' multiply-adds at the
    tensor-core peak of the operand type."""
    x = args[0]
    if name in ("conv_planar", "rsft_planar"):
        # the input's real region (channels, rows, columns; the pad never
        # reaches the result) is read, the whole planar output written
        hf, wf = 2 * kw.get("hc_real", x.shape[1]), 2 * kw["wc_real"]
        convs = ([(kw["c_in"], kw["c_out"])] if name == "conv_planar"
                 else [(kw["c"], kw["c"])] * 2)
        ops = sum(2 * 9 * hf * wf * ci * co for ci, co in convs)
        nbytes = (convs[0][0] * hf * wf * x.element_size()
                  + _nbytes(out, *args[1:]))
        return _bound(ops, nbytes, "bf16")
    _, h, wd, c_in = x.shape
    if name in ("conv_tile", "conv_tile_v3", "conv3x3_act_chw",
                "head_conv_chw"):
        w = args[1]
        ops = 2 * w.shape[1] * w.shape[2] * h * wd * c_in * w.shape[0]
        nbytes = _nbytes(x, out, *args[1:])
    elif name.startswith("resblock_sft"):
        ops = 2 * 9 * h * wd * c_in * c_in * 2
        nbytes = _nbytes(x, out, *args[1:])
    else:
        w = args[1]
        cout, c = w.conv_w.shape[0], w.w0.shape[0]
        hf, wf = (2 * h, 2 * wd) if name.startswith("fused_upconv") else (
            h, wd)
        ops = 2 * 9 * (h * wd * c_in * cout + 2 * hf * wf * c * c
                       + (hf * wf * c * 3 if kw.get("head") else 0))
        nbytes = _nbytes(x, out, args[2], *vars(w).values(),
                         kw.get("out_inv"))
    return _bound(ops, nbytes, "int8" if name.endswith("_i8") else "bf16")


def _bound(ops, nbytes, kind):
    t_ops = ops / PEAK_OPS_S[kind]
    t_bytes = nbytes / HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def rnd(gen, *shape, scale=1.0, dtype=torch.bfloat16):
    return ((torch.rand(shape, generator=gen, device="cuda") * 2 - 1)
            * scale).to(dtype)


def rnd_codes(gen, *shape):
    return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                         dtype=torch.int8)


def wrapper(name, plain=False):
    """A kernel wrapper of ops.kernels (planar, tile_conv, conv_chw or
    fused_sft) by name."""
    from boosting_nerv_torch.ops.kernels import (conv_chw, fused_sft, planar,
                                                 tile_conv)

    module = next(m for m in (planar, tile_conv, conv_chw, fused_sft)
                  if hasattr(m, name))
    return getattr(module, name + ("_plain" if plain else ""))


def ragged_i8(gen, c_in, c, up, head):
    """W8A8 weights of a small stage from random weights and bounds."""
    from boosting_nerv_torch.ops.kernels import planar

    def conv(cin, cout):
        m = torch.nn.Conv2d(cin, cout, 3, device="cuda").requires_grad_(False)
        b = (9 * cin) ** -0.5
        m.weight.uniform_(-b, b, generator=gen)
        m.bias.uniform_(-b, b, generator=gen)
        return m

    bounds = {k: torch.rand((n,), generator=gen, device="cuda") + 0.5
              for k, n in (("x", c_in), ("t0", c), ("t1", c), ("h", c))}
    return planar.StageWeightsI8.from_oihw(
        conv(c_in, 4 * c if up else c), conv(c, c), conv(c, c),
        conv(c, 3) if head else None, bounds=bounds)


def stage_cases(decode, decode_i8, gen):
    """(label, wrapper, args, kwargs, per_frame) for every tail stage of
    the bf16 serving decode and for stage 4 (bf16, int8-code output) and the
    int8 stages of the W8A8 one, each with its own weights and the SFT
    vectors of t = 0.5, plus one small ragged stage of each wrapper with
    random weights.  per_frame: the case is one call of a frame of the
    decode that serves the wrapper (the bf16 wrappers the bf16 decode, the
    int8 ones the W8A8 decode)."""
    from boosting_nerv_torch.ops.kernels import planar

    t_embed = decode.time_embed(torch.tensor([0.5], device="cuda"))
    cases = []
    zc = set(decode_i8.w8a8_zc)
    w8_tail = [st for st in decode_i8.tail
               if st.index in zc or st.out_inv is not None]
    for tag, st in [("", st) for st in decode.tail] + [
            (" w8a8", st) for st in w8_tail]:
        x = (rnd_codes(gen, *st.in_shape) if tag and st.index in zc
             else rnd(gen, *st.in_shape))
        kw = {"head": True} if st.head else {}
        if st.out_inv is not None:
            kw["out_inv"] = st.out_inv
        cases.append((f"stage {st.index}{tag}", st.kernel,
                      (x, st.weights, st.sft(t_embed)), kw,
                      st.kernel.endswith("_i8") or not tag))

    c_in, c, h, w = 6, 5, 9, 50   # width 50: not a multiple of the tile
    sft = (torch.rand((4, c), generator=gen, device="cuda") - 0.5) * 0.6
    up = planar.StageWeights(
        rnd(gen, 4 * c, 3, 3, c_in, scale=0.2), rnd(gen, 4 * c, scale=0.1),
        rnd(gen, c, 3, 3, c, scale=0.2), rnd(gen, c, scale=0.1),
        rnd(gen, c, 3, 3, c, scale=0.2), rnd(gen, c, scale=0.1))
    st1 = planar.StageWeights(
        rnd(gen, c, 3, 3, c, scale=0.2), rnd(gen, c, scale=0.1),
        rnd(gen, c, 3, 3, c, scale=0.2), rnd(gen, c, scale=0.1),
        rnd(gen, c, 3, 3, c, scale=0.2), rnd(gen, c, scale=0.1),
        rnd(gen, 3, 3, 3, c, scale=0.2), rnd(gen, 3, scale=0.1))
    up8, st8 = ragged_i8(gen, c_in, c, True, False), ragged_i8(
        gen, c, c, False, True)
    up_args = (rnd(gen, 1, h, w, c_in), up, sft)
    up8_args = (rnd(gen, 1, h, w, c_in), up8, sft)
    cases += [
        ("ragged", "fused_upconv_rsft", up_args,
         {"out_inv": out_inv(planar.fused_upconv_rsft_plain, up_args)},
         False),
        ("ragged", "fused_conv_rsft", (rnd(gen, 1, 2 * h, 2 * w, c), st1,
                                       sft), {"head": True}, False),
        ("ragged", "fused_upconv_rsft_i8", up8_args,
         {"out_inv": out_inv(planar.fused_upconv_rsft_i8_plain, up8_args)},
         False),
        ("ragged", "fused_conv_rsft_i8",
         (rnd_codes(gen, 1, 2 * h, 2 * w, c), st8, sft), {"head": True},
         False),
    ]
    return cases


def tile_cases(decode_v3, decode_v2, gen):
    """(label, wrapper, args, kwargs, per_frame) for every call of a frame
    of the v3 and v2 decodes (each with its own weights and the SFT vectors
    of t = 0.5) and one small ragged call of each tile wrapper with random
    weights (width 50; k = 1 for conv_tile_v3, k = 5 for conv_tile)."""
    cases = []
    for tag, dec in (("v3", decode_v3), ("v2", decode_v2)):
        t_embed = dec.time_embed(torch.tensor([0.5], device="cuda"))
        tail = dec.fine
        conv, rsft = tail.wrappers
        act = {"act": "sin"} if tail.v3 else {}
        for st in tail.stages:
            h, w = st.out_hw
            if st.upconv is None:
                cin, k = st.conv_w.shape[3], st.conv_w.shape[1]
                x = rnd(gen, 1, h // st.strd, w // st.strd, cin)
                cases.append((f"{tag} stage {st.index}", conv,
                              (x, st.conv_w, st.conv_b), {"k": k, **act},
                              True))
            x = rnd(gen, 1, h, w, st.rsft[0].shape[0])
            cases.append((f"{tag} stage {st.index}", rsft,
                          (x, *st.rsft, st.sft(t_embed)), {}, True))
        h, w = tail.stages[-1].out_hw
        x = rnd(gen, 1, h, w, tail.head_w.shape[3])
        cases.append((f"{tag} head", conv, (x, tail.head_w, tail.head_b),
                      {"k": 3, **({"act": "outimg"} if tail.v3 else {})},
                      True))

    c_in, c, h, w = 6, 5, 9, 50
    sft = (torch.rand((4, c), generator=gen, device="cuda") - 0.5) * 0.6

    def conv_args(k, cout):
        return (rnd(gen, 1, h, w, c_in), rnd(gen, cout, k, k, c_in,
                                               scale=(k * k * c_in) ** -0.5),
                rnd(gen, cout, scale=0.1))

    def rsft_args():
        return (rnd(gen, 1, h, w, c), rnd(gen, c, 3, 3, c, scale=0.2),
                rnd(gen, c, scale=0.1), rnd(gen, c, 3, 3, c, scale=0.2),
                rnd(gen, c, scale=0.1), sft)

    cases += [
        ("ragged k5", "conv_tile", conv_args(5, 7), {"k": 5}, False),
        ("ragged k5 wide", "conv_tile",
         (rnd(gen, 1, h, w, 128), rnd(gen, 80, 5, 5, 128,
                                      scale=(25 * 128) ** -0.5),
          rnd(gen, 80, scale=0.1)), {"k": 5}, False),
        ("ragged k1", "conv_tile_v3", conv_args(1, 7),
         {"k": 1, "act": "gelu"}, False),
        ("ragged", "resblock_sft_tile", rsft_args(), {}, False),
        ("ragged", "resblock_sft_tile_v3", rsft_args(), {}, False),
    ]
    return cases


def hwio(w):
    """An OHWI weight as the HWIO kernel of the planar entry points."""
    return w.permute(1, 2, 3, 0).contiguous()


def planar_in(gen, c, hc, wc, wd):
    """A random planar tensor (4 * round16(c), hc, wd) holding a fine
    (c, 2 hc, 2 wc) one; zero beyond it."""
    from boosting_nerv_torch.ops.kernels import planar

    xp = planar.to_planar(rnd(gen, c, 2 * hc, 2 * wc))
    return torch.nn.functional.pad(xp, (0, wd - wc))


def chw_cases(decode_v1, gen):
    """(label, wrapper, args, kwargs, per_frame) for every call of a frame
    of the v1 decode (each with its own weights and the SFT vectors of
    t = 0.5), for the planar form of its stage 7 and head (the planar
    phase's calls: C 51 -> Cp 64, Hc 540, wc_real 960, Wd 1024), and for
    one small ragged call of each of the five wrappers with random weights
    (9 rows, width 50)."""
    t_embed = decode_v1.time_embed(torch.tensor([0.5], device="cuda"))
    tail = decode_v1.chw
    cases = []
    for st in tail.stages:
        h, w = st.out_hw
        if st.upconv is None:
            x = rnd(gen, 1, h // st.strd, w // st.strd, st.conv_w.shape[3])
            cases.append((f"v1 stage {st.index}", "conv3x3_act_chw",
                          (x, st.conv_w, st.conv_b), {}, True))
        x = rnd(gen, 1, h, w, st.rsft[0].shape[0])
        cases.append((f"v1 stage {st.index}", "resblock_sft_chw",
                       (x, *st.rsft, st.sft(t_embed)),
                       {"input_sin": st.upconv is not None}, True))
    h, w = tail.stages[-1].out_hw
    x = rnd(gen, 1, h, w, tail.head_w.shape[3])
    cases.append(("v1 head", "head_conv_chw", (x, tail.head_w, tail.head_b),
                  {}, True))

    st = tail.stages[-1]
    c, hc, wc = st.rsft[0].shape[0], h // 2, w // 2
    w0, b0, w1, b1 = st.rsft
    cases += [
        ("v1 stage 7 planar", "conv_planar",
         (planar_in(gen, c, hc, wc, PLANAR_WD), hwio(st.conv_w), st.conv_b),
         {"c_in": c, "c_out": c, "wc_real": wc, "act": "sin"}, True),
        ("v1 stage 7 planar", "rsft_planar",
         (planar_in(gen, c, hc, wc, PLANAR_WD), hwio(w0), b0, hwio(w1), b1,
          st.sft(t_embed)), {"c": c, "hc_real": hc, "wc_real": wc}, True),
        ("v1 head planar", "conv_planar",
         (planar_in(gen, c, hc, wc, PLANAR_WD), hwio(tail.head_w),
          tail.head_b), {"c_in": c, "c_out": 3, "wc_real": wc,
                         "act": "outimg"}, True),
    ]

    c, h, w = 5, 9, 50
    sft = (torch.rand((4, c), generator=gen, device="cuda") - 0.5) * 0.6

    def conv(cout):
        return (rnd(gen, cout, 3, 3, c, scale=(9 * c) ** -0.5),
                rnd(gen, cout, scale=0.1))

    def rsft():
        return (rnd(gen, c, 3, 3, c, scale=0.2), rnd(gen, c, scale=0.1),
                rnd(gen, c, 3, 3, c, scale=0.2), rnd(gen, c, scale=0.1))

    (wc7, bc7), (w0, b0, w1, b1) = conv(7), rsft()
    cases += [
        ("ragged", "conv3x3_act_chw", (rnd(gen, 1, h, w, c), *conv(7)), {},
         False),
        ("ragged", "head_conv_chw", (rnd(gen, 1, h, w, c), *conv(3)), {},
         False),
        ("ragged", "resblock_sft_chw", (rnd(gen, 1, h, w, c), *rsft(), sft),
         {"input_sin": True}, False),
        ("ragged", "conv_planar", (planar_in(gen, c, h, w, 128), hwio(wc7),
                                   bc7),
         {"c_in": c, "c_out": 7, "wc_real": w, "act": "sin"}, False),
        ("ragged", "rsft_planar", (planar_in(gen, c, h, w, 128), hwio(w0), b0,
                                   hwio(w1), b1, sft),
         {"c": c, "hc_real": h, "wc_real": w}, False),
    ]
    return cases


def out_inv(plain, args):
    """The int8-output multiplier of a stage as calibration would set it:
    127 / (1.05 max|out|) per channel of its plain output."""
    from boosting_nerv_torch.ops.kernels import quant

    bound = plain(*args).float().abs().amax(dim=(0, 1, 2)) * 1.05
    return quant.inv_from_bound(bound).cuda()


def library_ms(args, kw):
    """F.conv2d (bf16, channels_last) of a conv_tile call."""
    x, w, b = args
    xc, wc = x.permute(0, 3, 1, 2), w.permute(0, 3, 1, 2)
    return cuda_ms(lambda: torch.nn.functional.conv2d(
        xc, wc, b, padding=kw["k"] // 2))


def check_kernels(cases, device_line):
    """Phase 4: kernel vs plain at every case; per-kernel summaries
    (errors over all shapes; times and bounds summed over one frame's calls
    of the decode that serves the kernel)."""
    summary = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                   "bound_ms": 0.0, "bound_by": "operations",
                   "library_ms": 0.0 if k in LIBRARY else None}
               for k in KERNELS}
    for label, name, args, kw, per_frame in cases:
        kernel, plain = wrapper(name), wrapper(name, plain=True)
        got = kernel(*args, **kw)
        want = plain(*args, **kw)
        torch.cuda.synchronize()
        codes = ""
        g, wnt = got.float(), want.float()
        if got.dtype == torch.int8:  # dequantise the codes with 1/inv
            inv = kw["out_inv"]
            scale = torch.where(inv > 0, 1 / inv, torch.zeros_like(inv))
            codes = (f" codes_differ "
                     f"{(got != want).float().mean().item():.3e}")
            g, wnt = g * scale, wnt * scale
        err = (g - wnt).abs().max().item()
        tol = STAGE_TOL * max(wnt.abs().max().item(), 1.0)
        ms = cuda_ms(lambda: kernel(*args, **kw))
        plain_ms = cuda_ms(lambda: plain(*args, **kw), iters=2, warmup=1)
        lib_ms = library_ms(args, kw) if name in LIBRARY else None
        b_ms, b_by = bound(name, args, kw, got)
        x = args[0]
        lib = "" if lib_ms is None else f" library_ms {lib_ms:.4f}"
        print(f"kernel {name} {label} in {tuple(x.shape)} {x.dtype} out "
              f"{tuple(got.shape)} {got.dtype}: max_abs_err {err:.6g} (tol "
              f"{tol:.4g}){codes} ms {ms:.4f} plain_ms {plain_ms:.4f}{lib} "
              f"bound_ms {b_ms:.4f} ({b_by}) [{device_line}]", flush=True)
        if not (err <= tol):
            raise SmokeFailure(f"{name} {label}: error {err} > {tol}")
        s = summary[name]
        s["max_abs_err"] = max(s["max_abs_err"], err)
        if per_frame:
            s["ms"] += ms
            s["plain_ms"] += plain_ms
            s["bound_ms"] += b_ms
            if lib_ms is not None:
                s["library_ms"] += lib_ms
            if b_by == "bytes":
                s["bound_by"] = "bytes"
    return summary


def run_ab(decode, v2, v3, gen, device_line):
    """The same-call old/new comparison of the wrappers moved onto
    conv_sm90.cu: the stage kernel's chain (stage_conv.cu, as they were
    served before) against the wrapper, timed in turns old, new, new, old,
    at conv_tile's v2 stage-6 call (61 -> 204), at the bf16 v5 stages 2, 4
    and 6 of fused_upconv_rsft and 3, 5 and 7 + head of fused_conv_rsft,
    and at every resblock_sft_tile_v3 call of the v3 decode (45x80 to
    1080x1920).  Measurement only: no decode path chooses by it, and the
    old chain counts no launch."""
    from boosting_nerv_torch.ops.kernels import (_build, planar, probes,
                                                 tile_conv)

    lib = _build.load_library()
    st6 = next(st for st in v2.fine.stages if st.index == 6)
    h, w = st6.out_hw
    x = rnd(gen, 1, h // st6.strd, w // st6.strd, st6.conv_w.shape[3])
    wt, b = st6.conv_w, st6.conv_b
    out = torch.empty(x.shape[:3] + (wt.shape[0],), dtype=x.dtype,
                      device="cuda")
    cases = [("conv_tile v2 stage 6", tuple(x.shape),
              lambda: planar.launch_conv(lib, x, wt, b, out),
              lambda: tile_conv.conv_tile(x, wt, b, k=wt.shape[1]))]
    t_embed = decode.time_embed(torch.tensor([0.5], device="cuda"))
    for st in decode.tail:
        if st.kernel != "fused_upconv_rsft":
            continue
        xs, sft, sw = rnd(gen, *st.in_shape), st.sft(t_embed), st.weights

        def old(xs=xs, sft=sft, sw=sw):
            n, hh, ww, _ = xs.shape
            y = torch.empty((n, 2 * hh, 2 * ww, sw.w0.shape[0]),
                            dtype=xs.dtype, device="cuda")
            planar.launch_conv(lib, xs, sw.conv_w, sw.conv_b, y, act="sin",
                               shuffle=True)
            return planar.rsft_cuda(lib, y, sw.rsft, sft)

        cases.append((f"fused_upconv_rsft stage {st.index}",
                      tuple(xs.shape), old,
                      lambda xs=xs, sft=sft, sw=sw:
                      planar.fused_upconv_rsft(xs, sw, sft)))
    for st in decode.tail:
        if st.kernel != "fused_conv_rsft":
            continue
        xs, sft, sw = rnd(gen, *st.in_shape), st.sft(t_embed), st.weights
        label = f"fused_conv_rsft stage {st.index}" + (
            " + head" if st.head else "")
        cases.append((label, tuple(xs.shape),
                      lambda xs=xs, sft=sft, sw=sw, hd=st.head:
                      probes.conv_rsft_stage(xs, sw, sft, head=hd),
                      lambda xs=xs, sft=sft, sw=sw, hd=st.head:
                      planar.fused_conv_rsft(xs, sw, sft, head=hd)))
    t3 = v3.time_embed(torch.tensor([0.5], device="cuda"))
    for st in v3.fine.stages:
        h, w = st.out_hw
        xs, sft = rnd(gen, 1, h, w, st.rsft[0].shape[0]), st.sft(t3)
        cases.append((f"resblock_sft_tile_v3 v3 stage {st.index}",
                      tuple(xs.shape),
                      lambda xs=xs, sft=sft, rw=st.rsft:
                      planar.rsft_cuda(lib, xs, rw, sft),
                      lambda xs=xs, sft=sft, rw=st.rsft:
                      tile_conv.resblock_sft_tile_v3(xs, *rw, sft)))
    for label, shape, old, new in cases:
        o1, n1 = cuda_ms(old), cuda_ms(new)
        n2, o2 = cuda_ms(new), cuda_ms(old)
        print(f"a/b {label} in {shape}: stage_conv.cu {(o1 + o2) / 2:.4f} "
              f"ms ({o1:.4f}, {o2:.4f}), conv_sm90.cu {(n1 + n2) / 2:.4f} "
              f"ms ({n1:.4f}, {n2:.4f}) [{device_line}]", flush=True)


def check_plans(decode, v2, v3, device_line):
    """Every conv shape that conv_sm90.cu serves in the decodes: the
    library's shared-memory fit equals its mirror ``conv_sm90.fit`` (which
    the CPU tests use), and the plan each launch gets is printed."""
    from boosting_nerv_torch.ops.kernels import _build, conv_sm90

    shapes = set()
    for st in decode.tail:
        w = st.weights
        shapes |= {tuple(w.conv_w.shape[i] for i in (3, 0, 1)),
                   (w.w0.shape[0], w.w0.shape[0], 3)}
        if st.head:
            shapes.add((w.w0.shape[0], 3, 3))
    for st in v2.fine.stages:
        if st.upconv is None:
            shapes.add(tuple(st.conv_w.shape[i] for i in (3, 0, 1)))
    shapes.add(tuple(v2.fine.head_w.shape[i] for i in (3, 0, 1)))
    shapes |= {(st.rsft[0].shape[0], st.rsft[0].shape[0], 3)
               for st in v3.fine.stages}
    lib = _build.load_library()
    for cin, cout, k in sorted(shapes):
        ns, smem = conv_sm90.plan(lib, cin, cout, k)
        mirror = conv_sm90.fit(cin, cout, k, ns)
        if mirror is None or mirror[-1] != smem:
            raise SmokeFailure(f"conv_sm90 plan of {cin}->{cout} k{k} N "
                               f"{ns}: library {smem} bytes, mirror "
                               f"{mirror}")
        print(f"plan conv_sm90 {cin}->{cout} k{k}: N {ns} x "
              f"{-(-cout // ns)}, {mirror[0]} warpgroup(s), "
              f"{'resident' if mirror[2] else f'ring {mirror[1]}'}, "
              f"{smem} bytes [{device_line}]", flush=True)


def check_refusal(gen, device_line):
    """A conv with more than 128 input channels fits no shared-memory tile
    of the kernel: the tile, v1 and planar wrappers raise ValueError on the
    card."""
    c = 200
    xp = torch.zeros((4 * 208, 2, 128), dtype=torch.bfloat16, device="cuda")

    def rsft_args():
        return (rnd(gen, c, 3, 3, c), rnd(gen, c), rnd(gen, c, 3, 3, c),
                rnd(gen, c), torch.zeros((4, c), device="cuda"))

    calls = {
        "conv_tile": lambda: wrapper("conv_tile")(
            rnd(gen, 1, 9, 50, c), rnd(gen, 8, 5, 5, c), rnd(gen, 8), k=5),
        "conv_tile_v3": lambda: wrapper("conv_tile_v3")(
            rnd(gen, 1, 9, 50, c), rnd(gen, 8, 3, 3, c), rnd(gen, 8), k=3),
        "resblock_sft_tile_v3": lambda: wrapper("resblock_sft_tile_v3")(
            rnd(gen, 1, 9, 50, c), rnd(gen, c, 3, 3, c), rnd(gen, c),
            rnd(gen, c, 3, 3, c), rnd(gen, c),
            torch.zeros((4, c), device="cuda")),
        "conv3x3_act_chw": lambda: wrapper("conv3x3_act_chw")(
            rnd(gen, 1, 9, 50, c), rnd(gen, 8, 3, 3, c), rnd(gen, 8)),
        "head_conv_chw": lambda: wrapper("head_conv_chw")(
            rnd(gen, 1, 9, 50, c), rnd(gen, 3, 3, 3, c), rnd(gen, 3)),
        "resblock_sft_chw": lambda: wrapper("resblock_sft_chw")(
            rnd(gen, 1, 9, 50, c), *rsft_args(), input_sin=True),
        "conv_planar": lambda: wrapper("conv_planar")(
            xp, rnd(gen, 3, 3, c, 8), rnd(gen, 8), c_in=c, c_out=8,
            wc_real=50, act="sin"),
        "rsft_planar": lambda: wrapper("rsft_planar")(
            xp, *(hwio(w) if w.dim() == 4 else w for w in rsft_args()), c=c,
            hc_real=2, wc_real=50),
    }
    for name, call in calls.items():
        try:
            call()
        except ValueError as e:
            print(f"kernel {name} refuses Cin {c} on the card: {e} "
                  f"[{device_line}]", flush=True)
            continue
        raise SmokeFailure(f"{name} took Cin {c} without raising")


def serve(decode, embed, ts, shape=(1, 1080, 1920, 3)):
    """One slice's frames, with the launch counts set to 0 just before and
    read just after."""
    from boosting_nerv_torch.ops import kernels

    kernels.reset_launch_counts()
    outs = [decode(embed, t) for t in ts]
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    want = {k: decode.launches_per_frame.get(k, 0) * len(ts)
            for k in launches}
    if launches != want or not any(want.values()):
        raise SmokeFailure(f"launches {launches} for {len(ts)} frames, "
                           f"expected {want}")
    for out in outs:
        if tuple(out.shape) != shape:
            raise SmokeFailure(f"frame shape {tuple(out.shape)}")
        o = out.float()
        if not bool(torch.isfinite(o).all()):
            raise SmokeFailure("non-finite frame")
        if o.min().item() < 0.0 or o.max().item() > 1.0:
            raise SmokeFailure(f"frame outside [0, 1]: {o.min().item()} .. "
                               f"{o.max().item()}")
    return outs, launches


def turns(first, second, embed, ts):
    """ms/frame of two decodes timed in turns first, second, second, first
    (each turn one region over all frames): (mean, turns) of each."""
    def frames(dec):
        return lambda: [dec(embed, t) for t in ts]

    a1 = cuda_ms(frames(first), iters=1, warmup=1)
    b1 = cuda_ms(frames(second), iters=1, warmup=1)
    b2 = cuda_ms(frames(second), iters=1, warmup=0)
    a2 = cuda_ms(frames(first), iters=1, warmup=0)
    n = len(ts)
    return ((a1 + a2) / 2 / n, (a1 / n, a2 / n)), \
        ((b1 + b2) / 2 / n, (b1 / n, b2 / n))


def check_frames(label, decode, refs, embed, ts, expected=None):
    """Serve the frames, check them against the fp32 references and the
    launch counts; returns the launch counts."""
    if expected is not None and decode.launches_per_frame != expected:
        raise SmokeFailure(f"{label}: launches per frame "
                           f"{decode.launches_per_frame}, expected "
                           f"{expected}")
    outs, launches = serve(decode, embed, ts)
    print(f"slice {label} launches over {len(ts)} frames: {launches} "
          f"(per frame {decode.launches_per_frame})", flush=True)
    err = max((out.float() - ref).abs().max().item()
              for out, ref in zip(outs, refs))
    print(f"slice {label} {len(ts)} frames (1, 1080, 1920, 3) finite in "
          f"[0, 1]: max_abs_err vs fp32 plain decode {err:.6g} (tol "
          f"{SLICE_TOL})", flush=True)
    if not (err <= SLICE_TOL):
        raise SmokeFailure(f"{label} slice error {err} > {SLICE_TOL}")
    return launches


def print_turns(label, a, b, embed, ts, device_line):
    (a_ms, a_t), (b_ms, b_t) = turns(a[1], b[1], embed, ts)
    print(f"decode ms/frame (UVG-1080p, {label}, encoder excluded): "
          f"{b[0]} {b_ms:.3f} ({b_t[0]:.3f}, {b_t[1]:.3f}), {a[0]} "
          f"{a_ms:.3f} ({a_t[0]:.3f}, {a_t[1]:.3f}) [{device_line}]",
          flush=True)


def run_w8a8_slice(decode, decode_i8, plain_i8, embed, ts, device_line):
    """Phase 6: the W8A8 slice; returns its launch counts."""
    if not (decode_i8.w8a8_stages == decode_i8.w8a8_zc == [5, 6, 7]):
        raise SmokeFailure(f"W8A8 stages {decode_i8.w8a8_stages}, "
                           f"zero-convert {decode_i8.w8a8_zc}: expected "
                           "[5, 6, 7] for both")
    outs, launches = serve(decode_i8, embed, ts)
    print(f"slice w8a8 stages {decode_i8.w8a8_stages} (int8 codes in: "
          f"{decode_i8.w8a8_zc}) launches over {N_FRAMES} frames: {launches} "
          f"(per frame {decode_i8.launches_per_frame})", flush=True)
    err = max((out.float() - plain_i8(embed, t).float()).abs().max().item()
              for t, out in zip(ts, outs))
    t_hold = torch.tensor([T_HOLD], device="cuda")
    mse = (decode_i8(embed, t_hold).float()
           - decode(embed, t_hold).float()).pow(2).mean().item()
    psnr = 99.0 if mse <= 1e-12 else -10.0 * math.log10(mse)
    print(f"slice w8a8 {N_FRAMES} frames (1, 1080, 1920, 3) finite in "
          f"[0, 1]: max_abs_err vs plain-stage W8A8 decode {err:.6g} (tol "
          f"{W8A8_TOL}); PSNR vs bf16 kernel decode at t={T_HOLD}: "
          f"{psnr:.3f} dB (gate {PSNR_GATE})", flush=True)
    if not (err <= W8A8_TOL):
        raise SmokeFailure(f"W8A8 slice error {err} > {W8A8_TOL}")
    if not (psnr >= PSNR_GATE):
        raise SmokeFailure(f"W8A8 PSNR {psnr} dB < {PSNR_GATE}")
    print_turns("w8a8 vs bf16", ("bf16", decode), ("w8a8", decode_i8),
                embed, ts, device_line)
    return launches


def run_fallback(device_line):
    """Phase 8: the serving fallback on the card; returns its launch
    counts."""
    from boosting_nerv_torch.models import build_model
    from boosting_nerv_torch.runtime.fast_decode import build_serving_decode

    cfg = no_planar_config()
    model = build_model(cfg, seed=0).eval()
    frame = np.random.default_rng(1).uniform(
        size=(1, 48, 48, 3)).astype(np.float32)
    t = torch.tensor([0.4], device="cuda")
    with torch.no_grad():
        embed = model.encode(torch.from_numpy(frame).cuda())
        ref = model.decode(embed, t)
    decode = build_serving_decode(cfg, model)
    plain = build_serving_decode(cfg, model, plain=True)
    tile = {"conv_tile_v3", "resblock_sft_tile_v3"}
    if not (decode.launches_per_frame and set(decode.launches_per_frame)
            <= tile):
        raise SmokeFailure(f"fallback launches per frame "
                           f"{decode.launches_per_frame}: expected only "
                           f"{sorted(tile)}")
    (out,), launches = serve(decode, embed, [t], shape=(1, 48, 48, 3))
    err_plain = (out.float() - plain(embed, t).float()).abs().max().item()
    err_ref = (out.float() - ref).abs().max().item()
    print(f"serving fallback (no planar tail, {cfg.dec_strds} strides, "
          f"48x48): v3 decode, launches {launches}; max_abs_err vs plain "
          f"version {err_plain:.6g} (tol {STAGE_TOL}), vs fp32 decode "
          f"{err_ref:.6g} (tol {SLICE_TOL}) [{device_line}]", flush=True)
    if not (err_plain <= STAGE_TOL and err_ref <= SLICE_TOL):
        raise SmokeFailure(f"fallback errors {err_plain}, {err_ref}")
    return launches


def run_planar_phase(v1, refs, embed, ts, device_line):
    """Phase 9: stage 7 and the head of the v1 decode in planar form, fed
    the v1 decode's own stage 6 output; returns the launch counts."""
    from boosting_nerv_torch.ops import kernels
    from boosting_nerv_torch.ops.kernels import planar

    _, st7 = v1.chw.stages
    c, (h, w) = st7.rsft[0].shape[0], st7.out_hw
    hc, wc = h // 2, w // 2
    w0, b0, w1, b1 = st7.rsft
    conv_w, w0, w1, head_w = map(hwio, (st7.conv_w, w0, w1, v1.chw.head_w))

    def stage7_head(xp, t_embed):
        x = planar.conv_planar(xp, conv_w, st7.conv_b, c_in=c, c_out=c,
                               wc_real=wc, act="sin")
        x = planar.rsft_planar(x, w0, b0, w1, b1, st7.sft(t_embed), c=c,
                               hc_real=hc, wc_real=wc)
        return planar.conv_planar(x, head_w, v1.chw.head_b, c_in=c, c_out=3,
                                  wc_real=wc, act="outimg")

    with torch.no_grad():
        inputs = []
        for t in ts:
            t_embed = v1.time_embed(t)
            y = v1.chw.switch(v1.prefix(embed, t_embed), t_embed)
            xp = planar.to_planar(y[0].permute(2, 0, 1))
            inputs.append((torch.nn.functional.pad(xp, (0, PLANAR_WD - wc)),
                           t_embed))
        v1_frames = [v1(embed, t) for t in ts]
        kernels.reset_launch_counts()
        frames = [planar.from_planar(stage7_head(*a), 3)[:, :, :w].permute(
            1, 2, 0)[None] for a in inputs]
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        ms = cuda_ms(lambda: stage7_head(*inputs[0]))
    want = {k: PLANAR_LAUNCHES.get(k, 0) * len(ts) for k in launches}
    if launches != want:
        raise SmokeFailure(f"planar phase launches {launches}, expected "
                           f"{want}")
    for out in frames:
        o = out.float()
        if tuple(out.shape) != (1, h, w, 3) or not bool(
                torch.isfinite(o).all()) or o.min() < 0 or o.max() > 1:
            raise SmokeFailure("planar phase: a frame of the wrong shape, "
                               "non-finite or outside [0, 1]")
    err_v1 = max((a.float() - b.float()).abs().max().item()
                 for a, b in zip(frames, v1_frames))
    err = max((a.float() - r).abs().max().item()
              for a, r in zip(frames, refs))
    print(f"planar phase (v1 stage 7 + head as conv_planar, rsft_planar, "
          f"conv_planar; Hc {hc}, wc_real {wc}, Wd {PLANAR_WD}) launches over "
          f"{len(ts)} frames: {launches}; max_abs_err vs v1 frames "
          f"{err_v1:.6g} (tol {STAGE_TOL}), vs fp32 plain decode {err:.6g} "
          f"(tol {SLICE_TOL}); {ms:.3f} ms/frame [{device_line}]", flush=True)
    if not (err_v1 <= STAGE_TOL and err <= SLICE_TOL):
        raise SmokeFailure(f"planar phase errors {err_v1}, {err}")
    return launches


def run_probe_phase(device_line):
    """Phase 10: the probes; returns the launch counts of the timed run and
    the kernels-line entries of the four probe wrappers (each with the
    numbers of its family's headline variant)."""
    from boosting_nerv_torch.ops import kernels
    from boosting_nerv_torch.ops.kernels import _build
    from boosting_nerv_torch.tools import probes

    lib = _build.library_path()
    regs = {i["name"]: i for i in probes.ptxas_instances(lib + ".log")}
    counts = probes.sass_mma_counts(lib)
    for name, n in counts.items():
        src, desc = probes.source_of(name), probes.describe(name)
        if desc is None or src not in probes.PROBE_SOURCES:
            continue
        reg = regs.get(name, {})
        print(f"probe instance {src} {desc[0]} {desc[1]}: "
              f"{reg.get('registers')} registers, {reg.get('spills')} spill "
              f"bytes, {n} HMMA/IMMA", flush=True)
    if not any(probes.source_of(n) in probes.PROBE_SOURCES for n in counts):
        raise SmokeFailure("no probe instance in the library's SASS")
    bad = probes.mma_rule_failures(counts)
    if bad:
        raise SmokeFailure(f"probe instances with the wrong tensor-core "
                           f"instruction count: {bad}")
    keys = list(probes.VARIANTS)
    errs = dict.fromkeys(keys, 0.0)
    t0 = time.perf_counter()
    try:
        for size in ("tiny", "full"):
            checked = probes.run(keys, probes.Ctx.make("cuda", size),
                                 check=True, time=False)
            for k, r in checked.items():
                errs[k] = max(errs[k], r["err"] or 0.0)
        print(f"probe checks: {len(keys)} variants at full size and at a "
              f"small ragged size, every one held "
              f"({time.perf_counter() - t0:.1f} s) [{device_line}]",
              flush=True)
        heads = [head for _, _, head in probes.FAMILIES.values()]
        ctx = probes.Ctx.make("cuda", "full")
        kernels.reset_launch_counts()
        timed = probes.run(keys, ctx, extras=heads)
        launches = dict(kernels.LAUNCHES)
    except probes.ProbeFailure as e:
        raise SmokeFailure(f"probe phase: {e}") from e
    for site, entry in probes.PROBES.items():
        parts = [f"{k} {timed[k]['ms']:.4f} ms (bound "
                 f"{timed[k]['bound_ms']:.4f} {timed[k]['bound_by']}, "
                 f"{100 * timed[k]['share']:.2f}%)" for k in entry.variants]
        print(f"probe {site}: " + "; ".join(parts) + f" [{device_line}]",
              flush=True)
    for line in probes.breakdown_lines(timed):
        print(f"{line} [{device_line}]", flush=True)
    entries = {}
    for fam, (name, src, head) in probes.FAMILIES.items():
        mine = [k for k in keys if probes.VARIANTS[k].family == fam]
        sites = [s for s, e in probes.PROBES.items()
                 if set(e.variants) & set(mine)]
        r = timed[head]
        entries[name] = {
            "name": name, "route": "cuda", "source": src,
            "replaces": ", ".join(sites),
            "max_abs_err": max(errs[k] for k in mine), "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        print(f"probe {name} ({fam}) headline {head}: ms {r['ms']:.4f} "
              f"plain_ms {r['plain_ms']:.4f} bound_ms {r['bound_ms']:.4f} "
              f"({r['bound_by']}) library_ms {r['library_ms']} "
              f"[{device_line}]", flush=True)
    return launches, entries


def print_ptxas(log_path):
    """One line per source of ptxas's report in the build log: kernel
    instances, the range of their registers and their spill bytes."""
    sections = open(log_path).read().split("\n# ")
    for sec in sections:
        name, _, text = sec.lstrip("# ").partition("\n")
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(a) + int(b) for a, b in re.findall(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads", text))
        if regs:
            print(f"ptxas {name}: {len(regs)} kernel instances, "
                  f"{min(regs)}-{max(regs)} registers {sorted(regs)}, "
                  f"{spills} spill bytes", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one GPU",
              file=sys.stderr)
        return 2
    from boosting_nerv_torch.models import build_model
    from boosting_nerv_torch.ops.kernels import _build
    from boosting_nerv_torch.runtime.fast_decode import (
        build_fast_decode, build_fast_decode_v2, build_fast_decode_v3,
        build_fast_decode_v5, build_serving_decode)

    device_line = card()
    print(f"card: {device_line}", flush=True)
    # every float32 reference in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({_build.library_path()})", flush=True)
    print_ptxas(_build.library_path() + ".log")

    cfg = bench_config()
    model = build_model(cfg, seed=0).eval()
    frame = np.random.default_rng(0).uniform(
        size=(1, 1080, 1920, 3)).astype(np.float32)
    with torch.no_grad():
        embed = model.encode(torch.from_numpy(frame).cuda())
    ts = [torch.tensor([v], dtype=torch.float32, device="cuda")
          for v in np.linspace(0.01, 1.0, N_FRAMES)]
    calib = [(embed, torch.tensor([v], device="cuda")) for v in CALIB_TS]
    t0 = time.perf_counter()
    decode = build_serving_decode(cfg, model)
    plain_decode = build_serving_decode(cfg, model, plain=True)
    decode_i8 = build_serving_decode(cfg, model, w8a8_calib=calib)
    plain_i8 = build_serving_decode(cfg, model, w8a8_calib=calib, plain=True)
    v3 = build_fast_decode_v3(cfg, model, tile_from_h=TILE_FROM_H)
    plain_v3 = build_fast_decode_v3(cfg, model, tile_from_h=TILE_FROM_H,
                                    plain=True)
    v2 = build_fast_decode_v2(cfg, model, tile_from_h=TILE_FROM_H)
    plain_v2 = build_fast_decode_v2(cfg, model, tile_from_h=TILE_FROM_H,
                                    plain=True)
    hybrid = build_fast_decode_v5(cfg, model, fine_from_h=FINE_FROM_H)
    v1 = build_fast_decode(cfg, model, PALLAS_FROM_H)
    plain_v1 = build_fast_decode(cfg, model, PALLAS_FROM_H, plain=True)
    if v1.switch_at != 6:
        raise SmokeFailure(f"v1 switches at stage {v1.switch_at}, expected 6")
    print(f"decodes built (11, W8A8 calibrated twice; v1 switch at stage "
          f"{v1.switch_at}): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    with torch.no_grad():
        refs = [model.decode(embed, t) for t in ts]

    gen = torch.Generator(device="cuda").manual_seed(0)
    summary = check_kernels(stage_cases(decode, decode_i8, gen)
                            + tile_cases(v3, v2, gen) + chw_cases(v1, gen),
                            device_line)
    check_refusal(gen, device_line)
    check_plans(decode, v2, v3, device_line)
    run_ab(decode, v2, v3, gen, device_line)
    runs = [check_frames("bf16", decode, refs, embed, ts)]
    print_turns("bf16", ("plain stages", plain_decode), ("kernels", decode),
                embed, ts, device_line)
    runs.append(run_w8a8_slice(decode, decode_i8, plain_i8, embed, ts,
                               device_line))
    for label, dec, plain, want in (("v3", v3, plain_v3, V3_LAUNCHES),
                                    ("v2", v2, plain_v2, V2_LAUNCHES),
                                    ("hybrid", hybrid, None,
                                     HYBRID_LAUNCHES),
                                    ("v1", v1, plain_v1, V1_LAUNCHES)):
        runs.append(check_frames(label, dec, refs, embed, ts, want))
        print_turns(f"{label} vs v5 bf16", ("v5 bf16", decode), (label, dec),
                    embed, ts, device_line)
        if plain is not None:
            print_turns(f"{label}", (f"{label} plain", plain),
                        (f"{label} kernels", dec), embed, ts, device_line)
    runs.append(run_fallback(device_line))
    runs.append(run_planar_phase(v1, refs, embed, ts, device_line))
    probe_launches, probe_entries = run_probe_phase(device_line)
    runs.append(probe_launches)

    leaked = [m for m in ("jax", "flax", "boosting_nerv_tpu")
              if m in sys.modules]
    if leaked:
        raise SmokeFailure(f"imported {leaked}")
    entries = [{"name": name, "route": "cuda", "source": src,
                "replaces": rep, **summary[name]}
               for name, (src, rep) in KERNELS.items()]
    entries += list(probe_entries.values())
    unused = [e["name"] for e in entries
              if not sum(r[e["name"]] for r in runs)]
    if unused:
        raise SmokeFailure(f"kernels the main paths never launched: {unused}")
    print(json.dumps({"kernels": [
        {**e, "launches": sum(r[e["name"]] for r in runs)} for e in entries]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
