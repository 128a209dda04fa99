#!/usr/bin/env python3
"""Smoke run of the PyTorch port (boosting_nerv_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line of output each (or one line per shape):

1. requires CUDA (exits non-zero before anything else without it) and
   prints the card's name and power limit as nvidia-smi reports them;
2. builds the hand-written kernels from ``boosting_nerv_torch/ops/csrc``
   and prints the build's seconds and ptxas's register and spill report of
   every kernel instance, then one line per instance of the int8 form of
   the Hopper kernel (``conv_sm90_i8*.cu``) and of its sin, planar and
   K-loop modes (``conv_sm90_sin.cu``, ``conv_sm90_planar.cu``,
   ``conv_sm90_kloop.cu``): registers, spill
   bytes and its wgmma instructions in ``cuobjdump -sass`` (each instance
   must have some, and no spills);
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
   ragged shape each (width 50 and 9 rows; k = 1 with act gelu for
   conv_tile_v3, k = 5 for conv_tile, also at 128 -> 80 channels, which
   the Hopper kernel takes only at its narrowest N slice; wc_real 50 for
   the planar ones, rsft_planar also with hc_real 7 of 9 rows and random
   pads; the four tile wrappers, the three v1 wrappers and the bf16
   fused_upconv_rsft and fused_conv_rsft on the Hopper kernel
   conv_sm90.cu, resblock_sft_chw's input_sin on its sin instances
   conv_sm90_sin.cu, rsft_planar and conv_planar on its planar instances
   conv_sm90_planar.cu, the W8A8 fused_upconv_rsft_i8 and
   fused_conv_rsft_i8 on its int8 form conv_sm90_i8.cu): max
   abs error within 2e-2 * max(|plain|, 1), int8 codes compared after
   dequantising with 1/inv; prints the share of codes that differ; times
   both with CUDA events, F.conv2d for conv_tile and, beside
   conv_tile_v3, F.conv2d of its conv alone (no act); then checks that a
   conv with more input channels than the kernel takes (264: beyond its
   K loop's 256 in bf16, and beyond the modes' 128) raises ValueError on
   the card from the tile, v1 and planar wrappers; checks conv_sm90.cu's and conv_sm90_i8.cu's shared-memory
   plan of every conv shape they serve, and conv_sm90.cu's slice-group
   plan G at every launch grid, and those of the sin instances at the v1
   ResBlockSFT's grid and of the planar instances at the planar phase's
   (rsft_planar's two modes, conv_planar's in-and-out mode), against the
   Python mirror and prints the
   plans; times each conv_sm90.cu launch of the v3 decode on a grid of at
   most 270 rows and the v5 stage 2 upconv at every slice-group count
   and at one and two warpgroups beside the plan's ("schedule" lines);
   and times the stage kernel's
   chain (stage_conv.cu) beside conv_sm90.cu in turns (old, new, new,
   old) at conv_tile's v2 stage-6 call, at fused_upconv_rsft's bf16
   stages 2, 4 and 6, at fused_conv_rsft's stages 3, 5 and 7 + head, at
   every resblock_sft_tile_v3 and conv_tile_v3 call of the v3 decode and
   at every resblock_sft_tile call of the v2 decode, at resblock_sft_chw's
   v1 stages 6 (input_sin) and 7, at conv3x3_act_chw's v1 stage 7 and
   head_conv_chw's v1 head, at rsft_planar's planar stage 7 and
   conv_planar's two planar-phase calls (stage 7 with sin, the head with
   outimg; each with its torch crop and planar write around the stage
   kernel, as it was served before), and rsft_planar's two designs on
   conv_sm90 (the NHWC chain with the torch crop and write, against the
   planar instances), with one "split" line each for rsft_planar and for
   conv_planar's stage-7 call (its fill and launch against the NHWC
   conv_sm90.cu launch of the same conv), and the W8A8 stage
   kernel's chain (stage_conv_i8.cu) beside conv_sm90_i8.cu at the W8A8
   stages 5, 6 and 7 + head (the same-call A/B);
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
10. the probe phase, the path of the five probe wrappers
   (``boosting_nerv_torch/tools/probes.py``, the counterparts of the TPU
   probes in ``tools/``): prints each probe instance's registers, spills
   and tensor-core instruction count (HMMA, IMMA, HGMMA, IGMMA) from
   ``cuobjdump -sass`` (a no-GEMM instance must have none, every other
   K1-K3 and K5 instance some, the staging kernels none);
   holds every probe variant against its plain version at full size and
   at a small ragged one (2e-2 * max(|plain|, 1), or exact where the
   variant computes the production launch's function: "all" against the
   production wrapper, DIRECT, PACK and ASYNC, the staging modes against
   their plain staging, no STORE against its untouched output); then times
   every variant through the entry point and prints one line per TPU site
   and the phase breakdown of each stage (K1 on the stage kernel, K2 on
   the W8A8 stage kernel, K5 on conv_sm90.cu and on its int8 form
   conv_sm90_i8.cu at the W8A8 stage 7 + head and stage 6);
11. the training slice: the port's ``RegressionTrainer`` at bench.py's
   widths (fc_dim pinned at 127) on a 4-frame 1080x1920
   ``synthetic_video``, batch 1, Fusion10_freq, Adan, lr 0.003 (the UVG
   recipe's), TF32 off, 3 epochs (12 steps; evals at epochs 1 and 3, each
   timing the serving decode); checks (a) the first step's loss against
   ``loss_fn(model(img, t), img)`` just before it (1e-5 relative), (b)
   every loss finite and the last epoch's mean train PSNR above the
   first's, the training run's launches (fused_upconv_rsft and
   fused_conv_rsft 3 a decode, one warm-up and 20 timed decodes an eval,
   nothing else), (c) ``evaluate(huffman_coding=True)``: 8 finite slots,
   bits/param > 0, fps > 0, (d) ``measure_fps``'s launches (the same, 3 a
   decode) and the serving decode of the trained weights at t = 0.37
   within 1e-2 of their fp32 decode, (e) a checkpoint written by the
   port loads back to identical parameters; prints the median train-step
   ms (CUDA events), the peak allocation of a step without and with
   ``remat``, the eval's seconds and the fps; then one step at the same
   widths on a 120x240 frame on the card and on the CPU from the same
   weights, TF32 off (L1_freq: MS-SSIM needs more than 160 pixels a
   side): the losses within 1e-4 relative, every gradient within 1e-3 of
   its leaf's max |g| (the CPU on torch's own convolutions; the CPU on
   oneDNN's, its default, printed beside it and not gated);
12. the other families: NeRV-Boost and E-NeRV-Boost at UVG-1080p 10M full
   width (scripts/regression/UVG/{nerv_boost,enerv_boost}.sh, modelsize
   5.2 / 4.3: fc_dim 131 / 115; seeded random weights): the bf16 serving
   decode and the W8A8 one (calibrated as phase 3's, t in CALIB_TS,
   margin 1.05), each also on its wrappers' plain versions; the W8A8
   stages ([3] / [3, 7], int8 codes into each) and each decode's launches
   a frame (bf16: fused_upconv_rsft 3, fused_conv_rsft 3; W8A8 3 / 2 / 1
   and 3 / 1 / 2 of fused_upconv_rsft / fused_conv_rsft /
   fused_conv_rsft_i8); the plans of their convs (E-NeRV-Boost's stage-2
   upconv, 172 -> 4 x 86, on the K loop of conv_sm90_kloop.cu); every
   stage wrapper against its plain version at every tail shape, with
   phase 4's tolerance, ms and bound (stage 2's K-loop upconv alone and
   with int8 codes out, and the K loop's widest served input, stage 2 of
   E-NeRV-Boost 15M, Cin 213, with random weights, alone and with codes
   out); 8 frames of each decode (bf16 within 1e-2 of the
   fp32 model, TF32 off; W8A8 within 2e-2 of its plain stages and >= 35 dB
   against bf16 at t = 0.37) with their launch counts, and the timing
   turns (plain, kernels; bf16, W8A8); then ``train()`` of each for one
   epoch of a 4-frame 1080x1920 clip (4 steps and its eval; its recipe's
   lr, Fusion10_freq, Adan, TF32 off, E-NeRV-Boost's clip 1.0): the
   first loss against a forward just before it (1e-5 relative), every
   loss finite, ``measure_fps``'s launches (3 + 3 a decode), the median
   step ms and the peak allocation; and one step of the HNeRV baseline
   (scripts/regression/UVG/hnerv.sh, modelsize 3, fc_dim 83), whose fps
   clock times its eager decode (no kernel launch); then the phase's
   seconds;
13. CEM compression (``training/compress_trainer.py``): two recipes at
   full width, TF32 off (the recipes train at "high"), one epoch of a
   4-frame 1080x1920 clip, batch 1, Fusion10_freq, Adan, lr 0.0005
   cosine_0_1_0.1, 8-bit quantisers, target_bit 4: HNeRV-Boost
   (scripts/compression/hnerv_boost.sh, Size 2.8: bench.py's model,
   fc_dim 127; scale / scale / scalebeta, ``embed_entropy``, lambda 0.05;
   warm-started with ``--weight`` from phase 11's ``model_latest.ckpt``)
   and NeRV-Boost (nerv_boost.sh, Size 5.2: fc_dim 131; scale / scale,
   lambda 0.2; seeded weights).  For each: (a) one CEM step on a 120x240
   frame on the card and on the CPU (torch's own convolutions) from the
   same weights, quantisers and noise, loss and bpp within 1e-4 relative
   (L1_freq; NeRV-Boost at fc_hw 1_2); (b) ``train()`` (4 steps and its
   coding eval): every loss finite, the quantiser parameters moved from
   their ``init_qparams`` values, each step's bpp a frame against
   ``target_bpp`` (the rate term on or off), its eval's fps clock's
   launches; (c) ``evaluate_cem(coding=True)`` once more: its seconds,
   the ``quant_seen`` PSNR / SSIM, real and estimated bpp and their ratio
   within [0.9, 1.1], and every tensor's rANS stream (each frame's
   embedding's too) decoded back to its codes exactly; (d) that eval's
   ``measure_fps`` of the dequantised weights through the serving
   decode, launches fused_upconv_rsft 3 and fused_conv_rsft 3 a decode,
   20 decodes and a warm-up, and one serving decode at t = 0.37 (3 + 3
   launches) within 1e-2 of the eager dequantised model (bf16 against
   fp32); (e) a fresh trainer resumes the CEM checkpoint with equal model
   and quantiser parameters; (f) the median CEM step ms (CUDA events)
   and the peak allocation of a step beside the regression step of the
   same trainer; then the phase's seconds;
14. the tasks and the script surface, at full width: (a) a 17-frame
   1080x1920 synthetic clip written as PNGs by ``data/png.py`` and read
   back by ``VideoData.from_dir`` equal to the array (ms a frame written
   and read); (b) the first command of scripts/interpolation/hnerv_boost.sh
   (Beauty: HNeRV-Boost at modelsize 2.75, ``1_1_2``, ``--embed_inter``,
   ``--train_precision high``), listed by ``recipes.recipe_commands`` and
   run in-process through the port's CLI with only these cuts, each
   printed: ``--data_path`` the clip, ``-e 2``, ``--eval_freq 1``,
   ``--outf`` under output/chip_smoke_tasks, ``--not_resume``, plus
   ``--profile --dump_images --dump_videos``: the split 9 even training
   frames and 8 odd validation frames, every loss finite, each eval's fps
   clock launching fused_upconv_rsft 3 and fused_conv_rsft 3 a decode;
   (c) the eval's ``pred_unseen_psnr`` within 1e-3 dB of a recomputation
   from the trained model that decodes each odd frame from
   ``0.5 * (encode(pre) + encode(post))``; (d) one serving decode of the
   trained weights at t = 0.37 (3 + 3 launches) within 1e-2 of the eager
   fp32 model; (e) the profiler's Chrome trace holds CUDA kernels launched
   in each of the five traced steps (2-6); (f) 17 dumped PNGs named by
   index, each read by ``data/png.py`` within 0.5 dB of the PSNR in its
   name, and ``gt_pred.gif`` with a 1920x1080 screen and 17 image
   descriptors (its seconds and bytes); (g) ``--eval_only`` on the run's
   ``model_latest.ckpt``: ``eval.csv``, one ``eval.txt`` line, metrics
   within 0.01 dB of the last training eval, its fps clock's launches;
   (h) one epoch of the first command of scripts/interpolation/
   nerv_boost.sh (index-only, the plain eval on the split) with the same
   cuts; then the seconds of an eval of (b)'s model without and with the
   dumps, the median step ms of (b)'s model with TF32 on (the recipe's
   "high") and off, in turns, and the phase's seconds;
15. data parallelism (``boosting_nerv_torch/parallel``), run just after
   phase 11, whose checkpoint its CEM step starts from: phase 11's model
   at full width (fc_dim 127, TF32 off) on four synthetic 1080x1920
   frames, global batch 2 (frames 0 and 1).  (a) dp=2: two ranks on
   cuda:0 over gloo (NCCL refuses two ranks on one device), started by
   ``parallel.launch`` and running ``parallel.steps``' workers: 2
   regression steps (Fusion10_freq, Adan, lr 0.003), then 1 CEM step
   (hnerv_boost.sh's quantisers, ``embed_entropy``, from phase 11's
   checkpoint) fed noise drawn once on the CPU; each held to the same
   steps at dp=1 in this process: the losses (and the CEM step's bpp)
   within 1e-4 relative, the first step's gradients of the weights and
   the parameters (and quantiser parameters) after it within 1e-3 of each
   leaf's largest value, except elements whose two gradients differ in sign or lie
   within 1e-6 of 0, where Adan's step flips or follows |g| (there within
   2 lr), the
   two ranks' parameters identical; (b) dp=1 through
   DDP over NCCL at world size 1 (``make_mesh_plan(1, backend="nccl")``
   in one launched rank): its first loss equal to the plain dp=1 step's
   (1e-5 relative), then its median step ms beside the plain step's, in
   turns plain, DDP, DDP, plain (3 steps a turn, CUDA events); each
   rank's device and peak allocation, no kernel launched, and the
   phase's seconds;
16. the 'spatial' axis (``parallel/spatial.py``), run just after phase 15
   (its CEM step starts from phase 11's checkpoint): phase 11's model at
   full width (fc_dim 127, TF32 off) on four synthetic 1080x1920 frames,
   batch 1 (frame 0), Fusion10_freq, Adan, lr 0.003.  sp=1 runs in this
   process; sp=2 as two ranks on cuda:0 over gloo (one launch, its
   workers ``parallel.steps``' ``train_steps``, ``cem_steps`` and
   ``split_decode``): 2 regression steps and 1 CEM step (hnerv_boost.sh's
   quantisers, ``embed_entropy``, each side drawing its noise from the
   trainer's seeded generator), held to sp=1 with phase 15's gates (the
   losses and the CEM step's bpp within 1e-4 relative, the first step's
   gradients and the parameters after it within 1e-3 of each leaf's
   largest where no Adan step flips, the two ranks' parameters
   identical); one split decode of the seeded weights at t = 0.37 from
   frame 0's embedding, held to the whole decode in this process within
   1e-4 abs (fp32, TF32 off); printed: the split plan, each rank's peak
   allocation beside sp=1's, the step ms (host clock to the loss read
   back) beside sp=1's, the split decode's ms a frame beside the whole
   decode's (CUDA events, median of 5), no kernel launched, and the
   phase's seconds.

The launch counts are set to 0 just before each slice's frames (the
planar phase's stage-7 calls, the probe phase's timed run, the training
runs, the CEM evals and fps clocks, the tasks phase's runs) and read just
after.  Before the
last two lines the run's seconds are printed.  The line before the last
is a JSON object with one entry per kernel; the last line is
{"ok": true, "device": {...}}.  Any failed phase exits non-zero without
printing either.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import statistics
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
SM90_CU = "boosting_nerv_torch/ops/csrc/conv_sm90.cu"
SM90_I8_CU = "boosting_nerv_torch/ops/csrc/conv_sm90_i8.cu"
SM90_SIN_CU = "boosting_nerv_torch/ops/csrc/conv_sm90_sin.cu"
SM90_PLANAR_CU = "boosting_nerv_torch/ops/csrc/conv_sm90_planar.cu"
KERNELS = {  # wrapper: (source, replaces)
    "fused_upconv_rsft": (SM90_CU, f"{PLANAR}:1308"),
    "fused_conv_rsft": (SM90_CU, f"{PLANAR}:1541"),
    "fused_upconv_rsft_i8": (SM90_I8_CU,
                             f"{PLANAR}:1308 (W8A8 prep {PLANAR}:707)"),
    "fused_conv_rsft_i8": (SM90_I8_CU,
                           f"{PLANAR}:1541 (W8A8 prep {PLANAR}:673)"),
    "conv_tile": (SM90_CU, f"{TILE}:144"),
    "conv_tile_v3": (SM90_CU, f"{TILE}:473"),
    "resblock_sft_tile": (SM90_CU, f"{TILE}:951"),
    "resblock_sft_tile_v3": (SM90_CU, f"{TILE}:788"),
    "conv3x3_act_chw": (SM90_CU, f"{CHW}:88"),
    "head_conv_chw": (SM90_CU, f"{CHW}:95"),
    "resblock_sft_chw": (SM90_SIN_CU,
                         "boosting_nerv_tpu/ops/pallas/fused_sft.py:138"),
    "conv_planar": (SM90_PLANAR_CU, f"{PLANAR}:398"),
    "rsft_planar": (SM90_PLANAR_CU, f"{PLANAR}:484"),
}
LIBRARY = {"conv_tile"}  # one PyTorch call computes it: F.conv2d
V3_LAUNCHES = {"conv_tile_v3": 8, "resblock_sft_tile_v3": 8}
V2_LAUNCHES = {"conv_tile": 8, "resblock_sft_tile": 8}
HYBRID_LAUNCHES = {"fused_upconv_rsft": 2, "fused_conv_rsft": 2,
                   "conv_tile_v3": 3, "resblock_sft_tile_v3": 2}
V1_LAUNCHES = {"conv3x3_act_chw": 1, "resblock_sft_chw": 2,
               "head_conv_chw": 1}
PLANAR_LAUNCHES = {"conv_planar": 2, "rsft_planar": 1}
REPO = os.path.dirname(os.path.abspath(__file__))
# phase 11, the training slice
TRAIN_FRAMES = 4     # a 4-frame 1080x1920 synthetic clip, batch 1
TRAIN_EPOCHS = 3     # 12 steps; evals at epochs 1 and 3 (last 3 and 1)
TRAIN_LR = 0.003     # scripts/regression/UVG/hnerv_boost.sh
FPS_REPS = 20        # measure_fps's timed decodes (eval_fps off)
# phase 13, CEM compression: phase 11's checkpoint warm-starts HNeRV-Boost
WARM_CKPT = os.path.join(REPO, "output", "chip_smoke_cem", "warm.ckpt")
CEM_LR = 0.0005      # scripts/compression/*.sh
CEM_RATIO = (0.9, 1.1)  # total_bpp / estimate_bpp: the coder's overhead
CEM_STEP_RTOL = 1e-4  # card vs CPU: loss and bpp of one CEM step
SERVING_LAUNCHES = {"fused_upconv_rsft": 3, "fused_conv_rsft": 3}
FIRST_LOSS_RTOL = 1e-5  # the first step's loss vs a forward just before
STEP_LOSS_RTOL = 1e-4   # card vs CPU, TF32 off on the card
STEP_GRAD_TOL = 1e-3    # x the leaf's max |g|, card vs CPU
# phase 12, the other families at UVG-1080p 10M (scripts/regression/UVG)
FAMILY_SIZES = {"NeRV_Boost": 5.2, "ENeRV_Boost": 4.3}
FAMILY_LR = {"NeRV_Boost": 0.003, "ENeRV_Boost": 0.0015}
FAMILY_W8A8 = {"NeRV_Boost": [3], "ENeRV_Boost": [3, 7]}
ENERV_15M = 5.8     # enerv_boost.sh's 15M: stage 2 takes Cin 213
FAMILY_LAUNCHES = {  # a frame's launches, bf16 (False) and W8A8 (True)
    ("NeRV_Boost", False): SERVING_LAUNCHES,
    ("NeRV_Boost", True): {"fused_upconv_rsft": 3, "fused_conv_rsft": 2,
                           "fused_conv_rsft_i8": 1},
    ("ENeRV_Boost", False): SERVING_LAUNCHES,
    ("ENeRV_Boost", True): {"fused_upconv_rsft": 3, "fused_conv_rsft": 1,
                            "fused_conv_rsft_i8": 2}}
# phase 14, the tasks slice: scripts/interpolation/*.sh at full width
TASK_FRAMES = 17     # 9 even frames train, 8 odd frames test
TASK_ROOT = os.path.join(REPO, "output", "chip_smoke_tasks")
TASK_PSNR_TOL = 1e-3  # dB: the eval's unseen PSNR vs its recomputation
DUMP_PSNR_TOL = 0.5  # dB: a dumped PNG (truncated to uint8) vs its name
EVAL_ONLY_TOL = 0.01  # dB: --eval_only vs the last training eval
TRACED_STEPS = 5     # --profile: steps 2-6 of the first epoch
# phase 15, data parallelism on the one card
DP_FRAMES = 4        # four 1080x1920 frames; the global batch is 0 and 1
DP_IDX = [0, 1]
DP_STEPS = 2         # regression steps of each run
DP_TURN_STEPS = 3    # (b): timed steps a turn
DP_TIMEOUT = 600.0   # seconds a rank waits in a collective
# Adan's first step moves an element by lr g / (|g| + eps), eps 1e-8:
# where the two runs' gradients differ in sign it flips, and where one
# lies within 100 eps of 0 the step's size follows |g| by more than 1%
# (the JAX package compares raw gradients for that reason,
# __graft_entry__.py:186-189)
DP_FLIP_G = 1e-6
# phase 16, the 'spatial' axis on the one card
SP_IDX = [0]         # batch 1: frame 0
SP_STEPS = 4         # regression steps a side: DP_STEPS gated, and the
                     # median of all but the first (cuDNN's warm-up) timed
SP_DECODE_TOL = 1e-4  # max abs, split decode vs whole, fp32
SP_DECODE_REPS = 5   # timed decodes a side
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
        taps = w.head_w.shape[1] * w.head_w.shape[2] if kw.get("head") \
            else 0   # the head: 3x3 (HNeRV-Boost) or 1x1
        ops = 2 * (9 * (h * wd * c_in * cout + 2 * hf * wf * c * c)
                   + taps * hf * wf * c * 3)
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


def tail_cases(decode, decode_i8, gen, prefix=""):
    """(label, wrapper, args, kwargs, per_frame) for every tail stage of
    the bf16 serving decode and for the W8A8 one's stages that run int8
    or store int8 codes, each with its own weights and the SFT vectors of
    t = 0.5; per_frame: the case is one call of a frame of the decode that
    serves the wrapper."""
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
        cases.append((f"{prefix}stage {st.index}{tag}", st.kernel,
                      (x, st.weights, st.sft(t_embed)), kw,
                      st.kernel.endswith("_i8") or not tag))
    return cases


def stage_cases(decode, decode_i8, gen):
    """(label, wrapper, args, kwargs, per_frame) for every tail stage of
    the bf16 serving decode and for stage 4 (bf16, int8-code output) and the
    int8 stages of the W8A8 one, each with its own weights and the SFT
    vectors of t = 0.5, plus one small ragged stage of each wrapper with
    random weights.  per_frame: the case is one call of a frame of the
    decode that serves the wrapper (the bf16 wrappers the bf16 decode, the
    int8 ones the W8A8 decode)."""
    from boosting_nerv_torch.ops.kernels import planar

    cases = tail_cases(decode, decode_i8, gen)
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


def planar_in(gen, c, hc, wc, wd, fill=False):
    """A random planar tensor (4 * round16(c), hc, wd) holding a fine
    (c, 2 hc, 2 wc) one; zero beyond it, or with ``fill`` random there
    too."""
    from boosting_nerv_torch.ops.kernels import planar

    xp = planar.to_planar(rnd(gen, c, 2 * hc, 2 * wc))
    xp = torch.nn.functional.pad(xp, (0, wd - wc))
    if fill:
        real = torch.zeros_like(xp, dtype=torch.bool)
        real.view(4, -1, hc, wd)[:, :c, :, :wc] = True
        xp = torch.where(real, xp, rnd(gen, *xp.shape))
    return xp


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
        ("ragged rows", "rsft_planar",
         (planar_in(gen, c, h, w, 128, fill=True), hwio(w0), b0, hwio(w1),
          b1, sft), {"c": c, "hc_real": h - 2, "wc_real": w}, False),
    ]
    return cases


def out_inv(plain, args):
    """The int8-output multiplier of a stage as calibration would set it:
    127 / (1.05 max|out|) per channel of its plain output."""
    from boosting_nerv_torch.ops.kernels import quant

    bound = plain(*args).float().abs().amax(dim=(0, 1, 2)) * 1.05
    return quant.inv_from_bound(bound).cuda()


def library_ms(args, kw):
    """F.conv2d (bf16, channels_last) of a conv_tile call, or of a
    conv_tile_v3 call's conv alone (no act)."""
    x, w, b = args
    xc, wc = x.permute(0, 3, 1, 2), w.permute(0, 3, 1, 2)
    return cuda_ms(lambda: torch.nn.functional.conv2d(
        xc, wc, b, padding=kw["k"] // 2))


def check_kernels(cases, device_line, v3_line=True):
    """Phase 4: kernel vs plain at every case; per-kernel summaries
    (errors over all shapes; times and bounds summed over one frame's calls
    of the decode that serves the kernel); with ``v3_line`` the v3 frame's
    conv_tile_v3 time beside F.conv2d's."""
    summary = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                   "bound_ms": 0.0, "bound_by": "operations",
                   "library_ms": 0.0 if k in LIBRARY else None}
               for k in KERNELS}
    alone = 0.0  # F.conv2d of the conv alone over the v3 frame's calls
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
        conv_ms = library_ms(args, kw) if name == "conv_tile_v3" else None
        b_ms, b_by = bound(name, args, kw, got)
        x = args[0]
        lib = "" if lib_ms is None else f" library_ms {lib_ms:.4f}"
        if conv_ms is not None:
            lib = f" conv_alone_ms {conv_ms:.4f} (F.conv2d, no act)"
            alone += conv_ms if per_frame else 0.0
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
    if v3_line:
        print(f"conv_tile_v3 over the v3 frame's calls: "
              f"{summary['conv_tile_v3']['ms']:.4f} ms, F.conv2d of the "
              f"conv alone {alone:.4f} ms [{device_line}]", flush=True)
    return summary


def run_ab(decode, decode_i8, v2, v3, v1, gen, device_line):
    """The same-call old/new comparison of the wrappers moved onto
    conv_sm90.cu: the stage kernel's chain (stage_conv.cu, as they were
    served before) against the wrapper, timed in turns old, new, new, old,
    at conv_tile's v2 stage-6 call (61 -> 204), at the bf16 v5 stages 2, 4
    and 6 of fused_upconv_rsft and 3, 5 and 7 + head of fused_conv_rsft,
    at every resblock_sft_tile_v3 and conv_tile_v3 call of the v3 decode
    (stages 0-7 and 1-7 + head, 45x80 to 1080x1920), at every
    resblock_sft_tile call of the v2 decode (stages 0-7), at
    resblock_sft_chw's v1 stages 6 (input_sin: stage_conv_sin.cu) and 7,
    at conv3x3_act_chw's v1 stage 7 and head_conv_chw's v1 head, at
    rsft_planar's planar stage 7 and at conv_planar's planar stage 7 (sin)
    and head (outimg) (the stage kernel between the torch crop and planar
    write that served them); rsft_planar's two designs on conv_sm90: (a)
    conv_sm90.cu's NHWC chain between the same crop and write, (b) the
    planar instances (conv_sm90_planar.cu); and of the W8A8
    wrappers moved onto conv_sm90_i8.cu: the
    W8A8 stage kernel's chain (stage_conv_i8.cu) against the wrapper at
    the W8A8 stages 5, 6 and 7 + head.  Then the parts of rsft_planar's
    and of conv_planar's stage-7 call, each alone ("split" lines).
    Measurement only: no decode path chooses by it, and the old chains
    count no launch."""
    from boosting_nerv_torch.ops.kernels import (_build, conv_chw, conv_sm90,
                                                 fused_sft, planar, probes,
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
    names = ("stage_conv.cu", "conv_sm90.cu")
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
    convs = [(f"stage {st.index}", st.conv_w, st.conv_b,
              (st.out_hw[0] // st.strd, st.out_hw[1] // st.strd), "sin")
             for st in v3.fine.stages if st.upconv is None]
    convs.append(("head", v3.fine.head_w, v3.fine.head_b,
                  v3.fine.stages[-1].out_hw, "outimg"))
    for label, cw, cb, (hh, ww), act in convs:
        xs = rnd(gen, 1, hh, ww, cw.shape[3])
        y = torch.empty((1, hh, ww, cw.shape[0]), dtype=xs.dtype,
                        device="cuda")
        cases.append((f"conv_tile_v3 v3 {label}", tuple(xs.shape),
                      lambda xs=xs, cw=cw, cb=cb, y=y, act=act:
                      planar.launch_conv(lib, xs, cw, cb, y, act=act),
                      lambda xs=xs, cw=cw, cb=cb, act=act:
                      tile_conv.conv_tile_v3(xs, cw, cb, k=cw.shape[1],
                                             act=act)))
    t2 = v2.time_embed(torch.tensor([0.5], device="cuda"))
    for st in v2.fine.stages:
        xs, sft = rnd(gen, 1, *st.out_hw, st.rsft[0].shape[0]), st.sft(t2)
        cases.append((f"resblock_sft_tile v2 stage {st.index}",
                      tuple(xs.shape),
                      lambda xs=xs, sft=sft, rw=st.rsft:
                      planar.rsft_cuda(lib, xs, rw, sft),
                      lambda xs=xs, sft=sft, rw=st.rsft:
                      tile_conv.resblock_sft_tile(xs, *rw, sft)))
    cases = [c + names for c in cases]
    t1 = v1.time_embed(torch.tensor([0.5], device="cuda"))
    for st in v1.chw.stages:
        xs, sft, s_in = (rnd(gen, 1, *st.out_hw, st.rsft[0].shape[0]),
                         st.sft(t1), st.upconv is not None)
        cases.append((f"resblock_sft_chw v1 stage {st.index}"
                      + (" input_sin" if s_in else ""), tuple(xs.shape),
                      lambda xs=xs, sft=sft, rw=st.rsft, s_in=s_in:
                      planar.rsft_cuda(lib, xs, rw, sft, input_sin=s_in),
                      lambda xs=xs, sft=sft, rw=st.rsft, s_in=s_in:
                      fused_sft.resblock_sft_chw(xs, *rw, sft,
                                                 input_sin=s_in),
                      "stage_conv_sin.cu" if s_in else "stage_conv.cu",
                      "conv_sm90_sin.cu" if s_in else "conv_sm90.cu"))
    st7 = v1.chw.stages[-1]
    c, (hf, wf) = st7.rsft[0].shape[0], st7.out_hw
    convs = [("v1 stage 7", st7.conv_w, st7.conv_b, "sin",
              conv_chw.conv3x3_act_chw),
             ("v1 head", v1.chw.head_w, v1.chw.head_b, "outimg",
              conv_chw.head_conv_chw)]
    for label, cw, cb, act, fn in convs:
        xs = rnd(gen, 1, hf, wf, cw.shape[3])
        y = torch.empty((1, hf, wf, cw.shape[0]), dtype=xs.dtype,
                        device="cuda")
        cases.append((f"{fn.__name__} {label}", tuple(xs.shape),
                      lambda xs=xs, cw=cw, cb=cb, y=y, act=act:
                      planar.launch_conv(lib, xs, cw, cb, y, act=act),
                      lambda xs=xs, cw=cw, cb=cb, fn=fn: fn(xs, cw, cb),
                      "stage_conv.cu", "conv_sm90.cu"))
    xp, sft7 = planar_in(gen, c, hf // 2, wf // 2, PLANAR_WD), st7.sft(t1)
    w0, b0, w1, b1 = st7.rsft
    kw = {"c": c, "hc_real": hf // 2, "wc_real": wf // 2}
    conv = conv_sm90.cuda_conv(lib)

    def cropped(chain):
        """rsft_planar as a chain on the cropped NHWC region, written back
        into a copy of xp."""
        y = chain(planar._fine(xp, c, hf // 2, wf // 2))
        return planar._put_planar(xp.clone(), y)

    def planar_b():
        return planar.rsft_planar(xp, hwio(w0), b0, hwio(w1), b1, sft7,
                                  **kw)

    cases.append(("rsft_planar planar stage 7", tuple(xp.shape),
                  lambda: cropped(lambda y: planar.rsft_cuda(
                      lib, y, st7.rsft, sft7)), planar_b,
                  "stage_conv.cu (torch crop and write)",
                  "conv_sm90_planar.cu"))
    cases.append(("rsft_planar planar stage 7, (a) against (b)",
                  tuple(xp.shape), lambda: cropped(lambda y: conv_sm90.rsft(
                      conv, y, st7.rsft, sft7)), planar_b,
                  "conv_sm90.cu (a: torch crop and write)",
                  "conv_sm90_planar.cu (b)"))

    def conv_planar_old(cw, cb, act):
        """conv_planar as the stage kernel served it: the torch crop, one
        launch, a planar output filled with act(0) and the planar
        write."""
        x = planar._fine(xp, c, hf // 2, wf // 2)
        y = torch.empty(x.shape[:3] + (cw.shape[0],), dtype=x.dtype,
                        device="cuda")
        planar.launch_conv(lib, x, cw, cb, y, act=act)
        out = torch.full((4 * planar._round16(cw.shape[0]), hf // 2,
                          xp.shape[2]), conv_sm90.act_zero(act),
                         dtype=y.dtype, device="cuda")
        return planar._put_planar(out, y)

    for label, cw, cb, act, _ in convs:
        kwp = {"c_in": c, "c_out": cw.shape[0], "wc_real": wf // 2,
               "act": act}
        cases.append((f"conv_planar planar {label[3:]}", tuple(xp.shape),
                      lambda cw=cw, cb=cb, act=act:
                      conv_planar_old(cw, cb, act),
                      lambda w=hwio(cw), cb=cb, kwp=kwp:
                      planar.conv_planar(xp, w, cb, **kwp),
                      "stage_conv.cu (torch crop and write)",
                      "conv_sm90_planar.cu"))
    t8 = decode_i8.time_embed(torch.tensor([0.5], device="cuda"))
    zc = set(decode_i8.w8a8_zc)
    for st in decode_i8.tail:
        if not st.kernel.endswith("_i8"):
            continue
        xs = (rnd_codes(gen, *st.in_shape) if st.index in zc
              else rnd(gen, *st.in_shape))
        a = (xs, st.weights, st.sft(t8))
        label = f"{st.kernel} stage {st.index}" + (
            " + head" if st.head else "")
        if st.kernel == "fused_upconv_rsft_i8":
            def old(a=a, oi=st.out_inv):
                return probes.upconv_rsft_i8_stage(*a, oi)

            def new(a=a, oi=st.out_inv):
                return planar.fused_upconv_rsft_i8(*a, oi)
        else:
            def old(a=a, hd=st.head, oi=st.out_inv):
                return probes.conv_rsft_i8_stage(*a, hd, oi)

            def new(a=a, hd=st.head, oi=st.out_inv):
                return planar.fused_conv_rsft_i8(*a, hd, oi)
        cases.append((label, tuple(xs.shape), old, new, "stage_conv_i8.cu",
                      "conv_sm90_i8.cu"))
    for label, shape, old, new, old_name, new_name in cases:
        o1, n1 = cuda_ms(old), cuda_ms(new)
        n2, o2 = cuda_ms(new), cuda_ms(old)
        print(f"a/b {label} in {shape}: {old_name} {(o1 + o2) / 2:.4f} "
              f"ms ({o1:.4f}, {o2:.4f}), {new_name} {(n1 + n2) / 2:.4f} "
              f"ms ({n1:.4f}, {n2:.4f}) [{device_line}]", flush=True)
    # rsft_planar's parts, each alone: (b)'s two launches and its copy of
    # xp, (a)'s crop, two NHWC launches and planar write
    fine = planar._fine(xp, c, hf // 2, wf // 2)
    t, y, out = torch.empty_like(fine), torch.empty_like(fine), xp.clone()
    kw0 = {"act": "gelu", "in_affine": (sft7[0], sft7[1]),
           "out_affine": (sft7[2], sft7[3])}
    parts = {
        "(b) conv0 planar in": lambda: conv_sm90.launch(
            lib, xp, w0, b0, t, planar="in", **kw0),
        "(b) conv1 planar out": lambda: conv_sm90.launch(
            lib, t, w1, b1, out, residual=xp, planar="out"),
        "(b) copy of xp": lambda: xp.clone(),
        "(a) crop": lambda: planar._fine(xp, c, hf // 2, wf // 2),
        "(a) conv0": lambda: conv_sm90.launch(lib, fine, w0, b0, t, **kw0),
        "(a) conv1": lambda: conv_sm90.launch(lib, t, w1, b1, y,
                                              residual=fine),
        "(a) planar write": lambda: planar._put_planar(out, y)}
    print("split rsft_planar planar stage 7: " + ", ".join(
        f"{k} {cuda_ms(f):.4f} ms" for k, f in parts.items())
        + f" [{device_line}]", flush=True)
    # conv_planar's stage-7 call, its parts alone: the fill of the planar
    # output with act(0) and the planar in-and-out launch, against the
    # NHWC launch of the same conv and the stage kernel's route's parts
    w7, b7 = st7.conv_w, st7.conv_b
    out7 = torch.empty((4 * planar._round16(c), hf // 2, PLANAR_WD),
                       dtype=torch.bfloat16, device="cuda")
    parts = {
        "fill": lambda: torch.full(out7.shape, 0.0, dtype=out7.dtype,
                                   device="cuda"),
        "launch planar io": lambda: conv_sm90.launch(
            lib, xp, w7, b7, out7, act="sin", planar="io", image=(hf, wf)),
        "NHWC conv_sm90.cu launch (conv_tile_v3's)": lambda: (
            conv_sm90.launch(lib, fine, w7, b7, y, act="sin")),
        "old: crop": lambda: planar._fine(xp, c, hf // 2, wf // 2),
        "old: stage_conv.cu launch": lambda: planar.launch_conv(
            lib, fine, w7, b7, y, act="sin"),
        "old: planar write": lambda: planar._put_planar(out7, y)}
    print("split conv_planar planar stage 7: " + ", ".join(
        f"{k} {cuda_ms(f):.4f} ms" for k, f in parts.items())
        + f" [{device_line}]", flush=True)


def check_plans(decode, decode_i8, v2, v3, v1, device_line):
    """Every conv that conv_sm90.cu serves in the decodes, every one that
    conv_sm90_i8.cu serves in the W8A8 decode, and the v1 ResBlockSFT's and
    the planar phase's convs on the sin and planar instances: the library's
    shared-memory fit equals its mirror ``conv_sm90.fit`` (which the CPU
    tests use), and at each bf16 launch grid the library's slice-group plan
    (``bnt_conv_sm90_groups``, or a mode's entry point's) equals its mirror
    ``conv_sm90.groups`` at the library's tiles, SMs and blocks an SM; each
    plan is printed."""
    from boosting_nerv_torch.ops.kernels import conv_sm90

    grids = tail_grids(decode, decode_i8)
    add = grids.add
    for fine in (v2.fine, v3.fine):
        for st in fine.stages:
            h, wd = st.out_hw
            if st.upconv is None:
                add(st.conv_w, (1, h // st.strd, wd // st.strd))
            add(st.rsft[0], (1, h, wd))
        add(fine.head_w, (1, *fine.stages[-1].out_hw))
    for st in v1.chw.stages:  # the ResBlockSFT of sin(x) at the switch
        if st.upconv is not None:
            add(st.rsft[0], (1, *st.out_hw), mode=conv_sm90.SIN_INPUT)
            add(st.rsft[2], (1, *st.out_hw), mode=conv_sm90.SIN_RESIDUAL)
    st7 = v1.chw.stages[-1]  # the planar phase's rsft_planar
    for mode in (conv_sm90.PLANAR_IN, conv_sm90.PLANAR_OUT):
        add(st7.rsft[0], (1, *st7.out_hw), mode=mode)
    for w in (st7.conv_w, v1.chw.head_w):  # conv3x3_act_chw, head_conv_chw
        add(w, (1, *st7.out_hw))           # and the planar phase's
        add(w, (1, *st7.out_hw), mode=conv_sm90.PLANAR_IO)  # conv_planar
    verify_plans(grids, device_line)


class Grids(dict):
    """(cin, cout, k, form, mode) -> the launch grids (n, h, w) of a conv
    of the decodes; a conv of more than 128 padded input channels in the
    K loop's mode."""

    def add(self, w, grid, form=None, mode=None):
        from boosting_nerv_torch.ops.kernels import conv_sm90

        form = conv_sm90.BF16 if form is None else form
        mode = conv_sm90.NONE if mode is None else mode
        if conv_sm90.wide(w.shape[3], form, mode):
            mode = conv_sm90.KLOOP
        self.setdefault((w.shape[3], w.shape[0], w.shape[1], form, mode),
                        set()).add(tuple(grid))


def tail_grids(decode, decode_i8) -> Grids:
    """The conv launches of the bf16 serving decode's tail stages and of
    the W8A8 decode's int8 stages."""
    from boosting_nerv_torch.ops.kernels import conv_sm90

    s8, s8q = conv_sm90.S8, conv_sm90.S8Q
    grids = Grids()
    for st in decode.tail:
        w = st.weights
        n, h, wd, _ = st.in_shape
        out = (n, 2 * h, 2 * wd) if st.strd == 2 else (n, h, wd)
        grids.add(w.conv_w, (n, h, wd))
        grids.add(w.w0, out)
        if st.head:
            grids.add(w.head_w, out)
    for st in decode_i8.tail:
        if not st.kernel.endswith("_i8"):
            continue
        w = st.weights
        n, h, wd, _ = st.in_shape
        out = (n, 2 * h, 2 * wd) if st.strd == 2 else (n, h, wd)
        grids.add(w.conv_w, (n, h, wd), s8 if st.index in decode_i8.w8a8_zc
                  else s8q)
        grids.add(w.w0, out, s8q)
        grids.add(w.w1, out, s8)
        if st.head:
            grids.add(w.head_w, out, s8)
    return grids


def verify_plans(grids, device_line):
    """check_plans' checks and "plan" lines of every conv in ``grids``."""
    from boosting_nerv_torch.ops.kernels import _build, conv_sm90

    bf, s8, s8q = conv_sm90.BF16, conv_sm90.S8, conv_sm90.S8Q
    lib = _build.load_library()
    names = {bf: "conv_sm90", s8: "conv_sm90_i8 codes in",
             s8q: "conv_sm90_i8 bf16 in"}
    modes = {conv_sm90.NONE: "", conv_sm90.SIN_INPUT: " sin input",
             conv_sm90.SIN_RESIDUAL: " sin residual",
             conv_sm90.PLANAR_IN: " planar in",
             conv_sm90.PLANAR_OUT: " planar out",
             conv_sm90.PLANAR_IO: " planar io",
             conv_sm90.KLOOP: " K loop"}
    for (cin, cout, k, form, mode), shapes in sorted(grids.items()):
        ns, smem = conv_sm90.plan(lib, cin, cout, k, form, mode)
        mirror = conv_sm90.fit(cin, cout, k, ns, form, mode)
        name = names[form] + modes[mode]
        if mirror is None or mirror[-1] != smem:
            raise SmokeFailure(f"{name} plan of {cin}->{cout} k{k} N "
                               f"{ns}: library {smem} bytes, mirror "
                               f"{mirror}")
        rows = conv_sm90.rows_at(ns, form)
        nsl = -(-cout // ns)
        sched = []
        for n, h, wd in sorted(shapes):
            if form != bf:  # the int8 form takes every slice a block
                continue
            g, tiles, nslices, sms, per_sm = conv_sm90.launch_plan(
                lib, n, h, wd, cin, cout, k, mode)
            want = conv_sm90.groups(tiles, nslices, sms, per_sm, mode)
            if (g != want or nslices != nsl
                    or tiles != conv_sm90.tiles(n, h, wd, mirror[0], rows)):
                raise SmokeFailure(
                    f"{name} slice groups of {cin}->{cout} k{k} at "
                    f"{n}x{h}x{wd}: library G {g} ({tiles} tiles, {nslices} "
                    f"slices, {sms} SMs x {per_sm}), mirror G {want}")
            sched.append(f"{h}x{wd}: {tiles} tiles x {per_sm} a SM, G {g}")
        print(f"plan {name} {cin}->{cout} k{k}: N {ns} x {nsl}, "
              f"{rows} rows x {mirror[0]} warpgroup(s), "
              f"{'resident' if mirror[2] else f'ring {mirror[1]}'}, "
              f"{smem} bytes" + (f"; {'; '.join(sched)}" if sched else "")
              + f" [{device_line}]", flush=True)


def run_schedules(decode, v3, gen, device_line):
    """The slice-group plan against the schedules it chose from, at every
    conv_sm90.cu launch of the v3 decode on a grid of at most 270 rows
    (each conv of its stage 0-3 ResBlockSFTs, its stage 1-4 convs) and at
    the v5 stage 2 upconv: each launch timed (CUDA events) at every valid
    slice-group count G and at one and two warpgroups (the 2 x 64 tile
    against the 4 x 64 one), beside the plan's.  Measurement only: the
    launches count nowhere."""
    from boosting_nerv_torch.ops.kernels import _build, conv_sm90

    lib = _build.load_library()
    t3 = v3.time_embed(torch.tensor([0.5], device="cuda"))
    calls = []
    for st in v3.fine.stages:
        h, w = st.out_hw
        if st.upconv is None and h // st.strd <= 270:
            x = rnd(gen, 1, h // st.strd, w // st.strd, st.conv_w.shape[3])
            calls.append((f"v3 stage {st.index} conv", x, st.conv_w,
                          st.conv_b, {"act": "sin"}))
        if h > 270:
            continue
        y, sft = rnd(gen, 1, h, w, st.rsft[0].shape[0]), st.sft(t3)
        w0, b0, w1, b1 = st.rsft
        calls += [(f"v3 stage {st.index} rsft conv0", y, w0, b0,
                   {"act": "gelu", "in_affine": (sft[0], sft[1]),
                    "out_affine": (sft[2], sft[3])}),
                  (f"v3 stage {st.index} rsft conv1", y, w1, b1,
                   {"residual": y})]
    st2 = next(st for st in decode.tail if st.index == 2)
    calls.append(("v5 stage 2 upconv", rnd(gen, *st2.in_shape),
                  st2.weights.conv_w, st2.weights.conv_b,
                  {"act": "sin", "shuffle": True}))
    for label, x, w, b, kw in calls:
        n, h, wd, cin = x.shape
        cout = w.shape[0]
        shape = (n, 2 * h, 2 * wd, cout // 4) if kw.get("shuffle") else (
            n, h, wd, cout)
        out = torch.empty(shape, dtype=torch.bfloat16, device="cuda")
        g, tiles, nsl, sms, per_sm = conv_sm90.launch_plan(
            lib, n, h, wd, cin, cout, w.shape[1])
        times = []
        for nwg in (2, 1):
            for grp in range(1, nsl + 1):
                per = -(-nsl // grp)
                if -(-nsl // per) != grp:
                    continue
                ms = cuda_ms(lambda grp=grp, nwg=nwg: conv_sm90.launch(
                    lib, x, w, b, out, schedule=(grp, nwg), **kw))
                times.append(f"G {grp} x{nwg}wg {ms:.4f}")
        ms = cuda_ms(lambda: conv_sm90.launch(lib, x, w, b, out, **kw))
        print(f"schedule {label} in {tuple(x.shape)} -> {cout} ({nsl} "
              f"slices, {tiles} tiles, {sms} SMs x {per_sm}): plan G {g} "
              f"{ms:.4f} ms; " + ", ".join(times) + f" [{device_line}]",
              flush=True)


def check_refusal(gen, device_line):
    """A conv with more input channels than the kernel takes (264: beyond
    the K loop's 256 in bf16, beyond 128 in the modes) fits no
    shared-memory tile of the kernel: the tile, v1 and planar wrappers
    raise ValueError on the card."""
    c = 264
    xp = torch.zeros((4 * 272, 2, 128), dtype=torch.bfloat16, device="cuda")

    def rsft_args():
        return (rnd(gen, c, 3, 3, c), rnd(gen, c), rnd(gen, c, 3, 3, c),
                rnd(gen, c), torch.zeros((4, c), device="cuda"))

    calls = {
        "conv_tile": lambda: wrapper("conv_tile")(
            rnd(gen, 1, 9, 50, c), rnd(gen, 8, 5, 5, c), rnd(gen, 8), k=5),
        "conv_tile_v3": lambda: wrapper("conv_tile_v3")(
            rnd(gen, 1, 9, 50, c), rnd(gen, 8, 3, 3, c), rnd(gen, 8), k=3),
        "resblock_sft_tile": lambda: wrapper("resblock_sft_tile")(
            rnd(gen, 1, 9, 50, c), *rsft_args()),
        "resblock_sft_tile_v3": lambda: wrapper("resblock_sft_tile_v3")(
            rnd(gen, 1, 9, 50, c), *rsft_args()),
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
              f"bytes, {n} HMMA/IMMA/HGMMA/IGMMA", flush=True)
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



def train_config(outf, **kw):
    """bench_config()'s model (fc_dim pinned at 127: resolve_sizes would
    solve it again from the clip's frame count) as the UVG recipe trains
    it, batch 1, Fusion10_freq, Adan, TF32 off."""
    return bench_config().replace(**{
        "fc_dim": 127, "batchSize": 1, "epochs": TRAIN_EPOCHS,
        "lr": TRAIN_LR, "loss": "Fusion10_freq", "optim_type": "Adan",
        "train_precision": "highest", "not_resume": True, "outf": outf,
        **kw})


def _step_ms_and_peak(trainer, steps, step=None, lr=TRAIN_LR):
    """Median ms of ``steps`` train steps (``step``, by default
    ``trainer.train_step_idx``; CUDA events each), and the peak allocation
    of one step above what was allocated before it (bytes)."""
    step = trainer.train_step_idx if step is None else step
    n = trainer.video.n
    times = []
    for i in range(steps + 1):
        idx = [i % n]
        if i == 0:  # the peak of one step, untimed
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(idx, trainer.video.norm_idx(idx), lr)
        end.record()
        torch.cuda.synchronize()
        if i == 0:
            peak = torch.cuda.max_memory_allocated() - before
        else:
            times.append(start.elapsed_time(end))
    return statistics.median(times), peak


def run_train_phase(device_line):
    """Phase 11: the port's RegressionTrainer at the bench config's full
    widths; returns the launch counts of its training run (the evals'
    measure_fps)."""
    from boosting_nerv_torch.data import VideoData, synthetic_video
    from boosting_nerv_torch.models import build_model
    from boosting_nerv_torch.ops import kernels
    from boosting_nerv_torch.ops.losses import loss_fn
    from boosting_nerv_torch.runtime.fast_decode import build_serving_decode
    from boosting_nerv_torch.training import checkpoint
    from boosting_nerv_torch.training.trainer import (METRIC_NAMES,
                                                      RegressionTrainer)
    from boosting_nerv_torch.utils.logger import RunLogger

    root = os.path.join(REPO, "output", "chip_smoke_train")  # gitignored
    shutil.rmtree(root, ignore_errors=True)

    def trainer(name, video, device="cuda", **kw):
        cfg = train_config(os.path.join(root, name), **kw)
        return RegressionTrainer(cfg, video=video, device=device,
                                 logger=RunLogger(cfg.outf, enable_tb=False))

    try:
        video = VideoData(synthetic_video(TRAIN_FRAMES, 1080, 1920, seed=0))
        tr = trainer("run", video)
        cfg = tr.cfg
        first = next(video.epoch_batches(tr.train_ind, cfg.batchSize, True,
                                         cfg.manualSeed))
        with torch.no_grad():
            img = tr.gather(first["idx"])
            want = float(loss_fn(tr.model(img, torch.as_tensor(
                first["norm_idx"], device="cuda")), img, cfg.loss))
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        tr.train()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        # phase 13 warm-starts its CEM finetune from this checkpoint
        os.makedirs(os.path.dirname(WARM_CKPT), exist_ok=True)
        shutil.copy(os.path.join(cfg.outf, "model_latest.ckpt"), WARM_CKPT)
        n_evals = 2
        expect = {k: SERVING_LAUNCHES.get(k, 0) * n_evals * (FPS_REPS + 1)
                  for k in launches}
        losses, psnrs = tr.train_losses, tr.train_psnr
        print(f"train phase: HNeRV-Boost at bench widths (fc_dim "
              f"{cfg.fc_dim}, {sum(p.numel() for p in tr.model.parameters())}"
              f" params), {video.n} frames {video.frames.shape[1]}x"
              f"{video.frames.shape[2]}, batch 1, "
              f"{cfg.loss}, Adan, TF32 off: {len(losses)} steps and "
              f"{n_evals} evals in {train_s:.1f} s; loss {losses[0]:.5f} -> "
              f"{losses[-1]:.5f}, train PSNR by epoch "
              f"{[round(p, 3) for p in psnrs]}; launches "
              f"{ {k: v for k, v in launches.items() if v} } "
              f"[{device_line}]", flush=True)
        if launches != expect:
            raise SmokeFailure(f"train phase launches {launches}, expected "
                               f"{expect}")
        rel = abs(losses[0] - want) / abs(want)
        print(f"train (a) first step's loss {losses[0]:.7g} vs loss_fn of "
              f"the model just before it {want:.7g}: rel err {rel:.3g} (tol "
              f"{FIRST_LOSS_RTOL})", flush=True)
        if not rel <= FIRST_LOSS_RTOL:
            raise SmokeFailure(f"first step's loss rel err {rel}")
        if not (len(losses) == TRAIN_FRAMES * TRAIN_EPOCHS
                and all(math.isfinite(v) for v in losses)
                and psnrs[-1] > psnrs[0]):
            raise SmokeFailure(f"(b) losses {losses}, PSNR by epoch {psnrs}")

        t0 = time.perf_counter()
        res = tr.evaluate(huffman_coding=True)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        print(f"train (c) evaluate: {eval_s:.2f} s; " + ", ".join(
            f"{k} {res[k]:.4f}" for k in METRIC_NAMES) + f"; bits/param "
            f"{tr.bits_per_param:.4f} ({tr.full_bits_per_param:.4f} with "
            f"overhead), bpp {tr.total_bpp:.6f}, fps {tr.fps:.2f} "
            f"[{device_line}]", flush=True)
        if not (list(res) == METRIC_NAMES
                and all(math.isfinite(v) for v in res.values())
                and tr.bits_per_param > 0 and tr.fps > 0):
            raise SmokeFailure(f"(c) eval {res}, bits/param "
                               f"{tr.bits_per_param}, fps {tr.fps}")

        kernels.reset_launch_counts()
        fps = tr.measure_fps(reps=FPS_REPS)
        fps_launches = dict(kernels.LAUNCHES)
        want_fps = {k: SERVING_LAUNCHES.get(k, 0) * (FPS_REPS + 1)
                    for k in fps_launches}
        decode = build_serving_decode(cfg, tr.model)
        t = torch.tensor([T_HOLD], device="cuda")
        with torch.no_grad():
            embed = tr.model.encode(tr.gather([0]))
            out, ref = decode(embed, t).float(), tr.model.decode(embed, t)
        err = (out - ref).abs().max().item()
        print(f"train (d) measure_fps on the trained weights: {fps:.2f} "
              f"decodes/s (batch 1, encoder excluded, {FPS_REPS} decodes and "
              f"one warm-up), launches "
              f"{ {k: v for k, v in fps_launches.items() if v} }; serving "
              f"decode at t "
              f"{T_HOLD} vs the trained model's fp32 decode: max_abs_err "
              f"{err:.6g} (tol {SLICE_TOL}) [{device_line}]", flush=True)
        if fps_launches != want_fps or not (
                tuple(out.shape) == (1, 1080, 1920, 3) and err <= SLICE_TOL):
            raise SmokeFailure(f"(d) launches {fps_launches}, expected "
                               f"{want_fps}; err {err}")

        path = os.path.join(root, "check.ckpt")
        checkpoint.save_checkpoint(path, cfg.epochs, tr.model, cfg, tr.opt)
        back = build_model(cfg, seed=None, device="cuda")
        checkpoint.restore(back, checkpoint.load_checkpoint(path), cfg)
        state, got = tr.model.state_dict(), back.state_dict()
        same = state.keys() == got.keys() and all(
            torch.equal(state[k], got[k]) for k in state)
        print(f"train (e) checkpoint ({os.path.getsize(path)} bytes, flax "
              f"layout) loads back identical: {same}", flush=True)
        if not same:
            raise SmokeFailure("(e) checkpoint round trip changed params")

        step_ms, peak = _step_ms_and_peak(tr, 5)
        del tr, back
        remat = trainer("remat", video, remat=True)
        remat_ms, remat_peak = _step_ms_and_peak(remat, 3)
        del remat
        print(f"train step at UVG-1080p (bench widths, batch 1, "
              f"Fusion10_freq, Adan, TF32 off): {step_ms:.2f} ms median of 5 "
              f"(CUDA events), peak allocation of a step "
              f"{peak / 2**30:.3f} GiB; with remat {remat_ms:.2f} ms median "
              f"of 3, {remat_peak / 2**30:.3f} GiB [{device_line}]",
              flush=True)

        small = VideoData(synthetic_video(1, 120, 240, seed=1))
        # the CPU reference on torch's own convolutions; oneDNN's float32
        # ones (the CPU default) are printed beside it, not gated
        step, params = {}, {}
        for key, dev, onednn in (("card", "cuda", False),
                                 ("cpu", "cpu", False),
                                 ("cpu_onednn", "cpu", True)):
            # L1_freq: MS-SSIM needs frames of more than 160 pixels a side
            t = trainer(f"step_{key}", small, device=dev, loss="L1_freq")
            with torch.backends.mkldnn.flags(enabled=onednn):
                step[key] = float(t.train_step_idx(
                    [0], small.norm_idx([0]), TRAIN_LR)[0])
            params[key] = dict(t.model.named_parameters())

        def worst_grad(key):
            """(error, leaf) of the largest gradient difference between
            the card and ``key``, in the leaf's max |g| there."""
            errs = []
            for n, p in params["card"].items():
                want = params[key][n].grad
                errs.append((((p.grad.cpu() - want).abs().max()
                              / want.abs().max().clamp_min(1e-30)).item(),
                             n))
            return max(errs)

        rel = abs(step["card"] - step["cpu"]) / abs(step["cpu"])
        worst, worst_name = worst_grad("cpu")
        onednn, onednn_name = worst_grad("cpu_onednn")
        print(f"train step card vs CPU (bench widths, 120x240, L1_freq, same "
              f"weights, TF32 off): loss {step['card']:.7g} vs "
              f"{step['cpu']:.7g}, rel err {rel:.3g} (tol {STEP_LOSS_RTOL}); "
              f"worst gradient error {worst:.3g} of its leaf's max |g| "
              f"({worst_name}; tol {STEP_GRAD_TOL}); against the CPU on "
              f"oneDNN's convolutions {onednn:.3g} ({onednn_name}; not "
              f"gated) [{device_line}]", flush=True)
        if not (rel <= STEP_LOSS_RTOL and worst <= STEP_GRAD_TOL):
            raise SmokeFailure(f"card vs CPU step: loss rel {rel}, gradient "
                               f"{worst} at {worst_name}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


def _worst(got, want, floor=0.0):
    """(error, name): the largest difference between the arrays of two
    dicts, in the leaf's largest |value| of ``want`` (at least
    ``floor``)."""
    return max(((float(np.abs(got[k].astype(np.float64) - want[k]).max())
                 / max(float(np.abs(want[k]).max()), floor, 1e-30)), k)
               for k in want)


def _worst_grad(got, want):
    """``_worst`` of two steps' gradients, a leaf's scale at least 1e-6 of
    the step's largest gradient (a leaf whose gradient is ~0, as the
    scalebeta quantiser's beta, has no scale of its own; the rule of
    tests/test_torch_compress_trainer.py)."""
    return _worst(got, want, 1e-6 * max(float(np.abs(v).max())
                                        for v in want.values()))


def _beyond_flips(got, want, grads_got, grads_want, lr):
    """The parameters ``got`` against ``want`` after ``len(grads_want)``
    Adan steps, each step's gradients of the two runs ``grads_got`` /
    ``grads_want``: (the largest error of an element no step could flip,
    in its leaf's max |value|, that leaf, the elements beyond
    STEP_GRAD_TOL that a step could flip, whether each of those lies
    within a flipped step a step, 2 lr)."""
    worst, at, flipped, ok = 0.0, None, 0, True
    for k, w in want.items():
        err = np.abs(got[k].astype(np.float64) - w)
        scale = max(float(np.abs(w).max()), 1e-30)
        flippable = np.zeros(w.shape, bool)
        for ga, gb in zip(grads_got, grads_want):
            if k in gb:
                flippable |= ((np.sign(ga[k]) != np.sign(gb[k]))
                              | (np.minimum(np.abs(ga[k]), np.abs(gb[k]))
                                 <= DP_FLIP_G))
        beyond = flippable & (err > STEP_GRAD_TOL * scale)
        flipped += int(beyond.sum())
        ok = ok and bool((err[beyond]
                          <= 2 * lr * len(grads_want) * (1 + 1e-3)).all())
        if (~flippable).any() and err[~flippable].max() / scale > worst:
            worst, at = float(err[~flippable].max()) / scale, k
    return worst, at, flipped, ok


def dp_rank_turns(plan, cfg, frames, steps):
    """Phase 15 (b) in the one rank of a world-size-1 group: the
    regression step through DDP (``plan``) and the plain dp=1 step (no
    group) from the same seeded weights; (first losses, median ms of each
    side in turns plain, DDP, DDP, plain, the rank's device and peak)."""
    from boosting_nerv_torch.data import VideoData
    from boosting_nerv_torch.parallel import make_mesh_plan
    from boosting_nerv_torch.training.trainer import RegressionTrainer
    from boosting_nerv_torch.utils.logger import NullLogger

    video = VideoData(frames)
    plain = make_mesh_plan(1, devices=[plan.device])
    trainers = {side: RegressionTrainer(cfg, video=video, plan=p,
                                        logger=NullLogger())
                for side, p in (("plain", plain), ("ddp", plan))}
    first = {side: float(t.train_step_idx([0], video.norm_idx([0]),
                                          TRAIN_LR)[0])
             for side, t in trainers.items()}
    ms, peak = {"plain": [], "ddp": []}, 0
    for side in ("plain", "ddp", "ddp", "plain"):
        ms[side].append(_step_ms_and_peak(trainers[side], steps)[0])
        peak = max(peak, torch.cuda.max_memory_allocated(plan.device))
    return {"first": first, "ms": ms, "device": str(plan.device),
            "backend": plan.backend, "group": plan.group is not None,
            "peak_bytes": peak}


def run_dp_phase(device_line):
    """Phase 15: the 'data' axis on the one card; returns the launch
    counts of this process's runs (none: the steps are plain torch)."""
    from boosting_nerv_torch.data import VideoData, synthetic_video
    from boosting_nerv_torch.ops import kernels
    from boosting_nerv_torch.parallel import launch
    from boosting_nerv_torch.parallel.steps import cem_steps, train_steps
    from boosting_nerv_torch.training.compress_trainer import (
        EMBED, CompressionTrainer)
    from boosting_nerv_torch.utils.logger import NullLogger

    t_phase = time.perf_counter()
    root = os.path.join(REPO, "output", "chip_smoke_dp")  # gitignored
    shutil.rmtree(root, ignore_errors=True)
    frames = synthetic_video(DP_FRAMES, 1080, 1920, seed=0)
    gib = 2 ** 30
    kernels.reset_launch_counts()
    try:
        # (a) regression: dp=1 here, then two ranks on cuda:0 over gloo
        cfg = train_config(os.path.join(root, "train"), batchSize=2)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        one = launch(train_steps, dict(dp=1, devices=["cuda:0"]),
                     args=(cfg, frames, None, DP_IDX, TRAIN_LR, DP_STEPS))[0]
        one_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        two = launch(train_steps, dict(dp=2, devices=["cuda:0"] * 2),
                     args=(cfg.replace(dp=2), frames, None, DP_IDX,
                           TRAIN_LR, DP_STEPS), timeout=DP_TIMEOUT)
        two_s = time.perf_counter() - t0
        rel = max(abs(a - b) / abs(b)
                  for a, b in zip(two[0]["losses"], one["losses"]))
        # the first step's raw gradients, from the same weights, and the
        # parameters it gives; the second step's loss carries that update
        # through the whole model (tests/test_sharding.py:248-255)
        grad, grad_at = _worst_grad(two[0]["grads"][0], one["grads"][0])
        param, param_at, flipped, flips_ok = _beyond_flips(
            two[0]["states"][0], one["states"][0], two[0]["grads"][:1],
            one["grads"][:1], TRAIN_LR)
        last, last_at = _worst(two[0]["states"][-1], one["states"][-1])
        same = all(np.array_equal(two[1]["states"][-1][k], v)
                   for k, v in two[0]["states"][-1].items())
        print(f"dp (a) {DP_STEPS} regression steps at UVG-1080p (bench "
              f"widths, global batch 2, Fusion10_freq, Adan, TF32 off): "
              f"dp=2 (2 ranks on cuda:0, gloo) losses "
              f"{[round(v, 7) for v in two[0]['losses']]} vs dp=1 "
              f"{[round(v, 7) for v in one['losses']]}: rel err {rel:.3g} "
              f"(tol {STEP_LOSS_RTOL}); first step's gradients {grad:.3g} "
              f"of the leaf's max ({grad_at}; tol {STEP_GRAD_TOL}); "
              f"parameters after it {param:.3g} ({param_at}; tol "
              f"{STEP_GRAD_TOL}) where the step could not flip, {flipped} "
              f"elements beyond it whose gradients differ in sign or lie "
              f"within {DP_FLIP_G} of 0, within a flipped step each: "
              f"{flips_ok}; after {DP_STEPS} steps {last:.3g} ({last_at}; "
              f"not gated); ranks' parameters identical: {same}; step ms "
              f"(host clock to the loss read back) dp=2 "
              f"{[round(v, 2) for v in two[0]['ms']]}, dp=1 (batch 2) "
              f"{[round(v, 2) for v in one['ms']]}; {two_s:.1f} s with the "
              f"ranks' start against {one_s:.1f} s [{device_line}]",
              flush=True)
        for r in [one] + two:
            print(f"dp (a) rank {r['rank']} of {'1' if r is one else '2'}: "
                  f"{r['device']}, peak allocation "
                  f"{r['peak_bytes'] / gib:.3f} GiB", flush=True)
        if not (rel <= STEP_LOSS_RTOL and grad <= STEP_GRAD_TOL
                and param <= STEP_GRAD_TOL and flips_ok and same
                and all(r["device"] == "cuda:0" for r in two)):
            raise SmokeFailure(f"(a) dp=2 regression: loss rel {rel}, "
                               f"gradient {grad} at {grad_at}, parameter "
                               f"{param} at {param_at}, flips within a step "
                               f"{flips_ok}, ranks equal {same}")

        # (a) one CEM step from phase 11's checkpoint, the same noise
        ccfg = cem_config("HNeRV_Boost", os.path.join(root, "cem"),
                          batchSize=2)
        tr = CompressionTrainer(ccfg, video=VideoData(frames),
                                logger=NullLogger(), device="cuda")
        tr.maybe_resume()
        tr.init_qparams()
        gen = torch.Generator().manual_seed(5)
        noise = {k: torch.rand(s, generator=gen) - 0.5
                 for k, s in tr.flax_shapes.items()}
        with torch.no_grad():
            shape = tr.model.encode(tr.gather(DP_IDX)).shape
        noise[EMBED] = torch.rand(shape, generator=gen) - 0.5
        loss1, _, bpp1 = tr.cem_step_idx(
            DP_IDX, tr.video.norm_idx(DP_IDX), CEM_LR,
            {k: v.cuda() for k, v in noise.items()})
        loss1, bpp1 = float(loss1), float(bpp1)
        state1 = {k: v.detach().cpu().numpy()
                  for k, v in tr.model.state_dict().items()}
        qp_of = {f"{k}/{n}": v for k, d in tr.qparams.items()
                 for n, v in d.items()}
        qp_of.update({f"embed/{n}": v for n, v in tr.embed_qp.items()})
        qp1 = {k: v.detach().cpu().numpy() for k, v in qp_of.items()}
        grads1 = {k: v.grad.cpu().numpy() for k, v in
                  list(tr.model.named_parameters()) + list(qp_of.items())
                  if v.grad is not None}
        del tr
        torch.cuda.empty_cache()
        cem = launch(cem_steps, dict(dp=2, devices=["cuda:0"] * 2),
                     args=(ccfg.replace(dp=2), frames, None, DP_IDX, CEM_LR,
                           {k: v.numpy() for k, v in noise.items()}),
                     timeout=DP_TIMEOUT)
        c = cem[0]
        qp2 = {f"{k}/{n}": v for k, d in c["qp"].items()
               for n, v in d.items()}
        qp2.update({f"embed/{n}": v for n, v in c["embed_qp"].items()})
        grads2 = {f"{k}/{n}": v for k, d in c["qp_grads"].items()
                  for n, v in d.items()}
        grads2.update({f"embed/{n}": v
                       for n, v in c["embed_qp_grads"].items()})
        grads2.update(c["grads"][0])
        rel_l = abs(c["losses"][0] - loss1) / abs(loss1)
        rel_b = abs(c["bpps"][0] - bpp1) / abs(bpp1)
        # the weights' gradients; a quantiser parameter is a scalar whose
        # gradient sums cancelling terms, held by the parameter check
        grad, grad_at = _worst_grad(c["grads"][0], {k: grads1[k]
                                                    for k in c["grads"][0]})
        qgrad, qgrad_at = _worst_grad(
            {k: v for k, v in grads2.items() if k not in c["grads"][0]},
            {k: v for k, v in grads1.items() if k not in c["grads"][0]})
        param, param_at, flipped, flips_ok = _beyond_flips(
            {**c["states"][0], **qp2}, {**state1, **qp1}, [grads2],
            [grads1],
            CEM_LR)
        same = all(np.array_equal(cem[1]["states"][0][k], v)
                   for k, v in c["states"][0].items())
        print(f"dp (a) CEM step (hnerv_boost.sh, embed_entropy, phase 11's "
              f"weights, fed noise): dp=2 loss {c['losses'][0]:.7g} bpp "
              f"{c['bpps'][0]:.7g} vs dp=1 {loss1:.7g} / {bpp1:.7g}: rel "
              f"err {rel_l:.3g} / {rel_b:.3g} (tol {CEM_STEP_RTOL}); "
              f"weights' gradients {grad:.3g} of the leaf's max ({grad_at}"
              f"; tol {STEP_GRAD_TOL}), quantisers' {qgrad:.3g} "
              f"({qgrad_at}; not gated); "
              f"parameters and quantiser parameters {param:.3g} ({param_at}"
              f"; tol {STEP_GRAD_TOL}) where the step could not flip, "
              f"{flipped} elements beyond it within a flipped step each: "
              f"{flips_ok}; ranks' parameters identical: {same}; step ms "
              f"{round(c['ms'][0], 2)}; peak allocation "
              f"{[round(r['peak_bytes'] / gib, 3) for r in cem]} GiB "
              f"[{device_line}]", flush=True)
        if not (rel_l <= CEM_STEP_RTOL and rel_b <= CEM_STEP_RTOL
                and grad <= STEP_GRAD_TOL and param <= STEP_GRAD_TOL
                and flips_ok and same):
            raise SmokeFailure(f"(a) dp=2 CEM step: loss rel {rel_l}, bpp "
                               f"rel {rel_b}, gradient {grad} at {grad_at}, "
                               f"parameter {param} at {param_at}, flips "
                               f"within a step {flips_ok}, ranks equal "
                               f"{same}")

        # (b) DDP over NCCL at world size 1 beside the plain step
        torch.cuda.empty_cache()
        b = launch(dp_rank_turns, dict(dp=1, devices=["cuda:0"],
                                       backend="nccl"),
                   args=(train_config(os.path.join(root, "turns")), frames,
                         DP_TURN_STEPS), timeout=DP_TIMEOUT)[0]
        first = b["first"]
        rel = abs(first["ddp"] - first["plain"]) / abs(first["plain"])
        plain_ms = statistics.median(b["ms"]["plain"])
        ddp_ms = statistics.median(b["ms"]["ddp"])
        print(f"dp (b) DDP over {b['backend']} at world size 1 "
              f"({b['device']}, group {b['group']}): first loss "
              f"{first['ddp']:.7g} vs plain {first['plain']:.7g} (rel err "
              f"{rel:.3g}, tol {FIRST_LOSS_RTOL}); step ms in turns plain "
              f"{[round(v, 2) for v in b['ms']['plain']]}, DDP "
              f"{[round(v, 2) for v in b['ms']['ddp']]} (median of "
              f"{DP_TURN_STEPS} each): DDP {ddp_ms:.2f} vs plain "
              f"{plain_ms:.2f} ms ({ddp_ms / plain_ms:.4f}x); peak "
              f"allocation {b['peak_bytes'] / gib:.3f} GiB [{device_line}]",
              flush=True)
        if not (b["backend"] == "nccl" and b["group"]
                and rel <= FIRST_LOSS_RTOL):
            raise SmokeFailure(f"(b) DDP over NCCL: {b['backend']}, group "
                               f"{b['group']}, first loss rel {rel}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = dict(kernels.LAUNCHES)
    if any(launches.values()):
        raise SmokeFailure(f"dp phase launched kernels {launches}")
    print(f"dp phase: {time.perf_counter() - t_phase:.1f} s, no kernel "
          f"launched [{device_line}]", flush=True)
    return launches


def _cem_tree(r):
    """(parameters and quantiser parameters, their first step's gradients)
    of a ``cem_steps`` result, keyed flat."""
    params = {**r["states"][0]}
    grads = {**r["grads"][0]}
    for k, d in r["qp"].items():
        params.update({f"{k}/{n}": v for n, v in d.items()})
        grads.update({f"{k}/{n}": v for n, v in r["qp_grads"][k].items()})
    params.update({f"embed/{n}": v for n, v in r["embed_qp"].items()})
    grads.update({f"embed/{n}": v for n, v in r["embed_qp_grads"].items()})
    return params, grads


def run_sp_phase(device_line):
    """Phase 16: the 'spatial' axis on the one card, sp=1 and sp=2 each in
    fresh ranks (a world-1 gloo group, and two gloo ranks); returns the
    launch counts of this process's runs and the ranks' (none: the split
    path is plain torch)."""
    from boosting_nerv_torch.models import build_model
    from boosting_nerv_torch.ops import kernels
    from boosting_nerv_torch.parallel import launch
    from boosting_nerv_torch.parallel.steps import (cem_steps, run_jobs,
                                                    split_decode,
                                                    train_steps)
    from boosting_nerv_torch.data import synthetic_video

    t_phase = time.perf_counter()
    root = os.path.join(REPO, "output", "chip_smoke_sp")  # gitignored
    shutil.rmtree(root, ignore_errors=True)
    frames = synthetic_video(DP_FRAMES, 1080, 1920, seed=0)
    gib = 2 ** 30
    kernels.reset_launch_counts()
    try:
        cfg = train_config(os.path.join(root, "train"))
        ccfg = cem_config("HNeRV_Boost", os.path.join(root, "cem"))
        # the whole decode and frame 0's embedding, seeded weights
        model = build_model(cfg, seed=cfg.manualSeed).eval()
        t = [T_HOLD]
        with torch.no_grad():
            embed = model.encode(torch.from_numpy(
                frames[:1].astype(np.float32) / 255.0).cuda())
        state = {k: v.cpu().numpy() for k, v in model.state_dict().items()}
        del model
        torch.cuda.empty_cache()
        jobs = [(train_steps, (cfg, frames, None, SP_IDX, TRAIN_LR,
                               SP_STEPS)),
                (cem_steps, (ccfg, frames, None, SP_IDX, CEM_LR)),
                (split_decode, (cfg, state, t, embed.cpu().numpy(),
                                SP_DECODE_REPS))]
        t0 = time.perf_counter()
        one = launch(run_jobs, dict(dp=1, devices=["cuda:0"],
                                    backend="gloo"),
                     args=(jobs,), timeout=DP_TIMEOUT)[0]
        one_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        two = launch(run_jobs, dict(dp=1, sp=2, devices=["cuda:0"] * 2),
                     args=([(w, (a[0].replace(sp=2), *a[1:]))
                            if w is not split_decode else (w, a)
                            for w, a in jobs],), timeout=DP_TIMEOUT)
        two_s = time.perf_counter() - t0
        (tr1, cem1, dec1), (tr2, cem2, dec2) = one, two[0]

        # (a) the regression steps, phase 15's gates on the first DP_STEPS
        rel = max(abs(a - b) / abs(b) for a, b in
                  zip(tr2["losses"][:DP_STEPS], tr1["losses"][:DP_STEPS]))
        ms1, ms2 = (float(np.median(tr["ms"][1:])) for tr in (tr1, tr2))
        grad, grad_at = _worst_grad(tr2["grads"][0], tr1["grads"][0])
        param, param_at, flipped, flips_ok = _beyond_flips(
            tr2["states"][0], tr1["states"][0], tr2["grads"][:1],
            tr1["grads"][:1], TRAIN_LR)
        same = all(np.array_equal(two[1][0]["states"][-1][k], v)
                   for k, v in tr2["states"][-1].items())
        print(f"sp split plan (UVG-1080p HNeRV-Boost, sp=2): "
              f"{'; '.join(tr2['split_plan'])} [{device_line}]", flush=True)
        print(f"sp (a) {SP_STEPS} regression steps at UVG-1080p (bench "
              f"widths, batch 1, Fusion10_freq, Adan, TF32 off): sp=2 (2 "
              f"ranks on cuda:0, gloo) losses "
              f"{[round(v, 7) for v in tr2['losses']]} vs sp=1 (1 fresh "
              f"rank, gloo) {[round(v, 7) for v in tr1['losses']]}: rel "
              f"err of the first {DP_STEPS} {rel:.3g} "
              f"(tol {STEP_LOSS_RTOL}); first step's gradients {grad:.3g} "
              f"of the leaf's max ({grad_at}; tol {STEP_GRAD_TOL}); "
              f"parameters after it {param:.3g} ({param_at}; tol "
              f"{STEP_GRAD_TOL}) where the step could not flip, {flipped} "
              f"elements beyond it within a flipped step each: {flips_ok}; "
              f"ranks' parameters identical: {same}; step ms (host clock to "
              f"the loss read back) sp=2 {[round(v, 2) for v in tr2['ms']]}"
              f", sp=1 {[round(v, 2) for v in tr1['ms']]}; median of steps "
              f"2-{SP_STEPS} sp=2 {ms2:.2f}, sp=1 {ms1:.2f}; {two_s:.1f} s "
              f"with the ranks' start against {one_s:.1f} s "
              f"[{device_line}]", flush=True)
        ok = (rel <= STEP_LOSS_RTOL and grad <= STEP_GRAD_TOL
              and param <= STEP_GRAD_TOL and flips_ok and same)

        # (b) the CEM step
        p1, g1 = _cem_tree(cem1)
        p2, g2 = _cem_tree(cem2)
        rel_l = abs(cem2["losses"][0] - cem1["losses"][0]) / abs(
            cem1["losses"][0])
        rel_b = abs(cem2["bpps"][0] - cem1["bpps"][0]) / abs(cem1["bpps"][0])
        cgrad, cgrad_at = _worst_grad(cem2["grads"][0], cem1["grads"][0])
        cparam, cparam_at, cflipped, cflips_ok = _beyond_flips(
            p2, p1, [g2], [g1], CEM_LR)
        csame = all(np.array_equal(two[1][1]["states"][0][k], v)
                    for k, v in cem2["states"][0].items())
        print(f"sp (b) CEM step (hnerv_boost.sh, embed_entropy, phase 11's "
              f"weights): sp=2 loss {cem2['losses'][0]:.7g} bpp "
              f"{cem2['bpps'][0]:.7g} vs sp=1 {cem1['losses'][0]:.7g} / "
              f"{cem1['bpps'][0]:.7g}: rel err {rel_l:.3g} / {rel_b:.3g} "
              f"(tol {CEM_STEP_RTOL}); weights' gradients {cgrad:.3g} of the "
              f"leaf's max ({cgrad_at}; tol {STEP_GRAD_TOL}); parameters "
              f"and quantiser parameters {cparam:.3g} ({cparam_at}; tol "
              f"{STEP_GRAD_TOL}) where the step could not flip, {cflipped} "
              f"elements beyond it within a flipped step each: {cflips_ok}; "
              f"ranks' parameters identical: {csame}; step ms sp=2 "
              f"{round(cem2['ms'][0], 2)}, sp=1 {round(cem1['ms'][0], 2)} "
              f"[{device_line}]", flush=True)
        ok = ok and (rel_l <= CEM_STEP_RTOL and rel_b <= CEM_STEP_RTOL
                     and cgrad <= STEP_GRAD_TOL and cparam <= STEP_GRAD_TOL
                     and cflips_ok and csame)

        # (c) the split decode against the whole one
        err = max(float(np.abs(r[2]["frame"] - dec1["frame"]).max())
                  for r in two)
        finite = all(np.isfinite(r[2]["frame"]).all() for r in two)
        print(f"sp (c) split decode at t = {T_HOLD} (seeded weights, fp32, "
              f"TF32 off): max abs vs the whole decode {err:.3g} (tol "
              f"{SP_DECODE_TOL}), finite {finite}; ms a frame sp=2 "
              f"{dec2['ms']:.3f} vs whole {dec1['ms']:.3f} (median of "
              f"{SP_DECODE_REPS}, CUDA events) [{device_line}]", flush=True)
        ok = ok and err <= SP_DECODE_TOL and finite
        for (tr, _, dec), n in [(one, 1)] + [(rr, 2) for rr in two]:
            print(f"sp rank {tr['rank']} of {n}: {tr['device']}, peak "
                  f"allocation of the {SP_STEPS} regression steps "
                  f"{(tr['peak_bytes'] or 0) / gib:.3f} GiB, of the run "
                  f"(the CEM step and the decode after them) "
                  f"{(dec['peak_bytes'] or 0) / gib:.3f} GiB "
                  f"[{device_line}]", flush=True)
        if not ok:
            raise SmokeFailure(
                f"sp=2 vs sp=1: loss rel {rel}, gradient {grad} at "
                f"{grad_at}, parameter {param} at {param_at}, flips "
                f"{flips_ok}, ranks equal {same}; CEM loss rel {rel_l}, bpp "
                f"rel {rel_b}, gradient {cgrad} at {cgrad_at}, parameter "
                f"{cparam} at {cparam_at}, flips {cflips_ok}, ranks equal "
                f"{csame}; decode {err}, finite {finite}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = dict(kernels.LAUNCHES)
    for res in [one] + two:
        for r in res:
            for k, v in r["launches"].items():
                launches[k] += v
    if any(launches.values()):
        raise SmokeFailure(f"sp phase launched kernels {launches}")
    print(f"sp phase: {time.perf_counter() - t_phase:.1f} s, no kernel "
          f"launched in this process or in any of the 3 ranks "
          f"[{device_line}]", flush=True)
    return launches


def family_config(model, size=None):
    """scripts/regression/UVG/{nerv_boost,enerv_boost}.sh at ``size``, by
    default the paper's 10M (modelsize 5.2 / 4.3), sized for a 120-frame
    1080p clip: fc_dim 131 / 115 (the index-only families' fc_dim does not
    depend on the clip)."""
    from boosting_nerv_torch.config import BoostConfig, resolve_sizes

    cfg = BoostConfig(
        model=model, sft_block="res_sft", ch_t=32, block_dim=128,
        conv_type=["convnext", "pshuffel_3x3"], act="sin", norm="none",
        crop_list="1080_1920", embed="pe_1.25_80", fc_hw="9_16",
        dec_strds=[5, 3, 2, 2, 2], ks="0_3_3", reduce=2,
        dec_blks=[1, 1, 2, 2, 2],
        modelsize=FAMILY_SIZES[model] if size is None else size,
        lower_width=12)
    return resolve_sizes(cfg, final_size=1920 * 1080, full_data_length=120)


def hnerv_config(outf):
    """scripts/regression/UVG/hnerv.sh at modelsize 3 (fc_dim pinned at
    83, its value for 120 frames), batch 1, as the recipe trains it."""
    from boosting_nerv_torch.config import BoostConfig

    return BoostConfig(
        model="HNeRV", conv_type=["convnext", "pshuffel_3x3"], act="gelu",
        norm="none", crop_list="1080_1920", loss="Fusion6",
        enc_strds=[5, 3, 2, 2, 2], enc_dim="64_16",
        dec_strds=[5, 3, 2, 2, 2], ks="0_1_5", reduce=1.2,
        dec_blks=[1, 1, 1, 1, 1], modelsize=3, fc_dim=83, lower_width=12,
        batchSize=1, lr=0.001, optim_type="Adan", train_precision="high",
        epochs=1, not_resume=True, outf=outf)


def run_family_train(model, cfg, video, root, device_line):
    """Phase 12's training of one Boost family: ``train()`` for one epoch
    of the 4-frame clip (4 steps, then its eval), at its recipe's lr and
    Fusion10_freq, Adan, TF32 off; checks the first loss against a forward
    just before it, every loss finite, and ``measure_fps``'s launches (3 +
    3 a decode); prints the median step ms and the peak allocation.
    Returns the launch counts of its runs."""
    from boosting_nerv_torch.ops import kernels
    from boosting_nerv_torch.ops.losses import loss_fn
    from boosting_nerv_torch.training.trainer import RegressionTrainer
    from boosting_nerv_torch.utils.logger import RunLogger

    tcfg = cfg.replace(
        batchSize=1, epochs=1, lr=FAMILY_LR[model], loss="Fusion10_freq",
        optim_type="Adan", train_precision="highest", not_resume=True,
        clip_max_norm=1.0 if model == "ENeRV_Boost" else None,
        outf=os.path.join(root, model))
    tr = RegressionTrainer(tcfg, video=video, device="cuda",
                           logger=RunLogger(tcfg.outf, enable_tb=False))
    if tr.fps_decode_path != "serving":
        raise SmokeFailure(f"{model} fps path {tr.fps_decode_path}")
    first = next(video.epoch_batches(tr.train_ind, 1, True,
                                     tr.cfg.manualSeed))
    with torch.no_grad():
        img = tr.gather(first["idx"])
        want = float(loss_fn(tr.model(torch.as_tensor(
            first["norm_idx"], device="cuda")), img, tr.cfg.loss))
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    tr.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    losses = tr.train_losses
    rel = abs(losses[0] - want) / abs(want)
    kernels.reset_launch_counts()
    fps = tr.measure_fps(reps=FPS_REPS)
    fps_launches = dict(kernels.LAUNCHES)
    want_fps = {k: SERVING_LAUNCHES.get(k, 0) * (FPS_REPS + 1)
                for k in fps_launches}
    step_ms, peak = _step_ms_and_peak(tr, 3)
    print(f"family {model} train: {len(losses)} steps and its eval in "
          f"{train_s:.1f} s (fc_dim {tr.cfg.fc_dim}, "
          f"{sum(p.numel() for p in tr.model.parameters())} params, "
          f"Fusion10_freq, Adan, lr {tcfg.lr}, clip "
          f"{tr.cfg.clip_max_norm}, TF32 off); losses "
          f"{[round(v, 5) for v in losses]}; first loss {losses[0]:.7g} "
          f"vs a forward just before it {want:.7g}: rel err {rel:.3g} (tol "
          f"{FIRST_LOSS_RTOL}); measure_fps {fps:.2f} decodes/s, launches "
          f"{ {k: v for k, v in fps_launches.items() if v} }; train step "
          f"{step_ms:.2f} ms median of 3 (CUDA events), peak allocation of "
          f"a step {peak / 2**30:.3f} GiB [{device_line}]", flush=True)
    if not (rel <= FIRST_LOSS_RTOL and len(losses) == TRAIN_FRAMES
            and all(math.isfinite(v) for v in losses)):
        raise SmokeFailure(f"{model} train: losses {losses}, first {want}")
    if fps_launches != want_fps or not fps > 0:
        raise SmokeFailure(f"{model} measure_fps launches {fps_launches}, "
                           f"expected {want_fps}")
    return [launches, fps_launches]


def widest_k_loop_cases(gen):
    """Phase 12's cases of the K loop's widest served input: stage 2 of
    E-NeRV-Boost 15M (``enerv_boost.sh`` at modelsize 5.8: 213 -> 4 x 106
    at 135 x 240, planned at N 64), random weights and SFT vectors, alone
    and with int8 codes out."""
    from boosting_nerv_torch.config import model_stage_plan
    from boosting_nerv_torch.ops.kernels import planar

    cfg = family_config("ENeRV_Boost", ENERV_15M)
    st, (h, w) = model_stage_plan(cfg)[2], (135, 240)
    c_in, c = st.ngf, st.new_ngf
    weights = planar.StageWeights(
        rnd(gen, 4 * c, 3, 3, c_in, scale=(9 * c_in) ** -0.5),
        rnd(gen, 4 * c, scale=0.1),
        rnd(gen, c, 3, 3, c, scale=(9 * c) ** -0.5), rnd(gen, c, scale=0.1),
        rnd(gen, c, 3, 3, c, scale=(9 * c) ** -0.5), rnd(gen, c, scale=0.1))
    sft = (torch.rand((4, c), generator=gen, device="cuda") - 0.5) * 0.6
    args = (rnd(gen, 1, h, w, c_in), weights, sft)
    label = f"ENeRV_Boost 15M stage 2 (K loop, Cin {c_in})"
    return [(label, "fused_upconv_rsft", args, {}, False),
            (label + " codes out", "fused_upconv_rsft", args,
             {"out_inv": out_inv(planar.fused_upconv_rsft_plain, args)},
             False)]


def run_families_phase(summary, device_line):
    """Phase 12: NeRV-Boost and E-NeRV-Boost at UVG-1080p 10M full width
    (seeded random weights) on the serving decode in bf16 and W8A8, each
    wrapper against its plain version at every tail shape (stage 2 of
    E-NeRV-Boost: the K loop's Cin 172), their frames and launches, the
    timing turns, and their training; then one train step of the HNeRV
    baseline, whose fps clock times its eager decode.  Adds the wrapper
    checks' errors to ``summary``; returns the launch counts of its
    runs."""
    from boosting_nerv_torch.data import VideoData, synthetic_video
    from boosting_nerv_torch.models import build_model
    from boosting_nerv_torch.ops import kernels
    from boosting_nerv_torch.runtime.fast_decode import build_serving_decode
    from boosting_nerv_torch.training.trainer import RegressionTrainer
    from boosting_nerv_torch.utils.logger import RunLogger

    t_phase = time.perf_counter()
    runs = []
    ts = [torch.tensor([v], dtype=torch.float32, device="cuda")
          for v in np.linspace(0.01, 1.0, N_FRAMES)]
    calib = [(None, torch.tensor([v], device="cuda")) for v in CALIB_TS]
    gen = torch.Generator(device="cuda").manual_seed(12)
    root = os.path.join(REPO, "output", "chip_smoke_families")  # gitignored
    shutil.rmtree(root, ignore_errors=True)
    try:
        video = VideoData(synthetic_video(TRAIN_FRAMES, 1080, 1920, seed=2))
        for model_name in FAMILY_SIZES:
            cfg = family_config(model_name)
            model = build_model(cfg, seed=0).eval()
            decode = build_serving_decode(cfg, model)
            plain = build_serving_decode(cfg, model, plain=True)
            decode_i8 = build_serving_decode(cfg, model, w8a8_calib=calib)
            plain_i8 = build_serving_decode(cfg, model, w8a8_calib=calib,
                                            plain=True)
            stages = [(st.index, st.in_shape[3], st.weights.w0.shape[0])
                      for st in decode.tail]
            want_i8 = FAMILY_W8A8[model_name]
            print(f"family {model_name} 10M (fc_dim {cfg.fc_dim}, "
                  f"{sum(p.numel() for p in model.parameters())} params): "
                  f"tail stages (index, Cin, C) {stages}; W8A8 stages "
                  f"{decode_i8.w8a8_stages}, int8 codes in "
                  f"{decode_i8.w8a8_zc}", flush=True)
            if not (decode_i8.w8a8_stages == decode_i8.w8a8_zc == want_i8):
                raise SmokeFailure(f"{model_name} W8A8 stages "
                                   f"{decode_i8.w8a8_stages}, expected "
                                   f"{want_i8}")
            for dec, i8 in ((decode, False), (decode_i8, True)):
                want = FAMILY_LAUNCHES[(model_name, i8)]
                if dec.launches_per_frame != want:
                    raise SmokeFailure(f"{model_name} launches per frame "
                                       f"{dec.launches_per_frame}, expected "
                                       f"{want}")
            verify_plans(tail_grids(decode, decode_i8), device_line)
            got = check_kernels(tail_cases(decode, decode_i8, gen,
                                           f"{model_name} "),
                                device_line, v3_line=False)
            for name, s in got.items():
                summary[name]["max_abs_err"] = max(
                    summary[name]["max_abs_err"], s["max_abs_err"])
            with torch.no_grad():
                refs = [model(t) for t in ts]
            outs, launches = serve(decode, None, ts)
            runs.append(launches)
            err = max((o.float() - r).abs().max().item()
                      for o, r in zip(outs, refs))
            print(f"family {model_name} bf16 {N_FRAMES} frames (1, 1080, "
                  f"1920, 3) finite in [0, 1]: max_abs_err vs the fp32 "
                  f"model {err:.6g} (tol {SLICE_TOL}); launches "
                  f"{ {k: v for k, v in launches.items() if v} }",
                  flush=True)
            if not err <= SLICE_TOL:
                raise SmokeFailure(f"{model_name} bf16 error {err}")
            outs, launches = serve(decode_i8, None, ts)
            runs.append(launches)
            err = max((o.float() - plain_i8(None, t).float()).abs().max()
                      .item() for t, o in zip(ts, outs))
            t_hold = torch.tensor([T_HOLD], device="cuda")
            mse = (decode_i8(None, t_hold).float()
                   - decode(None, t_hold).float()).pow(2).mean().item()
            psnr = 99.0 if mse <= 1e-12 else -10.0 * math.log10(mse)
            print(f"family {model_name} w8a8 {N_FRAMES} frames finite in "
                  f"[0, 1]: max_abs_err vs plain-stage W8A8 decode "
                  f"{err:.6g} (tol {W8A8_TOL}); PSNR vs bf16 at t={T_HOLD}: "
                  f"{psnr:.3f} dB (gate {PSNR_GATE}); launches "
                  f"{ {k: v for k, v in launches.items() if v} }",
                  flush=True)
            if not (err <= W8A8_TOL and psnr >= PSNR_GATE):
                raise SmokeFailure(f"{model_name} W8A8 error {err}, PSNR "
                                   f"{psnr}")
            print_turns(f"{model_name} bf16", ("plain stages", plain),
                        ("kernels", decode), None, ts, device_line)
            print_turns(f"{model_name} w8a8 vs bf16", ("bf16", decode),
                        ("w8a8", decode_i8), None, ts, device_line)
            del decode, plain, decode_i8, plain_i8, model
            runs += run_family_train(model_name, cfg, video, root,
                                     device_line)
        got = check_kernels(widest_k_loop_cases(gen), device_line,
                            v3_line=False)
        summary["fused_upconv_rsft"]["max_abs_err"] = max(
            summary["fused_upconv_rsft"]["max_abs_err"],
            got["fused_upconv_rsft"]["max_abs_err"])

        hcfg = hnerv_config(os.path.join(root, "HNeRV"))
        tr = RegressionTrainer(hcfg, video=video, device="cuda",
                               logger=RunLogger(hcfg.outf, enable_tb=False))
        kernels.reset_launch_counts()
        loss, _ = tr.train_step_idx([0], video.norm_idx([0]), hcfg.lr)
        fps = tr.measure_fps(reps=3)
        torch.cuda.synchronize()
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        print(f"family HNeRV (hnerv.sh, modelsize 3, fc_dim {tr.cfg.fc_dim}, "
              f"{sum(p.numel() for p in tr.model.parameters())} params): one "
              f"step, loss {float(loss):.6g}; fps clock "
              f"{tr.fps_decode_path} decode {fps:.2f} frames/s; kernel "
              f"launches {launches} [{device_line}]", flush=True)
        if not (math.isfinite(float(loss)) and tr.fps_decode_path == "eager"
                and fps > 0 and not launches):
            raise SmokeFailure(f"HNeRV: loss {loss}, fps path "
                               f"{tr.fps_decode_path}, launches {launches}")
        del tr
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"families phase: {time.perf_counter() - t_phase:.1f} s "
          f"[{device_line}]", flush=True)
    return {k: sum(r.get(k, 0) for r in runs) for k in kernels.LAUNCHES}


def cem_config(model, outf, **kw):
    """A compression recipe at full width, one epoch, batch 1, TF32 off
    (the recipes train at "high"): HNeRV-Boost
    (scripts/compression/hnerv_boost.sh at Size 2.8: bench.py's model,
    fc_dim 127, warm-started from phase 11's checkpoint) or NeRV-Boost
    (nerv_boost.sh at Size 5.2: fc_dim 131, seeded weights)."""
    base = dict(
        batchSize=1, epochs=1, lr=CEM_LR, lr_type="cosine_0_1_0.1",
        loss="Fusion10_freq", optim_type="Adan", train_precision="highest",
        not_resume=True, outf=outf, quant=True, quant_model_bit=8,
        quant_bias_bit=8, quantizer_w="scale", quantizer_b="scale",
        target_bit=4)
    if model == "HNeRV_Boost":
        return train_config(outf).replace(**{
            **base, "quant_embed_bit": 8, "quantizer_e": "scalebeta",
            "embed_entropy": True, "lambda_rate": 0.05,
            "weight": WARM_CKPT, **kw})
    return family_config(model).replace(**{**base, "lambda_rate": 0.2,
                                           **kw})


def _qp_copy(tr):
    return [v.detach().clone() for v in tr.qp_tensors()]


def _same_state(a, b):
    """Two trainers hold equal model parameters and quantiser
    parameters."""
    sa, sb = a.model.state_dict(), b.model.state_dict()
    qa, qb = a.qp_tensors(), b.qp_tensors()
    return (sa.keys() == sb.keys()
            and all(torch.equal(sa[k], sb[k].to(sa[k].device)) for k in sa)
            and len(qa) == len(qb)
            and all(torch.equal(x, y.to(x.device)) for x, y in zip(qa, qb)))


def cem_step_card_vs_cpu(model, root):
    """(a): one CEM step on a 120x240 frame on the card and on the CPU
    (torch's own convolutions) from the same weights and quantisers with
    the same noise (L1_freq: MS-SSIM needs more than 160 pixels a side;
    NeRV-Boost at fc_hw 1_2, its 120x240 output, every conv at its width):
    ((loss, bpp) card, (loss, bpp) CPU)."""
    from boosting_nerv_torch.data import VideoData, synthetic_video
    from boosting_nerv_torch.training.compress_trainer import (
        EMBED, CompressionTrainer)
    from boosting_nerv_torch.utils.logger import RunLogger

    small = VideoData(synthetic_video(1, 120, 240, seed=3))
    got, noise = {}, None
    for dev in ("cuda", "cpu"):
        small_out = {} if model == "HNeRV_Boost" else {"fc_hw": "1_2"}
        cfg = cem_config(model, os.path.join(root, f"step_{dev}"),
                         loss="L1_freq", **small_out)
        tr = CompressionTrainer(cfg, video=small, device=dev,
                                logger=RunLogger(cfg.outf, enable_tb=False))
        tr.maybe_resume()
        tr.init_qparams()
        if noise is None:  # drawn once, on the CPU
            gen = torch.Generator().manual_seed(5)
            noise = {k: torch.rand(s, generator=gen) - 0.5
                     for k, s in tr.flax_shapes.items()}
            if tr.embed_qp is not None:
                with torch.no_grad():
                    shape = tr.model.encode(tr.gather([0])).shape
                noise[EMBED] = torch.rand(shape, generator=gen) - 0.5
        with torch.backends.mkldnn.flags(enabled=False):
            loss, _, bpp = tr.cem_step_idx(
                [0], small.norm_idx([0]), CEM_LR,
                {k: v.to(dev) for k, v in noise.items()})
        got[dev] = (float(loss), float(bpp))
    return got["cuda"], got["cpu"]


def rans_round_trip(tr, dq):
    """Every weight tensor's codes, and each frame's embedding codes (the
    encoder of ``dq``, the dequantised model), through the rANS codec and
    back: (tensors, symbols, bits), raising on any difference."""
    from boosting_nerv_torch.compress import rans
    from boosting_nerv_torch.training.compress_trainer import coding_stats

    streams = [(k, code, q) for k, code, q in tr.coded_tensors()]
    if tr.embed_qp is not None:
        cfg = tr.cfg
        with torch.no_grad():
            for i in range(tr.video.n):
                code, quant, _ = tr.e_quant.apply(
                    dq.encode(tr.gather([i])), tr.embed_qp,
                    cfg.quant_embed_bit, signed=False,
                    per_channel=cfg.per_channel_e)
                streams.append((f"embed {i}", code,
                                quant.cpu().numpy().astype(np.int32)))
    n_sym = bits = 0
    for key, code, quant_i in streams:
        mean, std = coding_stats(code)
        words, lo, hi = rans.gaussian_ans_encode(quant_i, mean, std)
        back = rans.gaussian_ans_decode(words, quant_i.size, mean, std, lo,
                                        hi)
        if not np.array_equal(back, quant_i.ravel()):
            raise SmokeFailure(f"(c) rANS round trip of {key} differs")
        n_sym += quant_i.size
        bits += 32 * words.size
    return len(streams), n_sym, bits


def run_cem_recipe(model, root, device_line):
    """Phase 13's checks (a)-(f) of one recipe; returns its runs' launch
    counts."""
    from boosting_nerv_torch.data import VideoData, synthetic_video
    from boosting_nerv_torch.ops import kernels
    from boosting_nerv_torch.runtime.fast_decode import build_serving_decode
    from boosting_nerv_torch.training.compress_trainer import \
        CompressionTrainer
    from boosting_nerv_torch.training.trainer import METRIC_NAMES
    from boosting_nerv_torch.utils.logger import RunLogger

    runs = []
    card_step, cpu_step = cem_step_card_vs_cpu(model, root)
    rel = [abs(a - b) / abs(b) for a, b in zip(card_step, cpu_step)]
    print(f"cem {model} (a) one CEM step card vs CPU (120x240, L1_freq, "
          f"same weights, quantisers and noise, TF32 off): loss "
          f"{card_step[0]:.7g} vs {cpu_step[0]:.7g}, bpp {card_step[1]:.7g} "
          f"vs {cpu_step[1]:.7g}; rel err {rel[0]:.3g}, {rel[1]:.3g} (tol "
          f"{CEM_STEP_RTOL}) [{device_line}]", flush=True)
    if not max(rel) <= CEM_STEP_RTOL:
        raise SmokeFailure(f"(a) {model} card vs CPU rel err {rel}")

    video = VideoData(synthetic_video(TRAIN_FRAMES, 1080, 1920, seed=4))
    cfg = cem_config(model, os.path.join(root, model))
    tr = CompressionTrainer(cfg, video=video, device="cuda",
                            logger=RunLogger(cfg.outf, enable_tb=False))
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    tr.train()  # maybe_resume, init_qparams, 4 steps, the coding eval
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = dict(kernels.LAUNCHES)
    runs.append(train_launches)
    # one coding eval, at its end: one fps clock of FPS_REPS + 1 decodes
    want_fps = {k: SERVING_LAUNCHES.get(k, 0) * (FPS_REPS + 1)
                for k in train_launches}
    init = CompressionTrainer(cfg, video=video, device="cuda",
                              logger=RunLogger(cfg.outf, enable_tb=False))
    init.maybe_resume()
    init.init_qparams()
    moved = sum(not torch.equal(a, b)
                for a, b in zip(_qp_copy(init), _qp_copy(tr)))
    n_qp = len(_qp_copy(tr))
    del init
    losses = tr.train_losses
    per_frame = [b / video.n for b in tr.train_bpp]
    on = [b > tr.target_bpp for b in per_frame]
    print(f"cem {model} (b) train(): {len(losses)} steps and the coding "
          f"eval in {train_s:.1f} s (fc_dim {tr.cfg.fc_dim}, "
          f"{sum(p.numel() for p in tr.model.parameters())} params, "
          f"{len(tr.leaves)} quantised tensors, {n_qp} quantiser "
          f"parameters, lambda {cfg.lambda_rate}, embed_entropy "
          f"{cfg.embed_entropy}, TF32 off, the recipe's train_precision: "
          f"high); losses "
          f"{[round(v, 5) for v in losses]}; qp tensors moved from "
          f"init_qparams {moved}/{n_qp}; bpp/frame "
          f"{[round(v, 4) for v in per_frame]} vs target_bpp "
          f"{tr.target_bpp:.4f}: rate term on {on}; launches "
          f"{ {k: v for k, v in train_launches.items() if v} } "
          f"[{device_line}]", flush=True)
    if not (len(losses) == TRAIN_FRAMES
            and all(math.isfinite(v) for v in losses) and moved > 0
            and train_launches == want_fps):
        raise SmokeFailure(f"(b) {model}: losses {losses}, qp moved "
                           f"{moved}, launches {train_launches}, expected "
                           f"{want_fps}")

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = tr.evaluate_cem(coding=True)  # its fps clock is (d)'s
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    fps_launches = dict(kernels.LAUNCHES)
    runs.append(fps_launches)
    ratio = tr.total_bpp / tr.estimate_bpp
    dq = tr.dequant_model()
    n_streams, n_sym, rans_bits = rans_round_trip(tr, dq)
    print(f"cem {model} (c) evaluate_cem(coding=True): {eval_s:.2f} s; "
          + ", ".join(f"{k} {res[k]:.4f}" for k in METRIC_NAMES
                      if k.startswith("quant_seen"))
          + f"; real bpp {tr.total_bpp:.6f}, estimated {tr.estimate_bpp:.6f}"
          f", ratio {ratio:.5f} (gate {CEM_RATIO}); {n_streams} rANS "
          f"streams ({n_sym} symbols, {rans_bits} bits) decoded back to "
          f"their codes exactly; fps {tr.fps:.2f} [{device_line}]",
          flush=True)
    if not (CEM_RATIO[0] <= ratio <= CEM_RATIO[1]
            and all(math.isfinite(v) for v in res.values())):
        raise SmokeFailure(f"(c) {model}: ratio {ratio}, eval {res}")

    t = torch.tensor([T_HOLD], device="cuda")
    kernels.reset_launch_counts()
    with torch.no_grad():
        decode = build_serving_decode(tr.cfg, dq)
        if model == "HNeRV_Boost":
            embed = dq.encode(tr.gather([0]))
            out, ref = decode(embed, t).float(), dq.decode(embed, t)
        else:
            out, ref = decode(None, t).float(), dq(t)
    torch.cuda.synchronize()
    check_launches = dict(kernels.LAUNCHES)
    runs.append(check_launches)
    want_check = {k: SERVING_LAUNCHES.get(k, 0) for k in check_launches}
    err = (out - ref).abs().max().item()
    print(f"cem {model} (d) evaluate_cem's measure_fps of the dequantised "
          f"weights: {tr.fps:.2f} decodes/s (batch 1, encoder excluded), "
          f"launches "
          f"{ {k: v for k, v in fps_launches.items() if v} }; serving "
          f"decode of the dequantised weights at t {T_HOLD} vs their eager "
          f"fp32 model: max_abs_err {err:.6g} (tol {SLICE_TOL}) "
          f"[{device_line}]", flush=True)
    if (fps_launches != want_fps or check_launches != want_check
            or not (tuple(out.shape) == (1, 1080, 1920, 3)
                    and err <= SLICE_TOL)):
        raise SmokeFailure(f"(d) {model}: launches {fps_launches} and "
                           f"{check_launches}, expected {want_fps} and "
                           f"{want_check}; err {err}")
    del dq, decode

    back = CompressionTrainer(
        cfg.replace(not_resume=False, weight="None"), video=video,
        device="cuda", logger=RunLogger(cfg.outf, enable_tb=False))
    back.maybe_resume()
    back.init_qparams()
    same = _same_state(back, tr) and back.start_epoch == cfg.epochs
    print(f"cem {model} (e) a fresh trainer resumes the CEM checkpoint "
          f"({os.path.getsize(os.path.join(cfg.outf, 'model_latest.ckpt'))}"
          f" bytes): model, qp and embed_qp equal: {same}", flush=True)
    if not same:
        raise SmokeFailure(f"(e) {model}: the CEM checkpoint read back "
                           "differs")
    del back

    cem_ms, cem_peak = _step_ms_and_peak(tr, 5, tr.cem_step_idx, CEM_LR)
    reg_ms, reg_peak = _step_ms_and_peak(tr, 5)
    print(f"cem {model} (f) CEM step {cem_ms:.2f} ms median of 5 (CUDA "
          f"events), peak allocation of a step {cem_peak / 2**30:.3f} GiB; "
          f"the regression step of the same model {reg_ms:.2f} ms, "
          f"{reg_peak / 2**30:.3f} GiB ({cem_ms / reg_ms:.3f}x, "
          f"{cem_peak / reg_peak:.3f}x) [{device_line}]", flush=True)
    return runs


def run_cem_phase(device_line):
    """Phase 13: the CEM compression finetune and coding eval of
    HNeRV-Boost (hnerv_boost.sh, Size 2.8, warm-started from phase 11's
    checkpoint) and NeRV-Boost (nerv_boost.sh, Size 5.2, seeded weights)
    at full width; returns the launch counts of its runs."""
    from boosting_nerv_torch.ops import kernels

    t_phase = time.perf_counter()
    root = os.path.dirname(WARM_CKPT)  # gitignored
    runs = []
    try:
        if not os.path.isfile(WARM_CKPT):
            raise SmokeFailure(f"phase 11 left no checkpoint {WARM_CKPT}")
        for model in ("HNeRV_Boost", "NeRV_Boost"):
            runs += run_cem_recipe(model, root, device_line)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"cem phase: {time.perf_counter() - t_phase:.1f} s "
          f"[{device_line}]", flush=True)
    return {k: sum(r.get(k, 0) for r in runs) for k in kernels.LAUNCHES}


def set_flag(argv, flag, value):
    """``argv`` with ``flag``'s value set to ``value`` (appended when the
    flag is absent)."""
    argv = list(argv)
    if flag in argv:
        argv[argv.index(flag) + 1] = value
    else:
        argv += [flag, value]
    return argv


def task_argv(script, clip_dir, outf, epochs):
    """The first command of the recipe ``script`` with phase 14's cuts:
    (argv, the cuts as printed)."""
    from boosting_nerv_torch import recipes

    cli, argv = recipes.recipe_commands(os.path.join(REPO, script))[0]
    if cli != "boosting_nerv_torch.train_nerv_all":
        raise SmokeFailure(f"{script}: first command runs {cli}")
    cuts = [("--data_path", clip_dir), ("-e", str(epochs)),
            ("--eval_freq", "1"), ("--outf", outf)]
    for flag, value in cuts:
        argv = set_flag(argv, flag, value)
    return argv, " ".join(f"{f} {v}" for f, v in cuts)


def trace_step_kernels(path):
    """[CUDA kernels launched in each traced step] of a torch.profiler
    Chrome trace: a kernel belongs to the host-side ``train.step`` range
    (``utils/tracing.py``'s span) that holds the CUDA API call that
    launched it (matched by correlation id), on any thread."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    steps = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("name") == "train.step" and e.get("ph") == "X"
                   and e.get("cat") in ("cpu_op", "user_annotation"))
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat", "").startswith("cuda_")
                and "correlation" in e.get("args", {})}
    counts = [0] * len(steps)
    for e in events:
        if e.get("cat") != "kernel":
            continue
        ts = launched.get(e.get("args", {}).get("correlation"))
        for i, (a, b) in enumerate(steps):
            if ts is not None and a <= ts <= b:
                counts[i] += 1
    return counts


def run_tasks_phase(device_line):
    """Phase 14: the interpolation recipes through the recipe runner and
    the port's CLI at full width, with the profiler, the dumps and
    ``--eval_only``; returns the launch counts of its runs."""
    from boosting_nerv_torch import train_nerv_all
    from boosting_nerv_torch.data import VideoData, gif, png, synthetic_video
    from boosting_nerv_torch.ops import kernels
    from boosting_nerv_torch.ops.metrics import psnr_per_frame
    from boosting_nerv_torch.runtime.fast_decode import build_serving_decode
    from boosting_nerv_torch.training.trainer import (METRIC_NAMES,
                                                      set_train_precision)

    t_phase = time.perf_counter()
    shutil.rmtree(TASK_ROOT, ignore_errors=True)
    cwd = os.getcwd()
    os.chdir(REPO)  # the CLI writes output/<outf>/...
    runs = []
    try:
        # (a) the clip, through data/png.py both ways
        clip = synthetic_video(TASK_FRAMES, 1080, 1920, seed=5)
        clip_dir = os.path.join(TASK_ROOT, "clip")
        os.makedirs(clip_dir)
        t0 = time.perf_counter()
        for i, f in enumerate(clip):
            png.write_png(os.path.join(clip_dir, f"{i:04d}.png"), f)
        write_ms = (time.perf_counter() - t0) * 1e3 / TASK_FRAMES
        t0 = time.perf_counter()
        video = VideoData.from_dir(clip_dir, "1080_1920", True, True)
        read_ms = (time.perf_counter() - t0) * 1e3 / TASK_FRAMES
        nbytes = sum(os.path.getsize(os.path.join(clip_dir, f))
                     for f in os.listdir(clip_dir))
        same = np.array_equal(video.frames, clip)
        print(f"tasks (a) clip of {TASK_FRAMES} 1080x1920 PNG frames "
              f"({nbytes} bytes): write {write_ms:.1f} ms a frame, read "
              f"(VideoData.from_dir, data/png.py) {read_ms:.1f} ms a frame; "
              f"read back equal to the array: {same} [{device_line}]",
              flush=True)
        if not same:
            raise SmokeFailure("(a) the clip read back differs")

        # (b) scripts/interpolation/hnerv_boost.sh through the CLI
        argv, cuts = task_argv("scripts/interpolation/hnerv_boost.sh",
                               clip_dir, "chip_smoke_tasks/hnerv_boost", 2)
        extra = ["--not_resume", "--profile", "--dump_images",
                 "--dump_videos"]
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        tr = train_nerv_all.run(argv + extra)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        runs.append(launches)
        cfg, losses = tr.cfg, tr.train_losses
        n_evals = 2
        want = {k: SERVING_LAUNCHES.get(k, 0) * n_evals * (FPS_REPS + 1)
                for k in launches}
        split = (tr.video.n, tr.train_ind, tr.val_ind)
        print(f"tasks (b) scripts/interpolation/hnerv_boost.sh's first "
              f"command through recipes.recipe_commands and the port's CLI "
              f"with the cuts {cuts} {' '.join(extra)}: {cfg.model} "
              f"modelsize {cfg.modelsize}, fc_dim {cfg.fc_dim}, enc_dim "
              f"{cfg.enc_dim}, {sum(p.numel() for p in tr.model.parameters())}"
              f" params, split {cfg.data_split}, embed_inter "
              f"{cfg.embed_inter}, train_precision {cfg.train_precision}: "
              f"{tr.video.n} frames, train {tr.train_ind}, val "
              f"{tr.val_ind}; {len(losses)} steps and {n_evals} evals in "
              f"{run_s:.1f} s; losses {[round(v, 5) for v in losses]}; last "
              f"eval " + ", ".join(f"{k} {v:.4f}"
                                   for k, v in tr.last_eval.items())
              + f"; fps {tr.fps:.2f}; launches "
              f"{ {k: v for k, v in launches.items() if v} } "
              f"[{device_line}]", flush=True)
        if split != (TASK_FRAMES, list(range(0, TASK_FRAMES, 2)),
                     list(range(1, TASK_FRAMES, 2))):
            raise SmokeFailure(f"(b) split {split}")
        if not (len(losses) == 2 * len(tr.train_ind)
                and all(math.isfinite(v) for v in losses)):
            raise SmokeFailure(f"(b) losses {losses}")
        if launches != want:
            raise SmokeFailure(f"(b) launches {launches}, expected {want}")

        # (c) the neighbour average, recomputed by hand
        model = tr.model
        with torch.no_grad():
            mixed_psnr, own_psnr, apart = [], [], 0.0
            for j in tr.val_ind:
                t = torch.as_tensor(video.norm_idx([j]), device="cuda")
                mixed = 0.5 * (model.encode(tr.gather([j - 1]))
                               + model.encode(tr.gather([j + 1])))
                outs = [model.decode(e, t) for e in
                        (mixed, model.encode(tr.gather([j])))]
                for out, acc in zip(outs, (mixed_psnr, own_psnr)):
                    acc.append(float(psnr_per_frame(out, tr.gather([j]))[0]))
                apart = max(apart, (outs[0] - outs[1]).abs().max().item())
        got = tr.last_eval["pred_unseen_psnr"]
        err = abs(got - float(np.mean(mixed_psnr)))
        print(f"tasks (c) pred_unseen_psnr {got:.4f} dB vs its "
              f"recomputation from 0.5 * (encode(pre) + encode(post)) "
              f"{np.mean(mixed_psnr):.4f} dB: err {err:.3g} (tol "
              f"{TASK_PSNR_TOL}); the odd frames from their own embedding "
              f"{np.mean(own_psnr):.6f} dB against {np.mean(mixed_psnr):.6f}"
              f", frames apart by {apart:.3g} at most [{device_line}]",
              flush=True)
        if not err <= TASK_PSNR_TOL:
            raise SmokeFailure(f"(c) err {err} dB")

        # (d) the serving decode of the trained weights, eager fp32 ref
        set_train_precision("highest")
        t = torch.tensor([T_HOLD], device="cuda")
        kernels.reset_launch_counts()
        with torch.no_grad():
            decode = build_serving_decode(cfg, model)
            embed = model.encode(tr.gather([0]))
            out, ref = decode(embed, t).float(), model.decode(embed, t)
        torch.cuda.synchronize()
        check_launches = dict(kernels.LAUNCHES)
        runs.append(check_launches)
        want_check = {k: SERVING_LAUNCHES.get(k, 0) for k in check_launches}
        err = (out - ref).abs().max().item()
        print(f"tasks (d) serving decode of the trained weights at t "
              f"{T_HOLD} vs their eager fp32 model: max_abs_err {err:.6g} "
              f"(tol {SLICE_TOL}); launches "
              f"{ {k: v for k, v in check_launches.items() if v} } "
              f"[{device_line}]", flush=True)
        if check_launches != want_check or not (
                tuple(out.shape) == (1, 1080, 1920, 3) and err <= SLICE_TOL):
            raise SmokeFailure(f"(d) launches {check_launches}, err {err}")
        del decode, out, ref

        # (e) the profiler's trace
        trace = os.path.join(cfg.outf, "profile", "trace.json")
        per_step = trace_step_kernels(trace)
        print(f"tasks (e) --profile trace {trace} ({os.path.getsize(trace)} "
              f"bytes): CUDA kernels a traced step {per_step} "
              f"[{device_line}]", flush=True)
        if len(per_step) != TRACED_STEPS or not all(per_step):
            raise SmokeFailure(f"(e) kernels a traced step {per_step}")

        # (f) the dumps
        vis = os.path.join(cfg.outf, "visualize_model_orig")
        names = sorted(os.listdir(vis))
        errs = []
        for i, name in enumerate(names):
            if not name.startswith(f"pred_{i:04d}_"):
                raise SmokeFailure(f"(f) dump {i} is {name}")
            img = torch.from_numpy(png.read_png(os.path.join(vis, name)))
            p = float(psnr_per_frame(img[None].cuda().float() / 255.0,
                                     tr.gather([i]))[0])
            errs.append(abs(p - float(name[10:-4])))
        gif_path = os.path.join(cfg.outf, "gt_pred.gif")
        with open(gif_path, "rb") as f:
            screen, frames = gif.gif_layout(f.read())
        again = os.path.join(TASK_ROOT, "again.gif")
        t0 = time.perf_counter()
        gif.write_gif(again, (png.read_png(os.path.join(vis, n))
                              for n in names))
        gif_s = time.perf_counter() - t0
        with open(gif_path, "rb") as a, open(again, "rb") as b:
            gif_same = a.read() == b.read()
        print(f"tasks (f) {len(names)} dumped PNGs, |PSNR of the file - "
              f"PSNR in its name| max {max(errs):.3f} dB (tol "
              f"{DUMP_PSNR_TOL}); gt_pred.gif {os.path.getsize(gif_path)} "
              f"bytes, screen {screen[0]}x{screen[1]}, {len(frames)} image "
              f"descriptors; written again from the PNGs in {gif_s:.2f} s "
              f"(the same bytes: {gif_same}) [{device_line}]", flush=True)
        if not (len(names) == TASK_FRAMES and max(errs) <= DUMP_PSNR_TOL
                and screen == (1920, 1080) and gif_same
                and frames == [(0, 0, 1920, 1080)] * TASK_FRAMES):
            raise SmokeFailure(f"(f) {len(names)} PNGs, errs {errs}, GIF "
                               f"{screen} {len(frames)}")

        # (g) --eval_only on the run's model_latest.ckpt (auto-resume)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        ev = train_nerv_all.run(argv + ["--eval_only"])
        torch.cuda.synchronize()
        ev_s = time.perf_counter() - t0
        ev_launches = dict(kernels.LAUNCHES)
        runs.append(ev_launches)
        want_ev = {k: SERVING_LAUNCHES.get(k, 0) * (FPS_REPS + 1)
                   for k in ev_launches}
        diff = max(abs(ev.last_eval[k] - tr.last_eval[k])
                   for k in METRIC_NAMES if k.endswith("psnr"))
        with open(os.path.join(cfg.outf, "eval.txt")) as f:
            lines = [x for x in f.read().splitlines() if x]
        print(f"tasks (g) --eval_only from epoch {ev.start_epoch}'s "
              f"checkpoint in {ev_s:.1f} s: eval.csv "
              f"{os.path.isfile(os.path.join(cfg.outf, 'eval.csv'))}, "
              f"eval.txt {len(lines)} line(s); max |PSNR - the last "
              f"training eval's| {diff:.4g} dB (tol {EVAL_ONLY_TOL}); "
              f"bits/param {ev.full_bits_per_param:.4f}, fps {ev.fps:.2f}; "
              f"launches { {k: v for k, v in ev_launches.items() if v} } "
              f"[{device_line}]", flush=True)
        if not (ev.start_epoch == 2 and len(lines) == 1
                and diff <= EVAL_ONLY_TOL and ev_launches == want_ev
                and os.path.isfile(os.path.join(cfg.outf, "eval.csv"))):
            raise SmokeFailure(f"(g) start {ev.start_epoch}, lines {lines}, "
                               f"diff {diff}, launches {ev_launches}")
        del ev

        # (h) the index-only family: the plain eval on the split
        argv_n, cuts_n = task_argv("scripts/interpolation/nerv_boost.sh",
                                   clip_dir, "chip_smoke_tasks/nerv_boost",
                                   1)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        trn = train_nerv_all.run(argv_n + ["--not_resume"])
        torch.cuda.synchronize()
        n_s = time.perf_counter() - t0
        n_launches = dict(kernels.LAUNCHES)
        runs.append(n_launches)
        want_n = {k: SERVING_LAUNCHES.get(k, 0) * (FPS_REPS + 1)
                  for k in n_launches}
        print(f"tasks (h) scripts/interpolation/nerv_boost.sh's first "
              f"command with the cuts {cuts_n} --not_resume: "
              f"{trn.cfg.model} fc_dim {trn.cfg.fc_dim}, "
              f"{sum(p.numel() for p in trn.model.parameters())} params, "
              f"{len(trn.train_losses)} steps and its eval in {n_s:.1f} s; "
              f"losses {[round(v, 5) for v in trn.train_losses]}; eval "
              + ", ".join(f"{k} {v:.4f}" for k, v in trn.last_eval.items())
              + f"; fps {trn.fps:.2f} ({trn.fps_decode_path}); launches "
              f"{ {k: v for k, v in n_launches.items() if v} } "
              f"[{device_line}]", flush=True)
        if not ((trn.train_ind, trn.val_ind) == (tr.train_ind, tr.val_ind)
                and all(math.isfinite(v) for v in trn.train_losses)
                and trn.last_eval["pred_unseen_psnr"] > 0
                and n_launches == want_n):
            raise SmokeFailure(f"(h) split {trn.train_ind}, losses "
                               f"{trn.train_losses}, launches {n_launches}")
        del trn

        # the seconds of an eval of (b)'s model, without and with the dumps
        kernels.reset_launch_counts()
        eval_s = []
        for dump in (False, True):
            t0 = time.perf_counter()
            tr.evaluate(dump_vis=dump)
            torch.cuda.synchronize()
            eval_s.append(time.perf_counter() - t0)
        s_launches = dict(kernels.LAUNCHES)
        runs.append(s_launches)
        want_s = {k: SERVING_LAUNCHES.get(k, 0) * 2 * (FPS_REPS + 1)
                  for k in s_launches}
        print(f"tasks eval of (b)'s model ({TASK_FRAMES} frames, 2 slots, "
              f"the neighbour encodes, PTQ, the fps clock): {eval_s[0]:.2f} "
              f"s; with the PNG and GIF dumps {eval_s[1]:.2f} s; launches "
              f"{ {k: v for k, v in s_launches.items() if v} } "
              f"[{device_line}]", flush=True)
        if s_launches != want_s:
            raise SmokeFailure(f"eval launches {s_launches}, expected "
                               f"{want_s}")

        # the step of (b)'s model with TF32 on (the recipe's) and off
        step = {}
        for precision in ("high", "highest", "high", "highest"):
            set_train_precision(precision)
            ms, peak = _step_ms_and_peak(tr, 5, lr=cfg.lr)
            step.setdefault(precision, []).append((ms, peak))
        print("tasks step of (b)'s model, median of 5 (CUDA events), turns "
              "high / highest / high / highest: " + "; ".join(
                  f"{p} (TF32 {'on' if p == 'high' else 'off'}) "
                  f"{statistics.mean(m for m, _ in v):.2f} ms "
                  f"({', '.join(f'{m:.2f}' for m, _ in v)}), peak "
                  f"{max(b for _, b in v) / 2**30:.3f} GiB"
                  for p, v in step.items()) + f" [{device_line}]",
              flush=True)
        del tr
    finally:
        set_train_precision("highest")
        os.chdir(cwd)
        shutil.rmtree(TASK_ROOT, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"tasks phase: {time.perf_counter() - t_phase:.1f} s "
          f"[{device_line}]", flush=True)
    return {k: sum(r.get(k, 0) for r in runs) for k in kernels.LAUNCHES}


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


MODE_UNITS = ("conv_sm90_sin.cu", "conv_sm90_planar.cu",
              "conv_sm90_kloop.cu")


def check_instances(device_line):
    """Phase 2's lines of the int8 form of the Hopper kernel and of its sin,
    planar and K-loop modes: each production instance (conv_sm90_i8.cu,
    _64.cu, _80.cu, whose K5 probe units are phase 10's;
    conv_sm90_sin.cu, conv_sm90_planar.cu, conv_sm90_kloop.cu) with its
    registers, spill bytes and wgmma (IGMMA, HGMMA) instructions in the
    library's SASS; fails on a spill or an instance without them."""
    from boosting_nerv_torch.ops.kernels import _build
    from boosting_nerv_torch.tools import probes

    lib = _build.library_path()
    regs = {i["name"]: i for i in probes.ptxas_instances(lib + ".log")
            if (i["source"].startswith("conv_sm90_i8")
                or i["source"] in MODE_UNITS)
            and i["source"] not in probes.PROBE_SOURCES}
    counts = probes.sass_mma_counts(lib)
    for unit in ("conv_sm90_i8.cu",) + MODE_UNITS:
        if not any(r["source"] == unit for r in regs.values()):
            raise SmokeFailure(f"no {unit} instance in ptxas's report")
    for name, r in sorted(regs.items(), key=lambda kv: kv[1]["source"]):
        m = re.search(r"conv_sm90_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E"
                      r"Lb[01]ELi(\d+)E", name)
        what = ("N {} P {} form {} rows {} mode {}".format(*m.groups()) if m
                else name)
        n = counts.get(name, 0)
        print(f"ptxas {r['source']} {what}: "
              f"{r['registers']} registers, {r['spills']} spill bytes, {n} "
              f"wgmma (SASS) [{device_line}]", flush=True)
        if r["spills"] or not n:
            raise SmokeFailure(f"{name}: {r['spills']} spill bytes, {n} "
                               "wgmma instructions")


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

    t_start = time.perf_counter()
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
    check_instances(device_line)

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
    check_plans(decode, decode_i8, v2, v3, v1, device_line)
    run_schedules(decode, v3, gen, device_line)
    run_ab(decode, decode_i8, v2, v3, v1, gen, device_line)
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
    runs.append(run_train_phase(device_line))
    runs.append(run_dp_phase(device_line))  # needs phase 11's checkpoint
    runs.append(run_sp_phase(device_line))  # and so does this one
    runs.append(run_families_phase(summary, device_line))
    runs.append(run_cem_phase(device_line))
    runs.append(run_tasks_phase(device_line))

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
    print(f"smoke: {time.perf_counter() - t_start:.1f} s in all "
          f"[{device_line}]", flush=True)
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
