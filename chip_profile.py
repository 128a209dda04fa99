#!/usr/bin/env python3
"""Where the decode's (or a train step's) device time goes, on one NVIDIA
GPU.

    python3 chip_profile.py [--frames 4] [--train | --cem]

Builds HNeRV-Boost at the UVG-1080p serving config with seeded random
weights (as chip_smoke.py does), the bf16 serving decode and the W8A8 one,
warms both up, and traces ``--frames`` frames of each with torch.profiler.
For each decode it prints the wall time per frame, the device's busy time
per frame (the union of its kernels' intervals), idle share and kernel
launches per frame, the device time per frame of its largest kernels and
its longest idle gaps (``bench_h100/trace.py``'s reader of the trace), and
the program's span table (``boosting_nerv_torch/utils/tracing.py``).  The
template arguments in a kernel's name say which launch it is:
``conv_sm90_kernel<NS, P, F, R>`` (the Hopper kernel at N slice NS; F: 0
bf16, 1 int8 codes in, 2 bf16 in quantised to int8; R rows a
warpgroup), ``stage_conv_kernel<KS, CK, Q>`` (bf16, KS x KS taps; Q:
int8-code output) and ``stage_conv3x3_i8_kernel<IK, OK, CK>`` (IK/OK:
0 int8 codes, 1 bf16).  With ``--train`` it traces ``--frames`` steps of
the port's RegressionTrainer instead, as chip_smoke.py's phase 11 trains
(``train_config``: bench widths, a 4-frame 1080x1920 synthetic clip,
batch 1, Fusion10_freq, Adan, TF32 off), per step.  With ``--cem`` it
traces ``--frames`` CEM steps of the port's CompressionTrainer at
chip_smoke.py's phase-13 HNeRV-Boost recipe (``cem_config``, seeded
weights) and as many regression steps of the same trainer, per step.
Each line carries the card's name and power limit.  Exits non-zero
without CUDA.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import time

import numpy as np
import torch

from chip_smoke import CALIB_TS, CEM_LR, REPO, TRAIN_LR, bench_config, \
    card, cem_config, train_config

def profile(call, n):
    """(wall ms per call, the trace's summary (``bench_h100.trace.read``),
    the program's spans (``tracing.summary()``), {event name: count}) of
    one traced run of ``call(i)`` for i < n, after one untraced run."""
    from torch.profiler import ProfilerActivity, profile as trace

    from bench_h100.trace import read
    from boosting_nerv_torch.utils import tracing

    for i in range(n):  # warm-up
        call(i)
    torch.cuda.synchronize()
    tracing.reset()
    with trace(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            call(i)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    counts = {k.key[:200]: k.count for k in prof.key_averages()
              if k.device_type.name == "CUDA"}
    return wall / n, read(prof), tracing.summary(), counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--train", action="store_true",
                    help="trace train steps, not decodes")
    ap.add_argument("--cem", action="store_true",
                    help="trace CEM steps and regression steps")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device; this run needs one GPU",
              file=sys.stderr)
        return 2
    from boosting_nerv_torch.models import build_model
    from boosting_nerv_torch.runtime.fast_decode import build_serving_decode

    device_line = card()
    if args.train:
        return profile_train(args.frames, device_line)
    if args.cem:
        return profile_cem(args.frames, device_line)
    cfg = bench_config()
    model = build_model(cfg, seed=0).eval()
    frame = np.random.default_rng(0).uniform(
        size=(1, 1080, 1920, 3)).astype(np.float32)
    with torch.no_grad():
        embed = model.encode(torch.from_numpy(frame).cuda())
    calib = [(embed, torch.tensor([v], device="cuda")) for v in CALIB_TS]
    ts = [torch.tensor([v], dtype=torch.float32, device="cuda")
          for v in np.linspace(0.01, 1.0, args.frames)]
    for name, decode in (
            ("bf16", build_serving_decode(cfg, model)),
            ("w8a8", build_serving_decode(cfg, model, w8a8_calib=calib))):
        report(name, "frame", args.frames,
               profile(lambda i: decode(embed, ts[i]), args.frames),
               device_line)
    return 0


def report(name, per, n, result, device_line):
    from bench_h100.trace import _is_kernel
    from boosting_nerv_torch.utils import tracing

    wall, tr, spans, counts = result
    busy = tr.busy_s * 1e3 / n
    print(f"{name}: wall {wall:.3f} ms/{per}, device busy {busy:.3f} "
          f"ms/{per}, idle {1 - busy / wall:.1%}, {tr.launches / n:.1f} "
          f"kernel launches/{per} (traced, {n} {per}s) [{device_line}]")
    listed = 0
    for key, sec in tr.device_ops:
        listed += counts.get(key, 0) if _is_kernel(key) else 0
        print(f"  {sec * 1e3 / n:9.4f} ms/{per} {counts.get(key, 0) / n:6.1f} "
              f"launches/{per}  {key[:120]}")
    print(f"  {(tr.launches - listed) / n:.1f} launches/{per} of other "
          f"kernels")
    for key, sec in tr.idle_gaps:
        print(f"  {sec * 1e3 / n:9.4f} ms/{per} idle {key}")
    print(tracing.table(spans))


def profile_train(steps, device_line) -> int:
    from boosting_nerv_torch.data import VideoData, synthetic_video
    from boosting_nerv_torch.training.trainer import RegressionTrainer
    from boosting_nerv_torch.utils.logger import RunLogger

    outf = os.path.join(REPO, "output", "chip_profile_train")  # gitignored
    try:
        cfg = train_config(outf)
        tr = RegressionTrainer(
            cfg, video=VideoData(synthetic_video(4, 1080, 1920, seed=0)),
            logger=RunLogger(outf, enable_tb=False))
        n = tr.video.n
        report("train step", "step", steps, profile(
            lambda i: tr.train_step_idx([i % n], tr.video.norm_idx([i % n]),
                                        TRAIN_LR), steps), device_line)
    finally:
        shutil.rmtree(outf, ignore_errors=True)
    return 0


def profile_cem(steps, device_line) -> int:
    from boosting_nerv_torch.data import VideoData, synthetic_video
    from boosting_nerv_torch.training.compress_trainer import \
        CompressionTrainer
    from boosting_nerv_torch.utils.logger import RunLogger

    outf = os.path.join(REPO, "output", "chip_profile_cem")  # gitignored
    try:
        cfg = cem_config("HNeRV_Boost", outf, weight="None")
        tr = CompressionTrainer(
            cfg, video=VideoData(synthetic_video(4, 1080, 1920, seed=0)),
            logger=RunLogger(outf, enable_tb=False))
        tr.init_qparams()
        n = tr.video.n
        for name, step in (("cem step", tr.cem_step_idx),
                           ("regression step", tr.train_step_idx)):
            report(name, "step", steps, profile(
                lambda i: step([i % n], tr.video.norm_idx([i % n]), CEM_LR),
                steps), device_line)
    finally:
        shutil.rmtree(outf, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
