#!/usr/bin/env python3
"""Where the decode's device time goes, on one NVIDIA GPU.

    python3 chip_profile.py [--frames 4]

Builds HNeRV-Boost at the UVG-1080p serving config with seeded random
weights (as chip_smoke.py does), the bf16 serving decode and the W8A8 one,
warms both up, and traces ``--frames`` frames of each with torch.profiler.
For each decode it prints the wall time per frame, the device's busy time
per frame (the union of its kernels' intervals) and idle share, and the
device time per frame and launches per frame of its largest kernels.  The
template arguments in a kernel's name say which launch it is:
``conv_sm90_kernel<NS, P, F, R>`` (the Hopper kernel at N slice NS; F: 0
bf16, 1 int8 codes in, 2 bf16 in quantised to int8; R rows a
warpgroup), ``stage_conv_kernel<KS, CK, Q>`` (bf16, KS x KS taps; Q:
int8-code output) and ``stage_conv3x3_i8_kernel<IK, OK, CK>`` (IK/OK:
0 int8 codes, 1 bf16).
Each line carries the card's name and power limit.  Exits non-zero
without CUDA.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from chip_smoke import CALIB_TS, bench_config, card

TOP = 12  # kernels listed per decode, by device time


def profile(decode, embed, ts):
    """(wall ms/frame, busy ms/frame, [(kernel, ms/frame, launches/frame)])
    of one traced run over ``ts``."""
    from torch.profiler import ProfilerActivity, profile as trace

    for t in ts:  # warm-up
        decode(embed, t)
    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in ts:
            decode(embed, t)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type.name == "CUDA")
    busy, end = 0.0, -1.0
    for a, b in spans:  # union of the kernels' intervals, in us
        if b > end:
            busy += b - max(a, end)
            end = b
    n = len(ts)
    rows = sorted(((k.key, k.device_time_total / 1e3 / n, k.count / n)
                   for k in prof.key_averages()
                   if k.device_type.name == "CUDA"), key=lambda r: -r[1])
    return wall / n, busy / 1e3 / n, rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device; this run needs one GPU",
              file=sys.stderr)
        return 2
    from boosting_nerv_torch.models import build_model
    from boosting_nerv_torch.runtime.fast_decode import build_serving_decode

    device_line = card()
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
        wall, busy, rows = profile(decode, embed, ts)
        print(f"{name}: wall {wall:.3f} ms/frame, device busy {busy:.3f} "
              f"ms/frame, idle {1 - busy / wall:.1%} (traced, {args.frames} "
              f"frames) [{device_line}]")
        for key, ms, count in rows[:TOP]:
            print(f"  {ms:9.4f} ms/frame {count:6.1f} launches/frame  "
                  f"{key[:120]}")
        rest = sum(ms for _, ms, _ in rows[TOP:])
        print(f"  {rest:9.4f} ms/frame in {len(rows[TOP:])} other kernels")
    return 0


if __name__ == "__main__":
    sys.exit(main())
