#!/usr/bin/env python3
"""The mesh across cards: the 'spatial' and 'data' axes over NCCL.

    python3 chip_mesh.py          # four NVIDIA GPUs of one host
    python3 chip_mesh.py --cpu    # a rehearsal: gloo CPU processes, 240x480

chip_smoke.py's phase 16 runs the 'spatial' axis as two gloo ranks on one
card; this runs it as the CLIs do on several cards, one NCCL rank a
card.  Model: bench.py's UVG-1080p HNeRV-Boost as chip_smoke.py's phase
11 trains it (``train_config``: fc_dim 127, Fusion10_freq, Adan, lr
0.003, TF32 off) on four synthetic 1080x1920 frames, seeded weights:

(a) sp=2 on cuda:0-1 against one process on cuda:0, batch 1 (frame 0):
    ``STEPS`` regression steps (``parallel.steps.train_steps``) and the
    split decode of frame 0's embedding at t = 0.37
    (``parallel.steps.split_decode``, fp32);
(b) dp=2 x sp=2 on cuda:0-3 against one process, batch 2 (frames 0, 1):
    ``STEPS`` regression steps.

Gates, chip_smoke.py's phase 16's: the first two steps' losses within
1e-4 relative (the later ones carry Adan's flipped steps); the first
step's gradients and the parameters after it within 1e-3 of each
leaf's largest value where no Adan step flips; the ranks' parameters
identical; the split decode within 1e-4 abs of the whole one.  Printed:
the split plan, the step ms (host clock to the loss read back; the median
of the steps after the first, which warms cuDNN) and the peak allocation
of every rank beside one process's, the decode's ms a frame (CUDA events,
median of 5) beside the whole decode's, each line with the cards' names
and power limits.  Exits non-zero on a miss, or without four cards.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import chip_smoke as smoke

STEPS = 4            # regression steps of each run; the first warms cuDNN
DECODE_REPS = 5      # timed decodes a side
TIMEOUT = 300.0      # seconds a rank waits in a collective
GIB = 2 ** 30


def cards() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return "; ".join(out.stdout.strip().splitlines())


def steady_ms(run) -> float:
    return statistics.median(run["ms"][1:])


def check_steps(label, got, want, line) -> bool:
    """chip_smoke.py's phase-16 gates of ``got`` (rank results) against the
    one-process run ``want``; prints the line."""
    r = got[0]
    rel = max(abs(a - b) / abs(b) for a, b in zip(r["losses"][:2],
                                                  want["losses"][:2]))
    grad, grad_at = smoke._worst_grad(r["grads"][0], want["grads"][0])
    param, param_at, flipped, flips_ok = smoke._beyond_flips(
        r["states"][0], want["states"][0], r["grads"][:1],
        want["grads"][:1], smoke.TRAIN_LR)
    same = all(np.array_equal(o["states"][-1][k], v) for o in got[1:]
               for k, v in r["states"][-1].items())
    peaks = [round((o["peak_bytes"] or 0) / GIB, 3) for o in got]
    print(f"mesh {label}: losses {[round(v, 7) for v in r['losses']]} vs "
          f"one process {[round(v, 7) for v in want['losses']]}: the first "
          f"two's rel err {rel:.3g} (tol {smoke.STEP_LOSS_RTOL}; the later "
          f"ones carry Adan's flips, not gated); first step's gradients "
          f"{grad:.3g} of the leaf's max ({grad_at}; tol "
          f"{smoke.STEP_GRAD_TOL}); parameters after it {param:.3g} "
          f"({param_at}) where no step flips, {flipped} flipped within a "
          f"step each: {flips_ok}; ranks identical: {same}; step ms "
          f"{steady_ms(r):.2f} (steps {[round(v, 2) for v in r['ms']]}) vs "
          f"one process {steady_ms(want):.2f}; peak a rank {peaks} GiB vs "
          f"{(want['peak_bytes'] or 0) / GIB:.3f} [{line}]", flush=True)
    return (rel <= smoke.STEP_LOSS_RTOL and grad <= smoke.STEP_GRAD_TOL
            and param <= smoke.STEP_GRAD_TOL and flips_ok and same)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true",
                   help="rehearse on gloo CPU processes at 240x480")
    args = p.parse_args(argv)
    from boosting_nerv_torch.data import synthetic_video
    from boosting_nerv_torch.models import build_model
    from boosting_nerv_torch.parallel import launch
    from boosting_nerv_torch.parallel.steps import (run_jobs, split_decode,
                                                    train_steps)

    if args.cpu:
        line, dev, hw = "CPU rehearsal", ["cpu"] * 4, (240, 480)
    else:
        if torch.cuda.device_count() < 4:
            print("chip_mesh: needs four CUDA devices", file=sys.stderr)
            return 2
        line, hw = cards(), (1080, 1920)
        dev = [f"cuda:{i}" for i in range(4)]
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    frames = synthetic_video(smoke.DP_FRAMES, *hw, seed=0)
    cfg = smoke.train_config("output/chip_mesh")
    model = build_model(cfg, seed=cfg.manualSeed, device=dev[0]).eval()
    with torch.no_grad():
        embed = model.encode(torch.from_numpy(
            frames[:1].astype(np.float32) / 255.0).to(dev[0]))
    state = {k: v.cpu().numpy() for k, v in model.state_dict().items()}
    del model
    decode = (split_decode, (cfg, state, [smoke.T_HOLD],
                             embed.cpu().numpy(), DECODE_REPS))
    if not args.cpu:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    one = launch(run_jobs, dict(dp=1, devices=dev[:1]), args=([
        (train_steps, (cfg, frames, state, [0], smoke.TRAIN_LR, STEPS)),
        (train_steps, (cfg.replace(batchSize=2), frames, state, [0, 1],
                       smoke.TRAIN_LR, STEPS)), decode],))[0]
    if not args.cpu:
        torch.cuda.empty_cache()
    sp2 = launch(run_jobs, dict(dp=1, sp=2, devices=dev[:2]), args=([
        (train_steps, (cfg.replace(sp=2), frames, state, [0],
                       smoke.TRAIN_LR, STEPS)), decode],), timeout=TIMEOUT)
    mesh = launch(run_jobs, dict(dp=2, sp=2, devices=dev), args=([
        (train_steps, (cfg.replace(batchSize=2, dp=2, sp=2), frames, state,
                       [0, 1], smoke.TRAIN_LR, STEPS))],), timeout=TIMEOUT)
    print(f"mesh split plan (sp=2 on {[r[0]['device'] for r in sp2]}): "
          f"{'; '.join(sp2[0][0]['split_plan'])} [{line}]", flush=True)
    ok = check_steps("(a) sp=2, batch 1", [r[0] for r in sp2], one[0],
                     line)
    err = max(float(np.abs(r[1]["frame"] - one[2]["frame"]).max())
              for r in sp2)
    print(f"mesh (a) split decode at t = {smoke.T_HOLD}: max abs vs the "
          f"whole decode {err:.3g} (tol {smoke.SP_DECODE_TOL}); ms a frame "
          f"{sp2[0][1]['ms']:.3f} vs whole {one[2]['ms']:.3f} (median of "
          f"{DECODE_REPS}) [{line}]", flush=True)
    ok = ok and err <= smoke.SP_DECODE_TOL
    ok = check_steps("(b) dp=2 x sp=2, batch 2", [r[0] for r in mesh],
                     one[1], line) and ok
    print(f"mesh: {time.perf_counter() - t0:.1f} s [{line}]", flush=True)
    if not ok:
        print("chip_mesh: FAIL", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
