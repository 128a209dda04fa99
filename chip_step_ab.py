#!/usr/bin/env python3
"""The unsplit regression step of two checkouts on one card, in turns.

    python3 chip_step_ab.py PARENT_ROOT CHANGE_ROOT

Each run is one process (no process group) that imports the checkout's own
``chip_smoke.py`` and ``boosting_nerv_torch``: ``train_config`` gives
bench.py's UVG-1080p HNeRV-Boost as chip_smoke.py's phase 11 trains it
(fc_dim 127, batch 1, Fusion10_freq, Adan, lr 0.003, TF32 off), seeded
weights, on four synthetic 1080x1920 frames.  It times ``STEPS`` train
steps (host clock to the loss read back) and ``STEPS`` forward calls under
``no_grad`` (host clock around the call alone, no synchronisation: the
Python and the kernels' enqueue), and prints one JSON line with the
medians of all but the first of each (the first warms cuDNN).  The runs go
parent, change, change, parent; each line carries the card's name and
power limit from nvidia-smi.  Exits non-zero without a card or when a run
fails.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

STEPS = 6
RUN_TIMEOUT = 600  # seconds a run may take


def cards() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return "; ".join(out.stdout.strip().splitlines())


def one(root: str) -> dict:
    """The step and forward times of the checkout at ``root``."""
    sys.path[0] = root  # the checkout's chip_smoke and package
    import numpy as np
    import torch

    import chip_smoke as smoke
    from boosting_nerv_torch.data import VideoData, synthetic_video
    from boosting_nerv_torch.training.trainer import RegressionTrainer
    from boosting_nerv_torch.utils.logger import NullLogger

    frames = synthetic_video(4, 1080, 1920, seed=0)
    cfg = smoke.train_config(os.path.join(root, "output", "step_ab"))
    tr = RegressionTrainer(cfg, video=VideoData(frames), logger=NullLogger())
    step_ms = []
    for i in range(STEPS):
        idx = [i % len(frames)]
        t0 = time.perf_counter()
        loss, _ = tr.train_step_idx(idx, tr.video.norm_idx(idx),
                                    smoke.TRAIN_LR)
        float(loss)
        step_ms.append((time.perf_counter() - t0) * 1e3)
    img = torch.from_numpy(frames[:1].astype(np.float32) / 255.0).cuda()
    t = torch.tensor([smoke.T_HOLD], device="cuda")
    fwd_ms = []
    with torch.no_grad():
        for _ in range(STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.model(img, t)
            fwd_ms.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
    return {"root": root, "step_ms": step_ms,
            "step_ms_median": statistics.median(step_ms[1:]),
            "forward_host_ms": fwd_ms,
            "forward_host_ms_median": statistics.median(fwd_ms[1:]),
            "card": cards()}


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(one(os.path.abspath(argv[1]))), flush=True)
        return 0
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_step_ab: no CUDA device", file=sys.stderr)
        return 1
    parent, change = (os.path.abspath(a) for a in argv)
    runs = []
    for label, root in (("parent", parent), ("change", change),
                        ("change", change), ("parent", parent)):
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", root], cwd=root, capture_output=True,
                             text=True, timeout=RUN_TIMEOUT)
        if out.returncode:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            return 1
        run = {"run": label, **json.loads(out.stdout.strip().splitlines()[-1])}
        runs.append(run)
        print(json.dumps(run), flush=True)
    for label in ("parent", "change"):
        mine = [r for r in runs if r["run"] == label]
        print(f"{label}: step ms (median of steps 2-{STEPS}) "
              f"{[round(r['step_ms_median'], 3) for r in mine]}, forward "
              f"host ms {[round(r['forward_host_ms_median'], 3) for r in mine]}"
              f" [{cards()}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
