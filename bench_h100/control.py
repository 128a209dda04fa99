"""Readings for a cell's limits: the program's numbers over many seeds,
and its controls' numbers over a few, in one process.

    python3 bench_h100/control.py --workload <cell> --seeds 12 \\
        --control-seeds 3 --seconds 2 [--first-seed N]

For each seed the cell is set up as a run sets it up, runs a short window
at its own load (``--seconds``), and its compared numbers are read as a
run reads them (one JSON line, "program").  For the first
``--control-seeds`` seeds the controls are read too (a JSON line each):

- a decode cell: the reference put in the program's place at the next
  precision below the configuration's (W8A8 -> 4-bit integer stages; bf16
  -> 8-bit integer on every tail stage: "reference_int8"), and for a bf16
  cell also the program's own W8A8 path ("program_w8a8"), each against
  the reference's frames;
- a training cell: the reference's steps under bfloat16 autocast against
  its float32 steps ("reference_bf16"); a step that leaves the state
  unchanged reads 1 on the change by construction.

The last line sums up: per number, the largest program reading and the
smallest reading of each control.  Runs only on a CUDA device; nothing
here is part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from bench_h100 import drivers, harness  # noqa: E402
from bench_h100.reference import models as ref  # noqa: E402


def decode_controls(cell):
    """A decode cell's controls against the reference's frames, as its
    check reads them: the W8A8 stages in int4, or a bf16 cell's tail in
    int8 and in fp8 and the program's own W8A8 path."""
    want = cell.reference_frames()
    m = cell.cfg["model"]
    plan = ref.stage_plan(m)
    out = {}
    if cell.mix["precision"] == "w8a8":
        ctl = cell.reference_frames(bits=4, stages=ref.w8a8_stages(m, plan))
        out["reference_int4"] = cell.gaps(ctl, want)
    else:
        tail = list(range(ref.planar_tail(m, plan), len(plan)))
        ctl = cell.reference_frames(bits=8, stages=tail)
        out["reference_int8"] = cell.gaps(ctl, want)
        ctl = cell.reference_frames(stages=tail, fp8=True)
        out["reference_fp8"] = cell.gaps(ctl, want)
        w8 = drivers.DecodeCell(cell.cfg, {**cell.mix, "precision": "w8a8"},
                                cell.seed, cell.device)
        w8.setup()
        w8.window(1.0)
        w8.free()
        out["program_w8a8"] = w8.gaps(w8.kept, w8.reference_frames(
            bits=8, stages=[]))
    return out


def leaves(cell, top=4):
    """The leaves with the widest gradient and change gaps, with the
    reference's norms, for finding why a number reads as it does."""
    losses, grads, change = cell.reference_steps()
    g_med = sorted(grads.values())[len(grads) // 2]
    c_med = sorted(change.values())[len(change) // 2]
    rows = {}
    for what, got, want, floor in (("grad", cell.grad_norms, grads, g_med),
                                   ("change", cell.change_norms, change,
                                    c_med)):
        gap = {k: abs(got[k] - want[k]) / max(want[k], floor) for k in want}
        rows[what] = [[k, gap[k], got[k], want[k], grads[k] / g_med]
                      for k in sorted(gap, key=gap.get)[-top:]]
    rows["losses"] = [cell.losses, losses]
    return rows


def bf16_gaps(cell):
    """The reference's bf16 steps judged as the program's are."""
    want = cell.reference_steps()
    got = cell.reference_steps(autocast_dtype=torch.bfloat16)
    saved = (cell.losses, cell.grad_norms, cell.change_norms)
    cell.losses, cell.grad_norms, cell.change_norms = got
    try:
        return cell.gaps(*want)
    finally:
        cell.losses, cell.grad_norms, cell.change_norms = saved


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    bench = harness.spec()
    cell_spec = harness.cell_of(bench, args.workload)
    config = harness.config_of(bench, cell_spec)
    mix = harness.mix_of(cell_spec)
    card = harness.card_state()
    prog, ctls = {}, {}
    for k in range(args.seeds):
        seed = args.first_seed + 7919 * k
        t0 = time.perf_counter()
        cell = drivers.KINDS[mix["kind"]](config, mix, seed)
        cell.setup()
        cell.window(args.seconds)
        cell.free()
        readings = cell.check()
        if mix["kind"] == "train":
            print(json.dumps({"seed": seed, "leaves": leaves(cell)}))
        print(json.dumps({"seed": seed, "program": readings, "card": card,
                          "s": round(time.perf_counter() - t0, 1)}),
              flush=True)
        for n, v in readings.items():
            prog[n] = max(prog.get(n, v), v)
        if k < args.control_seeds:
            c = (decode_controls(cell) if mix["kind"] == "decode" else
                 {"reference_bf16": bf16_gaps(cell)})
            print(json.dumps({"seed": seed, "controls": c}), flush=True)
            for name, r in c.items():
                for n, v in r.items():
                    d = ctls.setdefault(name, {})
                    d[n] = min(d.get(n, v), v)
        del cell
        drivers._free("cuda")
    print(json.dumps({"workload": args.workload, "program_max": prog,
                      "control_min": ctls, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
