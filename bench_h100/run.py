"""Run one cell of the benchmark of ``boosting_nerv_torch`` once.

    python3 bench_h100/run.py --workload <cell> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

Builds the cell's program state from the seed (set-up), runs its mix for
``--seconds`` (with ``--trace 1`` a shorter traced window of the mix's
``trace_units`` under ``torch.profiler``), frees the program's state,
compares what the window produced with the plain reference, and prints
the compared numbers with their limits as the last lines of standard
error and one JSON line as the last line of standard output.  Exits 2
without enough CUDA devices, 3 if JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# build caches at fixed paths inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, ".bench_cache",
                                                  "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".bench_cache", "triton")


def run_cell(bench, workload, seed, seconds, trace, device="cuda",
             config=None, mix=None, limits=None, wrap=None, t_start=None):
    """One run of ``workload``: (result dict, lines for standard error).
    ``config`` / ``mix`` / ``limits`` replace the cell's files (the tests'
    small sizes); ``wrap(cell)`` is called in set-up once the program is
    built, before its first timed call (the tests' planted faults)."""
    import torch

    from bench_h100 import drivers, harness
    from bench_h100 import trace as tracing

    t_start = T_START if t_start is None else t_start
    cell = harness.cell_of(bench, workload)
    config = config or harness.config_of(bench, cell)
    mix = mix or harness.mix_of(cell)
    limits = limits or harness.limits_of(cell)
    on_card = torch.device(device).type == "cuda"

    c = drivers.KINDS[mix["kind"]](config, mix, seed, device, bool(trace))
    c.setup(wrap)
    setup_s = time.perf_counter() - t_start
    before = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    summary = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else [])
        with profile(activities=acts) as prof:
            window_s = c.window(seconds, mix["trace_units"])
        summary = tracing.read(prof)
        del prof
    else:
        window_s = c.window(seconds)
    window_peak = torch.cuda.max_memory_allocated() if on_card else 0
    c.free()

    readings = c.check()
    if mix["kind"] == "decode" and not c.plan_agrees():
        readings["plan_mismatch"] = 1.0
        limits = {**limits, "plan_mismatch": 0.0}
    correct, checks, failed = harness.judge(readings, limits)

    ctx = harness.Ctx(workload, config, mix, run={
        "units": c.units, "window_s": window_s, "setup_s": setup_s,
        "window_peak_bytes": window_peak, "on_card": on_card},
        latencies_s=c.latencies
        if hasattr(c, "latencies") else [], trace=summary)
    metrics = harness.read_metrics(
        harness.metrics_of(bench, cell, bool(trace)), ctx)
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell["chips"] if on_card else 1,
           "memory_peak_bytes": max(before, window_peak)}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = window_s
    if on_card:
        dev["card"] = harness.card_state()
    result = {"correct": correct, "attempted": c.units, "failed": failed,
              "metrics": metrics, "device": dev}
    if summary is not None:
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    result["checks"] = checks
    lines = [f"setup {label}: {t - t_start:.3f} s" for label, t in c.marks]
    lines += [f"check {k}: {v['value']!r} limit {v['limit']!r}"
              for k, v in checks.items()]
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from bench_h100 import harness

    bench = harness.spec()
    cell = harness.cell_of(bench, args.workload)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"bench_h100: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, lines = run_cell(bench, args.workload, args.seed, args.seconds,
                             args.trace)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"bench_h100: loaded {', '.join(loaded)}: the run may import "
              "neither JAX nor the JAX package", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
