"""The harness: finds a cell's configuration, mix, limits and metric
readers by the names in ``BENCHMARK.json``, runs the cell once and builds
its result line.

Files, by name:

- ``bench_h100/configs/<config>.json``: a configuration (the model's
  fields, the clip, the training recipe);
- ``bench_h100/traffic/<mix>.json``: a mix (its ``kind`` names the
  generator in ``drivers.KINDS``; the rest are its parameters);
- ``bench_h100/limits/<config>.<mix>.json``: the limit of each number the
  cell's check compares;
- ``bench_h100/metrics/<metric>.py``: a metric's reader, ``read(ctx)``,
  returning a number, or None when it finds nothing to read.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "boosting_nerv_tpu")


@dataclass
class Ctx:
    """What a metric reader sees: the cell's names, configuration and
    mix, the window's host-clock measurements (``run``) and, in a traced
    run, the trace's summary (``trace``, a ``trace.Trace``)."""
    workload: str
    config: dict
    mix: dict
    run: Dict[str, float] = field(default_factory=dict)
    latencies_s: List[float] = field(default_factory=list)
    trace: Optional[object] = None


def load_json(path):
    with open(path) as f:
        return json.load(f)


def spec():
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell_of(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def config_of(bench: dict, cell: dict) -> dict:
    for c in bench["configs"]:
        if c["name"] == cell["config"]:
            return load_json(os.path.join(ROOT, c["file"]))
    raise SystemExit(f"no config {cell['config']!r} in BENCHMARK.json")


def mix_of(cell: dict) -> dict:
    return load_json(os.path.join(HERE, "traffic", cell["traffic"] + ".json"))


def limits_of(cell: dict) -> dict:
    return load_json(os.path.join(HERE, "limits", cell["name"] + ".json"))


def metrics_of(bench: dict, cell: dict, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics (``trace`` False) or per-layer ones."""
    name = cell["name"]
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    mine = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in mine)]


def reader(metric: str):
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec_ = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod.read


def read_metrics(metrics: List[dict], ctx: Ctx) -> Dict[str, dict]:
    out = {}
    for m in metrics:
        v = reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    """Modules whose top-level name is JAX's, flax's or the JAX
    package's, loaded in this process."""
    return sorted({k for k in sys.modules
                   if k.split(".")[0] in FORBIDDEN})


def card_state() -> str:
    """The card's name, power limit, SM clock and temperature, as
    nvidia-smi reads them after the window."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def judge(readings: Dict[str, float], limits: Dict[str, float]):
    """(correct, the compared numbers with their limits, how many are
    out of limit)."""
    checks = {k: {"value": readings[k], "limit": limits[k]}
              for k in limits}
    failed = sum(1 for c in checks.values()
                 if not c["value"] <= c["limit"])
    return failed == 0, checks, failed
