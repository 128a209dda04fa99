"""Small configurations of the benchmark's cells for the CPU tests: the
same families and mixes as the cells, at 240x240 frames and narrow
widths (the stage wrappers run their plain versions on the CPU)."""

import copy
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


def _load(*parts):
    with open(os.path.join(ROOT, "bench_h100", *parts)) as f:
        return json.load(f)


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def config(name, frames=4):
    """The configuration ``name`` cut to a 2x2 grid (240x240 frames),
    fc_dim 64, an encoder's embedding of 8 channels, ``frames`` frames."""
    cfg = copy.deepcopy(_load("configs", name + ".json"))
    cfg["model"].update(fc_hw="2_2", fc_dim=64, lower_width=32)
    if "enc_dim" in cfg["model"]:
        cfg["model"]["enc_dim"] = "16_8"
    cfg["clip"] = {"frames": frames, "height": 240, "width": 240}
    return cfg


def enerv_boost(block_dim=128, frames=4):
    """An E-NeRV-Boost configuration at ``config``'s small size, built here
    and not read from a file: the 10M NeRV-Boost configuration with the
    E-NeRV-Boost recipe's model (scripts/regression/UVG/enerv_boost.sh,
    modelsize 4.3, block_dim 128)."""
    cfg = config("nerv_boost_10m_uvg1080p", frames)
    cfg["name"] = "enerv_boost_small"
    cfg["model"].update(model="ENeRV_Boost", modelsize=4.3,
                        block_dim=block_dim)
    return cfg


def mix(name, **kw):
    m = _load("traffic", name + ".json")
    m.update(warm_frames=1, calib_frames=2, check_frames=3,
             check_min_frames=1, trace_units=3)
    m.update(kw)
    return m


def limits(workload):
    return _load("limits", workload + ".json")
