"""Whole runs of the cells at a small size on the CPU (the stage wrappers
run their plain versions): sound runs come out correct; the controls, and
the program with its timed path broken underneath, come out not correct
under the cells' own limits."""

import pytest
import torch

import small
from bench_h100 import control, drivers, harness
from bench_h100.run import run_cell

SEED = 2 ** 31 + 5
CELLS = {  # workload: (config, mix)
    "hnerv_boost_3m_uvg1080p.playback_w8a8": ("hnerv_boost_3m_uvg1080p",
                                              "playback_w8a8"),
    "nerv_boost_10m_uvg1080p.seek_bf16": ("nerv_boost_10m_uvg1080p",
                                          "seek_bf16"),
    "hnerv_boost_3m_uvg1080p.train": ("hnerv_boost_3m_uvg1080p", "train"),
}


def run(workload, trace=0, wrap=None):
    cfg, mix = CELLS[workload]
    return run_cell(small.bench(), workload, SEED, 0.5, trace, device="cpu",
                    config=small.config(cfg), mix=small.mix(mix),
                    wrap=wrap)[0]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", sorted(CELLS))
def test_sound_run_is_correct(workload, trace):
    res = run(workload, trace)
    assert res["correct"] and res["failed"] == 0
    assert res["attempted"] > 0
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) == set(harness.limits_of(
        harness.cell_of(small.bench(), workload)))
    if not trace:
        assert "setup_s" in res["metrics"]


def _cell(workload):
    cfg, mix = CELLS[workload]
    kind = drivers.KINDS[small.mix(mix)["kind"]]
    c = kind(small.config(cfg), small.mix(mix), SEED, "cpu")
    c.setup()
    c.window(0.5)
    c.free()
    return c


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_control_is_not_correct(workload):
    """The next precision below the configuration's, in the program's
    place: int4 stages for W8A8, fp8 for bf16, bf16 autocast for TF32
    training."""
    c = _cell(workload)
    limits = harness.limits_of(harness.cell_of(small.bench(), workload))
    limits.pop("frames_missing", None)
    if isinstance(c, drivers.TrainCell):
        got = control.bf16_gaps(c)
    else:
        got = control.decode_controls(c)
        got = got.get("reference_int4") or got["reference_fp8"]
    assert harness.judge(got, limits)[0] is False


def _altered(cell):
    """An answer altered where it is produced: a frame's pixels moved by
    a fortieth of their range."""
    decode = cell.decode

    def wrong(embed, t):
        out = decode(embed, t)
        return (out.float() + 0.025 * torch.sin(
            torch.arange(out.numel()).reshape(out.shape).float())).to(
                out.dtype)
    cell.decode = wrong


def _unchanged(cell):
    """A step that returns its state unchanged."""
    cell.trainer.opt.step = lambda *a, **k: None


@pytest.mark.parametrize("workload,fault", [
    ("hnerv_boost_3m_uvg1080p.playback_w8a8", _altered),
    ("nerv_boost_10m_uvg1080p.seek_bf16", _altered),
    ("hnerv_boost_3m_uvg1080p.train", _unchanged),
])
def test_fault_is_not_correct(workload, fault):
    res = run(workload, wrap=fault)
    assert res["correct"] is False and res["failed"] > 0
