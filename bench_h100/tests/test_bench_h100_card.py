"""The cells at their own sizes on a CUDA device: on three seeds each,
a short run comes out correct and the control in the program's place does
not.  Run on the card:

    python3 -m pytest bench_h100/tests/test_bench_h100_card.py -q
"""

import pytest
import torch

import small
from bench_h100 import control, drivers, harness
from bench_h100.run import run_cell

SEEDS = (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13)


@pytest.mark.card
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      small.bench()["workloads"]])
def test_cell_and_control_on_the_card(card, workload):
    bench = small.bench()
    cell = harness.cell_of(bench, workload)
    cfg, mix = harness.config_of(bench, cell), harness.mix_of(cell)
    limits = {k: v for k, v in harness.limits_of(cell).items()
              if k != "frames_missing"}
    for seed in SEEDS:
        assert run_cell(bench, workload, seed, 2.0, 0, device=card)[0][
            "correct"]
        c = drivers.KINDS[mix["kind"]](cfg, mix, seed, card)
        c.setup()
        c.window(1.0)
        c.free()
        if mix["kind"] == "train":
            got = control.bf16_gaps(c)
        else:
            got = control.decode_controls(c)
            got = got.get("reference_int4") or got["reference_fp8"]
        assert harness.judge(got, limits)[0] is False
