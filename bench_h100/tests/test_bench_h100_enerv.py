"""E-NeRV-Boost 15M at UVG-1080p and its cell,
``enerv_boost_15m_uvg1080p.playback_bf16``.

On the CPU: the cell at ``small``'s size comes out correct, traced and
untraced, and not correct with a planted fault or with the fp8 tail
control in the program's place; the configuration's stage plan, parameter
count and counts are pinned at full size; the new metrics' readers give
nothing off the card and the right shares on a made-up summary.

Marked ``card``: at the cell's own size, the prefix graph's output (the
NHWC input of stage 2) against the float32 reference at the same point,
and the trunk in float32 against the reference's grid map, with three
faults of the reference's trunk outside those tolerances.  Run on the
card:

    python3 -m pytest bench_h100/tests/test_bench_h100_enerv.py -q
"""

from contextlib import contextmanager

import pytest
import torch
import torch.nn.functional as F

import small
from bench_h100 import control, counts, drivers, harness
from bench_h100.reference import models as ref
from bench_h100.run import run_cell
from bench_h100.trace import Trace
from boosting_nerv_torch.models import build_model
from boosting_nerv_torch.utils import tracing
from test_bench_h100_runs import _altered

NAME = "enerv_boost_15m_uvg1080p"
WORKLOAD = NAME + ".playback_bf16"
SEED = 2 ** 31 + 5
NEW = ("decode_mfu.enerv_playback", "planar_roofline.enerv_playback",
       "kloop_roofline.enerv_playback", "prefix_ms.enerv_playback",
       "prefix_roofline.enerv_playback", "tail_ms.enerv_playback",
       "busy_ms.enerv_playback", "device_idle.enerv_playback")
# at full size, on the CPU (the reference's and counts' arithmetic)
PLAN = [(142, 426, 5), (426, 213, 3), (213, 106, 2), (106, 106, 1),
        (106, 53, 2), (53, 53, 1), (53, 26, 2), (26, 26, 1)]
PARAMS = 15059981
LEAST_S = 0.000683442790115268           # counts.decode_least_s, bf16
TAIL_BOUNDS = [(2, 0.1062615166835187, "operations"),
               (3, 0.07950861718907988, "operations"),
               (4, 0.10601148958543984, "operations"),
               (5, 0.07950861718907988, "operations"),
               (6, 0.10303003437815975, "operations"),
               (7, 0.07686367644084934, "operations")]
PREFIX_LEAST_S = 0.0001322586931769464   # prefix_roofline's least time


def _cell():
    return harness.cell_of(small.bench(), WORKLOAD)


def _run(trace=0, wrap=None):
    return run_cell(small.bench(), WORKLOAD, SEED, 0.5, trace, device="cpu",
                    config=small.config(NAME), mix=small.mix("playback_bf16"),
                    wrap=wrap)[0]


@pytest.mark.parametrize("trace", [0, 1])
def test_sound_run_is_correct(trace):
    res = _run(trace)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert set(res["checks"]) == set(harness.limits_of(_cell()))
    mine = {m["name"] for m in harness.metrics_of(small.bench(), _cell(),
                                                   bool(trace))}
    if trace:   # every new reader finds nothing to read off the card
        assert mine == set(NEW) and res["metrics"] == {}
    else:
        assert mine == set(res["metrics"]) == {"decode_fps", "setup_s"}


def test_fault_and_fp8_control_are_not_correct():
    res = _run(wrap=_altered)
    assert res["correct"] is False and res["failed"] > 0
    c = drivers.DecodeCell(small.config(NAME), small.mix("playback_bf16"),
                           SEED, "cpu")
    c.setup()
    c.window(0.5)
    c.free()
    limits = harness.limits_of(_cell())
    limits.pop("frames_missing")
    got = control.decode_controls(c)["reference_fp8"]
    assert harness.judge(got, limits)[0] is False


def test_full_size_is_pinned():
    cfg = harness.config_of(small.bench(), _cell())
    m = cfg["model"]
    fam = harness.family(m["model"])
    assert [(s.ngf, s.new_ngf, s.strd) for s in fam.stage_plan(m)] == PLAN
    assert ref.planar_tail(m, fam.stage_plan(m)) == 2
    assert sum(torch.Size(s).numel()
               for s, _ in fam.param_shapes(m).values()) == PARAMS
    assert counts.decode_least_s(cfg, "bf16") == LEAST_S
    assert counts.tail_bounds(cfg, "bf16") == TAIL_BOUNDS
    prefix = harness.reader("prefix_roofline.enerv_playback").__globals__
    assert prefix["least_s"](cfg) == PREFIX_LEAST_S


def _ctx(on_card=True, trace=True):
    """Four frames in 80 ms, 60 ms of them busy, 50 under the wrappers."""
    cfg = harness.config_of(small.bench(), _cell())
    summary = Trace(busy_s=0.06, launches=400, span_s={
        "fused_upconv_rsft": 0.03, "fused_conv_rsft": 0.02})
    return harness.Ctx(WORKLOAD, cfg, harness.mix_of(_cell()), run={
        "units": 4, "window_s": 0.08, "on_card": on_card},
        trace=summary if trace else None)


def test_readers_of_the_new_metrics(monkeypatch):
    tracing.reset()
    for name in NEW:   # off the card, untraced, or nothing recorded
        assert harness.reader(name)(_ctx(on_card=False)) is None
        assert harness.reader(name)(_ctx(trace=False)) is None
    for name in ("kloop_roofline.enerv_playback", "prefix_ms.enerv_playback",
                 "prefix_roofline.enerv_playback", "tail_ms.enerv_playback"):
        assert harness.reader(name)(_ctx()) is None

    def row(stream_ms):
        return {"count": 4, "host_ms": 1.0, "self_host_ms": 1.0,
                "stream_ms": stream_ms, "idle_ms": 0.0}

    made_up = {"units": 4, "device": True, "idle_outside_ms": 0.0,
               "launches": {}, "spans": {"decode.prefix": row(4.0),
                                         "decode.tail": row(56.0),
                                         "decode.stage2": row(5.2)}}
    monkeypatch.setattr(tracing, "summary", lambda: made_up)
    ctx = _ctx()
    got = {name: harness.reader(name)(ctx) for name in NEW}
    assert got["prefix_ms.enerv_playback"] == pytest.approx(1.0)
    assert got["tail_ms.enerv_playback"] == pytest.approx(14.0)
    assert got["kloop_roofline.enerv_playback"] == pytest.approx(
        100 * TAIL_BOUNDS[0][1] / 1.3)
    assert got["prefix_roofline.enerv_playback"] == pytest.approx(
        100 * PREFIX_LEAST_S * 1e3 / 1.0)
    assert got["decode_mfu.enerv_playback"] == pytest.approx(
        100 * LEAST_S / 0.02)
    assert got["planar_roofline.enerv_playback"] == pytest.approx(
        100 * sum(ms for _, ms, _ in TAIL_BOUNDS) / 1e3 * 4 / 0.05)
    assert got["busy_ms.enerv_playback"] == pytest.approx(15.0)
    assert got["device_idle.enerv_playback"] == pytest.approx(25.0)
    for name, v in got.items():
        if name.endswith(("roofline.enerv_playback", "mfu.enerv_playback")):
            assert 0 < v < 100, name


# -- the trunk at the cell's size, on the card --------------------------- #
def reference_prefix(p, m, t):
    """The float32 reference's input of the kernel tail, NHWC: the trunk's
    grid map (``grid_map``) through the stages ahead of ``planar_tail``
    (stage 0's ConvUpBlock, stage 1), conditioned by t_branch(PE(t))."""
    fam = harness.family(m["model"])
    plan = fam.stage_plan(m)
    with torch.no_grad(), drivers.fp32_exact():
        pe = ref.position_encoding(t, m["embed"], torch.float32)
        x = fam.grid_map(pe, p, m)
        cond = ref.mlp(pe, p, "t_branch", 2)
        for i in range(ref.planar_tail(m, plan)):
            q = {"stage": i, "quant": None, "calib": None}
            up = fam._conv_up if i < m["dec_blks"][0] else ref.upsample
            x = ref.rsft(torch.sin(up(x, p, i, plan[i], q)), p,
                         f"blocks.{i}.rsft", cond, **q)
    return x.permute(0, 2, 3, 1)


def gap(got, want) -> float:
    """Mean absolute gap over the reference's mean magnitude."""
    return float((got.float() - want).abs().mean() / want.abs().mean())


@contextmanager
def trunk_fault(name):
    """A fault of the reference's trunk (``reference/enerv_boost.py``)
    while inside: "no_trans2" (the 8-head block left out), "relu_ff" (ReLU
    for GELU in both blocks' feed-forward) or "one_head" (trans2's eight
    heads of 64 attended as one head of 512, scale kept)."""
    fam = harness.family("ENeRV_Boost")
    with pytest.MonkeyPatch.context() as mp:
        if name == "no_trans2":
            block = fam._block
            mp.setattr(fam, "_block", lambda z, p, n, h: (
                z if n == "trunk.trans2" else block(z, p, n, h)))
        elif name == "relu_ff":
            class ReluF:
                gelu = staticmethod(F.relu)

                def __getattr__(self, key):
                    return getattr(F, key)
            mp.setattr(fam, "F", ReluF())
        elif name == "one_head":
            attention = fam._attention

            def one(z, p, n, heads):
                if n != "trunk.trans2.attn":
                    return attention(z, p, n, heads)
                q, k, v = F.linear(z, p[n + ".qkv.weight"]).chunk(3, dim=-1)
                a = torch.softmax(q @ k.transpose(-1, -2)
                                  * fam.DIM_HEAD ** -0.5, dim=-1)
                return ref.lin(a @ v, p, n + ".out")
            mp.setattr(fam, "_attention", one)
        else:
            raise ValueError(name)
        yield


FAULTS = ("no_trans2", "relu_ff", "one_head")
CARD_SEEDS = (2 ** 31 + 21, 2 ** 31 + 22, 2 ** 31 + 23)
# gap() of the graph's bf16 prefix against the float32 reference's: bf16
# rounding through the trunk and stages 0-1 (five convs, two ResBlockSFTs)
# reads 0.53-0.59% on the card; the trunk without trans2 10-12%, ReLU for
# GELU 2.4-3.3%; 1.2% lies twice from both.  Eight heads as one moves the
# prefix by 3-5e-5 of its magnitude, under bf16's own rounding: at the
# seeded weights trans2's softmax is near uniform (its outputs differ by
# 1e-3 between the two), so no bf16 comparison sees it.
PREFIX_TOL = 0.012
# gap() of the program's trunk module in float32 (TF32 off), the module the
# decode serves in bf16, against the reference's grid map: the same
# operations give 0 on the CPU; eight heads as one moves the map by
# 1.8-4.3e-4, ReLU for GELU by 0.12-0.15, no trans2 by 0.6-0.75.
GRID_TOL = 2e-5


@pytest.mark.card
def test_trunk_at_the_cells_size(card):
    """On three seeds, three frames each: the graph's bf16 prefix against
    the float32 reference's within ``PREFIX_TOL``, and outside it with the
    trunk faults bf16 can see; the trunk in float32 against the reference's
    grid map within ``GRID_TOL``, and outside it with each fault."""
    bench = small.bench()
    cell = harness.cell_of(bench, WORKLOAD)
    cfg = harness.config_of(bench, cell)
    m = cfg["model"]
    fam = harness.family(m["model"])
    for seed in CARD_SEEDS:
        c = drivers.DecodeCell(cfg, harness.mix_of(cell), seed, card)
        c.setup()
        assert c.decode.graph is not None
        with torch.device(card):
            model = build_model(drivers.port_config(cfg), seed=None,
                                device=card)
        model.load_state_dict(c.params, strict=True)
        for i in (0, 59, 119):
            x, t = c.args(i)
            c.decode(x, t)
            got = c.decode.graph.out[0].clone()
            torch.cuda.synchronize()
            assert got.dtype == torch.bfloat16 and got.shape == (
                1, 135, 240, 213)
            assert gap(got, reference_prefix(c.params, m, t)) <= PREFIX_TOL
            with torch.no_grad(), drivers.fp32_exact():
                grid = model.trunk(t)[0]
                pe = ref.position_encoding(t, m["embed"], torch.float32)
                assert gap(grid, fam.grid_map(pe, c.params, m)) <= GRID_TOL
            for fault in FAULTS:
                with trunk_fault(fault):
                    bad = reference_prefix(c.params, m, t)
                    with torch.no_grad(), drivers.fp32_exact():
                        bad_grid = fam.grid_map(pe, c.params, m)
                assert gap(grid, bad_grid) > GRID_TOL, (seed, i, fault)
                if fault != "one_head":
                    assert gap(got, bad) > PREFIX_TOL, (seed, i, fault)
        del model
        c.free()
