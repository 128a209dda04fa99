"""The port's span recorder (``boosting_nerv_torch/utils/tracing.py``) on
the CPU: off without a recording profiler; on under one, the span trees of
the v5 decode (tiny HNeRV-Boost, NeRV-Boost and E-NeRV-Boost, plain
wrappers; E-NeRV-Boost's transformer trunk a leaf of its own in the stem)
and of the trainer's step, with every operation inside a leaf and the host stamps on
the profiler's clock; and the summary's arithmetic on hand-made records
with a made-up device clock."""

import gc
import itertools
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule
from torch.utils._python_dispatch import TorchDispatchMode

from boosting_nerv_torch.config import BoostConfig
from boosting_nerv_torch.data import VideoData, synthetic_video
from boosting_nerv_torch.models import build_model
from boosting_nerv_torch.runtime.fast_decode import build_fast_decode_v5
from boosting_nerv_torch.training.trainer import RegressionTrainer
from boosting_nerv_torch.utils import tracing
from boosting_nerv_torch.utils.logger import RunLogger

TINY = dict(embed="pe_1.25_4", fc_dim=16, fc_hw="2_4", dec_strds=[2, 2],
            dec_blks=[1, 2], ks="0_1_5",
            conv_type=["convnext", "pshuffel_3x3"], act="sin", norm="none",
            sft_block="res_sft", ch_t=8, reduce=1.2, lower_width=4,
            block_dim=16, enc_strds=[2, 2], enc_dim="8_4")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh():
    tracing.reset()
    yield
    tracing.reset()


def _decode(model):
    cfg = BoostConfig(model=model, **TINY)
    net = build_model(cfg, seed=0, device="cpu").eval()
    dec = build_fast_decode_v5(cfg, net, planar_from_h=1)
    embed = torch.randn(1, 2, 4, 4) if model == "HNeRV_Boost" else None
    return dec, [(embed, torch.tensor([v])) for v in (0.25, 0.75)]


class _Where(TorchDispatchMode):
    """The innermost open span of every operation that may launch work:
    not a view, nor a profiler range's op (the optimizer's ``zero_grad``
    opens one)."""

    def __init__(self):
        super().__init__()
        self.at = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not (func.is_view or func.namespace == "profiler"):
            stack = tracing._S.stack
            self.at.append((stack[-1] if stack else -1, str(func)))
        return func(*args, **(kwargs or {}))


def _tree(spans, root):
    """Names of ``root``'s children, in order."""
    return [s.name for s in spans if s.parent == root.id]


def _ops_in_leaves(spans, where):
    assert where.at
    parents = {s.parent for s in spans}
    inner = [(i, op) for i, op in where.at if i in parents]
    assert inner == []   # no span with children runs an operation
    assert all(i >= 0 for i, _ in where.at)   # nor does code outside


def test_spans_cost_nothing_off_and_leave_no_garbage_on(monkeypatch):
    calls = []
    monkeypatch.setattr(tracing, "_range", lambda *a: calls.append(a))
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda *a, **k: calls.append(k))
    assert not torch.autograd.profiler._is_profiler_enabled
    assert tracing.span("a") is tracing.span("b", unit=True) is tracing.OFF
    dec, frames = _decode("HNeRV_Boost")
    # a scheduled profiler's wait and warm-up steps record nothing
    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=1, warmup=1, active=1)) as prof:
        for _ in range(2):
            dec(*frames[0])
            prof.step()
        torch.ones(2).sum()
    assert not any(e.name.startswith("decode") for e in prof.events())
    assert calls == [] and tracing.records() == []
    assert tracing.summary()["units"] == 0
    # the off path allocates no more than a bare shared no-op does
    assert _peak_bytes(tracing.span) <= _peak_bytes(
        lambda name, unit=False: tracing.OFF)
    monkeypatch.undo()
    # on, the records are columns: no object for the collector to track
    with profile(activities=[ProfilerActivity.CPU]):
        _frames(tracing.span, 50)
        gc.disable()
        try:
            before = gc.get_count()[0]
            _frames(tracing.span, 1000)
            grew = gc.get_count()[0] - before
        finally:
            gc.enable()
    assert len(tracing.records()) == 2 * 1050 and grew < 20


def _frames(span, n):
    """``n`` units of one leaf each."""
    for _ in itertools.repeat(None, n):
        with span("decode", unit=True):
            with span("decode.kernel"):
                pass


def _peak_bytes(span):
    """The traced memory's peak over 1000 units, above its start."""
    _frames(span, 1000)
    tracemalloc.start()
    _frames(span, 1000)
    tracemalloc.reset_peak()
    base = tracemalloc.get_traced_memory()[0]
    _frames(span, 1000)
    peak = tracemalloc.get_traced_memory()[1]
    tracemalloc.stop()
    return peak - base


@pytest.mark.parametrize("model", ["HNeRV_Boost", "NeRV_Boost",
                                   "ENeRV_Boost"])
def test_decode_span_tree(model):
    dec, frames = _decode(model)
    dec(*frames[0])   # warm
    want = dec(*frames[1])
    where = _Where()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert torch.autograd.profiler._is_profiler_enabled
        with where:
            for f in frames:
                got = dec(*f)
    assert torch.equal(got, want)   # the spans change nothing
    spans = tracing.records()
    roots = [s for s in spans if s.parent == -1]
    assert [(s.name, s.unit) for s in roots] == [("decode", 0), ("decode", 1)]
    by_id = {s.id: s for s in spans}
    for s in spans:   # each span in its frame's unit, inside its parent
        top = s
        while top.parent != -1:
            p = by_id[top.parent]
            assert p.host_start <= top.host_start <= top.host_end <= \
                p.host_end
            top = p
        assert s.unit == top.unit
    root = roots[0]
    stages = [f"decode.stage{st.index}" for st in dec.tail]
    assert _tree(spans, root) == ["decode.prefix", "decode.tail"]
    prefix, tail = (s for s in spans if s.parent == root.id)
    pe_stem = (["decode.pe", "decode.time_mlp", "decode.pe", "decode.stem"]
               if model == "NeRV_Boost" else
               ["decode.pe", "decode.time_mlp", "decode.stem"])
    assert _tree(spans, prefix) == pe_stem + ["decode.block0"]
    stem = next(s for s in spans
                if s.parent == prefix.id and s.name == "decode.stem")
    assert _tree(spans, stem) == (["decode.trunk"]
                                  if model == "ENeRV_Boost" else [])
    assert _tree(spans, tail) == stages
    for st in (s for s in spans if s.parent == tail.id):
        assert _tree(spans, st) == ["decode.sft", "decode.kernel"]
    _ops_in_leaves(spans, where)
    summ = tracing.summary()
    # device stamps come with CUDA in use in the process, as on a card
    # where an earlier test ran there
    assert summ["units"] == 2 and summ["device"] is (
        torch.cuda.is_available() and torch.cuda.is_initialized())
    assert summ["spans"]["decode.pe"]["count"] == 2 * pe_stem.count(
        "decode.pe")
    assert summ["spans"]["decode.kernel"]["count"] == 2 * len(stages)
    assert summ["launches"] == {}   # the CPU path launches no kernel
    # the host stamps are on the profiler's clock
    t0 = prof.profiler.kineto_results.trace_start_ns()
    for name in ("decode", "decode.prefix", "decode.pe", "decode.kernel"):
        evs = sorted(t0 + e.time_range.start * 1000 for e in prof.events()
                     if e.name == name)
        mine = sorted(s.host_start for s in spans if s.name == name)
        assert len(evs) == len(mine) > 0
        assert max(abs(a - b) for a, b in zip(evs, mine)) < 1e6
    assert "decode.kernel" in tracing.table(summ)


@pytest.mark.parametrize("micro", [0, 1])
def test_train_step_span_tree(tmp_path, micro):
    cfg = BoostConfig(model="HNeRV_Boost", **TINY, batchSize=2, lr=5e-3,
                      loss="L2", optim_type="Adan", micro_batch=micro,
                      outf=str(tmp_path), not_resume=True)
    tr = RegressionTrainer(cfg, video=VideoData(synthetic_video(4, 8, 16)),
                           logger=RunLogger(str(tmp_path), enable_tb=False),
                           device="cpu")
    idx = [0, 1]
    t = tr.video.norm_idx(idx)
    tr.train_step_idx(idx, t, 1e-3)   # warm
    where = _Where()
    if micro:
        with profile(activities=[ProfilerActivity.CPU]):
            img, tt = tr.gather(idx), torch.as_tensor(t)
            with where:
                tr.train_step(img, tt, 1e-3)
        spans = tracing.records()
        chunk = ["train.forward", "train.loss", "train.backward",
                 "train.psnr"]
        want = chunk * 2 + ["train.psnr", "train.optim"]
    else:
        prof = tr._start_profile()
        with where:
            for _ in range(2):
                tr.train_step_idx(idx, t, 1e-3)
        spans = tracing.records()
        tr._stop_profile(prof)
        assert tracing.records() == []   # logged, then reset
        with open(tr.logger.log_path) as f:
            log = f.read()
        assert "spans over 2 unit(s)" in log and "train.optim" in log
        want = ["train.gather", "train.forward", "train.loss",
                "train.backward", "train.psnr", "train.optim"]
    roots = [s for s in spans if s.parent == -1]
    assert [s.name for s in roots] == ["train.step"] * (2 - micro)
    assert [s.unit for s in roots] == list(range(2 - micro))
    for root in roots:
        assert _tree(spans, root) == want
    assert {s.unit for s in spans} == {s.unit for s in roots}
    _ops_in_leaves(spans, where)
    assert any("convolution_backward" in op for _, op in where.at)


def _span(i, parent, name, host, dev=None):
    return tracing.Span(i, parent, 0 if i < 6 else 1, name,
                        host[0] * 1000, host[1] * 1000,
                        *((dev[0] * 1000, dev[1] * 1000) if dev else
                          (None, None)))


def test_summary_self_time_and_idle_on_a_made_up_clock():
    """Two frames on a device clock in us: the stream idles 140 us while
    the host is in ``pe``, 160 us while it is in ``mlp`` and 950 us
    between the frames, where the host is in no span."""
    spans = [
        _span(0, -1, "decode", (0, 1000), (0, 1200)),
        _span(1, 0, "prefix", (10, 400)),
        _span(2, 1, "pe", (20, 100), (50, 60)),
        _span(3, 1, "mlp", (100, 390), (200, 250)),
        _span(4, 0, "tail", (400, 990)),
        _span(5, 4, "kernel", (410, 980), (410, 1100)),
        _span(6, -1, "decode", (2000, 2100)),
        _span(7, 6, "pe", (2010, 2090), (2050, 2080)),
        _span(8, 6, "kernel", (2090, 2095), (2060, 2070)),  # overlaps pe
    ]
    s = tracing.summarise(spans, units=2, launches={"fused_conv_rsft": 4})
    rows = s["spans"]
    assert s["device"] and s["units"] == 2
    assert rows["decode"]["count"] == 2
    assert rows["decode"]["host_ms"] == pytest.approx(1.1)
    assert rows["decode"]["self_host_ms"] == pytest.approx(
        1.0 - 0.39 - 0.59 + 0.1 - 0.08 - 0.005)
    assert rows["prefix"]["self_host_ms"] == pytest.approx(0.39 - 0.08 - 0.29)
    assert rows["pe"]["stream_ms"] == pytest.approx(0.04)
    assert rows["kernel"]["stream_ms"] == pytest.approx(0.7)
    assert rows["prefix"]["stream_ms"] == 0.0   # no device stamps of its own
    idle = {k: v["idle_ms"] for k, v in rows.items() if v["idle_ms"]}
    assert idle == pytest.approx({"pe": 0.14, "mlp": 0.16})
    assert s["idle_outside_ms"] == pytest.approx(0.95)
    assert s["launches"] == {"fused_conv_rsft": 4}
    assert np.isclose(sum(idle.values()) + s["idle_outside_ms"], 1.25)


def test_device_stamps_of_leaves_and_their_parents():
    """A unit's pair of events; a leaf that waits on the stream starts at
    the previous leaf's end, one entered on a dry stream at its host
    start; a span with children spans its leaves.  Records as the
    recorder keeps them: [id, parent, unit, name, host start, host end,
    start event's time, end event's time, has children]."""
    recs = [[0, -1, 0, "decode", 10, 500, 12, 480, True],
            [1, 0, 0, "decode.prefix", 20, 200, None, None, True],
            [2, 1, 0, "decode.pe", 30, 100, None, 150, False],
            [3, 1, 0, "decode.stem", 110, 190, None, 300, False],
            [4, 0, 0, "decode.kernel", 400, 450, None, 470, False]]
    got = tracing.device_stamps(recs, 0)
    assert got == {0: [12, 480], 1: [30, 300], 2: [30, 150],
                   3: [150, 300], 4: [400, 470]}
    spans = [tracing.Span(*r[:6], *got[r[0]]) for r in recs]
    s = tracing.summarise(spans, units=1)
    assert s["spans"]["decode.prefix"]["stream_ms"] == pytest.approx(270e-6)
    # the stream ran dry at 300, the host in the frame between its parts
    assert s["spans"]["decode"]["idle_ms"] == pytest.approx(100e-6)
    assert s["idle_outside_ms"] == 0.0


class _Event:
    """A made-up timing event on a clock that ticks 1 ms a record."""
    clock = itertools.count()
    made = 0

    def __init__(self, enable_timing=True):
        _Event.made += 1
        self.at = None

    def record(self, stream=None):
        self.at = next(_Event.clock)

    def query(self):
        return True

    def elapsed_time(self, other):
        return float(other.at - self.at)


def test_events_are_recycled_once_the_stream_passes_them(monkeypatch):
    """Fifty units of two leaves record four events each (the unit's
    pair, one a leaf) and make five with the anchor: the oldest finished unit's events
    are read and reused when the pool runs dry; each unit's stream
    interval is the three ticks between its first and last record."""
    monkeypatch.setattr(tracing, "_new_event", _Event)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: "stream")
    monkeypatch.setattr(tracing._S, "pool", [])
    _Event.made = 0
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(50):
            with tracing.span("decode", unit=True):
                with tracing.span("decode.pe"):
                    pass
                with tracing.span("decode.kernel"):
                    pass
    assert _Event.made == 5   # the anchor and one unit's four
    spans = tracing.records()
    units = [s for s in spans if s.name == "decode"]
    assert len(units) == 50
    assert {s.dev_end - s.dev_start for s in units} == {3_000_000}
    kernels = [s for s in spans if s.name == "decode.kernel"]
    assert all(k.dev_end - u.dev_end == -1_000_000
               for k, u in zip(kernels, units))
    tracing.reset()
