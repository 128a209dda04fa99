"""The readers of the program's own spans (``spans.py`` and the metrics
that call it): None with no records or off the card, the right value on a
made-up summary; and (marked ``card``) the recorder on a CUDA device."""

import time

import pytest
import torch

import small
from bench_h100 import harness, spans
from boosting_nerv_torch.utils import tracing

NEW = {  # metric: (span read, field), in ms a unit
    "prefix_ms.playback": ("decode.prefix", "stream_ms"),
    "prefix_ms.seek": ("decode.prefix", "stream_ms"),
    "prefix_host_ms.playback": ("decode.prefix", "host_ms"),
    "prefix_host_ms.seek": ("decode.prefix", "host_ms"),
    "tail_ms.playback": ("decode.tail", "stream_ms"),
    "tail_ms.seek": ("decode.tail", "stream_ms"),
    "forward_ms.train": ("train.forward", "stream_ms"),
    "loss_ms.train": ("train.loss", "stream_ms"),
    "backward_ms.train": ("train.backward", "stream_ms"),
    "optim_ms.train": ("train.optim", "stream_ms"),
}
IDLE = ("idle_in_program_ms.playback", "idle_in_program_ms.seek",
        "idle_in_program_ms.train")


def _ctx(on_card=True, trace=True):
    return harness.Ctx("w", {}, {}, run={"units": 4, "window_s": 1.0,
                                         "on_card": on_card},
                       trace=object() if trace else None)


def _row(k):
    return {"count": 4, "host_ms": 10.0 * k, "self_host_ms": 1.0,
            "stream_ms": 20.0 * k, "idle_ms": 2.0 * k}


MADE_UP = {"units": 4, "device": True, "idle_outside_ms": 100.0,
           "launches": {}, "spans": {
               "decode.prefix": _row(1), "decode.tail": _row(2),
               "train.forward": _row(3), "train.loss": _row(4),
               "train.backward": _row(5), "train.optim": _row(6)}}


def test_the_new_metrics_are_declared():
    declared = {m["name"]: m for m in small.bench()["per_layer"]}
    for name in list(NEW) + list(IDLE):
        assert declared[name]["source"] == "program_span"
        assert len(declared[name]["workloads"]) == 1


def test_readers_of_the_spans(monkeypatch):
    tracing.reset()
    for name in list(NEW) + list(IDLE):   # nothing recorded
        assert harness.reader(name)(_ctx()) is None
    monkeypatch.setattr(tracing, "summary", lambda: MADE_UP)
    rows = MADE_UP["spans"]
    for name, (span, field) in NEW.items():
        read = harness.reader(name)
        assert read(_ctx()) == pytest.approx(rows[span][field] / 4)
        assert read(_ctx(on_card=False)) is None
        assert read(_ctx(trace=False)) is None
    for name in IDLE:   # the spans' idle, not the idle outside them
        assert harness.reader(name)(_ctx()) == pytest.approx(
            2.0 * 21 / 4)
    assert spans.host_ms(_ctx(), "decode.head") is None
    cpu = {**MADE_UP, "device": False}
    monkeypatch.setattr(tracing, "summary", lambda: cpu)
    assert spans.stream_ms(_ctx(), "decode.prefix") is None


@pytest.mark.card
def test_the_recorder_on_the_card(card):
    """Twelve units, each a matmul chain (``work``), 20 ms of host time in a
    span with children (``between``, its leaf ``small`` one launch), then
    another chain (``last``); between the units the host synchronises and
    sleeps 10 ms outside every span.  The stream runs dry in ``between``
    and outside; the unit's stream interval is its leaves and that idle."""
    a = torch.randn(2048, 2048, device=card)

    def chain(x):
        for _ in range(20):
            x = torch.tanh(x @ x)
        return x

    chain(a)
    tracing.reset()
    tracing._S.pool.clear()
    with torch.profiler.profile():
        for _ in range(12):
            with tracing.span("u", unit=True):
                with tracing.span("work"):
                    a = chain(a)
                with tracing.span("between"):
                    time.sleep(0.02)
                    with tracing.span("small"):
                        a = a + 1
                with tracing.span("last"):
                    a = chain(a)
            torch.cuda.synchronize()
            time.sleep(0.01)
    s = tracing.summary()
    rows = s["spans"]
    print(tracing.table(s))
    assert s["units"] == 12 and s["device"]
    # a unit records five events; finished units give theirs back
    assert len(tracing._S.pool) <= 2 * 5
    assert rows["work"]["stream_ms"] > 0.2 and rows["last"]["stream_ms"] > 0.2
    assert rows["between"]["host_ms"] > 40.0
    assert rows["between"]["idle_ms"] > 15.0
    assert 5.0 < s["idle_outside_ms"]
    leaves = sum(rows[k]["stream_ms"] for k in ("work", "small", "last"))
    idle = sum(r["idle_ms"] for r in rows.values())
    assert rows["u"]["stream_ms"] == pytest.approx(leaves + idle, rel=0.05)
    tracing.reset()
