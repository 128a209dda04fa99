"""Spans of the port's hot paths, recorded only while a torch profiler
records.

``span(name, unit=False)`` is a context manager placed at the layer
boundaries of the serving decode (``runtime/fast_decode.py``) and the
trainer's step (``training/trainer.py``).

- Off (no ``torch.profiler`` recording): ``span`` returns one shared no-op
  and does nothing else: no allocation, no profiler range, no CUDA call;
  the caller pays one read of the profiler's flag.
- On: the span opens a profiler range of its name (the RecordFunction
  that ``record_function`` opens, without its two dispatched op calls),
  so it shows in the profiler's trace and Chrome export on the profiler's
  own clock; and appends a record (id, parent, unit, name, host start and
  end from ``time.time_ns()``, the profiler's clock).  A span with
  ``unit=True`` (one decoded frame, one optimizer step) starts a unit that
  its children share.

Device stamps, when CUDA is in use, come from pooled timing events on the
current stream (looked up once a unit): a pair on each unit span, one at
the exit of each leaf (a span that opened no other).  When the pool runs
dry, the oldest finished unit whose end the stream has passed gives its
events back, their times read first, so a recording of any length holds
about as many events as units in flight and creates new ones only at its
start.  Inside a unit every
launch happens inside a leaf, and a span with children launches nothing
of its own, so on the in-order stream a leaf's work starts no earlier than
the previous leaf's end and its own host start: the later of the two is
its device start.  A span with children spans its leaves.  Events are
ordered on the stream, so a leaf's end also follows the kernels that
autograd's thread launches inside ``loss.backward()``, which a profiler
range opened on the calling thread does not annotate.  Device stamps are
put on the host clock by one anchor event, recorded at the first span of a
recording on an idle stream (the one synchronise the recorder makes) just
after a host stamp, so they lie early by at most the launch latency.
Events are resolved in ``summary()``, after the caller's own synchronise.

``summary()`` gives, per name: count, host ms, self host ms (less the
children's), stream ms (device end less device start) and the stream idle
attributed to it: every positive gap between the latest device end so far
and the next leaf's device start goes to the innermost span whose host
interval holds the gap's start, or to ``outside``.  Idle inside a leaf
(between its own kernels) stays in its stream ms.

Records accumulate over every recording until ``reset()``.
"""

from __future__ import annotations

import bisect
import time
from array import array
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _profiler

from ..ops.kernels import LAUNCHES

_range = None   # the profiler's range type, looked up at the first span on

OUTSIDE = "outside"   # idle whose start no span holds


class _Off:
    """The span while nothing records."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, typ, val, tb):
        return False


OFF = _Off()


@dataclass(frozen=True)
class Span:
    """A finished span; stamps in ns on the host clock, ``dev_*`` None
    without CUDA."""
    id: int
    parent: int          # -1 at the top
    unit: int            # -1 outside every unit
    name: str
    host_start: int
    host_end: int
    dev_start: Optional[int] = None
    dev_end: Optional[int] = None


class _State:
    """The records, one column a field (no record is an object of its
    own: recording leaves the garbage collector nothing new to track, as a
    window of thousands of spans otherwise sets off collections over the
    whole heap); and the recording's clock, stream and event pool."""

    def __init__(self):
        self.clear()
        self.pool: list = []

    def clear(self) -> None:
        self.parent, self.unit_of = array("q"), array("q")
        self.h0, self.h1 = array("q"), array("q")
        self.d0, self.d1 = array("q"), array("q")   # read events, -1 none
        self.kids = bytearray()          # 1: the span opened another
        self.names: List[str] = []
        self.ev0: list = []              # a unit's start event, until read
        self.ev1: list = []              # a unit's or a leaf's end event
        self.pending: deque = deque()    # (first, last) index of a unit
        self.stack: List[int] = []
        self.unit, self.units = -1, 0
        self.anchor = None               # (event or None, host ns)
        self.stream = None               # the current stream, once a unit
        self.launches0: Dict[str, int] = {}
        self.cache = None

    def begin(self) -> None:
        """The first span of a recording: the launch counts and the
        clock's anchor."""
        self.launches0 = dict(LAUNCHES)
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
            self.stream = torch.cuda.current_stream()
            host = time.time_ns()
            self.anchor = (self.event(), host)
        else:
            self.anchor = (None, time.time_ns())

    def event(self):
        """A pooled timing event, recorded now on the stream."""
        if not self.pool:
            self.recycle()
        ev = self.pool.pop() if self.pool else _new_event()
        ev.record(self.stream)
        return ev

    def recycle(self) -> None:
        """Read the events of the oldest finished units the stream has
        passed and return them to the pool, until it holds one."""
        while self.pending and not self.pool:
            first, last = self.pending[0]
            if not self.ev1[first].query():
                return
            self.pending.popleft()
            self.read(first, last + 1)

    def read(self, a: int, b: int) -> None:
        """The times of the events of records ``a`` to ``b`` on the host
        clock; the events go back to the pool."""
        anchor, host0 = self.anchor
        for col, out in ((self.ev0, self.d0), (self.ev1, self.d1)):
            for i in range(a, b):
                ev = col[i]
                if ev is not None:
                    out[i] = host0 + int(round(anchor.elapsed_time(ev) * 1e6))
                    col[i] = None
                    self.pool.append(ev)


def _new_event():
    """A timing event (the extension type itself, which the garbage
    collector does not track, where this torch has it)."""
    make = getattr(torch._C, "_CudaEventBase", torch.cuda.Event)
    return make(enable_timing=True)


_S = _State()


class _On:
    """The span while a profiler records."""
    __slots__ = ("name", "unit", "idx", "rng", "prev_unit")

    def __init__(self, name: str, unit: bool):
        self.name, self.unit = name, unit

    def __enter__(self):
        global _range
        s = _S
        if s.anchor is None:
            s.begin()
        if _range is None:   # record_function's range, without its ops
            _range = getattr(torch._C._profiler, "_RecordFunctionFast",
                             _profiler.record_function)
        h0 = time.time_ns()
        self.rng = _range(self.name)
        self.rng.__enter__()
        self.prev_unit = s.unit
        ev0 = None
        if self.unit:
            s.unit = s.units
            s.units += 1
            if s.stream is not None:
                s.stream = torch.cuda.current_stream()
                ev0 = s.event()
        self.idx = len(s.names)
        parent = s.stack[-1] if s.stack else -1
        if parent >= 0:
            s.kids[parent] = 1
        s.parent.append(parent)
        s.unit_of.append(s.unit)
        s.h0.append(h0)
        s.h1.append(-1)
        s.d0.append(-1)
        s.d1.append(-1)
        s.kids.append(0)
        s.names.append(self.name)
        s.ev0.append(ev0)
        s.ev1.append(None)
        s.stack.append(self.idx)
        return None

    def __exit__(self, typ, val, tb):
        s, idx = _S, self.idx
        if s.stream is not None and (self.unit or not s.kids[idx]):
            s.ev1[idx] = s.event()
        self.rng.__exit__(typ, val, tb)
        s.h1[idx] = time.time_ns()
        if s.stack and s.stack[-1] == idx:
            s.stack.pop()
        if self.unit and s.stream is not None:
            s.pending.append((idx, len(s.names) - 1))
        s.unit = self.prev_unit
        return False


def span(name: str, unit: bool = False):
    """A span ``name``; ``unit``: it is one frame or one step."""
    if not _profiler._is_profiler_enabled:
        return OFF
    return _On(name, unit)


def reset() -> None:
    """Forget every record; the next span anchors the clock again.  The
    events go back to the pool, which outlives the records."""
    s = _S
    s.pool.extend(ev for ev in s.ev0 + s.ev1 if ev is not None)
    if s.anchor is not None and s.anchor[0] is not None:
        s.pool.append(s.anchor[0])
    s.clear()


def records() -> List[Span]:
    """The finished spans, device stamps resolved onto the host clock
    (``device_stamps``)."""
    s = _S
    if s.anchor is not None and s.anchor[0] is not None:
        torch.cuda.synchronize()
        s.pending.clear()
        s.read(0, len(s.names))
    done = [[i, s.parent[i], s.unit_of[i], s.names[i], s.h0[i], s.h1[i],
             s.d0[i] if s.d0[i] >= 0 else None,
             s.d1[i] if s.d1[i] >= 0 else None, s.kids[i]]
            for i in range(len(s.names)) if s.h1[i] >= 0]
    if s.stream is None:
        return [Span(*r[:6]) for r in done]
    stamps = device_stamps(done, s.anchor[1])
    return [Span(*r[:6], *stamps.get(r[0], (None, None))) for r in done]


def device_stamps(recs: List[list], host0: int) -> Dict[int, list]:
    """[device start, device end] of each record of ``recs`` (in the order
    they opened, with their events' times on the host clock; the stream
    idle from ``host0``): a leaf starts at the later of the latest end
    before it and its host start, and ends at its event; a span with
    children spans its leaves, a unit its own pair of events."""
    by_id = {r[0]: r for r in recs}
    stamps: Dict[int, list] = {}
    last = host0
    for r in recs:
        if r[8]:
            continue
        start, end = max(last, r[4]), r[7]
        last = max(last, end)
        p = r
        while p is not None:
            st = stamps.setdefault(p[0], [start, end])
            st[0], st[1] = min(st[0], start), max(st[1], end)
            p = by_id.get(p[1])
    for r in recs:
        if r[6] is not None:
            stamps[r[0]] = [r[6], r[7]]
    return stamps


def summary() -> dict:
    """``summarise`` of the records so far, with the unit count and the
    ``ops.kernels.LAUNCHES`` deltas since the recording began."""
    s = _S
    key = (len(s.names), len(s.stack))
    if s.cache is None or s.cache[0] != key:
        launches = {k: v - s.launches0.get(k, 0) for k, v in LAUNCHES.items()
                    if v != s.launches0.get(k, 0)} if s.anchor else {}
        s.cache = (key, summarise(records(), s.units, launches))
    return s.cache[1]


def summarise(spans: List[Span], units: int,
              launches: Optional[Dict[str, int]] = None) -> dict:
    """Per span name: count, host ms, self host ms, stream ms (None
    without device stamps) and attributed idle ms; the idle of gaps no
    span holds under ``idle_outside_ms``."""
    by_id = {sp.id: sp for sp in spans}
    child_ns: Dict[int, int] = {}
    for sp in spans:
        if sp.parent in by_id:
            child_ns[sp.parent] = (child_ns.get(sp.parent, 0)
                                   + sp.host_end - sp.host_start)
    device = any(sp.dev_start is not None for sp in spans)
    out: Dict[str, dict] = {}
    for sp in spans:
        row = out.setdefault(sp.name, {
            "count": 0, "host_ms": 0.0, "self_host_ms": 0.0,
            "stream_ms": 0.0 if device else None, "idle_ms": 0.0})
        host = (sp.host_end - sp.host_start) / 1e6
        row["count"] += 1
        row["host_ms"] += host
        row["self_host_ms"] += host - child_ns.get(sp.id, 0) / 1e6
        if device and sp.dev_start is not None:
            row["stream_ms"] += (sp.dev_end - sp.dev_start) / 1e6

    # the stream's idle between leaves, to the span the host was in
    order = sorted(spans, key=lambda sp: (sp.host_start, sp.id))
    starts = [sp.host_start for sp in order]

    def holder(t: int) -> str:
        j = bisect.bisect_right(starts, t) - 1
        sp = order[j] if j >= 0 else None
        while sp is not None and sp.host_end < t:
            sp = by_id.get(sp.parent)
        return sp.name if sp is not None else OUTSIDE

    leaves = sorted((sp.dev_start, sp.dev_end) for sp in spans
                    if sp.id not in child_ns and sp.dev_start is not None)
    outside, end = 0.0, None
    for a, b in leaves:
        if end is not None and a > end:
            name = holder(end)
            if name == OUTSIDE:
                outside += (a - end) / 1e6
            else:
                out[name]["idle_ms"] += (a - end) / 1e6
        end = b if end is None else max(end, b)
    return {"units": units, "device": device, "spans": out,
            "idle_outside_ms": outside, "launches": dict(launches or {})}


def table(summ: dict) -> str:
    """``summ`` as a table, ms a unit where it has units."""
    per = max(summ["units"], 1)
    lines = [f"spans over {summ['units']} unit(s), ms a unit: count, host, "
             "self host, stream, idle attributed"]
    for name, r in sorted(summ["spans"].items()):
        stream = ("-" if r["stream_ms"] is None
                  else f"{r['stream_ms'] / per:10.3f}")
        lines.append(f"  {name:20s} {r['count'] / per:7.2f} "
                     f"{r['host_ms'] / per:10.3f} "
                     f"{r['self_host_ms'] / per:10.3f} {stream:>10s} "
                     f"{r['idle_ms'] / per:10.3f}")
    lines.append(f"  idle outside every span: "
                 f"{summ['idle_outside_ms'] / per:.3f} ms a unit")
    if summ["launches"]:
        lines.append("  wrapper launches: " + ", ".join(
            f"{k} {v}" for k, v in sorted(summ["launches"].items())))
    return "\n".join(lines)
