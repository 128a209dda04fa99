"""Reading a ``torch.profiler`` trace of a run's window.

The arithmetic is that of the repository's profiling script
(``chip_profile.py``'s ``profile``, copied here so that the yardstick does
not move with the program): a device operation is a CUDA event of the
trace that is not a user annotation (a ``record_function`` range also
shows on the device, as an annotation spanning its launches); the device
is busy in the union of those events' intervals.  Added here: each device
operation is attributed to the benchmark's own span whose device-side
annotation contains it (the span that launched it), and the idle gaps are
named by what the next device operation was launched under.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List

SPAN = "bench::"   # prefix of the benchmark's own spans
TOP = 10


@dataclass
class Trace:
    busy_s: float
    launches: int                       # kernels, copies and fills apart
    span_s: Dict[str, float] = field(default_factory=dict)
    device_ops: List[list] = field(default_factory=list)
    idle_gaps: List[list] = field(default_factory=list)


def _device_op(e) -> bool:
    return e.device_type.name == "CUDA" and not getattr(
        e, "is_user_annotation", False)


def _is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def _union(spans):
    """[(a, b)] merged, and the total length."""
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged, sum(b - a for a, b in merged)


def read(prof) -> Trace:
    """The summary of a finished ``torch.profiler.profile``."""
    events = prof.events()
    ops = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in events if _device_op(e))
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in events
                   if e.device_type.name == "CUDA"
                   and getattr(e, "is_user_annotation", False)
                   and e.name.startswith(SPAN))
    merged, busy_us = _union((a, b) for a, b, _ in ops)

    # attribution: the innermost (latest-starting) span containing the op
    starts = [a for a, _, _ in spans]
    span_us: Dict[str, float] = defaultdict(float)
    owner: List[str] = []
    for a, b, _ in ops:
        name = ""
        j = bisect.bisect_right(starts, a) - 1
        while j >= 0:
            sa, sb, sn = spans[j]
            if sa <= a and b <= sb:
                name = sn[len(SPAN):]
                break
            j -= 1
            if a - sa > 5e6:   # spans are short: stop looking far back
                break
        owner.append(name)
        if name:
            span_us[name] += b - a

    by_name: Dict[str, float] = defaultdict(float)
    for a, b, n in ops:
        by_name[n] += b - a
    device_ops = sorted(([n[:200], t / 1e6] for n, t in by_name.items()),
                        key=lambda r: -r[1])[:TOP]

    # an idle gap is named by the op that ends it and its span
    gaps: Dict[str, float] = defaultdict(float)
    end = None
    for (a, b, n), o in zip(ops, owner):
        if end is not None and a > end:
            gaps[f"before {o or 'unspanned'}: {n[:120]}"] += a - end
        end = b if end is None else max(end, b)
    idle_gaps = sorted(([n, t / 1e6] for n, t in gaps.items()),
                       key=lambda r: -r[1])[:TOP]
    return Trace(busy_s=busy_us / 1e6,
                 launches=sum(1 for _, _, n in ops if _is_kernel(n)),
                 span_s={k: v / 1e6 for k, v in span_us.items()},
                 device_ops=device_ops, idle_gaps=idle_gaps)
