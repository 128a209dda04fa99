"""Reading the program's own spans (``boosting_nerv_torch.utils.tracing``),
which it records while the traced window's profiler records, for the
metrics under ``metrics/``.  Each reader gives milliseconds a unit, a unit
being the recorder's own (a decoded frame, an optimizer step), and None
off the card, outside a traced run, or where the program records no such
span (a program without the recorder)."""

from __future__ import annotations

from typing import Optional

from .readers import _traced


def summary(ctx) -> Optional[dict]:
    """The recorder's summary of the traced window, if it timed units on
    the device."""
    if not _traced(ctx):
        return None
    try:
        from boosting_nerv_torch.utils import tracing
    except ImportError:
        return None
    s = tracing.summary()
    return s if s["units"] and s["device"] else None


def _per_unit(ctx, name: str, field: str) -> Optional[float]:
    s = summary(ctx)
    row = s["spans"].get(name) if s is not None else None
    if row is None or row[field] is None:
        return None
    return row[field] / s["units"]


def stream_ms(ctx, name: str) -> Optional[float]:
    """Device ms a unit from span ``name``'s enter to its exit on the
    stream, over all its instances."""
    return _per_unit(ctx, name, "stream_ms")


def host_ms(ctx, name: str) -> Optional[float]:
    """Host ms a unit inside span ``name``, blocking waits included."""
    return _per_unit(ctx, name, "host_ms")


def idle_in_program_ms(ctx) -> Optional[float]:
    """Stream idle ms a unit between the leaves' device intervals that
    began while the host was inside a program span (not ``outside``)."""
    s = summary(ctx)
    if s is None:
        return None
    return sum(r["idle_ms"] for r in s["spans"].values()) / s["units"]
