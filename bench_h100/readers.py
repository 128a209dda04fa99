"""Arithmetic shared by the metric readers under ``metrics/``: each
reader names its cell's kind of work and calls one of these."""

from __future__ import annotations

import statistics
from typing import Optional

from . import counts


def rate(ctx) -> Optional[float]:
    """Frames completed over the window's seconds."""
    if not ctx.run.get("units"):
        return None
    return ctx.run["units"] / ctx.run["window_s"]


def p95_ms(ctx) -> Optional[float]:
    """95th percentile of the window's request latencies, in ms."""
    lat = ctx.latencies_s
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=20, method="inclusive")[18] * 1e3


def _traced(ctx) -> bool:
    return (ctx.trace is not None and ctx.run.get("on_card")
            and ctx.run.get("units", 0) > 0)


def decode_mfu(ctx) -> Optional[float]:
    """The frame's multiply-adds at the peaks of their precisions, as a
    share (%) of the traced frame time."""
    if not _traced(ctx):
        return None
    frame_s = ctx.run["window_s"] / ctx.run["units"]
    return 100.0 * counts.decode_least_s(ctx.config,
                                         ctx.mix["precision"]) / frame_s


def planar_roofline(ctx, wrappers) -> Optional[float]:
    """The kernel tail's least time (``counts.tail_bounds``) as a share
    (%) of the device time of everything launched under the stage
    wrappers' spans."""
    if not _traced(ctx):
        return None
    device_s = sum(ctx.trace.span_s.get(w, 0.0) for w in wrappers)
    if device_s <= 0.0:
        return None
    least_s = sum(ms for _, ms, _ in counts.tail_bounds(
        ctx.config, ctx.mix["precision"])) / 1e3
    return 100.0 * least_s * ctx.run["units"] / device_s


def launches_per(ctx, per_units: int = 1) -> Optional[float]:
    """Kernel launches in the trace per ``per_units`` units."""
    if not _traced(ctx):
        return None
    return ctx.trace.launches * per_units / ctx.run["units"]


def device_idle(ctx) -> Optional[float]:
    """Share (%) of the traced window in which no device operation ran."""
    if not _traced(ctx):
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.run["window_s"])


def train_mfu(ctx, chips: int = 1) -> Optional[float]:
    """3x the forward's model operations of each step over the traced step
    time, as a share (%) of the TF32 peak of the chips."""
    if not _traced(ctx):
        return None
    batch = ctx.config["train"]["batch"]
    step_s = ctx.run["window_s"] * batch / ctx.run["units"]
    return 100.0 * counts.train_flops(ctx.config, batch) / step_s / (
        counts.PEAK_OPS_S["tf32"] * chips)


def busy_ms(ctx, per_units: int = 1) -> Optional[float]:
    """Device-busy milliseconds (the union of device operations in the
    trace) per ``per_units`` units: the steadier companion of a host-paced
    rate, moved by the kernels alone."""
    if not _traced(ctx):
        return None
    return ctx.trace.busy_s * 1e3 * per_units / ctx.run["units"]
