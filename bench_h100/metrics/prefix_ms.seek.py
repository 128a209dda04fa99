"""prefix_ms.seek: stream ms a frame of the span decode.prefix (PE, time
MLP, stem, prefix stages)."""
from bench_h100.spans import stream_ms


def read(ctx):
    return stream_ms(ctx, "decode.prefix")
