"""tail_ms.enerv_playback: stream ms a frame of the span decode.tail (each
stage's wrapper; the SFT vectors come from the prefix graph)."""
from bench_h100.spans import stream_ms


def read(ctx):
    return stream_ms(ctx, "decode.tail")
