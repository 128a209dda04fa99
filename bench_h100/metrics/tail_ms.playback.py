"""tail_ms.playback: stream ms a frame of the span decode.tail (each stage's
SFT vectors and its stage kernel)."""
from bench_h100.spans import stream_ms


def read(ctx):
    return stream_ms(ctx, "decode.tail")
