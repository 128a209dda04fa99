"""prefix_ms.enerv_playback: stream ms a frame of the span decode.prefix (the
graph's PE, t_branch, trunk, stages 0-1 and every tail stage's SFT
vectors)."""
from bench_h100.spans import stream_ms


def read(ctx):
    return stream_ms(ctx, "decode.prefix")
