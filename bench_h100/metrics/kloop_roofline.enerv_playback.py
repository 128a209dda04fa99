"""kloop_roofline.enerv_playback: stage 2's least time (its row of
``counts.tail_bounds``: the K loop's conv of Cin 213 and the stage's
ResBlockSFT) over the stream ms a frame of the span decode.stage2, which on
the graph path holds stage 2's wrapper alone (%)."""
from bench_h100 import counts
from bench_h100.spans import stream_ms

STAGE = 2


def read(ctx):
    ms = stream_ms(ctx, f"decode.stage{STAGE}")
    if not ms:
        return None
    least_ms = {i: b for i, b, _ in counts.tail_bounds(
        ctx.config, ctx.mix["precision"])}[STAGE]
    return 100.0 * least_ms / ms
