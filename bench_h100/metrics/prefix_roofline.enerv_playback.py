"""prefix_roofline.enerv_playback: the prefix's least time over the stream ms
a frame of the span decode.prefix (%).  The least time is the multiply-adds
of ``counts.decoder_layers`` ahead of the kernel tail (stage None: the
trunk and t_branch; stages below ``planar_tail``: stages 0-1), two
operations each, at the bf16 peak."""
from bench_h100 import counts, harness
from bench_h100.reference.models import planar_tail
from bench_h100.spans import stream_ms


def least_s(cfg: dict) -> float:
    m = cfg["model"]
    first = planar_tail(m, harness.family(m["model"]).stage_plan(m))
    macs = sum(layer.macs for layer in counts.decoder_layers(cfg)
               if layer.stage is None or layer.stage < first)
    return 2 * macs / counts.PEAK_OPS_S["bf16"]


def read(ctx):
    ms = stream_ms(ctx, "decode.prefix")
    if not ms:
        return None
    return 100.0 * least_s(ctx.config) * 1e3 / ms
