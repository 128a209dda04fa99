"""planar_roofline.playback: the kernel tail's bound over the device time
launched under the stage wrappers' spans (%)."""
from bench_h100.readers import planar_roofline

WRAPPERS = ("fused_upconv_rsft", "fused_conv_rsft", "fused_upconv_rsft_i8",
            "fused_conv_rsft_i8")


def read(ctx):
    return planar_roofline(ctx, WRAPPERS)
