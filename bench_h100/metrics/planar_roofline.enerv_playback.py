"""planar_roofline.enerv_playback: the kernel tail's bound over the device
time launched under the two bf16 stage wrappers' spans (%)."""
from bench_h100.readers import planar_roofline

WRAPPERS = ("fused_upconv_rsft", "fused_conv_rsft")


def read(ctx):
    return planar_roofline(ctx, WRAPPERS)
