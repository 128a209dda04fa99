"""prefix_host_ms.seek: host ms a frame inside the span decode.prefix,
blocking waits included."""
from bench_h100.spans import host_ms


def read(ctx):
    return host_ms(ctx, "decode.prefix")
