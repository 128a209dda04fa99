"""busy_ms.train: device-busy ms per training step in the traced window."""
from bench_h100.readers import busy_ms


def read(ctx):
    return busy_ms(ctx, ctx.config["train"]["batch"])
