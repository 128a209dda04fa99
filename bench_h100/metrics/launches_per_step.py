"""launches_per_step: kernel launches in the trace per training step."""
from bench_h100.readers import launches_per


def read(ctx):
    return launches_per(ctx, ctx.config["train"]["batch"])
