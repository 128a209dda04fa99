"""train_peak_gib: max_memory_allocated over the window, GiB."""


def read(ctx):
    peak = ctx.run.get("window_peak_bytes", 0)
    return peak / 2 ** 30 if peak else None
