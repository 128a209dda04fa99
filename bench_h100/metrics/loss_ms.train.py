"""loss_ms.train: stream ms an optimizer step of the span
train.loss."""
from bench_h100.spans import stream_ms


def read(ctx):
    return stream_ms(ctx, "train.loss")
