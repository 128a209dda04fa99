"""train_mfu: 3x the forward's model operations per step over the traced
step time, as a share of the TF32 peak (%)."""
from bench_h100.readers import train_mfu as read  # noqa: F401
