"""device_idle.playback: share of the traced window with no device op (%)."""
from bench_h100.readers import device_idle as read  # noqa: F401
