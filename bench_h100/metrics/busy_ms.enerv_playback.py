"""busy_ms.enerv_playback: device-busy ms per frame in the traced window."""
from bench_h100.readers import busy_ms as read  # noqa: F401
