"""seek_p95_ms: 95th percentile of the requests' latencies (ms)."""
from bench_h100.readers import p95_ms as read  # noqa: F401
