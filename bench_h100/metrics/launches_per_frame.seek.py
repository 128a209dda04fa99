"""launches_per_frame.seek: kernel launches in the trace per frame."""
from bench_h100.readers import launches_per as read  # noqa: F401
