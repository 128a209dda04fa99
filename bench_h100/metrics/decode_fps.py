"""decode_fps: frames completed in the window over its seconds."""
from bench_h100.readers import rate as read  # noqa: F401
