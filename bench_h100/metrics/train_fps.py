"""train_fps: frames trained (batch x steps) over the window's seconds."""
from bench_h100.readers import rate as read  # noqa: F401
