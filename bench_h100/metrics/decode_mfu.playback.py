"""decode_mfu.playback: the frame's multiply-adds at their precisions' peaks
over the traced frame time (%)."""
from bench_h100.readers import decode_mfu as read  # noqa: F401
