"""decode_mfu.enerv_playback: the frame's multiply-adds (the trunk's Q K^T
and A V included) at the bf16 peak over the traced frame time (%)."""
from bench_h100.readers import decode_mfu as read  # noqa: F401
