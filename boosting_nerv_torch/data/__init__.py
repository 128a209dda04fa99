"""The video dataset of the port (counterpart of boosting_nerv_tpu/data/)."""

from .video import VideoData, data_split, make_inpaint_mask, synthetic_video

__all__ = ["VideoData", "data_split", "make_inpaint_mask", "synthetic_video"]
