from .hnerv import HNeRVBoost, decoder_only_params
from .registry import build_model

__all__ = ["HNeRVBoost", "build_model", "decoder_only_params"]
