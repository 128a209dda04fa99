from .enerv import ENeRV, ENeRVBoost
from .hnerv import HNeRV, HNeRVBoost, decoder_only_params
from .nerv import NeRVBoost
from .registry import build_model
