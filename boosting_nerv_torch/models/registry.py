"""Model registry (port of boosting_nerv_tpu/models/registry.py): the five
trainable families."""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn as nn

from ..config import BoostConfig
from .blocks import init_weights
from .enerv import ENeRV, ENeRVBoost
from .hnerv import HNeRV, HNeRVBoost
from .nerv import NeRVBoost

_REGISTRY = {
    "NeRV_Boost": NeRVBoost,
    "ENeRV": ENeRV,
    "ENeRV_Boost": ENeRVBoost,
    "HNeRV_Boost": HNeRVBoost,
    "HNeRV": HNeRV,
}


def build_model(cfg: BoostConfig, seed: Optional[int] = 0,
                device: Union[str, torch.device] = "cuda") -> nn.Module:
    """The model for ``cfg`` on ``device``: the card unless the caller asks
    for the CPU (``device="cpu"``).  With ``seed`` not None every
    parameter is drawn from ``torch.Generator().manual_seed(seed)`` on the
    CPU first, so the weights do not depend on the device or on torch's
    global RNG.  An unknown ``cfg.model`` raises KeyError."""
    try:
        cls = _REGISTRY[cfg.model]
    except KeyError:
        raise KeyError(f"Unknown model {cfg.model!r}; "
                       f"available: {sorted(_REGISTRY)}") from None
    model = cls(cfg)
    if seed is not None:
        init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device)
