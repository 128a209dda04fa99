"""Model registry (port of boosting_nerv_tpu/models/registry.py).

Only HNeRV-Boost, the serving model, is ported; the other families raise
NotImplementedError naming their ROADMAP item."""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..config import BoostConfig
from .blocks import init_weights
from .hnerv import HNeRVBoost

_NOT_PORTED = ("NeRV_Boost", "ENeRV", "ENeRV_Boost", "HNeRV")


def build_model(cfg: BoostConfig, seed: Optional[int] = 0,
                device: Union[str, torch.device] = "cuda") -> HNeRVBoost:
    """The model for ``cfg`` on ``device``: the card unless the caller asks
    for the CPU (``device="cpu"``).  With ``seed`` not None every
    parameter is drawn from ``torch.Generator().manual_seed(seed)`` on the
    CPU first, so the weights do not depend on the device or on torch's
    global RNG."""
    if cfg.model in _NOT_PORTED:
        raise NotImplementedError(f"{cfg.model} is not ported yet (ROADMAP "
                                  "queue 1: other model families)")
    if cfg.model != "HNeRV_Boost":
        raise KeyError(f"Unknown model {cfg.model!r}; available: "
                       f"{['HNeRV_Boost', *sorted(_NOT_PORTED)]}")
    model = HNeRVBoost(cfg)
    if seed is not None:
        init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device)
