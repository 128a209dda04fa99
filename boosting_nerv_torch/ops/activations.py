"""Activation registry (port of boosting_nerv_tpu/ops/activations.py).

Same menu as the reference ``ActivationLayer``: relu, leaky (slope .01),
leaky01 (slope .1), relu6, gelu (exact erf form), sin (the Boost default),
swish, softplus, hardswish, none.  The reference also advertises ``ressin``
with no implementation; it raises KeyError here as there.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

_ACTS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": F.relu,
    "leaky": lambda x: F.leaky_relu(x, negative_slope=0.01),
    "leaky01": lambda x: F.leaky_relu(x, negative_slope=0.1),
    "relu6": lambda x: torch.clamp(x, 0.0, 6.0),
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "sin": torch.sin,
    "swish": F.silu,
    "softplus": F.softplus,
    "hardswish": lambda x: x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0,
    "none": lambda x: x,
}


def get_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    try:
        return _ACTS[name]
    except KeyError:
        raise KeyError(f"Unknown activation function {name}.")
