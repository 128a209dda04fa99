"""Output squashing (port of ``out_img`` in boosting_nerv_tpu/ops/losses.py).

The reconstruction losses follow with the training slice."""

from __future__ import annotations

import torch


def out_img(x: torch.Tensor, out_bias: str = "tanh") -> torch.Tensor:
    if out_bias == "sigmoid":
        return torch.reciprocal(1.0 + torch.exp(-x))
    if out_bias == "tanh":
        return torch.tanh(x) * 0.5 + 0.5
    return x + float(out_bias)
