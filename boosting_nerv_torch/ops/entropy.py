"""The differentiable entropy model of the CEM finetune (port of
boosting_nerv_tpu/ops/entropy.py).

One global Gaussian (or Laplace) a tensor over its quantiser codes: the
estimate is bits = -log2(CDF(x + 1/2) - CDF(x - 1/2) + 1e-5), floored at 0
by ``lower_bound``, whose gradient passes where the input is above the
bound or the gradient pushes it up.  In training the codes are relaxed
with U(-1/2, 1/2) noise that the caller draws (``rate_bits``'s
``noise``): the trainer from a ``torch.Generator``, the tests from the
JAX package's own draws.  The std is the unbiased one (torch.std's).
The real bitstream sizes come from the rANS codec (``compress.rans``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Union

import torch

Scalar = Union[float, torch.Tensor]


class _LowerBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp_min(x, bound)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        pass_through = (x >= ctx.bound) | (g < 0)
        return torch.where(pass_through, g, torch.zeros_like(g)), None


def lower_bound(x: torch.Tensor, bound: float) -> torch.Tensor:
    """max(x, bound); the gradient passes where x >= bound or g < 0."""
    return _LowerBound.apply(x, bound)


def _normal_cdf(x):
    return 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def _laplace_cdf(x, mu, b):
    z = x - mu
    return 0.5 - 0.5 * torch.sign(z) * torch.expm1(-torch.abs(z) / b)


def _as_tensor(v: Scalar, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def gaussian_bits(x: torch.Tensor, mean: Scalar, std: Scalar,
                  distribution: str = "gaussian") -> torch.Tensor:
    """Per-element bit estimate under the global Gaussian / Laplace
    model with ``mean`` and ``std`` (tensors, or floats taken as
    float32)."""
    mean = _as_tensor(mean, x)
    std = torch.clamp(_as_tensor(std, x), 1e-5, 1e10)
    if distribution == "gaussian":
        probs = (_normal_cdf((x + 0.5 - mean) / std)
                 - _normal_cdf((x - 0.5 - mean) / std))
    else:
        probs = (_laplace_cdf(x + 0.5, mean, std)
                 - _laplace_cdf(x - 0.5, mean, std))
    bits = -torch.log(probs + 1e-5) / math.log(2.0)
    return lower_bound(bits, 0.0)


def code_stats(code: torch.Tensor):
    """(mean, unbiased std) of a code tensor: the tensor's model; the std
    of one element is 0."""
    mean = code.mean()
    std = code.std() if code.numel() > 1 else torch.zeros_like(mean)
    return mean, std


def rate_bits(code: torch.Tensor, noise: Optional[torch.Tensor] = None,
              training: bool = False, distribution: str = "gaussian"
              ) -> Dict[str, torch.Tensor]:
    """Estimated bits of one tensor's codes: in training the codes plus
    ``noise`` (U(-1/2, 1/2), code's shape, drawn by the caller), at eval
    the codes as given."""
    mean, std = code_stats(code)
    x = code
    if training:
        if noise is None:
            raise ValueError("rate_bits in training needs the noise")
        x = code + noise
    bits = torch.sum(gaussian_bits(x, mean, std, distribution))
    return {"bitrate": bits, "mean": mean, "std": std}
