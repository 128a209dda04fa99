"""PixelShuffle channel order (port of boosting_nerv_tpu/ops/pixelshuffle.py).

The JAX ``depth_to_space`` / ``space_to_depth`` pack the r*r*C channels
as (r1, r2, c), major to minor; torch's ``F.pixel_shuffle`` /
``F.pixel_unshuffle`` pack them as (c, r1, r2).  The port keeps torch's
order everywhere (models, plain versions, CUDA store addressing) and uses
torch's functions itself; it reorders the output channels of every
upsampling conv, and the input channels of every PixelUnshuffle conv, once,
when flax weights are loaded (``bridge.py``), with
``jax_to_torch_shuffle_perm``.  ``space_to_depth`` is the JAX packing in
torch, for the tests that hold the two orders together.
"""

from __future__ import annotations

import numpy as np
import torch


def jax_to_torch_shuffle_perm(c: int, r: int) -> np.ndarray:
    """Index array p with ``torch_channels = jax_channels[p]``, for the
    r*r*c channels of a PixelShuffle input or a PixelUnshuffle output.

    Torch channel c*r*r + q (q = r1*r + r2) holds what JAX keeps at
    q*C + c."""
    return np.arange(r * r * c).reshape(r * r, c).T.reshape(-1)


def space_to_depth(x: torch.Tensor, r: int) -> torch.Tensor:
    """NHWC [B, H*r, W*r, C] -> [B, H, W, r*r*C] in the JAX packing
    (block position major: (r1, r2, c))."""
    if r == 1:
        return x
    b, hr, wr, c = x.shape
    x = x.reshape(b, hr // r, r, wr // r, r, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hr // r, wr // r, r * r * c)
