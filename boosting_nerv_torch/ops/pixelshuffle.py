"""PixelShuffle channel order (port of boosting_nerv_tpu/ops/pixelshuffle.py).

The JAX ``depth_to_space`` packs the r*r*C channels as (r1, r2, c), major
to minor; torch's ``F.pixel_shuffle`` packs them as (c, r1, r2).  The port
keeps torch's order everywhere (models, plain versions, CUDA store
addressing) and uses ``F.pixel_shuffle`` itself; it reorders the output
channels of every upsampling conv once, when flax weights are loaded
(``bridge.py``), with ``jax_to_torch_shuffle_perm``.
"""

from __future__ import annotations

import numpy as np


def jax_to_torch_shuffle_perm(c: int, r: int) -> np.ndarray:
    """Index array p with ``torch_channels = jax_channels[p]``.

    Torch channel c*r*r + q (q = r1*r + r2) holds what JAX keeps at
    q*C + c."""
    return np.arange(r * r * c).reshape(r * r, c).T.reshape(-1)
