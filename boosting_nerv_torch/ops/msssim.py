"""SSIM and MS-SSIM in PyTorch (port of boosting_nerv_tpu/ops/msssim.py).

The conventions of the ``pytorch_msssim`` package the reference uses:
an 11x11 Gaussian window (sigma 1.5) applied separably and depthwise with
VALID padding; MS-SSIM over 5 levels with weights (0.0448, 0.2856, 0.3001,
0.2363, 0.1333), the contrast terms relu'd, a 2x2 average pool between
levels that zero-pads odd sides and counts the zeros; K = (0.01, 0.03).
Images are NHWC at the API, as in the JAX package, and NCHW inside.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

_MS_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


@functools.lru_cache(maxsize=None)
def _gaussian_window(win_size: int, sigma: float) -> tuple:
    coords = np.arange(win_size, dtype=np.float64) - win_size // 2
    g = np.exp(-(coords ** 2) / (2.0 * sigma ** 2))
    g /= g.sum()
    return tuple(g.astype(np.float32).tolist())


def _depthwise_blur(x: torch.Tensor, win_size: int, sigma: float
                    ) -> torch.Tensor:
    """Separable depthwise Gaussian filter, VALID padding; x NCHW."""
    c = x.shape[1]
    g = torch.tensor(_gaussian_window(win_size, sigma), dtype=x.dtype,
                     device=x.device)
    x = F.conv2d(x, g.view(1, 1, win_size, 1).expand(c, 1, win_size, 1),
                 groups=c)
    return F.conv2d(x, g.view(1, 1, 1, win_size).expand(c, 1, 1, win_size),
                    groups=c)


def _ssim_maps(x, y, data_range, win_size, sigma, k1, k2):
    """Per-sample, per-channel means of the SSIM and contrast-structure
    maps: two [B, C] tensors."""
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    blur = lambda t: _depthwise_blur(t, win_size, sigma)  # noqa: E731
    mu1, mu2 = blur(x), blur(y)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = blur(x * x) - mu1_sq
    sigma2_sq = blur(y * y) - mu2_sq
    sigma12 = blur(x * y) - mu1_mu2
    cs_map = (2.0 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2)
    ssim_map = ((2.0 * mu1_mu2 + c1) / (mu1_sq + mu2_sq + c1)) * cs_map
    return ssim_map.mean(dim=(2, 3)), cs_map.mean(dim=(2, 3))


def _avg_pool2_padded(x: torch.Tensor) -> torch.Tensor:
    """2x2 / stride-2 average pool of NCHW x; an odd side is zero-padded on
    both ends and the zeros count in the mean."""
    return F.avg_pool2d(x, 2, 2, padding=(x.shape[2] % 2, x.shape[3] % 2),
                        count_include_pad=True)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def ssim(x: torch.Tensor, y: torch.Tensor, data_range: float = 1.0,
         size_average: bool = True, win_size: int = 11,
         win_sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03
         ) -> torch.Tensor:
    """Single-scale SSIM of NHWC images: a scalar (``size_average``) or
    one value a sample."""
    ssim_pc, _ = _ssim_maps(_nchw(x), _nchw(y), data_range, win_size,
                            win_sigma, k1, k2)
    per_image = ssim_pc.mean(dim=-1)
    return per_image.mean() if size_average else per_image


def ms_ssim(x: torch.Tensor, y: torch.Tensor, data_range: float = 1.0,
            size_average: bool = True, win_size: int = 11,
            win_sigma: float = 1.5, weights=_MS_WEIGHTS,
            k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Multi-scale SSIM of NHWC images: a scalar (``size_average``) or one
    value a sample.  Raises ValueError unless
    min(H, W) > (win_size - 1) * 2 ** (levels - 1) (160 for the defaults):
    below that the smallest scale is narrower than the window and the
    result would be NaN."""
    levels = len(weights)
    min_side = (win_size - 1) * 2 ** (levels - 1)
    if min(x.shape[1], x.shape[2]) <= min_side:
        raise ValueError(
            f"ms_ssim needs min(H, W) > {min_side} for {levels} levels "
            f"(got {x.shape[1]}x{x.shape[2]})")
    w = torch.tensor(weights, dtype=x.dtype, device=x.device)
    x, y = _nchw(x), _nchw(y)
    mcs = []
    for i in range(levels):
        ssim_pc, cs_pc = _ssim_maps(x, y, data_range, win_size, win_sigma,
                                    k1, k2)
        if i < levels - 1:
            mcs.append(torch.relu(cs_pc))
            x = _avg_pool2_padded(x)
            y = _avg_pool2_padded(y)
    stack = torch.stack(mcs + [torch.relu(ssim_pc)], dim=0)  # [levels, B, C]
    msv = torch.prod(stack ** w[:, None, None], dim=0)
    per_image = msv.mean(dim=-1)
    return per_image.mean() if size_average else per_image
