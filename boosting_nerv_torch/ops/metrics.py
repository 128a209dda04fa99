"""PSNR and MS-SSIM metrics (port of boosting_nerv_tpu/ops/metrics.py):
per-frame PSNR is -10 * log10(mean squared error + 1e-9) over each
sample's pixels."""

from __future__ import annotations

import torch

from .msssim import ms_ssim


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Scalar PSNR over the whole batch."""
    mse = torch.mean((pred - target) ** 2)
    return -10.0 * torch.log10(mse + 1e-9)


def psnr_per_frame(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """[B, ...] -> [B] per-frame PSNR."""
    mse = ((pred - target) ** 2).reshape(pred.shape[0], -1).mean(dim=1)
    return -10.0 * torch.log10(mse + 1e-9)


def msssim_per_frame(pred: torch.Tensor, target: torch.Tensor
                     ) -> torch.Tensor:
    """[B, H, W, C] -> [B] per-frame MS-SSIM."""
    return ms_ssim(pred, target, data_range=1.0, size_average=False)
