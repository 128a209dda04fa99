"""Plain PyTorch training step of HNeRV-Boost: the Fusion10_freq loss
(with MS-SSIM) and the Adan optimizer, over a parameter dict.

- Fusion10_freq = 60 (0.7 L1 + 0.3 (1 - MS-SSIM)) + L1 of the 2-D FFTs
  of the frames (real and imaginary parts stacked, so the mean is halved);
- MS-SSIM as the ``pytorch_msssim`` package computes it: an 11x11
  Gaussian window of sigma 1.5 applied separably, depthwise and without
  padding; 5 scales with weights (0.0448, 0.2856, 0.3001, 0.2363, 0.1333);
  the contrast terms clipped at 0; a 2x2 average pool between scales that
  zero-pads an odd side and counts the zeros; K = (0.01, 0.03);
- Adan (Xie et al., arXiv:2208.06677): betas (0.98, 0.92, 0.99), eps
  1e-8, no weight decay; bias corrections 1 - b1^k, 1 - b2^k and
  sqrt(1 - b3^k); the previous gradient taken equal to the first one.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

MS_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _window(dtype, device, size=11, sigma=1.5):
    c = torch.arange(size, dtype=torch.float64) - size // 2
    g = torch.exp(-(c ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).to(device=device, dtype=dtype)


def _blur(x):
    c = x.shape[1]
    g = _window(x.dtype, x.device)
    x = F.conv2d(x, g.view(1, 1, -1, 1).expand(c, 1, -1, 1), groups=c)
    return F.conv2d(x, g.view(1, 1, 1, -1).expand(c, 1, 1, -1), groups=c)


def _ssim_terms(x, y):
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mu1, mu2 = _blur(x), _blur(y)
    s11 = _blur(x * x) - mu1 * mu1
    s22 = _blur(y * y) - mu2 * mu2
    s12 = _blur(x * y) - mu1 * mu2
    cs = (2 * s12 + c2) / (s11 + s22 + c2)
    ssim = (2 * mu1 * mu2 + c1) / (mu1 * mu1 + mu2 * mu2 + c1) * cs
    return ssim.mean(dim=(2, 3)), cs.mean(dim=(2, 3))


def ms_ssim(x, y):
    """Per-frame MS-SSIM of NHWC frames in [0, 1]."""
    x, y = x.permute(0, 3, 1, 2), y.permute(0, 3, 1, 2)
    terms = []
    for i in range(len(MS_WEIGHTS)):
        ssim, cs = _ssim_terms(x, y)
        if i < len(MS_WEIGHTS) - 1:
            terms.append(F.relu(cs))
            pad = (x.shape[2] % 2, x.shape[3] % 2)
            x = F.avg_pool2d(x, 2, 2, padding=pad, count_include_pad=True)
            y = F.avg_pool2d(y, 2, 2, padding=pad, count_include_pad=True)
    terms.append(F.relu(ssim))
    w = torch.tensor(MS_WEIGHTS, dtype=x.dtype, device=x.device)
    return torch.prod(torch.stack(terms) ** w[:, None, None], dim=0).mean(-1)


def fusion10_freq(pred, target):
    """The batch mean of the per-frame Fusion10_freq loss (NHWC)."""
    b = pred.shape[0]
    l1 = (pred - target).abs().reshape(b, -1).mean(1)
    mix = 0.7 * l1 + 0.3 * (1.0 - ms_ssim(pred, target))
    pf = torch.fft.fft2(pred, dim=(1, 2))
    tf = torch.fft.fft2(target, dim=(1, 2))
    freq = ((pf.real - tf.real).abs() + (pf.imag - tf.imag).abs())
    return (60.0 * mix + freq.reshape(b, -1).mean(1) * 0.5).mean()


class Adan:
    """Adan over a dict of leaf tensors, updated in place."""

    def __init__(self, params: Dict[str, torch.Tensor],
                 betas=(0.98, 0.92, 0.99), eps=1e-8):
        self.params, self.betas, self.eps = params, betas, eps
        self.k = 0
        self.state: Dict[str, Dict[str, torch.Tensor]] = {}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor], lr: float):
        b1, b2, b3 = self.betas
        self.k += 1
        k = self.k
        for name, p in self.params.items():
            g = grads[name]
            st = self.state.get(name)
            if st is None:
                st = self.state[name] = {
                    "m": torch.zeros_like(p), "d": torch.zeros_like(p),
                    "n": torch.zeros_like(p), "prev": g.clone()}
            diff = g - st["prev"]
            st["m"] = b1 * st["m"] + (1 - b1) * g
            st["d"] = b2 * st["d"] + (1 - b2) * diff
            u = g + b2 * diff
            st["n"] = b3 * st["n"] + (1 - b3) * u * u
            denom = torch.sqrt(st["n"]) / math.sqrt(1 - b3 ** k) + self.eps
            p += (-(lr / (1 - b1 ** k)) * st["m"] / denom
                  - (lr * b2 / (1 - b2 ** k)) * st["d"] / denom)
            st["prev"] = g.clone()
