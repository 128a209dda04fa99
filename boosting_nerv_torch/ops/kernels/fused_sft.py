"""The ResBlockSFT of the v1 decode: the port of the Pallas kernel of
``boosting_nerv_tpu/ops/pallas/fused_sft.py``.

``resblock_sft_chw(x, w0, b0, w1, b1, sft, *, input_sin=False)``
(fused_sft.py:138): with y = sin(x) if ``input_sin`` else x,

    y + conv3x3(SFT1(gelu(conv3x3(SFT0(y)) + b0))) + b1,

SFTi(v) = v * (scale_i + 1) + shift_i, sft [4, C] float32 (scale0, shift0,
scale1, shift1).  ``input_sin`` is the sinusoidal activation of the
NeRVBlock before it (the v1 decode's switch stage): the residual is sin(x),
not x (fused_sft.py:115, 134), and zero padding applies after SFT0
(:119).  The name keeps ``_chw`` only so that a reader can find the
counterpart: tensors are NHWC bf16 [N, H, W, C], weights OHWI [C, 3, 3, C]
bf16 and biases [C] bf16, as for ``tile_conv``; the Pallas kernel's
channels-major layout, 128-lane W and row tiles are Mosaic tactics.

For a tensor on the CPU the wrapper runs ``resblock_sft_chw_plain``; for a
tensor on the card the two launches of the Hopper kernel's ResBlockSFT
chain ``conv_sm90.rsft``, the body of ``tile_conv.resblock_sft_tile``
(without ``input_sin`` the two compute one function): on
``ops/csrc/conv_sm90.cu``, or with ``input_sin`` on its sin instances
(``ops/csrc/conv_sm90_sin.cu``): conv0 stages sin(x) before SFT0, conv1
adds sin(x) as its residual, so sin(x) is never written to device memory.
On a CUDA tensor it launches or raises ValueError, it never falls back.
``LAUNCHES`` counts the wrapper calls that launched.
"""

from __future__ import annotations

import torch

from .planar import rsft_nhwc_plain
from .tile_conv import _rsft


def resblock_sft_chw_plain(x: torch.Tensor, w0: torch.Tensor,
                           b0: torch.Tensor, w1: torch.Tensor,
                           b1: torch.Tensor, sft: torch.Tensor, *,
                           input_sin: bool = False) -> torch.Tensor:
    """[N, H, W, C] -> [N, H, W, C]: ResBlockSFT(sin(x) or x)."""
    return rsft_nhwc_plain(x, w0, b0, w1, b1, sft, input_sin)


def resblock_sft_chw(x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor,
                     w1: torch.Tensor, b1: torch.Tensor, sft: torch.Tensor, *,
                     input_sin: bool = False) -> torch.Tensor:
    """ResBlockSFT of NHWC x, or of sin(x) with ``input_sin``:
    [N, H, W, C] -> [N, H, W, C]."""
    return _rsft("resblock_sft_chw", x, w0, b0, w1, b1, sft, input_sin)
