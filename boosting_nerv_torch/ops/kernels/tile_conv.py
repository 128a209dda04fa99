"""Fine-grid convolutions of the decoder tail: the port of the four Pallas
kernels of ``boosting_nerv_tpu/ops/pallas/tile_conv.py``, which serve the
v2 and v3 decodes and the hybrid tail of the v5 one.

- ``conv_tile(x, w, b, *, k)`` (tile_conv.py:144): k x k same-padded conv
  + bias, k in {1, 3, 5}.
- ``conv_tile_v3(x, w, b, *, k, act)`` (tile_conv.py:473): the same for
  k in {1, 3}, followed by ``act``: "none", "sin", "outimg"
  (tanh(v) * 0.5 + 0.5) or "gelu" (exact erf).
- ``resblock_sft_tile(x, w0, b0, w1, b1, sft)`` (tile_conv.py:951) and
  ``resblock_sft_tile_v3`` (tile_conv.py:788): the fused ResBlockSFT
  x + conv3x3(SFT1(gelu(conv3x3(SFT0(x)) + b0))) + b1 with
  SFTi(v) = v * (scale_i + 1) + shift_i; sft is [4, C] float32 (scale0,
  shift0, scale1, shift1).  The TPU's v2 and v3 kernels differ only in
  tactics, so both wrappers compute one function.

Tensors are NHWC bf16 on the fine grid; weights are OHWI ([Cout, k, k,
Cin]) bf16, biases [Cout] bf16.  The JAX kernels' channels-major layout,
padded to 128 lanes with garbage beyond ``w_real``, and their ``mode`` /
``th`` / ``head_th`` choices are Mosaic tactics with no counterpart here:
every mode computes the function above.  Their degree-9 polynomial sin and
Abramowitz-Stegun erf become the kernel's reduced SFU sine and ``erff``.

Each wrapper runs its plain PyTorch version (``*_plain``) for a tensor on
the CPU, and for a tensor on the card one launch per conv, two per
ResBlockSFT: ``conv_tile`` and ``resblock_sft_tile_v3`` of the Hopper
kernel ``ops/csrc/conv_sm90.cu`` (``conv_sm90.launch`` / ``conv_sm90.rsft``),
``conv_tile_v3`` and ``resblock_sft_tile`` of the bf16 stage kernel
``ops/csrc/stage_conv.cu`` with KS = k taps (``planar.rsft_cuda``).  On a
CUDA tensor it launches or raises ValueError (for example for more than
128 input channels, which no shared-memory tile of either kernel takes);
it never falls back.  ``LAUNCHES`` counts the wrapper calls that launched.
"""

from __future__ import annotations

import torch

from . import LAUNCHES, _build, conv_sm90
from .planar import (_check_conv, _check_rsft, conv_act_plain,
                     rsft_nhwc_plain, run_conv, run_rsft, sm90_smem)


# --------------------------------------------------------------------- #
# plain PyTorch versions (NHWC in and out, in x's dtype)
# --------------------------------------------------------------------- #

def conv_tile_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                    k: int) -> torch.Tensor:
    """[N, H, W, Cin] -> [N, H, W, Cout]: k x k conv + bias."""
    return conv_tile_v3_plain(x, w, b, k=k, act="none")


def conv_tile_v3_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                       k: int, act: str = "none") -> torch.Tensor:
    """[N, H, W, Cin] -> [N, H, W, Cout]: act(k x k conv + bias)."""
    return conv_act_plain(x, w, b, act)


def resblock_sft_tile_plain(x: torch.Tensor, w0: torch.Tensor,
                            b0: torch.Tensor, w1: torch.Tensor,
                            b1: torch.Tensor, sft: torch.Tensor
                            ) -> torch.Tensor:
    """[N, H, W, C] -> [N, H, W, C]: ResBlockSFT(x)."""
    return rsft_nhwc_plain(x, w0, b0, w1, b1, sft)


resblock_sft_tile_v3_plain = resblock_sft_tile_plain


# --------------------------------------------------------------------- #
# CUDA wrappers
# --------------------------------------------------------------------- #

def conv_tile(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
              k: int) -> torch.Tensor:
    """k x k same-padded conv + bias of NHWC x, k in {1, 3, 5}:
    [N, H, W, Cin] -> [N, H, W, Cout]: one launch of ``conv_sm90.cu`` on
    the card."""
    if not _check_conv(x, w, b, k, (1, 3, 5), "none", sm90_smem):
        return conv_tile_plain(x, w, b, k=k)
    out = torch.empty(x.shape[:3] + (w.shape[0],), dtype=x.dtype,
                      device=x.device)
    conv_sm90.launch(_build.load_library(), x, w, b, out)
    LAUNCHES["conv_tile"] += 1
    return out


def conv_tile_v3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                 k: int, act: str = "none") -> torch.Tensor:
    """act(k x k same-padded conv + bias) of NHWC x, k in {1, 3}, act in
    none / sin / outimg / gelu: [N, H, W, Cin] -> [N, H, W, Cout]."""
    return run_conv("conv_tile_v3", x, w, b, k=k, ks=(1, 3), act=act)


def resblock_sft_tile(x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor,
                      w1: torch.Tensor, b1: torch.Tensor, sft: torch.Tensor
                      ) -> torch.Tensor:
    """ResBlockSFT of NHWC x: [N, H, W, C] -> [N, H, W, C]; w0/w1 OHWI
    [C, 3, 3, C]; sft [4, C] float32 (the v2 formulation's port)."""
    return run_rsft("resblock_sft_tile", x, w0, b0, w1, b1, sft)


def resblock_sft_tile_v3(x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor,
                         w1: torch.Tensor, b1: torch.Tensor, sft: torch.Tensor
                         ) -> torch.Tensor:
    """The same function as ``resblock_sft_tile`` (the v3 formulation's
    port), counted under its own name: two launches of ``conv_sm90.cu`` on
    the card."""
    if not _check_rsft(x, w0, b0, w1, b1, sft, sm90_smem):
        return resblock_sft_tile_v3_plain(x, w0, b0, w1, b1, sft)
    out = conv_sm90.rsft(conv_sm90.cuda_conv(_build.load_library()), x,
                         (w0, b0, w1, b1), sft)
    LAUNCHES["resblock_sft_tile_v3"] += 1
    return out
