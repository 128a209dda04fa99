"""3x3 convolutions of the v1 decode: the port of the two Pallas kernels of
``boosting_nerv_tpu/ops/pallas/conv_chw.py``, which serve the stages after
the switch of ``build_fast_decode`` and its head.

- ``conv3x3_act_chw(x, w, b)`` (conv_chw.py:88): sin(conv3x3(x) + b), the
  stride-1 NeRVBlock body (a stride-2 stage's 4C channels, PixelShuffle
  follows in torch).
- ``head_conv_chw(x, w, b)`` (conv_chw.py:95): tanh(conv3x3(x) + b) * 0.5
  + 0.5, the output head and OutImg.

The names keep ``_chw`` only so that a reader can find the counterpart.
Tensors are NHWC bf16 [N, H, W, C], weights OHWI [Cout, 3, 3, Cin] bf16,
biases [Cout] bf16, as for ``tile_conv``: the Pallas kernels'
channels-major (C, H, W) layout with W on the 128 lanes, their 8-row tiles
and 16-row halo DMA are Mosaic tactics with no counterpart here, and any
width or height is taken.

Each wrapper runs its plain PyTorch version (``*_plain``) for a tensor on
the CPU and, for a tensor on the card, one launch of the Hopper kernel
``ops/csrc/conv_sm90.cu`` with its sin or outimg epilogue: the body of
``tile_conv.conv_tile_v3`` (``tile_conv._conv`` at k = 3), counted under
the wrapper's own name (the 51 -> 3 head takes the N 8 slice, as
``conv_tile_v3``'s head does).  The stage kernel ``stage_conv.cu``, which
served them before, serves only the K1 probes and chip_smoke.py's A/B.  On
a CUDA tensor a wrapper launches or raises ValueError (for example for
more than 256 input channels, beyond the kernel's K loop), it never falls
back.  ``LAUNCHES`` counts
the wrapper calls that launched.
"""

from __future__ import annotations

import torch

from .planar import conv_act_plain
from .tile_conv import _conv


def conv3x3_act_chw_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                          ) -> torch.Tensor:
    """[N, H, W, Cin] -> [N, H, W, Cout]: sin(conv3x3(x) + b)."""
    return conv_act_plain(x, w, b, "sin")


def head_conv_chw_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                        ) -> torch.Tensor:
    """[N, H, W, Cin] -> [N, H, W, Cout]: tanh(conv3x3(x) + b) * 0.5 + 0.5."""
    return conv_act_plain(x, w, b, "outimg")


def conv3x3_act_chw(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                    ) -> torch.Tensor:
    """sin(conv3x3(x) + b) of NHWC x: [N, H, W, Cin] -> [N, H, W, Cout]."""
    return _conv("conv3x3_act_chw", x, w, b, 3, (3,), "sin")


def head_conv_chw(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                  ) -> torch.Tensor:
    """tanh(conv3x3(x) + b) * 0.5 + 0.5 of NHWC x: [N, H, W, Cin] ->
    [N, H, W, Cout] (Cout = 3 for the RGB head)."""
    return _conv("head_conv_chw", x, w, b, 3, (3,), "outimg")
