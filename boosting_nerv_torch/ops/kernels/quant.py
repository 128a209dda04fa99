"""Symmetric per-channel int8 quantisation of the W8A8 serving decode.

Port of ``boosting_nerv_tpu/ops/pallas/planar.py:185-190`` (``_quant_act``)
and ``:634-670`` (``_inv_from_bound``, ``out_quant_vec``, ``_quant_conv``)
to the port's NHWC activations and OHWI weights, where the TPU's planar
rows are simply the output channels.  All scales are per channel, float32:

- a conv input with per-channel bound ``b`` (``runtime.fast_decode.
  calibrate_planar_bounds``) is quantised at ``inv = 127 / b`` (0 for a
  dead channel, which then quantises to exactly 0);
- its weights take the activation scale ``b / 127`` folded into their
  input channels, then one scale per output channel:
  ``s_w = max(max|kf[o]|, 1e-12) / 127``;
- the conv dequantises as ``float(sum(codes * wq)) * s_w + bias``.
"""

from __future__ import annotations

from typing import Tuple

import torch


def inv_from_bound(bound) -> torch.Tensor:
    """Per-channel |x| bound -> float32 multiplier 127 / bound, 0 where the
    bound is <= 1e-12 (a dead channel)."""
    b = torch.as_tensor(bound, dtype=torch.float32)
    return torch.where(b > 1e-12, 127.0 / b.clamp_min(1e-12),
                       torch.zeros_like(b))


def out_quant_vec(bound) -> torch.Tensor:
    """A producer's ``out_inv``: the multiplier of its consumer's "x"
    bound, so that it stores exactly the int8 codes the consumer's folded
    weights expect (the zero-convert chain)."""
    return inv_from_bound(bound)


def quant_act(x: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """Channel-last activations -> int8 codes
    clip(round_half_even(x * inv), -127, 127), computed in float32."""
    q = torch.round(x.float() * inv.to(x.device, torch.float32))
    return q.clamp_(-127.0, 127.0).to(torch.int8)


def fold_quant_weight(w_ohwi: torch.Tensor, bound_in
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """OHWI conv weight + per-input-channel bound of its input -> (int8
    codes [Cout, kh, kw, Cin], float32 dequant scale [Cout])."""
    sx = torch.as_tensor(bound_in, dtype=torch.float32,
                         device=w_ohwi.device) / 127.0
    kf = w_ohwi.float() * sx
    scale = kf.abs().amax(dim=(1, 2, 3)).clamp_min(1e-12) / 127.0
    codes = torch.round(kf / scale[:, None, None, None]).clamp_(-127, 127)
    return codes.to(torch.int8), scale
