"""Decoder-tail stage kernels: the port of the two bf16 Pallas kernels of
``boosting_nerv_tpu/ops/pallas/planar.py`` that serve HNeRV-Boost.

- ``fused_upconv_rsft`` (stride-2 stage):
  y = sin(PixelShuffle2(conv3x3(x) + b)); out = ResBlockSFT(y).
- ``fused_conv_rsft`` (stride-1 stage): y = sin(conv3x3(x) + b);
  out = ResBlockSFT(y); with ``head`` also
  rgb = tanh(conv3x3_{c->3}(out) + b_h) * 0.5 + 0.5.

ResBlockSFT(y) = y + conv3x3(SFT1(gelu(conv3x3(SFT0(y)) + b0))) + b1 with
SFTi(v) = v * (scale_i + 1) + shift_i per channel.

Tensors are NHWC on the fine grid: the TPU's subpixel-planar layout served
Mosaic and is not part of this contract.  Each wrapper runs its plain
PyTorch version for a tensor on the CPU and its CUDA kernel
(``ops/csrc/stage_conv.cu``, three or four launches of one fused 3x3
convolution) for a tensor on the card; on a CUDA tensor it launches or
raises, it never falls back.  ``LAUNCHES`` counts the wrapper calls that
launched the CUDA kernel.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

LAUNCHES = {"fused_upconv_rsft": 0, "fused_conv_rsft": 0}

_ACT = {"none": 0, "sin": 1, "gelu": 2, "outimg": 3}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclass(frozen=True)
class StageWeights:
    """One tail stage's parameters.  Conv weights are OHWI
    ([Cout, 3, 3, Cin], the layout the kernel reads); an upconv's 4*C output
    channels are in torch PixelShuffle order (c, r1, r2)."""
    conv_w: torch.Tensor
    conv_b: torch.Tensor
    w0: torch.Tensor
    b0: torch.Tensor
    w1: torch.Tensor
    b1: torch.Tensor
    head_w: Optional[torch.Tensor] = None
    head_b: Optional[torch.Tensor] = None

    @staticmethod
    def from_oihw(conv, rsft_conv0, rsft_conv1, head=None,
                  dtype=torch.bfloat16) -> "StageWeights":
        """From ``nn.Conv2d``-like modules (OIHW ``weight``, ``bias``)."""
        def w(m):
            return m.weight.detach().permute(0, 2, 3, 1).to(dtype).contiguous()

        def b(m):
            return m.bias.detach().to(dtype).contiguous()

        return StageWeights(
            w(conv), b(conv), w(rsft_conv0), b(rsft_conv0),
            w(rsft_conv1), b(rsft_conv1),
            w(head) if head is not None else None,
            b(head) if head is not None else None)


# --------------------------------------------------------------------- #
# plain PyTorch versions (any dtype; NHWC in and out)
# --------------------------------------------------------------------- #

def _conv(x, w_ohwi, b):
    return F.conv2d(x, w_ohwi.permute(0, 3, 1, 2), b, padding=1)


def _rsft(y, weights, sft):
    s0, h0, s1, h1 = (v.to(y.dtype)[None, :, None, None] for v in sft)
    t = F.gelu(_conv(y * (s0 + 1) + h0, weights.w0, weights.b0))
    t = t * (s1 + 1) + h1
    return y + _conv(t, weights.w1, weights.b1)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1).contiguous()


def fused_upconv_rsft_plain(x: torch.Tensor, weights: StageWeights,
                            sft: torch.Tensor) -> torch.Tensor:
    """[N, H, W, Cin] -> [N, 2H, 2W, C]; sft: [4, C] = (s0, h0, s1, h1)."""
    y = torch.sin(F.pixel_shuffle(_conv(_nchw(x), weights.conv_w,
                                        weights.conv_b), 2))
    return _nhwc(_rsft(y, weights, sft))


def fused_conv_rsft_plain(x: torch.Tensor, weights: StageWeights,
                          sft: torch.Tensor, head: bool = False
                          ) -> torch.Tensor:
    """[N, H, W, C] -> [N, H, W, C], or [N, H, W, 3] RGB with ``head``."""
    y = torch.sin(_conv(_nchw(x), weights.conv_w, weights.conv_b))
    out = _rsft(y, weights, sft)
    if head:
        out = torch.tanh(_conv(out, weights.head_w, weights.head_b)) * 0.5 + 0.5
    return _nhwc(out)


# --------------------------------------------------------------------- #
# CUDA wrappers
# --------------------------------------------------------------------- #

def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _conv3x3(lib, x, w, b, out, *, act="none", shuffle=False,
             in_affine=None, out_affine=None, residual=None):
    n, h, wd, cin = x.shape
    cout = w.shape[0]
    s_in, h_in = in_affine if in_affine is not None else (None, None)
    s_out, h_out = out_affine if out_affine is not None else (None, None)
    err = lib.bnt_stage_conv3x3(
        _ptr(x), _ptr(w), _ptr(b), _ptr(s_in), _ptr(h_in), _ptr(s_out),
        _ptr(h_out), _ptr(residual), _ptr(out), n, h, wd, cin, cout,
        _ACT[act], int(shuffle), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "stage_conv3x3 launch")


def _check_inputs(x, weights, sft, c_in, c, head, up):
    if x.dim() != 4 or x.shape[3] != c_in:
        raise ValueError(f"x must be NHWC [N, H, W, {c_in}], got "
                         f"{tuple(x.shape)}")
    shapes = {"w0": (c, 3, 3, c), "b0": (c,), "w1": (c, 3, 3, c),
              "b1": (c,)}
    if head:
        shapes.update(head_w=(3, 3, 3, c), head_b=(3,))
    for name, shape in shapes.items():
        t = getattr(weights, name)
        if t is None or tuple(t.shape) != shape:
            raise ValueError(f"weights.{name} must have shape {shape}, got "
                             f"{None if t is None else tuple(t.shape)}")
    if tuple(sft.shape) != (4, c):
        raise ValueError(f"sft must be [4, {c}], got {tuple(sft.shape)}")
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    tensors = [x, sft] + [getattr(weights, k) for k in shapes] + [
        weights.conv_w, weights.conv_b]
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"all tensors must be on {x.device}, got "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernel takes contiguous tensors")
        if t is not sft and t.dtype != torch.bfloat16:
            raise ValueError(f"the CUDA kernel takes bfloat16, got {t.dtype}")
    if sft.dtype != torch.float32:
        raise ValueError(f"sft must be float32 on the card, got {sft.dtype}")
    lib = _build.load_library()
    convs = [(c_in, 4 * c if up else c), (c, c)]
    if head:
        convs.append((c, 3))
    for cin, cout in convs:
        if lib.bnt_stage_conv3x3_smem(cin, cout) < 0:
            raise ValueError(f"a {cin}->{cout} conv does not fit the "
                             "kernel's shared-memory tile")
    return True


def _rsft_cuda(lib, y, weights, sft):
    t = torch.empty_like(y)
    _conv3x3(lib, y, weights.w0, weights.b0, t, act="gelu",
             in_affine=(sft[0], sft[1]), out_affine=(sft[2], sft[3]))
    out = torch.empty_like(y)
    _conv3x3(lib, t, weights.w1, weights.b1, out, residual=y)
    return out


def fused_upconv_rsft(x: torch.Tensor, weights: StageWeights,
                      sft: torch.Tensor) -> torch.Tensor:
    """Stride-2 stage: [N, H, W, Cin] -> [N, 2H, 2W, C].  sft: [4, C]
    (scale0, shift0, scale1, shift1), float32 on the card."""
    c4, c_in = weights.conv_w.shape[0], weights.conv_w.shape[3]
    if weights.conv_w.shape[1:3] != (3, 3) or c4 % 4 or tuple(
            weights.conv_b.shape) != (c4,):
        raise ValueError("conv_w must be [4*C, 3, 3, Cin] with a [4*C] bias")
    c = c4 // 4
    if not _check_inputs(x, weights, sft, c_in, c, head=False, up=True):
        return fused_upconv_rsft_plain(x, weights, sft)
    lib = _build.load_library()
    n, h, w, _ = x.shape
    y = torch.empty((n, 2 * h, 2 * w, c), dtype=x.dtype, device=x.device)
    _conv3x3(lib, x, weights.conv_w, weights.conv_b, y, act="sin",
             shuffle=True)
    out = _rsft_cuda(lib, y, weights, sft)
    LAUNCHES["fused_upconv_rsft"] += 1
    return out


def fused_conv_rsft(x: torch.Tensor, weights: StageWeights,
                    sft: torch.Tensor, head: bool = False) -> torch.Tensor:
    """Stride-1 stage: [N, H, W, C] -> [N, H, W, C], or with ``head`` the
    [N, H, W, 3] RGB frame in [0, 1]."""
    c = weights.conv_w.shape[0]
    if tuple(weights.conv_w.shape) != (c, 3, 3, c) or tuple(
            weights.conv_b.shape) != (c,):
        raise ValueError("conv_w must be [C, 3, 3, C] with a [C] bias")
    if not _check_inputs(x, weights, sft, c, c, head=head, up=False):
        return fused_conv_rsft_plain(x, weights, sft, head=head)
    lib = _build.load_library()
    y = torch.empty_like(x)
    _conv3x3(lib, x, weights.conv_w, weights.conv_b, y, act="sin")
    out = _rsft_cuda(lib, y, weights, sft)
    if head:
        rgb = torch.empty(x.shape[:3] + (3,), dtype=x.dtype, device=x.device)
        _conv3x3(lib, out, weights.head_w, weights.head_b, rgb, act="outimg")
        out = rgb
    LAUNCHES["fused_conv_rsft"] += 1
    return out
