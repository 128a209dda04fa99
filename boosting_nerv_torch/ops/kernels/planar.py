"""Decoder-tail stage kernels: the port of the Pallas kernels of
``boosting_nerv_tpu/ops/pallas/planar.py`` that serve HNeRV-Boost, in their
bf16 and W8A8 forms.

- ``fused_upconv_rsft`` (stride-2 stage):
  y = sin(PixelShuffle2(conv3x3(x) + b)); out = ResBlockSFT(y).
- ``fused_conv_rsft`` (stride-1 stage): y = sin(conv3x3(x) + b);
  out = ResBlockSFT(y); with ``head`` also
  rgb = tanh(conv3x3_{c->3}(out) + b_h) * 0.5 + 0.5.
- ``fused_upconv_rsft_i8`` / ``fused_conv_rsft_i8``: the same functions in
  W8A8 (``StageWeightsI8``): every conv input is quantised per channel to
  int8 codes, the weights are int8 with the activation scale folded in, and
  the int32 sums are dequantised per output channel (``quant``).  Their
  input is int8 codes (the zero-convert chain) or bf16, which the first
  launch quantises.  y stays floating point and is the residual, in bf16
  as the Pallas stride-1 kernel keeps it (planar.py:1475-1478); the Pallas
  stride-2 kernel keeps it in float32 in VMEM (:1290), which the port's
  stride-2 stage does not, as its bf16 form does not.

ResBlockSFT(y) = y + conv3x3(SFT1(gelu(conv3x3(SFT0(y)) + b0))) + b1 with
SFTi(v) = v * (scale_i + 1) + shift_i per channel.  With ``out_inv`` a
stage stores its output as int8 codes at that multiplier (the next int8
stage's input bound) instead of bf16.

The stage wrappers' tensors are NHWC on the fine grid: the TPU's
subpixel-planar layout served Mosaic and is not part of their contract.
Each wrapper runs its plain PyTorch version for a tensor on the CPU and its
CUDA kernel (three or four launches of one fused 3x3 convolution:
``ops/csrc/conv_sm90.cu`` for both bf16 wrappers, the chains
``conv_sm90.upconv_rsft`` / ``conv_rsft``; ``ops/csrc/stage_conv_i8.cu``
for W8A8) for a tensor on the card; on a CUDA tensor it launches or
raises, it never falls back.  ``LAUNCHES`` (shared with ``tile_conv``,
``conv_chw`` and ``fused_sft``) counts the wrapper calls that launched a
CUDA kernel.

The standalone planar entry points of the same Pallas module keep the
planar layout, because it is their own input and output contract:
fine (C, 2H, 2W) <-> planar (4 * Cp, H, Wd) with Cp = round16(C) and
planar[(2 * r1 + r2) * Cp + c, y, x] = fine[c, 2y + r1, 2x + r2]
(``to_planar`` / ``from_planar``, planar.py:76-91; ``upconv_kernel_to_planar``
:94 reorders a JAX-ordered upconv kernel to it).

- ``conv_planar(xp, w, b, *, c_in, c_out, wc_real, act)`` (planar.py:398):
  act(conv3x3(x) + b) of the fine tensor held in xp, none / sin / outimg /
  gelu, with the HWIO kernel [3, 3, C, Co].
- ``rsft_planar(xp, w0, b0, w1, b1, sft, *, c, hc_real, wc_real)``
  (planar.py:484): the ResBlockSFT of the fine tensor held in the first
  ``hc_real`` rows and ``wc_real`` columns of xp, HWIO kernels.

Each crops the real region to fine NHWC in torch (the Pallas kernels' own
XLA converters do the same at the tail's ends), runs the KS = 3 kernel (one
launch) or the two-launch ResBlockSFT on it, and writes the planar result.
Pad channels hold what the Pallas kernel leaves there: act(0) for
``conv_planar`` (0 for none / sin / gelu, 0.5 for outimg), xp's for
``rsft_planar``.  Pad columns and rows, which no caller reads, hold act(0)
and xp's values (the Pallas kernel leaves its convolution's edge values
there).  The Pallas ``th`` and ``interpret`` arguments are tactics and are
dropped.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional

import torch
import torch.nn.functional as F

from . import LAUNCHES, _build, conv_sm90, quant

WRAPPERS = ("fused_upconv_rsft", "fused_conv_rsft", "fused_upconv_rsft_i8",
            "fused_conv_rsft_i8")   # the stage wrappers

_ACT = conv_sm90.ACT_CODES   # bnt Act, shared by both bf16 kernels
_SIN = {"none": 0, "input": 1, "residual": 2}   # bnt::Sin
ACTS = {"none": lambda v: v, "sin": torch.sin,
        "outimg": lambda v: torch.tanh(v) * 0.5 + 0.5, "gelu": F.gelu}


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

    @property
    def rsft(self):
        """(w0, b0, w1, b1) of the stage's ResBlockSFT."""
        return self.w0, self.b0, self.w1, self.b1

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


@dataclass(frozen=True)
class StageWeightsI8:
    """One W8A8 tail stage (the port of ``prepare_conv_rsft_i8`` /
    ``prepare_upconv_rsft_i8``, planar.py:673-737): int8 OHWI weight codes
    with float32 per-output-channel dequant scales and float32 biases for
    the stage conv, conv0, conv1 and the optional head; and the float32
    quantisation multipliers of each conv's input: ``inv_x`` (the stage
    input), ``inv_t0``, ``inv_t1`` and ``inv_h`` (the head input)."""
    conv_w: torch.Tensor
    conv_scale: torch.Tensor
    conv_b: torch.Tensor
    w0: torch.Tensor
    scale0: torch.Tensor
    b0: torch.Tensor
    w1: torch.Tensor
    scale1: torch.Tensor
    b1: torch.Tensor
    inv_x: torch.Tensor
    inv_t0: torch.Tensor
    inv_t1: torch.Tensor
    head_w: Optional[torch.Tensor] = None
    head_scale: Optional[torch.Tensor] = None
    head_b: Optional[torch.Tensor] = None
    inv_h: Optional[torch.Tensor] = None

    @staticmethod
    def from_oihw(conv, rsft_conv0, rsft_conv1, head=None, *,
                  bounds: Mapping[str, torch.Tensor],
                  dtype=torch.bfloat16) -> "StageWeightsI8":
        """From ``nn.Conv2d``-like modules and the per-channel |x| bounds
        of each conv input, keyed "x", "t0", "t1" (and "h" with a head).
        The parameters are rounded to ``dtype`` first, as the serving
        decode holds them (the JAX decode quantises its bf16 tree)."""
        dev = conv.weight.device

        def fold(m, key):
            w = m.weight.detach().to(dtype).float().permute(0, 2, 3, 1)
            codes, scale = quant.fold_quant_weight(w, bounds[key])
            return (codes.contiguous(), scale.contiguous(),
                    m.bias.detach().to(dtype).float().contiguous())

        def inv(key):
            return quant.inv_from_bound(bounds[key]).to(dev).contiguous()

        hw = fold(head, "h") + (inv("h"),) if head is not None else ()
        return StageWeightsI8(
            *fold(conv, "x"), *fold(rsft_conv0, "t0"),
            *fold(rsft_conv1, "t1"), inv("x"), inv("t0"), inv("t1"), *hw)


# --------------------------------------------------------------------- #
# plain PyTorch versions (NHWC in and out)
# --------------------------------------------------------------------- #

def conv_plain(x, w_ohwi, b):
    """Same-padded k x k conv of NCHW x with an OHWI weight."""
    return F.conv2d(x, w_ohwi.permute(0, 3, 1, 2), b,
                    padding=w_ohwi.shape[1] // 2)


def rsft_plain(y, rsft_w, sft, f32_out=False):
    """ResBlockSFT of NCHW y in y's dtype; rsft_w = (w0, b0, w1, b1) OHWI;
    with ``f32_out`` the last conv and the residual sum in float32, as the
    kernel's epilogue computes them before it stores int8 codes."""
    w0, b0, w1, b1 = rsft_w
    s0, h0, s1, h1 = (v.to(y.dtype)[None, :, None, None] for v in sft)
    t = F.gelu(conv_plain(y * (s0 + 1) + h0, w0, b0))
    t = t * (s1 + 1) + h1
    if f32_out:
        return y.float() + conv_plain(t.float(), w1.float(), b1.float())
    return y + conv_plain(t, w1, b1)


def conv_act_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   act: str = "none") -> torch.Tensor:
    """NHWC [N, H, W, Cin] -> [N, H, W, Cout]: act(k x k conv + bias) with
    an OHWI weight, in x's dtype."""
    return nhwc(ACTS[act](conv_plain(nchw(x), w, b)))


def rsft_nhwc_plain(x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor,
                    w1: torch.Tensor, b1: torch.Tensor, sft: torch.Tensor,
                    input_sin: bool = False) -> torch.Tensor:
    """NHWC [N, H, W, C] -> [N, H, W, C]: the ResBlockSFT of y = sin(x)
    with ``input_sin``, else of y = x (residual y), in x's dtype."""
    y = torch.sin(x) if input_sin else x
    return nhwc(rsft_plain(nchw(y), (w0, b0, w1, b1), sft))


def nchw(x):
    return x.permute(0, 3, 1, 2)


def nhwc(x):
    return x.permute(0, 2, 3, 1).contiguous()


def _store(out, out_inv, dtype):
    """A stage's output: int8 codes at ``out_inv``, else ``dtype``."""
    if out_inv is None:
        return out.to(dtype)
    return quant.quant_act(out, out_inv)


def fused_upconv_rsft_plain(x: torch.Tensor, weights: StageWeights,
                            sft: torch.Tensor,
                            out_inv: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """[N, H, W, Cin] -> [N, 2H, 2W, C]; sft: [4, C] = (s0, h0, s1, h1)."""
    y = torch.sin(F.pixel_shuffle(conv_plain(nchw(x), weights.conv_w,
                                             weights.conv_b), 2))
    out = rsft_plain(y, weights.rsft, sft, f32_out=out_inv is not None)
    return _store(nhwc(out), out_inv, x.dtype)


def fused_conv_rsft_plain(x: torch.Tensor, weights: StageWeights,
                          sft: torch.Tensor, head: bool = False,
                          out_inv: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """[N, H, W, C] -> [N, H, W, C], or [N, H, W, 3] RGB with ``head``."""
    y = torch.sin(conv_plain(nchw(x), weights.conv_w, weights.conv_b))
    out = rsft_plain(y, weights.rsft, sft, f32_out=out_inv is not None)
    if head:
        out = torch.tanh(conv_plain(out, weights.head_w,
                                    weights.head_b)) * 0.5 + 0.5
    return _store(nhwc(out), out_inv, x.dtype)


def _conv_i8(q, codes, scale, bias):
    """int8 NHWC codes (x) int8 OHWI codes, dequantised: NHWC float32.
    The integer sum is taken in float64, which is exact for it (|sum| <
    9 * 128 * 127^2 < 2^53) on the CPU and on the card alike."""
    acc = F.conv2d(nchw(q).double(), codes.permute(0, 3, 1, 2).double(),
                   padding=1)
    return nhwc(acc).float() * scale + bias


def _codes(x, inv):
    """A stage input as int8 codes: as given (zero-convert) or quantised."""
    return x if x.dtype == torch.int8 else quant.quant_act(x, inv)


def _rsft_i8(y, w: StageWeightsI8, sft):
    """W8A8 ResBlockSFT of NHWC y: float32 y + dq(conv1(t1))."""
    s0, h0, s1, h1 = sft.float()
    yf = y.float()
    t0 = quant.quant_act(yf * (s0 + 1) + h0, w.inv_t0)
    a = F.gelu(_conv_i8(t0, w.w0, w.scale0, w.b0))
    t1 = quant.quant_act(a * (s1 + 1) + h1, w.inv_t1)
    return yf + _conv_i8(t1, w.w1, w.scale1, w.b1)


def fused_upconv_rsft_i8_plain(x: torch.Tensor, w: StageWeightsI8,
                               sft: torch.Tensor,
                               out_inv: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """W8A8 stride-2 stage: [N, H, W, Cin] int8 codes or floats ->
    [N, 2H, 2W, C] bf16, or int8 codes at ``out_inv``."""
    y = torch.sin(F.pixel_shuffle(nchw(_conv_i8(
        _codes(x, w.inv_x), w.conv_w, w.conv_scale, w.conv_b)), 2))
    y = nhwc(y).to(torch.bfloat16)
    return _store(_rsft_i8(y, w, sft), out_inv, torch.bfloat16)


def fused_conv_rsft_i8_plain(x: torch.Tensor, w: StageWeightsI8,
                             sft: torch.Tensor, head: bool = False,
                             out_inv: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """W8A8 stride-1 stage: [N, H, W, C] int8 codes or floats ->
    [N, H, W, C] bf16 (or int8 codes at ``out_inv``), or with ``head`` the
    [N, H, W, 3] bf16 RGB frame, whose input is quantised at ``inv_h``."""
    y = torch.sin(_conv_i8(_codes(x, w.inv_x), w.conv_w, w.conv_scale,
                           w.conv_b)).to(torch.bfloat16)
    out = _rsft_i8(y, w, sft)
    if head:
        hq = quant.quant_act(out, w.inv_h)
        rgb = torch.tanh(_conv_i8(hq, w.head_w, w.head_scale, w.head_b))
        return (rgb * 0.5 + 0.5).to(torch.bfloat16)
    return _store(out, out_inv, torch.bfloat16)


# --------------------------------------------------------------------- #
# CUDA wrappers
# --------------------------------------------------------------------- #

def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def launch_conv(lib, x, w, b, out, *, act="none", shuffle=False,
                in_affine=None, out_affine=None, residual=None, out_inv=None,
                sin="none"):
    """One launch of the bf16 kernel (``stage_conv.cu``): a same-padded
    k x k conv of NHWC x with the OHWI weight w [Cout, k, k, Cin].  ``sin``
    "input" stages sin(x) before the input affine, "residual" adds
    sin(residual) (k = 3 and a bf16 output only: ``stage_conv_sin.cu``)."""
    n, h, wd, cin = x.shape
    s_in, h_in = in_affine if in_affine is not None else (None, None)
    s_out, h_out = out_affine if out_affine is not None else (None, None)
    err = lib.bnt_stage_conv(
        _ptr(x), _ptr(w), _ptr(b), _ptr(s_in), _ptr(h_in), _ptr(s_out),
        _ptr(h_out), _ptr(residual), _ptr(out_inv), _ptr(out), n, h, wd, cin,
        w.shape[0], _ACT[act], int(shuffle), w.shape[1], _SIN[sin],
        _stream(x))
    _build.check(err, "stage_conv launch")


def _conv3x3_i8(lib, x, codes, scale, bias, out, *, act="none",
                shuffle=False, in_inv=None, in_affine=None, out_affine=None,
                residual=None, out_inv=None):
    n, h, wd, cin = x.shape
    s_in, h_in = in_affine if in_affine is not None else (None, None)
    s_out, h_out = out_affine if out_affine is not None else (None, None)
    err = lib.bnt_stage_conv3x3_i8(
        _ptr(x), _ptr(codes), _ptr(scale), _ptr(bias),
        None if x.dtype == torch.int8 else _ptr(in_inv), _ptr(s_in),
        _ptr(h_in), _ptr(s_out), _ptr(h_out), _ptr(residual), _ptr(out_inv),
        _ptr(out), n, h, wd, cin, codes.shape[0], _ACT[act], int(shuffle),
        int(x.dtype == torch.int8), _stream(x))
    _build.check(err, "stage_conv3x3_i8 launch")


def _check_inputs(x, sft, out_inv, c_in, c, head, tensors, x_dtypes,
                  smem_fn, convs):
    """A stage's inputs: ``check_tensors`` with the SFT vectors and the
    int8-output multiplier."""
    tensors = tensors + [("sft", sft, (4, c), torch.float32)]
    if out_inv is not None:
        if head:
            raise ValueError("the head's RGB output stays bf16: pass "
                             "out_inv or head, not both")
        tensors.append(("out_inv", out_inv, (c,), torch.float32))
    return check_tensors(x, c_in, tensors, x_dtypes, smem_fn, convs)


def check_tensors(x, c_in, tensors, x_dtypes, smem_fn, convs):
    """Shapes everywhere; on the card also device, contiguity, dtypes and
    the shared-memory fit of every conv.  ``tensors``: (name, tensor,
    shape, dtype on the card); ``convs``: the arguments of ``smem_fn(lib)``
    for each conv of the call.  True: launch the kernel; False: the input
    lies on the CPU, run the plain version."""
    if x.dim() != 4 or x.shape[3] != c_in:
        raise ValueError(f"x must be NHWC [N, H, W, {c_in}], got "
                         f"{tuple(x.shape)}")
    for name, t, shape, _ in tensors:
        if t is None or tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{None if t is None else tuple(t.shape)}")
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in x_dtypes:
        raise ValueError(f"the CUDA kernel takes x in {x_dtypes}, got "
                         f"{x.dtype}")
    for name, t, _, dtype in tensors + [("x", x, None, x.dtype)]:
        if t.device != x.device:
            raise ValueError(f"all tensors must be on {x.device}, got "
                             f"{name} on {t.device}")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernel takes contiguous tensors")
        if t.dtype != dtype:
            raise ValueError(f"the CUDA kernel takes {name} as {dtype}, got "
                             f"{t.dtype}")
    check_fit(smem_fn, convs)
    return True


def check_fit(smem_fn, convs) -> None:
    """Raise ValueError unless every conv's (Cin, Cout, ...) fits the
    shared memory of the kernel whose fit ``smem_fn(lib)`` gives."""
    smem = smem_fn(_build.load_library())
    for conv in convs:
        if smem(*conv) < 0:
            raise ValueError(f"a {conv[0]}->{conv[1]} conv does not fit the "
                             "kernel's shared-memory tile (Cin <= 128)")


def stage_smem(lib):
    """The shared-memory fit of the stage kernel (``stage_conv.cu``)."""
    return lib.bnt_stage_conv_smem


def sm90_smem(lib):
    """The shared-memory fit of the Hopper kernel (``conv_sm90.cu``)."""
    return lambda cin, cout, ks: conv_sm90.smem(lib, cin, cout, ks)


def _check_conv(x, w, b, k, ks, act, smem_fn=stage_smem):
    """``check_tensors`` for one k x k conv + act of NHWC x with the OHWI
    weight w and bias b (bf16 on the card), fitted by ``smem_fn``.  Raises
    for a k outside ``ks``, an unknown act or a weight that is not
    [Cout, k, k, Cin]."""
    if k not in ks:
        raise ValueError(f"k must be one of {ks}, got {k}")
    if act not in ACTS:
        raise ValueError(f"act must be one of {tuple(ACTS)}, got {act!r}")
    if w.dim() != 4 or tuple(w.shape[1:3]) != (k, k):
        raise ValueError(f"w must be OHWI [Cout, {k}, {k}, Cin], got "
                         f"{tuple(w.shape)}")
    cout, c_in = w.shape[0], w.shape[3]
    bf = torch.bfloat16
    return check_tensors(x, c_in, [("w", w, (cout, k, k, c_in), bf),
                                   ("b", b, (cout,), bf)], (bf,),
                         smem_fn, [(c_in, cout, k)])


def run_conv(name: str, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
             *, k: int, ks, act: str = "none") -> torch.Tensor:
    """The conv wrappers' body: act(k x k conv + bias) of NHWC x with the
    OHWI weight w, k in ``ks``; for a tensor on the card one launch of the
    bf16 kernel, counted in ``LAUNCHES[name]``, for one on the CPU the
    plain version.  Raises ValueError for a k, act or weight it does not
    take and, on the card, for a shape or type the kernel does not take."""
    if not _check_conv(x, w, b, k, ks, act):
        return conv_act_plain(x, w, b, act)
    out = torch.empty(x.shape[:3] + (w.shape[0],), dtype=x.dtype,
                      device=x.device)
    launch_conv(_build.load_library(), x, w, b, out, act=act)
    LAUNCHES[name] += 1
    return out


def _check_rsft(x, w0, b0, w1, b1, sft, smem_fn=stage_smem):
    """``check_tensors`` for a ResBlockSFT of NHWC x: w0/w1 OHWI
    [C, 3, 3, C] and b0/b1 [C] bf16, sft [4, C] float32 on the card;
    its C -> C conv fitted by ``smem_fn``."""
    c = x.shape[-1]
    bf = torch.bfloat16
    tensors = [("w0", w0, (c, 3, 3, c), bf), ("b0", b0, (c,), bf),
               ("w1", w1, (c, 3, 3, c), bf), ("b1", b1, (c,), bf),
               ("sft", sft, (4, c), torch.float32)]
    return check_tensors(x, c, tensors, (bf,), smem_fn, [(c, c, 3)])


def _stage_convs(c_in, c, up, head, *ks):
    """(Cin, Cout, *ks) of each conv of a stage."""
    return [(c_in, 4 * c if up else c, *ks), (c, c, *ks)] + (
        [(c, 3, *ks)] if head else [])


def _check_bf16(x, w: StageWeights, sft, out_inv, c_in, c, head, up):
    """``_check_inputs`` for a bf16 stage, its convs fitted by the Hopper
    kernel (``sm90_smem``)."""
    bf = torch.bfloat16
    tensors = [("weights.conv_w", w.conv_w, (4 * c if up else c, 3, 3, c_in),
                bf), ("weights.conv_b", w.conv_b, (4 * c if up else c,), bf),
               ("weights.w0", w.w0, (c, 3, 3, c), bf),
               ("weights.b0", w.b0, (c,), bf),
               ("weights.w1", w.w1, (c, 3, 3, c), bf),
               ("weights.b1", w.b1, (c,), bf)]
    if head:
        tensors += [("weights.head_w", w.head_w, (3, 3, 3, c), bf),
                    ("weights.head_b", w.head_b, (3,), bf)]
    return _check_inputs(x, sft, out_inv, c_in, c, head, tensors, (bf,),
                         sm90_smem, _stage_convs(c_in, c, up, head, 3))


def _check_i8(x, w: StageWeightsI8, sft, out_inv, c_in, c, head, up):
    i8, f32 = torch.int8, torch.float32
    cout = 4 * c if up else c
    tensors = [("w.conv_w", w.conv_w, (cout, 3, 3, c_in), i8),
               ("w.conv_scale", w.conv_scale, (cout,), f32),
               ("w.conv_b", w.conv_b, (cout,), f32),
               ("w.inv_x", w.inv_x, (c_in,), f32)]
    for k in ("0", "1"):
        tensors += [(f"w.w{k}", getattr(w, "w" + k), (c, 3, 3, c), i8),
                    (f"w.scale{k}", getattr(w, "scale" + k), (c,), f32),
                    (f"w.b{k}", getattr(w, "b" + k), (c,), f32),
                    (f"w.inv_t{k}", getattr(w, "inv_t" + k), (c,), f32)]
    if head:
        tensors += [("w.head_w", w.head_w, (3, 3, 3, c), i8),
                    ("w.head_scale", w.head_scale, (3,), f32),
                    ("w.head_b", w.head_b, (3,), f32),
                    ("w.inv_h", w.inv_h, (c,), f32)]
    return _check_inputs(x, sft, out_inv, c_in, c, head, tensors,
                         (torch.int8, torch.bfloat16),
                         lambda lib: lib.bnt_stage_conv3x3_i8_smem,
                         _stage_convs(c_in, c, up, head))


def _channels(conv_w, up):
    """(C_in, C) of a stage from its conv weight [Cout, 3, 3, Cin]."""
    if conv_w.dim() != 4 or conv_w.shape[1:3] != (3, 3) or (
            up and conv_w.shape[0] % 4):
        raise ValueError("conv_w must be [C or 4*C, 3, 3, Cin], got "
                         f"{tuple(conv_w.shape)}")
    cout, c_in = conv_w.shape[0], conv_w.shape[3]
    return c_in, cout // 4 if up else cout


def _out(x, shape, out_inv):
    return torch.empty(shape, dtype=torch.int8 if out_inv is not None
                       else torch.bfloat16, device=x.device)


def rsft_cuda(lib, y, rsft_w, sft, out_inv=None, input_sin=False):
    """ResBlockSFT of NHWC y in two launches: t = SFT1(gelu(conv0(SFT0(y))
    + b0)), then y + conv1(t) + b1; rsft_w = (w0, b0, w1, b1) OHWI.  With
    ``input_sin`` the block input is sin(y): conv0 stages it and conv1 adds
    it as its residual (bf16 output only)."""
    w0, b0, w1, b1 = rsft_w
    t = torch.empty_like(y)
    launch_conv(lib, y, w0, b0, t, act="gelu", in_affine=(sft[0], sft[1]),
                out_affine=(sft[2], sft[3]),
                sin="input" if input_sin else "none")
    out = _out(y, y.shape, out_inv)
    launch_conv(lib, t, w1, b1, out, residual=y, out_inv=out_inv,
                sin="residual" if input_sin else "none")
    return out


def run_rsft(name: str, x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor,
             w1: torch.Tensor, b1: torch.Tensor, sft: torch.Tensor, *,
             input_sin: bool = False) -> torch.Tensor:
    """The ResBlockSFT wrappers' body (``rsft_nhwc_plain``'s function): for
    a tensor on the card the two launches of ``rsft_cuda``, counted once in
    ``LAUNCHES[name]``, for one on the CPU the plain version.  Raises
    ValueError for weights, biases or SFT vectors of the wrong shape and,
    on the card, for a shape or type the kernel does not take."""
    if not _check_rsft(x, w0, b0, w1, b1, sft):
        return rsft_nhwc_plain(x, w0, b0, w1, b1, sft, input_sin)
    out = rsft_cuda(_build.load_library(), x, (w0, b0, w1, b1), sft,
                    input_sin=input_sin)
    LAUNCHES[name] += 1
    return out


def fused_upconv_rsft(x: torch.Tensor, weights: StageWeights,
                      sft: torch.Tensor,
                      out_inv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stride-2 stage: [N, H, W, Cin] -> [N, 2H, 2W, C] bf16, or int8
    codes at ``out_inv`` ([C] float32).  sft: [4, C] (scale0, shift0,
    scale1, shift1), float32 on the card."""
    c_in, c = _channels(weights.conv_w, up=True)
    if not _check_bf16(x, weights, sft, out_inv, c_in, c, False, True):
        return fused_upconv_rsft_plain(x, weights, sft, out_inv)
    out = conv_sm90.upconv_rsft(conv_sm90.cuda_conv(_build.load_library()),
                                x, weights, sft, out_inv)
    LAUNCHES["fused_upconv_rsft"] += 1
    return out


def fused_conv_rsft(x: torch.Tensor, weights: StageWeights,
                    sft: torch.Tensor, head: bool = False,
                    out_inv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stride-1 stage: [N, H, W, C] -> [N, H, W, C] bf16 (or int8 codes at
    ``out_inv``), or with ``head`` the [N, H, W, 3] RGB frame in [0, 1]."""
    c_in, c = _channels(weights.conv_w, up=False)
    if not _check_bf16(x, weights, sft, out_inv, c_in, c, head, False):
        return fused_conv_rsft_plain(x, weights, sft, head=head,
                                     out_inv=out_inv)
    out = conv_sm90.conv_rsft(conv_sm90.cuda_conv(_build.load_library()),
                              x, weights, sft, head, out_inv)
    LAUNCHES["fused_conv_rsft"] += 1
    return out


def _rsft_i8_cuda(lib, y, w: StageWeightsI8, sft, out_inv):
    t = torch.empty(y.shape, dtype=torch.int8, device=y.device)
    _conv3x3_i8(lib, y, w.w0, w.scale0, w.b0, t, act="gelu", in_inv=w.inv_t0,
                in_affine=(sft[0], sft[1]), out_affine=(sft[2], sft[3]),
                out_inv=w.inv_t1)
    out = _out(y, y.shape, out_inv)
    _conv3x3_i8(lib, t, w.w1, w.scale1, w.b1, out, residual=y,
                out_inv=out_inv)
    return out


def fused_upconv_rsft_i8(x: torch.Tensor, w: StageWeightsI8,
                         sft: torch.Tensor,
                         out_inv: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """W8A8 stride-2 stage: [N, H, W, Cin] int8 codes at ``w.inv_x`` or
    bf16 -> [N, 2H, 2W, C] bf16, or int8 codes at ``out_inv``."""
    c_in, c = _channels(w.conv_w, up=True)
    if not _check_i8(x, w, sft, out_inv, c_in, c, False, True):
        return fused_upconv_rsft_i8_plain(x, w, sft, out_inv)
    lib = _build.load_library()
    n, h, wd, _ = x.shape
    y = torch.empty((n, 2 * h, 2 * wd, c), dtype=torch.bfloat16,
                    device=x.device)
    _conv3x3_i8(lib, x, w.conv_w, w.conv_scale, w.conv_b, y, act="sin",
                shuffle=True, in_inv=w.inv_x)
    out = _rsft_i8_cuda(lib, y, w, sft, out_inv)
    LAUNCHES["fused_upconv_rsft_i8"] += 1
    return out


def fused_conv_rsft_i8(x: torch.Tensor, w: StageWeightsI8,
                       sft: torch.Tensor, head: bool = False,
                       out_inv: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """W8A8 stride-1 stage: [N, H, W, C] int8 codes at ``w.inv_x`` or bf16
    -> [N, H, W, C] bf16 (or int8 codes at ``out_inv``), or with ``head``
    the [N, H, W, 3] bf16 RGB frame."""
    c_in, c = _channels(w.conv_w, up=False)
    if not _check_i8(x, w, sft, out_inv, c_in, c, head, False):
        return fused_conv_rsft_i8_plain(x, w, sft, head=head,
                                        out_inv=out_inv)
    lib = _build.load_library()
    y = torch.empty(x.shape[:3] + (c,), dtype=torch.bfloat16,
                    device=x.device)
    _conv3x3_i8(lib, x, w.conv_w, w.conv_scale, w.conv_b, y, act="sin",
                in_inv=w.inv_x)
    if head:
        hq = _rsft_i8_cuda(lib, y, w, sft, w.inv_h)
        out = torch.empty(x.shape[:3] + (3,), dtype=torch.bfloat16,
                          device=x.device)
        _conv3x3_i8(lib, hq, w.head_w, w.head_scale, w.head_b, out,
                    act="outimg")
    else:
        out = _rsft_i8_cuda(lib, y, w, sft, out_inv)
    LAUNCHES["fused_conv_rsft_i8"] += 1
    return out


# --------------------------------------------------------------------- #
# standalone planar entry points (planar layout in and out)
# --------------------------------------------------------------------- #

def _round16(c: int) -> int:
    return (c + 15) // 16 * 16


def to_planar(x: torch.Tensor, cp: Optional[int] = None) -> torch.Tensor:
    """fine (C, 2H, 2W) -> planar (4 * Cp, H, W), pad channels zero."""
    c, h2, w2 = x.shape
    cp = _round16(c) if cp is None else cp
    x = x.reshape(c, h2 // 2, 2, w2 // 2, 2).permute(2, 4, 0, 1, 3)
    x = F.pad(x, (0, 0, 0, 0, 0, cp - c))
    return x.reshape(4 * cp, h2 // 2, w2 // 2)


def from_planar(xp: torch.Tensor, c: int) -> torch.Tensor:
    """planar (4 * Cp, H, W) -> fine (C, 2H, 2W)."""
    g, h, w = xp.shape
    x = xp.reshape(2, 2, g // 4, h, w)[:, :, :c]
    return x.permute(2, 3, 0, 4, 1).reshape(c, 2 * h, 2 * w)


def upconv_kernel_to_planar(kernel: torch.Tensor,
                            cp: Optional[int] = None) -> torch.Tensor:
    """HWIO (kh, kw, Cin, 4 * C) upconv kernel whose output channels are in
    the JAX PixelShuffle packing (r1, r2, c) -> (kh, kw, Cin, 4 * Cp) in the
    planar row order (plane-major, each plane zero-padded to Cp)."""
    kh, kw, cin, co4 = kernel.shape
    c = co4 // 4
    cp = _round16(c) if cp is None else cp
    k = F.pad(kernel.reshape(kh, kw, cin, 4, c), (0, cp - c))
    return k.reshape(kh, kw, cin, 4 * cp)


def _check_planar(xp, c, wc_real, hc_real=None):
    """xp (4 * round16(c), Hc, Wd) with Wd a power of two >= 128 and a real
    region hc_real (default Hc) x wc_real inside it (the Pallas asserts)."""
    if xp.dim() != 3:
        raise ValueError(f"xp must be planar (4 * Cp, Hc, Wd), got "
                         f"{tuple(xp.shape)}")
    g, hc, wd = xp.shape
    if wd < 128 or wd & (wd - 1):
        raise ValueError(f"the planar width Wd must be a power of two >= "
                         f"128, got {wd}")
    if g != 4 * _round16(c):
        raise ValueError(f"xp must have 4 * round16({c}) = "
                         f"{4 * _round16(c)} rows, got {g}")
    hc_real = hc if hc_real is None else hc_real
    if not (0 < hc_real <= hc and 0 < wc_real <= wd):
        raise ValueError(f"the real region {hc_real} x {wc_real} must lie "
                         f"inside the planar {hc} x {wd}")
    return hc_real


def _fine(xp, c, hc_real, wc_real):
    """The real region of planar xp as fine NHWC [1, 2 hc, 2 wc, C]."""
    return nhwc(from_planar(xp[:, :hc_real, :wc_real], c)[None])


def _put_planar(out, y):
    """Write fine NHWC y [1, 2 hc, 2 wc, C] into the real channels, rows and
    columns of planar ``out``."""
    _, h2, w2, c = y.shape
    g, hc, wd = out.shape
    planes = out.view(2, 2, g // 4, hc, wd)[:, :, :c, :h2 // 2, :w2 // 2]
    planes.copy_(y[0].view(h2 // 2, 2, w2 // 2, 2, c).permute(1, 3, 4, 0, 2))
    return out


def _hwio_to_ohwi(w, c_in, c_out):
    if tuple(w.shape) != (3, 3, c_in, c_out):
        raise ValueError(f"the kernel must be HWIO (3, 3, {c_in}, {c_out}), "
                         f"got {tuple(w.shape)}")
    return w.permute(3, 0, 1, 2).contiguous()


def _conv_planar(xp, w, b, c_in, c_out, wc_real, act, plain):
    hc = _check_planar(xp, c_in, wc_real)
    if act not in ACTS:
        raise ValueError(f"act must be one of {tuple(ACTS)}, got {act!r}")
    x = _fine(xp, c_in, hc, wc_real)
    w = _hwio_to_ohwi(w, c_in, c_out)
    y = (conv_act_plain(x, w, b, act) if plain else
         run_conv("conv_planar", x, w, b, k=3, ks=(3,), act=act))
    fill = float(ACTS[act](torch.zeros(())))
    out = torch.full((4 * _round16(c_out), hc, xp.shape[2]), fill,
                     dtype=y.dtype, device=y.device)
    return _put_planar(out, y)


def conv_planar_plain(xp: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                      c_in: int, c_out: int, wc_real: int,
                      act: str = "none") -> torch.Tensor:
    """``conv_planar`` in plain PyTorch."""
    return _conv_planar(xp, w, b, c_in, c_out, wc_real, act, plain=True)


def conv_planar(xp: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                c_in: int, c_out: int, wc_real: int,
                act: str = "none") -> torch.Tensor:
    """3x3 same conv + bias + act of the fine tensor held in planar xp
    (4 * round16(c_in), Hc, Wd), real columns < wc_real: HWIO w
    [3, 3, c_in, c_out], b [c_out] (bf16 on the card) -> planar
    (4 * round16(c_out), Hc, Wd) in xp's dtype."""
    return _conv_planar(xp, w, b, c_in, c_out, wc_real, act, plain=False)


def _rsft_planar(xp, w0, b0, w1, b1, sft, c, hc_real, wc_real, plain):
    _check_planar(xp, c, wc_real, hc_real)
    x = _fine(xp, c, hc_real, wc_real)
    w0, w1 = _hwio_to_ohwi(w0, c, c), _hwio_to_ohwi(w1, c, c)
    y = (rsft_nhwc_plain(x, w0, b0, w1, b1, sft) if plain else
         run_rsft("rsft_planar", x, w0, b0, w1, b1, sft))
    return _put_planar(xp.clone(memory_format=torch.contiguous_format), y)


def rsft_planar_plain(xp: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor,
                      w1: torch.Tensor, b1: torch.Tensor, sft: torch.Tensor,
                      *, c: int, hc_real: int, wc_real: int) -> torch.Tensor:
    """``rsft_planar`` in plain PyTorch."""
    return _rsft_planar(xp, w0, b0, w1, b1, sft, c, hc_real, wc_real,
                        plain=True)


def rsft_planar(xp: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor,
                w1: torch.Tensor, b1: torch.Tensor, sft: torch.Tensor, *,
                c: int, hc_real: int, wc_real: int) -> torch.Tensor:
    """ResBlockSFT of the fine tensor held in the first hc_real rows and
    wc_real columns of planar xp (4 * round16(c), Hc, Wd): HWIO w0/w1
    [3, 3, c, c], b0/b1 [c] (bf16 on the card), sft [4, c] float32
    (scale0, shift0, scale1, shift1) -> planar, xp's shape and dtype."""
    return _rsft_planar(xp, w0, b0, w1, b1, sft, c, hc_real, wc_real,
                        plain=False)
