"""Host side of the Hopper bf16 conv kernel (``ops/csrc/conv_sm90.cu``),
which serves ``tile_conv.conv_tile`` and ``planar.fused_upconv_rsft``.

What the kernel needs from Python is plain torch and lives here:

- the N-slice plan: ``slice_width(cout)`` picks the wgmma N (one of
  ``NS_CHOICES``, the kernel's instances) that wastes the fewest padded
  channels, counting 16 channels of overhead per slice (51 -> 56,
  61 -> 64, 73 -> 80, 204 -> 3 x 80, 244 -> 4 x 64, 3 -> 8); ``plan``
  takes the first width in that order whose launch fits the shared memory
  (a 5 x 5 conv of 128 channels to 80 fits only at N 8);
- the weight packing: ``pack_weight`` turns an OHWI weight into the
  kernel's B layout, one block per (N slice, tap), each k16 step of a
  block NS x 16 as 8 x 8 core matrices ([NS/8][2][8][8], no swizzle), the
  layout its wgmma descriptor reads (``b_offsets``); ``packed`` caches it
  per weight tensor;
- ``emulate``: the kernel's function computed the kernel's way, for the
  CPU tests: each 4 x 64 output tile's input rows staged as 16-byte-widened
  flat spans and repacked (prologue on in-image taps only) into the
  operand tile [8-channel group][pixel][8] (``group_stride`` pixels per
  group), the GEMM's A read from it through ``a_offsets`` at each tap's
  pixel shift and its B from the packed blocks through ``b_offsets``, then
  the epilogue.

``launch`` is one kernel launch; ``upconv_rsft`` the three launches of
the stride-2 stage, with a launch or ``emulate`` as its conv.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build, quant

NS_CHOICES = (8, 56, 64, 80)       # the kernel's instances (conv_sm90.cu)
TH, TW = 4, 64                     # output tile (rows, columns)
ACT_CODES = {"none": 0, "sin": 1, "gelu": 2, "outimg": 3}

def slice_widths(cout: int) -> list:
    """The N slice widths for ``cout`` channels, best first."""
    return sorted(NS_CHOICES, key=lambda ns: (-(-cout // ns) * (ns + 16), -ns))


def slice_width(cout: int) -> int:
    """Output channels per N slice for ``cout`` channels."""
    return slice_widths(cout)[0]


@functools.lru_cache(maxsize=None)
def plan(lib, cin: int, cout: int, ks: int) -> Tuple[int, int]:
    """(slice width, shared-memory bytes) of a launch: the first width of
    ``slice_widths(cout)`` whose launch fits, or (0, -1) where none does."""
    for ns in slice_widths(cout):
        smem = lib.bnt_conv_sm90_smem(cin, cout, ks, ns)
        if smem >= 0:
            return ns, smem
    return 0, -1


def cin_pad(cin: int) -> int:
    return -(-cin // 16) * 16


def pack_weight(w: torch.Tensor, ns: int) -> torch.Tensor:
    """OHWI [Cout, k, k, Cin] -> the flat packed B operand:
    [slice][tap][k16 step][NS/8][2][8][8], zero beyond Cout and Cin."""
    cout, k, _, cin = w.shape
    nsl, cp = -(-cout // ns), cin_pad(cin)
    wp = torch.zeros((nsl * ns, k * k, cp), dtype=w.dtype, device=w.device)
    wp[:cout, :, :cin] = w.reshape(cout, k * k, cin)
    wp = wp.reshape(nsl, ns // 8, 8, k * k, cp // 16, 2, 8)
    return wp.permute(0, 3, 4, 1, 5, 2, 6).contiguous().reshape(-1)


def packed(w: torch.Tensor, ns: int) -> torch.Tensor:
    """``pack_weight(w, ns)``, cached on the tensor (and repacked after an
    in-place change of w)."""
    hit = getattr(w, "_conv_sm90_packed", None)
    if hit is None or hit[:2] != (w._version, ns):
        hit = (w._version, ns, pack_weight(w, ns))
        w._conv_sm90_packed = hit
    return hit[2]


def b_offsets(ns: int) -> torch.Tensor:
    """[ns, 16] element offsets, within one k16 step of a packed block, of
    B[n, k]: core matrix (n // 8, k // 8) at (n // 8) * 256 + (k // 8) *
    128 bytes (the descriptor's stride and leading byte offsets), row n % 8
    at 16 bytes, element k % 8 at 2."""
    n = torch.arange(ns)[:, None]
    q = torch.arange(16)[None, :]
    return (n // 8) * 128 + (q // 8) * 64 + (n % 8) * 8 + q % 8


def group_stride(k: int) -> int:
    """Pixels between 8-channel groups of the operand tile: its pixel count
    rounded to 1 modulo 8 (conv_sm90.cuh::group_stride)."""
    return (TH + k - 1) * (TW + k - 1) // 8 * 8 + 9


def a_offsets(gs: int) -> torch.Tensor:
    """[64, 16] element offsets, from an m64 tile's first pixel within one
    k16 step of the operand tile, of A[i, k]: core matrix (i // 8, k // 8)
    at (i // 8) * 128 + (k // 8) * gs * 16 bytes (the descriptor's stride
    and leading byte offsets), pixel i % 8 at 16 bytes, element k % 8 at
    2."""
    i = torch.arange(64)[:, None]
    q = torch.arange(16)[None, :]
    return (i // 8) * 64 + (q // 8) * gs * 8 + (i % 8) * 8 + q % 8


def smem(lib, cin: int, cout: int, ks: int) -> int:
    """Shared memory of one launch, or -1 for a shape it does not take."""
    return plan(lib, cin, cout, ks)[1]


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def launch(lib, x, w, b, out, *, act="none", shuffle=False, in_affine=None,
           out_affine=None, residual=None, out_inv=None) -> None:
    """One launch: a same-padded k x k conv of NHWC bf16 x with the OHWI
    weight w [Cout, k, k, Cin] into ``out`` (see conv_sm90.cu)."""
    n, h, wd, cin = x.shape
    ns = plan(lib, cin, w.shape[0], w.shape[1])[0]
    s_in, h_in = in_affine if in_affine is not None else (None, None)
    s_out, h_out = out_affine if out_affine is not None else (None, None)
    err = lib.bnt_conv_sm90(
        _ptr(x), _ptr(packed(w, ns)), _ptr(b), _ptr(s_in), _ptr(h_in),
        _ptr(s_out), _ptr(h_out), _ptr(residual), _ptr(out_inv), _ptr(out),
        n, h, wd, cin, w.shape[0], ACT_CODES[act], int(shuffle), w.shape[1],
        ns, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "conv_sm90 launch")


def _stage_tile(virt, base, shape, b, ty0, tx0, k, in_mul, in_add):
    """The flat operand tile [cin_pad / 8][group_stride(k)][8] (bf16
    values) of the output tile at (ty0, tx0) of image b, staged from the
    16-byte-widened flat span of each in-image row of ``virt`` (x flat,
    ``base`` elements after a 16-byte boundary, NaN elsewhere)."""
    _, h, w, c = shape
    halo, ph, pw = (k - 1) // 2, TH + k - 1, TW + k - 1
    xs, xe = max(tx0 - halo, 0), min(tx0 - halo + pw, w)
    tile = torch.zeros((ph, pw, cin_pad(c)))
    for r in range(ph):
        iy = ty0 - halo + r
        if not 0 <= iy < h:
            continue
        row = (b * h + iy) * w
        a0, a1 = base + (row + xs) * c, base + (row + xe) * c
        lo, hi = a0 // 8 * 8, -(-a1 // 8) * 8
        raw = virt[lo:hi]
        span = raw[a0 - lo:a0 - lo + (xe - xs) * c].reshape(xe - xs, c)
        col = xs - (tx0 - halo)
        tile[r, col:col + xe - xs, :c] = span * in_mul + in_add
    flat = torch.zeros((cin_pad(c) // 8, group_stride(k), 8))
    flat[:, :ph * pw] = tile.reshape(ph * pw, -1, 8).transpose(0, 1)
    return flat.to(torch.bfloat16).float().reshape(-1)


def emulate(x: torch.Tensor, wpk: torch.Tensor, b: torch.Tensor, *,
            cout: int, k: int, act: str = "none", shuffle: bool = False,
            in_affine=None, out_affine=None, residual=None, out_inv=None
            ) -> torch.Tensor:
    """The kernel's output for NHWC x and the packed weight ``wpk``
    (``pack_weight(w, slice_width(cout))``), computed as the kernel does
    on a CPU tensor: bf16, or int8 codes at ``out_inv``."""
    from .planar import ACTS

    n, h, w, c = x.shape
    ns, cp, pw, gs = slice_width(cout), cin_pad(c), TW + k - 1, group_stride(k)
    nsl = -(-cout // ns)
    base = (x.data_ptr() % 16) // 2
    virt = torch.full((base + x.numel() + 8,), float("nan"))
    virt[base:base + x.numel()] = x.reshape(-1).float()
    if in_affine is not None:
        in_mul, in_add = in_affine[0].float() + 1, in_affine[1].float()
    else:
        in_mul, in_add = torch.ones(c), torch.zeros(c)
    wf, a_offs, b_offs = wpk.float(), a_offsets(gs), b_offsets(ns)
    acc = torch.zeros((n, -(-h // TH) * TH, -(-w // TW) * TW, nsl * ns))
    for bi in range(n):
        for ty0 in range(0, h, TH):
            for tx0 in range(0, w, TW):
                tile = _stage_tile(virt, base, x.shape, bi, ty0, tx0, k,
                                   in_mul, in_add)
                for s in range(nsl):
                    for tap in range(k * k):
                        dy, dx = divmod(tap, k)
                        blk = (s * k * k + tap) * ns * cp
                        for kk in range(cp // 16):
                            bmat = wf[blk + kk * ns * 16 + b_offs]
                            for r in range(TH):  # one m64 tile a row
                                p0 = (r + dy) * pw + dx
                                a = tile[(p0 + 2 * kk * gs) * 8 + a_offs]
                                acc[bi, ty0 + r, tx0:tx0 + TW,
                                    s * ns:(s + 1) * ns] += a @ bmat.T
    v = ACTS[act](acc[:, :h, :w, :cout] + b.float())
    if out_affine is not None:
        v = v * (out_affine[0].float() + 1) + out_affine[1].float()
    if shuffle:
        v = F.pixel_shuffle(v.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    if residual is not None:
        v = v + residual.float()
    if out_inv is not None:
        return quant.quant_act(v, out_inv)
    return v.to(torch.bfloat16)


Conv = Callable[..., torch.Tensor]


def cuda_conv(lib) -> Conv:
    """A conv of ``upconv_rsft``'s form that launches the kernel."""
    def conv(x, w, b, shape, **kw):
        dtype = torch.bfloat16 if kw.get("out_inv") is None else torch.int8
        out = torch.empty(shape, dtype=dtype, device=x.device)
        launch(lib, x, w, b, out, **kw)
        return out
    return conv


def emulated_conv(x, w, b, shape, **kw) -> torch.Tensor:
    """A conv of ``upconv_rsft``'s form computed by ``emulate``."""
    return emulate(x, pack_weight(w, slice_width(w.shape[0])), b,
                   cout=w.shape[0], k=w.shape[1], **kw)


def upconv_rsft(conv: Conv, x, weights, sft, out_inv=None) -> torch.Tensor:
    """The stride-2 stage as three convs: y = sin(PixelShuffle2(conv(x) +
    b)); t = SFT1(gelu(conv0(SFT0(y)) + b0)); y + conv1(t) + b1, stored
    bf16 or as int8 codes at ``out_inv``."""
    n, h, wd, _ = x.shape
    c = weights.w0.shape[0]
    y = conv(x, weights.conv_w, weights.conv_b, (n, 2 * h, 2 * wd, c),
             act="sin", shuffle=True)
    t = conv(y, weights.w0, weights.b0, y.shape, act="gelu",
             in_affine=(sft[0], sft[1]), out_affine=(sft[2], sft[3]))
    return conv(t, weights.w1, weights.b1, y.shape, residual=y,
                out_inv=out_inv)
