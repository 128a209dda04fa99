"""Measurement probes of the port's conv kernels: the port of the Pallas
kernels of the repository's ``tools/`` (the TPU probes that split the stage
kernels' time into phases, timed the dot ceiling and the K-buffer builds),
and the same phase knockouts of the Hopper kernel.  Five wrappers, each on
its own CUDA units of ``ops/csrc``, each beside its plain PyTorch version:

- ``stage_conv_probe`` (``stage_conv_probe.cu``): one 3x3 launch of the
  bf16 stage kernel with a probe's ``phases`` ("all", or one of "nostage",
  "nogemm", "noepi", "nostore" knocked out) and ``staging`` ("smem", the
  production tile; "direct", A fragments from device memory; "unmasked",
  the input affine on padding taps too).
- ``stage_conv_i8_probe`` (``stage_conv_i8_probe.cu``): the same for the
  W8A8 kernel, with ``staging`` "smem", "pack" (four codes a 32-bit
  shared-memory store) or "async" (cp.async; an int8-code input whose
  channels are padded to a multiple of 32).
- ``gemm_probe`` (``gemm_probe.cu``): the stage kernels' fragment loop on
  operands resident in shared memory, ``reps`` times: the tensor-core
  ceiling of their inner loop.
- ``stage_build_probe`` (``stage_build_probe.cu``): the staging of the
  input tiles alone ("f32", "raw16", "i8", "i8_pack").
- ``conv_sm90_probe`` (K5, ``conv_sm90_probe.cu`` and the per-N units
  ``conv_sm90_probe_56.cu``, ``_64.cu``, ``_80.cu``): one 3x3 launch of
  the Hopper kernel ``conv_sm90.cu`` with a probe's ``phases``, where
  "nostage" knocks out the consumers' repack into the operand tile; with
  int8 weight codes the same on its int8 form (``conv_sm90_i8.cu``'s
  instances: ``conv_sm90_i8_probe.cu`` and ``_64.cu``, ``_64q.cu``,
  ``_80.cu``), which the int8 stage chains ``conv_rsft_i8_probe`` /
  ``upconv_rsft_i8_probe`` take with ``sm90``.

What each knockout computes, so that it is checked and not only timed:
no STAGE stages zeros and no GEMM multiplies by zero weights (both give
the epilogue of a zero sum); no EPI stores the raw sum (a bias-free conv,
no activation, affine or residual); no STORE leaves ``out`` as it was
(the wrappers fill a new output with ``SENTINEL`` when the store is off).
"all", "direct" and "pack" / "async" compute the production launch's
function (``planar.launch_conv``, the int8 launch, ``conv_sm90.launch``),
bit for bit on the card.  ``conv_rsft_probe`` and ``conv_rsft_i8_probe``
chain the launches of a stride-1 stage, with the same probe mode on every
launch; with "all" they equal, bit for bit, the same chain on the
production instances: ``conv_rsft_stage`` (the stage kernel, K1),
``planar.fused_conv_rsft`` (the Hopper kernel, K5) and
``conv_rsft_i8_stage`` (the W8A8 stage kernel, K2; the chain the W8A8
wrappers ran before they moved onto ``conv_sm90_i8.cu``).

Each wrapper runs its plain version for a tensor on the CPU and launches
its kernel for one on the card, or raises ValueError; it never falls back.
``LAUNCHES`` counts the wrapper calls that launched (one per launch).
``boosting_nerv_torch/tools/probes.py`` registers which probe answers
which TPU probe, times them and prints the breakdown.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import LAUNCHES, _build, conv_sm90, quant
from .planar import (_ACT, ACTS, StageWeights, StageWeightsI8, _ptr, _stream,
                     check_tensors, launch_conv, nchw, nhwc, rsft_cuda,
                     sm90_smem)

STAGE, GEMM, EPI, STORE = 1, 2, 4, 8          # Phase (stage_common.cuh)
ALL = STAGE | GEMM | EPI | STORE
PHASES = {"all": ALL, "nostage": ALL & ~STAGE, "nogemm": ALL & ~GEMM,
          "noepi": ALL & ~EPI, "nostore": ALL & ~STORE}
STAGING = {"smem": 0, "direct": 16, "unmasked": 32}      # bnt::Staging
STAGING_I8 = {"smem": 0, "pack": 16, "async": 32}        # StagingI8
BUILD_MODES = {"f32": 0, "raw16": 1, "i8": 2, "i8_pack": 3}
SENTINEL = {torch.bfloat16: 3.0, torch.int8: 77}
IN_H, IN_W = 6, 34      # the halo tile of a 4 x 32 output tile (3x3 taps)


def _mask(phases: str, staging: str, modes) -> int:
    if phases not in PHASES:
        raise ValueError(f"phases must be one of {tuple(PHASES)}, got "
                         f"{phases!r}")
    if staging not in modes:
        raise ValueError(f"staging must be one of {tuple(modes)}, got "
                         f"{staging!r}")
    if staging != "smem" and phases != "all":
        raise ValueError("a staging mode other than smem runs every phase")
    return PHASES[phases] | modes[staging]


def _out(x, shape, dtype, mask, out):
    """The launch's output: ``out`` as given, else a new tensor, filled
    with SENTINEL where the store is off (it is then the result)."""
    if out is not None:
        return out
    if mask & STORE:
        return torch.empty(shape, dtype=dtype, device=x.device)
    return torch.full(shape, SENTINEL[dtype], dtype=dtype, device=x.device)


def _out_shape(x, cout, shuffle):
    n, h, w, _ = x.shape
    return (n, 2 * h, 2 * w, cout // 4) if shuffle else (n, h, w, cout)


def _affine(v, aff, dtype):
    """v * (scale + 1) + shift per channel of NCHW v, vectors in dtype."""
    s, h = (t.to(dtype)[None, :, None, None] for t in aff)
    return v * (s + 1) + h


def _vectors(name, aff, c):
    return [] if aff is None else [
        (f"{name}[{i}]", t, (c,), torch.float32) for i, t in enumerate(aff)]


# --------------------------------------------------------------------- #
# K1: the bf16 stage kernel
# --------------------------------------------------------------------- #

def stage_conv_probe_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                           *, act: str = "none", shuffle: bool = False,
                           in_affine=None, out_affine=None, residual=None,
                           phases: str = "all", staging: str = "smem",
                           out: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """``stage_conv_probe`` in plain PyTorch, in x's dtype: with "all" the
    function of ``planar.launch_conv`` as the stage wrappers' plain
    versions compute it (``planar.rsft_plain``)."""
    mask = _mask(phases, staging, STAGING)
    out = _out(x, _out_shape(x, w.shape[0], shuffle), x.dtype, mask, out)
    if not mask & STORE:
        return out
    xs, pad = nchw(x), 1
    if not mask & STAGE:
        xs = torch.zeros_like(xs)
    elif in_affine is not None and mask & STAGING["unmasked"]:
        xs, pad = _affine(F.pad(xs, (1, 1, 1, 1)), in_affine, x.dtype), 0
    elif in_affine is not None:
        xs = _affine(xs, in_affine, x.dtype)
    wk = (w if mask & GEMM else torch.zeros_like(w)).permute(0, 3, 1, 2)
    y = F.conv2d(xs, wk, b if mask & EPI else None, padding=pad)
    if mask & EPI:
        y = ACTS[act](y)
        if out_affine is not None:
            y = _affine(y, out_affine, x.dtype)
    if shuffle:
        y = F.pixel_shuffle(y, 2)
    if mask & EPI and residual is not None:
        y = nchw(residual) + y
    return out.copy_(nhwc(y))


def stage_conv_probe(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                     act: str = "none", shuffle: bool = False,
                     in_affine: Optional[Tuple[torch.Tensor, ...]] = None,
                     out_affine: Optional[Tuple[torch.Tensor, ...]] = None,
                     residual: Optional[torch.Tensor] = None,
                     phases: str = "all", staging: str = "smem",
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One 3x3 launch of the bf16 stage kernel (``planar.launch_conv``'s
    function, bf16 store, no sine) with a probe's phases and staging: NHWC
    x [N, H, W, Cin] (33 <= Cin <= 96 on the card), OHWI w [Cout, 3, 3,
    Cin], b [Cout] bf16, affines (scale, shift) float32 of Cin / Cout,
    residual output-shaped; returns ``out`` (or a new tensor)."""
    mask = _mask(phases, staging, STAGING)
    kw = {"act": act, "shuffle": shuffle, "in_affine": in_affine,
          "out_affine": out_affine, "residual": residual, "out": out}
    if not _check_conv_probe(x, w, b, kw,
                             lambda lib: lib.bnt_stage_conv_smem):
        return stage_conv_probe_plain(x, w, b, phases=phases,
                                      staging=staging, **kw)
    cout, cin = w.shape[0], w.shape[3]
    if not 33 <= cin <= 96:
        raise ValueError(f"the probe kernel takes 33..96 input channels, got "
                         f"{cin}")
    if staging == "direct" and in_affine is not None:
        raise ValueError("direct staging takes no input affine")
    out = _out(x, _out_shape(x, cout, shuffle), torch.bfloat16, mask, out)
    s_in, h_in = in_affine if in_affine is not None else (None, None)
    s_out, h_out = out_affine if out_affine is not None else (None, None)
    lib = _build.load_library()
    err = lib.bnt_stage_conv_probe(
        _ptr(x), _ptr(w), _ptr(b), _ptr(s_in), _ptr(h_in), _ptr(s_out),
        _ptr(h_out), _ptr(residual), _ptr(out), *x.shape, cout, _ACT[act],
        int(shuffle), mask, _stream(x))
    _build.check(err, "stage_conv_probe launch")
    LAUNCHES["stage_conv_probe"] += 1
    return out


def _check_conv_probe(x, w, b, kw, smem_fn):
    """``check_tensors`` for one 3x3 probe launch (``kw``: its act, shuffle,
    affines, residual and out), fitted by ``smem_fn``."""
    act, shuffle = kw["act"], kw["shuffle"]
    if act not in ACTS:
        raise ValueError(f"act must be one of {tuple(ACTS)}, got {act!r}")
    if w.dim() != 4 or tuple(w.shape[1:3]) != (3, 3):
        raise ValueError(f"w must be OHWI [Cout, 3, 3, Cin], got "
                         f"{tuple(w.shape)}")
    cout, cin = w.shape[0], w.shape[3]
    shape = _out_shape(x, cout, shuffle)
    bf = torch.bfloat16
    tensors = ([("w", w, (cout, 3, 3, cin), bf), ("b", b, (cout,), bf)]
               + _vectors("in_affine", kw["in_affine"], cin)
               + _vectors("out_affine", kw["out_affine"], cout))
    for name in ("residual", "out"):
        if kw[name] is not None:
            tensors.append((name, kw[name], shape, bf))
    return check_tensors(x, cin, tensors, (bf,), smem_fn, [(cin, cout, 3)])


def conv_rsft_stage(x: torch.Tensor, weights: StageWeights,
                    sft: torch.Tensor, head: bool = False) -> torch.Tensor:
    """The stride-1 stage on the bf16 stage kernel's production instances
    (``stage_conv.cu`` through ``planar.launch_conv`` and
    ``planar.rsft_cuda``: the chain ``planar.fused_conv_rsft`` ran before
    it moved onto ``conv_sm90.cu``), on the card: K1's exact reference and
    the old chain of chip_smoke.py's same-call A/B.  It counts no launch:
    no wrapper serves it."""
    lib = _build.load_library()
    c = weights.w0.shape[0]
    y = torch.empty(x.shape[:3] + (c,), dtype=x.dtype, device=x.device)
    launch_conv(lib, x, weights.conv_w, weights.conv_b, y, act="sin")
    out = rsft_cuda(lib, y, weights.rsft, sft)
    if head:
        rgb = torch.empty(x.shape[:3] + (3,), dtype=x.dtype, device=x.device)
        launch_conv(lib, out, weights.head_w, weights.head_b, rgb,
                    act="outimg")
        out = rgb
    return out


def _conv3x3_i8(lib, x, codes, scale, bias, out, *, act="none",
                shuffle=False, in_inv=None, in_affine=None, out_affine=None,
                residual=None, out_inv=None):
    """One launch of the W8A8 stage kernel's production instance
    (``stage_conv_i8.cu``): x int8 codes, or bf16 quantised at
    ``in_inv``."""
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


def _rsft_i8_stage(lib, y, w: StageWeightsI8, sft, out_inv):
    t = torch.empty(y.shape, dtype=torch.int8, device=y.device)
    _conv3x3_i8(lib, y, w.w0, w.scale0, w.b0, t, act="gelu", in_inv=w.inv_t0,
                in_affine=(sft[0], sft[1]), out_affine=(sft[2], sft[3]),
                out_inv=w.inv_t1)
    out = torch.empty(y.shape, dtype=torch.int8 if out_inv is not None
                      else torch.bfloat16, device=y.device)
    _conv3x3_i8(lib, t, w.w1, w.scale1, w.b1, out, residual=y,
                out_inv=out_inv)
    return out


def upconv_rsft_i8_stage(x: torch.Tensor, w: StageWeightsI8,
                         sft: torch.Tensor,
                         out_inv: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """The W8A8 stride-2 stage on the W8A8 stage kernel's production
    instances (``stage_conv_i8.cu``: the chain ``planar.
    fused_upconv_rsft_i8`` ran before it moved onto ``conv_sm90_i8.cu``),
    on the card: the old chain of chip_smoke.py's same-call A/B.  It
    counts no launch: no wrapper serves it."""
    lib = _build.load_library()
    n, h, wd, _ = x.shape
    y = torch.empty((n, 2 * h, 2 * wd, w.w0.shape[0]), dtype=torch.bfloat16,
                    device=x.device)
    _conv3x3_i8(lib, x, w.conv_w, w.conv_scale, w.conv_b, y, act="sin",
                shuffle=True, in_inv=w.inv_x)
    return _rsft_i8_stage(lib, y, w, sft, out_inv)


def conv_rsft_i8_stage(x: torch.Tensor, w: StageWeightsI8,
                       sft: torch.Tensor, head: bool = False,
                       out_inv: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """The W8A8 stride-1 stage on the W8A8 stage kernel's production
    instances (``planar.fused_conv_rsft_i8``'s chain before it moved onto
    ``conv_sm90_i8.cu``), on the card: K2's exact reference and the old
    chain of chip_smoke.py's same-call A/B.  It counts no launch."""
    lib = _build.load_library()
    y = torch.empty(x.shape[:3] + (w.w0.shape[0],), dtype=torch.bfloat16,
                    device=x.device)
    _conv3x3_i8(lib, x, w.conv_w, w.conv_scale, w.conv_b, y, act="sin",
                in_inv=w.inv_x)
    if not head:
        return _rsft_i8_stage(lib, y, w, sft, out_inv)
    hq = _rsft_i8_stage(lib, y, w, sft, w.inv_h)
    out = torch.empty(x.shape[:3] + (3,), dtype=torch.bfloat16,
                      device=x.device)
    _conv3x3_i8(lib, hq, w.head_w, w.head_scale, w.head_b, out,
                act="outimg")
    return out


def conv_rsft_probe(x: torch.Tensor, weights: StageWeights, sft: torch.Tensor,
                    *, head: bool = False, phases: str = "all",
                    staging: str = "smem", bufs: Optional[Sequence] = None,
                    plain: bool = False, sm90: bool = False) -> torch.Tensor:
    """A stride-1 stage (conv + sin, the ResBlockSFT pair, the optional
    outimg head: ``planar.fused_conv_rsft``'s launches), every launch with the
    same probe mode ("direct" only on the launches without an input
    affine), on the stage kernel (K1) or with ``sm90`` on the Hopper kernel
    (K5).  ``bufs``: the launches' outputs, reused; ``plain``: the plain
    versions on the card too."""
    launch = (stage_conv_probe_plain if plain else
              conv_sm90_probe if sm90 else stage_conv_probe)
    bufs = list(bufs) if bufs is not None else [None] * 4
    mode = {"phases": phases, "staging": staging}
    in_mode = {"phases": phases,
               "staging": "smem" if staging == "direct" else staging}
    y = launch(x, weights.conv_w, weights.conv_b, act="sin", out=bufs[0],
               **mode)
    t = launch(y, weights.w0, weights.b0, act="gelu",
               in_affine=(sft[0], sft[1]), out_affine=(sft[2], sft[3]),
               out=bufs[1], **in_mode)
    out = launch(t, weights.w1, weights.b1, residual=y, out=bufs[2], **mode)
    if head:
        out = launch(out, weights.head_w, weights.head_b, act="outimg",
                     out=bufs[3], **mode)
    return out


# --------------------------------------------------------------------- #
# K5: the Hopper conv kernel
# --------------------------------------------------------------------- #

def conv_sm90_probe(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                    act: str = "none", shuffle: bool = False,
                    in_affine: Optional[Tuple[torch.Tensor, ...]] = None,
                    out_affine: Optional[Tuple[torch.Tensor, ...]] = None,
                    residual: Optional[torch.Tensor] = None,
                    phases: str = "all", staging: str = "smem",
                    out: Optional[torch.Tensor] = None,
                    scale: Optional[torch.Tensor] = None,
                    in_inv: Optional[torch.Tensor] = None,
                    out_inv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One 3x3 launch of the Hopper kernel (``conv_sm90.launch``'s
    function, bf16 store) with a probe's phases; "nostage" knocks out the
    repack (the operand tile is zeroed once and never restaged).
    Arguments as ``stage_conv_probe``'s (Cin <= 128 on the card, staging
    "smem" only); its plain version is ``stage_conv_probe_plain``.  With
    int8 weight codes w, its int8 form (``conv_sm90_i8_probe*.cu``):
    ``scale`` and b the float32 dequant scale and bias, x int8 codes or
    bf16 quantised at ``in_inv``, the output bf16 or int8 codes at
    ``out_inv``; its plain version is then ``stage_conv_i8_probe_plain``
    (the knockouts compute what K2's do)."""
    if w.dtype == torch.int8:
        return _conv_sm90_i8_probe(
            x, w, scale, b, act=act, shuffle=shuffle, in_inv=in_inv,
            in_affine=in_affine, out_affine=out_affine, residual=residual,
            out_inv=out_inv, phases=phases, staging=staging, out=out)
    if out_inv is not None:
        raise ValueError("the bf16 probe stores bf16: out_inv is for int8 "
                         "weight codes")
    mask = _mask(phases, staging, {"smem": 0})
    kw = {"act": act, "shuffle": shuffle, "in_affine": in_affine,
          "out_affine": out_affine, "residual": residual, "out": out}
    if not _check_conv_probe(x, w, b, kw, sm90_smem):
        return stage_conv_probe_plain(x, w, b, phases=phases, **kw)
    cout, cin = w.shape[0], w.shape[3]
    out = _out(x, _out_shape(x, cout, shuffle), torch.bfloat16, mask, out)
    s_in, h_in = in_affine if in_affine is not None else (None, None)
    s_out, h_out = out_affine if out_affine is not None else (None, None)
    lib = _build.load_library()
    ns = conv_sm90.plan(lib, cin, cout, 3)[0]
    err = lib.bnt_conv_sm90_probe(
        _ptr(x), _ptr(conv_sm90.packed(w, ns)), _ptr(b), _ptr(s_in),
        _ptr(h_in), _ptr(s_out), _ptr(h_out), _ptr(residual), None,
        _ptr(out), *x.shape[:3], cin, cout, _ACT[act], int(shuffle), 3, ns,
        mask, _stream(x))
    _build.check(err, "conv_sm90_probe launch")
    LAUNCHES["conv_sm90_probe"] += 1
    return out


def _conv_sm90_i8_probe(x, codes, scale, bias, *, act, shuffle, in_inv,
                        in_affine, out_affine, residual, out_inv, phases,
                        staging, out):
    """``conv_sm90_probe``'s int8 form."""
    mask = _mask(phases, staging, {"smem": 0})
    tensors, shape, dtype = _i8_tensors(x, codes, scale, bias, act, shuffle,
                                        in_inv, in_affine, out_affine,
                                        residual, out_inv, out)
    cout, cin = codes.shape[0], codes.shape[3]
    form = conv_sm90.S8 if x.dtype == torch.int8 else conv_sm90.S8Q
    if not check_tensors(x, cin, tensors, (torch.int8, torch.bfloat16),
                         sm90_smem, [(cin, cout, 3, form)]):
        return stage_conv_i8_probe_plain(
            x, codes, scale, bias, act=act, shuffle=shuffle, in_inv=in_inv,
            in_affine=in_affine, out_affine=out_affine, residual=residual,
            out_inv=out_inv, phases=phases, out=out)
    out = _out(x, shape, dtype, mask, out)
    s_in, h_in = in_affine if in_affine is not None else (None, None)
    s_out, h_out = out_affine if out_affine is not None else (None, None)
    lib = _build.load_library()
    ns = conv_sm90.plan(lib, cin, cout, 3, form)[0]
    err = lib.bnt_conv_sm90_i8_probe(
        _ptr(x), _ptr(conv_sm90.packed(codes, ns)), _ptr(scale), _ptr(bias),
        _ptr(in_inv) if form == conv_sm90.S8Q else None, _ptr(s_in),
        _ptr(h_in), _ptr(s_out), _ptr(h_out), _ptr(residual), _ptr(out_inv),
        _ptr(out), *x.shape[:3], cin, cout, _ACT[act], int(shuffle), 3, ns,
        mask, _stream(x))
    _build.check(err, "conv_sm90_probe launch")
    LAUNCHES["conv_sm90_probe"] += 1
    return out


def _sm90_i8_launch(x, codes, scale, bias, **kw):
    """``conv_sm90_probe``'s int8 form with ``stage_conv_i8_probe``'s
    argument order, for the int8 stage chains."""
    return conv_sm90_probe(x, codes, bias, scale=scale, **kw)


# --------------------------------------------------------------------- #
# K2: the W8A8 stage kernel
# --------------------------------------------------------------------- #

def stage_conv_i8_probe_plain(x: torch.Tensor, codes: torch.Tensor,
                              scale: torch.Tensor, bias: torch.Tensor, *,
                              act: str = "none", shuffle: bool = False,
                              in_inv=None, in_affine=None, out_affine=None,
                              residual=None, out_inv=None,
                              phases: str = "all", staging: str = "smem",
                              out: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """``stage_conv_i8_probe`` in plain PyTorch: the integer sums exact in
    float64, the rest float32 as ``planar``'s int8 plain versions."""
    mask = _mask(phases, staging, STAGING_I8)
    dtype = torch.bfloat16 if out_inv is None else torch.int8
    out = _out(x, _out_shape(x, codes.shape[0], shuffle), dtype, mask, out)
    if not mask & STORE:
        return out
    x = x[..., :codes.shape[3]]   # an "async" input's channel padding
    if x.dtype == torch.int8:
        q = x
    else:
        v = nchw(x.float())
        if in_affine is not None:
            v = _affine(v, in_affine, torch.float32)
        q = quant.quant_act(nhwc(v), in_inv)
    if not mask & STAGE:
        q = torch.zeros_like(q)
    wk = codes if mask & GEMM else torch.zeros_like(codes)
    v = nchw(nhwc(F.conv2d(nchw(q).double(), wk.permute(0, 3, 1, 2).double(),
                           padding=1)).float())
    if mask & EPI:
        v = ACTS[act](v * scale[None, :, None, None]
                      + bias[None, :, None, None])
        if out_affine is not None:
            v = _affine(v, out_affine, torch.float32)
    if shuffle:
        v = F.pixel_shuffle(v, 2)
    if mask & EPI and residual is not None:
        v = nchw(residual.float()) + v
    v = nhwc(v)
    return out.copy_(v.to(dtype) if out_inv is None
                     else quant.quant_act(v, out_inv))


def _i8_tensors(x, codes, scale, bias, act, shuffle, in_inv, in_affine,
                out_affine, residual, out_inv, out):
    """(``check_tensors``'s tensors, output shape, output dtype) of one
    int8 probe launch; raises for an act or a weight it does not take."""
    if act not in ACTS:
        raise ValueError(f"act must be one of {tuple(ACTS)}, got {act!r}")
    if codes.dim() != 4 or tuple(codes.shape[1:3]) != (3, 3):
        raise ValueError(f"codes must be OHWI [Cout, 3, 3, Cin], got "
                         f"{tuple(codes.shape)}")
    cout, cin = codes.shape[0], codes.shape[3]
    shape = _out_shape(x, cout, shuffle)
    f32 = torch.float32
    dtype = torch.bfloat16 if out_inv is None else torch.int8
    tensors = ([("codes", codes, (cout, 3, 3, cin), torch.int8),
                ("scale", scale, (cout,), f32), ("bias", bias, (cout,), f32)]
               + _vectors("in_affine", in_affine, cin)
               + _vectors("out_affine", out_affine, cout))
    if x.dtype != torch.int8 or in_inv is not None:
        tensors.append(("in_inv", in_inv, (cin,), f32))
    if out_inv is not None:
        tensors.append(("out_inv", out_inv,
                        (cout // 4 if shuffle else cout,), f32))
    if residual is not None:
        tensors.append(("residual", residual, shape, torch.bfloat16))
    if out is not None:
        tensors.append(("out", out, shape, dtype))
    return tensors, shape, dtype


def stage_conv_i8_probe(x: torch.Tensor, codes: torch.Tensor,
                        scale: torch.Tensor, bias: torch.Tensor, *,
                        act: str = "none", shuffle: bool = False,
                        in_inv: Optional[torch.Tensor] = None,
                        in_affine: Optional[Tuple[torch.Tensor, ...]] = None,
                        out_affine: Optional[Tuple[torch.Tensor, ...]] = None,
                        residual: Optional[torch.Tensor] = None,
                        out_inv: Optional[torch.Tensor] = None,
                        phases: str = "all", staging: str = "smem",
                        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One 3x3 launch of the W8A8 kernel with a probe's phases and staging:
    x int8 codes or bf16 (quantised at ``in_inv``) [N, H, W, Cin], 33 <= Cin
    <= 64 on the card ("async": int8 codes with their channels padded to
    64), int8 OHWI ``codes`` with float32 ``scale`` and ``bias`` [Cout];
    the output is int8 codes at ``out_inv`` or bf16."""
    mask = _mask(phases, staging, STAGING_I8)
    tensors, shape, dtype = _i8_tensors(x, codes, scale, bias, act, shuffle,
                                        in_inv, in_affine, out_affine,
                                        residual, out_inv, out)
    cout, cin = codes.shape[0], codes.shape[3]
    x_c = (cin + 31) // 32 * 32 if staging == "async" else cin
    x_dtypes = (torch.int8,) if staging == "async" else (torch.int8,
                                                         torch.bfloat16)
    if not check_tensors(x, x_c, tensors, x_dtypes,
                         lambda lib: lib.bnt_stage_conv3x3_i8_smem,
                         [(cin, cout)]):
        return stage_conv_i8_probe_plain(
            x, codes, scale, bias, act=act, shuffle=shuffle, in_inv=in_inv,
            in_affine=in_affine, out_affine=out_affine, residual=residual,
            out_inv=out_inv, phases=phases, staging=staging, out=out)
    if not 33 <= cin <= 64:
        raise ValueError(f"the int8 probe kernel takes 33..64 input "
                         f"channels, got {cin}")
    if staging == "async" and out_inv is not None:
        raise ValueError("async staging stores bf16 only")
    out = _out(x, shape, dtype, mask, out)
    s_in, h_in = in_affine if in_affine is not None else (None, None)
    s_out, h_out = out_affine if out_affine is not None else (None, None)
    in_i8 = x.dtype == torch.int8
    lib = _build.load_library()
    err = lib.bnt_stage_conv3x3_i8_probe(
        _ptr(x), _ptr(codes), _ptr(scale), _ptr(bias),
        None if in_i8 else _ptr(in_inv), _ptr(s_in), _ptr(h_in), _ptr(s_out),
        _ptr(h_out), _ptr(residual), _ptr(out_inv), _ptr(out), *x.shape[:3],
        cin, cout, _ACT[act], int(shuffle), int(in_i8), mask, _stream(x))
    _build.check(err, "stage_conv_i8_probe launch")
    LAUNCHES["stage_conv_i8_probe"] += 1
    return out


def _i8_stage_probe(x, w: StageWeightsI8, sft, *, up, head, out_inv,
                    phases, staging, bufs, plain, sm90):
    """A W8A8 stage's launches (the stage conv, the ResBlockSFT pair, the
    optional head), every launch with the same probe mode, on the W8A8
    stage kernel (K2) or with ``sm90`` on the int8 form of the Hopper
    kernel (K5); x int8 codes or bf16."""
    launch = (stage_conv_i8_probe_plain if plain else
              _sm90_i8_launch if sm90 else stage_conv_i8_probe)
    bufs = list(bufs) if bufs is not None else [None] * 4
    mode = {"phases": phases, "staging": staging}
    y = launch(x, w.conv_w, w.conv_scale, w.conv_b, act="sin", shuffle=up,
               in_inv=None if x.dtype == torch.int8 else w.inv_x,
               out=bufs[0], **mode)
    t = launch(y, w.w0, w.scale0, w.b0, act="gelu", in_inv=w.inv_t0,
               in_affine=(sft[0], sft[1]), out_affine=(sft[2], sft[3]),
               out_inv=w.inv_t1, out=bufs[1], **mode)
    out = launch(t, w.w1, w.scale1, w.b1, residual=y,
                 out_inv=w.inv_h if head else out_inv, out=bufs[2], **mode)
    if head:
        out = launch(out, w.head_w, w.head_scale, w.head_b, act="outimg",
                     out=bufs[3], **mode)
    return out


def conv_rsft_i8_probe(x: torch.Tensor, w: StageWeightsI8, sft: torch.Tensor,
                       *, head: bool = False,
                       out_inv: Optional[torch.Tensor] = None,
                       phases: str = "all", staging: str = "smem",
                       bufs: Optional[Sequence] = None,
                       plain: bool = False, sm90: bool = False
                       ) -> torch.Tensor:
    """A W8A8 stride-1 stage (``planar.fused_conv_rsft_i8``'s launches),
    every launch with the same probe mode, on the W8A8 stage kernel or
    with ``sm90`` on the int8 form of the Hopper kernel; x int8 codes or
    bf16."""
    return _i8_stage_probe(x, w, sft, up=False, head=head, out_inv=out_inv,
                           phases=phases, staging=staging, bufs=bufs,
                           plain=plain, sm90=sm90)


def upconv_rsft_i8_probe(x: torch.Tensor, w: StageWeightsI8,
                         sft: torch.Tensor, *,
                         out_inv: Optional[torch.Tensor] = None,
                         phases: str = "all", staging: str = "smem",
                         bufs: Optional[Sequence] = None,
                         plain: bool = False, sm90: bool = False
                         ) -> torch.Tensor:
    """A W8A8 stride-2 stage (``planar.fused_upconv_rsft_i8``'s launches),
    as ``conv_rsft_i8_probe``."""
    return _i8_stage_probe(x, w, sft, up=True, head=False, out_inv=out_inv,
                           phases=phases, staging=staging, bufs=bufs,
                           plain=plain, sm90=sm90)


# --------------------------------------------------------------------- #
# K3: the fragment loop's ceiling
# --------------------------------------------------------------------- #

def _gemm_dims(a, b, taps):
    th, tw = taps
    if a.dim() != 4 or b.dim() != 3 or b.shape[0] != th * tw or (
            b.shape[2] != a.shape[3]) or a.shape[2] != 32 + tw - 1:
        raise ValueError(f"a must be [tiles, rows + {th - 1}, {32 + tw - 1}, "
                         f"K] and b [{th * tw}, N, K], got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    return a.shape[0], a.shape[1] - th + 1, b.shape[1], a.shape[3]


def gemm_probe_plain(a: torch.Tensor, b: torch.Tensor, *, taps=(3, 3),
                     n_chunk: int = 8, act: str = "none", alpha: float = 1.0,
                     reps: int = 1, grid: Optional[int] = None
                     ) -> torch.Tensor:
    """``gemm_probe`` in float64: reps * sum over taps (dy, dx) of the
    window of a shifted by (dy, dx) times b[tap]^T, or its sine."""
    tiles, rows, n, kt = _gemm_dims(a, b, taps)
    c = torch.zeros((tiles, 32 * rows, n), dtype=torch.float64,
                    device=a.device)
    for tap in range(taps[0] * taps[1]):
        dy, dx = divmod(tap, taps[1])
        at = a[:, dy:dy + rows, dx:dx + 32].reshape(tiles, 32 * rows, kt)
        c += at.double() @ b[tap].double().t()
    c = c * reps
    return (torch.sin(c * alpha) if act == "sin" else c).float()


def gemm_probe(a: torch.Tensor, b: torch.Tensor, *, taps=(3, 3),
               n_chunk: int = 8, act: str = "none", alpha: float = 1.0,
               reps: int = 1, grid: Optional[int] = None) -> torch.Tensor:
    """The fragment loop on resident operands: a [tiles, rows + th - 1,
    32 + tw - 1, K] halo tiles and b [th * tw, N, K] (N <= 64, rows <= 8),
    both bf16 or both int8, taps (th, tw) <= (3, 3); ``grid`` blocks (at
    least tiles; block i computes tile i % tiles) each run it ``reps``
    times.  Returns C [tiles, 32 * rows, N] float32."""
    tiles, rows, n, kt = _gemm_dims(a, b, taps)
    if act not in ("none", "sin") or n_chunk not in (2, 4, 8):
        raise ValueError(f"act must be none or sin and n_chunk 2, 4 or 8, "
                         f"got {act!r}, {n_chunk}")
    if a.device.type == "cpu":
        return gemm_probe_plain(a, b, taps=taps, n_chunk=n_chunk, act=act,
                                alpha=alpha, reps=reps, grid=grid)
    i8 = a.dtype == torch.int8
    if a.dtype not in (torch.bfloat16, torch.int8) or b.dtype != a.dtype or (
            b.device != a.device) or not (a.is_contiguous()
                                          and b.is_contiguous()):
        raise ValueError("a and b must be contiguous, on one device, both "
                         "bf16 or both int8")
    lib = _build.load_library()
    if lib.bnt_gemm_probe_smem(rows, *taps, kt, n, int(i8)) < 0 or (
            i8 and n_chunk != 8):
        raise ValueError(f"the GEMM probe does not take rows {rows}, N {n}, "
                         f"K {kt}, taps {taps}, n_chunk {n_chunk}")
    c = torch.empty((tiles, 32 * rows, n), dtype=torch.float32,
                    device=a.device)
    err = lib.bnt_gemm_probe(
        _ptr(a), _ptr(b), _ptr(c), tiles, grid or tiles, rows, *taps, kt, n,
        int(i8), n_chunk, int(act == "sin"), alpha, reps, _stream(a))
    _build.check(err, "gemm_probe launch")
    LAUNCHES["gemm_probe"] += 1
    return c


def gemm_probe_fill(rows: int, taps, kt: int, n: int, i8: bool,
                    n_chunk: int = 8) -> int:
    """Blocks of a GEMM-probe launch that fill the card at once."""
    fill = _build.load_library().bnt_gemm_probe_fill(rows, *taps, kt, n,
                                                      int(i8), n_chunk)
    if fill < 1:
        raise ValueError("the GEMM probe does not take this shape")
    return fill


# --------------------------------------------------------------------- #
# K4: staging alone
# --------------------------------------------------------------------- #

def stage_build_probe_plain(x: torch.Tensor, *, mode: str, in_affine=None,
                            in_inv=None, smem: int = 0, store: bool = True
                            ) -> torch.Tensor:
    """The staged tiles [tiles, 6 * 34, cin_pad] of NHWC x: the halo'd
    window of each 4 x 32 output tile (row-major tiles), pixels outside
    the image and channels >= Cin zero; "f32" / "raw16" in x's dtype (the
    affine, in float32, on in-image pixels), "i8" / "i8_pack" the int8
    codes of ``quant.quant_act``.  (``smem`` and ``store`` only matter on
    the card.)"""
    if mode not in BUILD_MODES:
        raise ValueError(f"mode must be one of {tuple(BUILD_MODES)}, got "
                         f"{mode!r}")
    n, h, w, cin = x.shape
    i8 = mode.startswith("i8")
    cpad = (cin + 31) // 32 * 32 if i8 else (cin + 15) // 16 * 16
    v = x.float()
    if in_affine is not None:
        v = nhwc(_affine(nchw(v), in_affine, torch.float32))
    v = quant.quant_act(v, in_inv) if i8 else v.to(x.dtype)
    th, tw = -(-h // 4), -(-w // 32)
    xp = torch.zeros((n, 4 * th + 2, 32 * tw + 2, cpad), dtype=v.dtype,
                     device=x.device)
    xp[:, 1:h + 1, 1:w + 1, :cin] = v
    win = xp.unfold(1, IN_H, 4).unfold(2, IN_W, 32)   # n, th, tw, C, 6, 34
    return win.permute(0, 1, 2, 4, 5, 3).reshape(n * th * tw, IN_H * IN_W,
                                                 cpad)


def stage_build_probe(x: torch.Tensor, *, mode: str,
                      in_affine: Optional[Tuple[torch.Tensor, ...]] = None,
                      in_inv: Optional[torch.Tensor] = None, smem: int = 0,
                      store: bool = True) -> torch.Tensor:
    """Stage every 4 x 32 output tile's input of NHWC bf16 x [N, H, W, Cin]
    (33 <= Cin <= 96) as the stage kernels' phase 2 does, at ``smem``
    bytes of shared memory per block (the production launch's, for its
    occupancy): with ``store`` returning the staged tiles (as
    ``stage_build_probe_plain``); without, in shared memory only,
    returning a checksum [1] int32.  "raw16" takes no affine; the
    int8 modes need ``in_inv``."""
    if mode not in BUILD_MODES:
        raise ValueError(f"mode must be one of {tuple(BUILD_MODES)}, got "
                         f"{mode!r}")
    cin = x.shape[-1]
    i8 = mode.startswith("i8")
    if mode == "raw16" and in_affine is not None:
        raise ValueError("raw16 staging takes no affine")
    if i8 and in_inv is None:
        raise ValueError(f"{mode} staging needs in_inv")
    tensors = (_vectors("in_affine", in_affine, cin)
               + ([("in_inv", in_inv, (cin,), torch.float32)] if i8 else []))
    if not check_tensors(x, cin, tensors, (torch.bfloat16,),
                         lambda lib: lib.bnt_stage_conv_smem, []):
        return stage_build_probe_plain(x, mode=mode, in_affine=in_affine,
                                       in_inv=in_inv, smem=smem, store=store)
    lib = _build.load_library()
    if lib.bnt_stage_build_probe_smem(cin, BUILD_MODES[mode]) < 0:
        raise ValueError(f"the staging probe takes 33..96 input channels, "
                         f"got {cin}")
    n, h, w, _ = x.shape
    cpad = (cin + 31) // 32 * 32 if i8 else (cin + 15) // 16 * 16
    tiles = n * -(-h // 4) * -(-w // 32)
    out = (torch.empty((tiles, IN_H * IN_W, cpad),
                       dtype=torch.int8 if i8 else x.dtype, device=x.device)
           if store else None)
    sink = torch.zeros((1,), dtype=torch.int32, device=x.device)
    s_in, h_in = in_affine if in_affine is not None else (None, None)
    err = lib.bnt_stage_build_probe(
        _ptr(x), _ptr(s_in), _ptr(h_in), _ptr(in_inv), _ptr(out), _ptr(sink),
        n, h, w, cin, BUILD_MODES[mode], smem, _stream(x))
    _build.check(err, "stage_build_probe launch")
    LAUNCHES["stage_build_probe"] += 1
    return out if store else sink
