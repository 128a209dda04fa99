"""Host side of the Hopper conv kernel (``ops/csrc/conv_sm90.cuh``): its
bf16 form (``conv_sm90.cu``, and ``conv_sm90_split.cu`` for launches split
into slice groups), which serves the four fine-grid wrappers of
``tile_conv`` (``conv_tile``, ``conv_tile_v3``, ``resblock_sft_tile``,
``resblock_sft_tile_v3``), the v1 wrappers ``conv_chw.conv3x3_act_chw``,
``conv_chw.head_conv_chw`` and ``fused_sft.resblock_sft_chw``,
``planar.fused_upconv_rsft`` and ``planar.fused_conv_rsft``, with its
modes: the sine of the staged input or of the residual
(``conv_sm90_sin.cu``, ``resblock_sft_chw`` with ``input_sin``) and the
planar staging, residual and store (``conv_sm90_planar.cu``:
``planar.rsft_planar``, and both in one launch with an activation,
``planar.conv_planar``); and its int8 form (``conv_sm90_i8.cu``), which
serves ``planar.fused_upconv_rsft_i8`` and ``planar.fused_conv_rsft_i8``.
No wrapper launches the stage kernel ``stage_conv.cu`` any more
(``planar.launch_conv``): it serves the K1 probes and chip_smoke.py's
same-call A/B.

A launch's operand form follows from its tensors: bf16 weights give the
bf16 form (``BF16``); int8 weight codes give the int8 form, repacking int8
input codes (``S8``) or quantising a bf16 input at ``in_inv`` (``S8Q``),
with the int32 sums dequantised by the per-output-channel ``scale`` and a
float32 bias.  What the kernel needs from Python is plain torch and lives
here:

- the N-slice plan: ``slice_width(cout, form)`` picks the wgmma N (one of
  ``ns_choices(form)``, the kernel's instances: the integer wgmma shapes
  have no N 56) that wastes the fewest padded channels, counting 16
  channels of overhead per slice (bf16: 51 -> 56, 61 -> 64, 73 -> 80,
  204 -> 3 x 80, 244 -> 4 x 64, 3 -> 8; int8: 51, 61 -> 64, 204 -> 3 x
  80, 3 -> 8); ``plan`` takes the first width in that order whose launch
  fits the shared memory (a 5 x 5 conv of 128 channels to 80 fits only at
  N 8); ``fit`` mirrors the library's shared-memory plan (warpgroups,
  weight ring, bytes) for the CPU tests, and chip_smoke.py holds the two
  equal;
- the slice-group plan of a bf16 launch: ``groups`` (mirroring the
  library's, which ``launch_plan`` reads and chip_smoke.py holds equal)
  splits the N slices of a launch whose tiles leave SMs idle into G
  groups, each block taking one group's slices of its tiles
  (``group_slices``, ``work_items``); G = 1 where the tiles fill the card;
- the weight packing: ``pack_weight`` turns an OHWI weight into the
  kernel's B layout, one block per (N slice, tap), each K step of a block
  (k16 of bf16, k32 of int8: 32 bytes) NS x 32 bytes as 8 x 16-byte core
  matrices ([NS/8][2][8][16 bytes], no swizzle), the layout its wgmma
  descriptor reads (``b_offsets``); ``packed`` caches it per weight
  tensor;
- ``emulate``: the kernel's function computed the kernel's way, for the
  CPU tests: each 4 x 64 output tile's input rows staged as 16-byte-widened
  flat spans (a planar input: the tile's planar box, zero outside the real
  region) and repacked (prologue on in-image taps only, after the sine of
  ``sin="input"``; in ``S8Q`` then quantised) into the operand tile
  [16-byte channel group][pixel][16 bytes] (``group_stride`` pixels per
  group), the GEMM's A read from it through ``a_offsets`` at each tap's
  pixel shift and its B from the packed blocks through ``b_offsets`` (int8
  sums exact), then the epilogue (int8: dequantised first; the residual's
  sine with ``sin="residual"``; a planar residual and store at the planar
  offsets, ``planar_offsets``).
- the modes (``SIN_INPUT``, ``SIN_RESIDUAL``, ``PLANAR_IN``,
  ``PLANAR_OUT``, ``PLANAR_IO``; ``mode_of``), bf16 only, one slice group
  a launch (``groups`` gives 1); ``fit`` mirrors the planar box's raw
  buffer and the transposed staging of the planar output.
- the K loop (``KLOOP``, ``conv_sm90_kloop.cu``): a bf16 launch of no
  other mode whose Cin, padded to 16, lies beyond 128 (``wide``; up to
  256) runs it, one slice group, its weights streamed: each slice's K is
  a loop over chunks of ``KC`` (64) input channels (``chunks``, Cin padded
  to whole chunks, ``kloop_pad``; walked in ``chunk_at``'s order), each
  repacked into the operand tile from the raw rows of all Cin channels;
  ``pack_weight`` packs its weight [slice][chunk][tap][K step of the
  chunk]...; ``fit`` mirrors its plan (the operand tile and a ring slot
  of one chunk) and ``emulate`` its chunks; ``launch`` counts each
  K-loop launch in ``LAUNCHES["conv_sm90_kloop"]``.  The int8 form and
  the other modes keep 128.

``launch`` is one kernel launch; ``rsft`` the two launches of a
ResBlockSFT (of sin(y) with ``input_sin``), ``rsft_planar`` those of the
planar one, ``conv_planar`` the one of the planar conv, ``upconv_rsft``
and ``conv_rsft`` the three (four with the head) of the stride-2 and
stride-1 stages, each with a launch
(``cuda_conv``) or ``emulate`` (``emulated_conv``) as its conv, on bf16
``StageWeights`` or on W8A8 ``StageWeightsI8``, whose convs take their
dequant scales and input multipliers from the weights' fields.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from . import LAUNCHES, _build, quant

BF16, S8, S8Q = 0, 1, 2            # operand forms (conv_sm90.cuh::Form)
NS_CHOICES = (8, 56, 64, 80)       # the bf16 form's instances (N slices)
NS_CHOICES_S8 = (8, 64, 80)        # the int8 form's: integer wgmma, no 56
TH, TW = 4, 64                     # output tile (rows, columns)
ACT_CODES = {"none": 0, "sin": 1, "gelu": 2, "outimg": 3}
MAX_SMEM = 232448                  # the card's opt-in shared memory a block
MAX_CIN_PAD, MAX_WS = 128, 8
MAX_CIN_KLOOP, KC = 256, 64        # the K loop's Cin (padded) and chunk
ROWS_S8_64 = 3                     # int8 rows a warpgroup at N 64
FULL_WAVES = 4                     # the slice-group plan's (groups)
REPACK_COST, SLICE_COST = 1, 4
# the modes of a bf16 launch (conv_sm90.cuh::Mode)
NONE, SIN_INPUT, SIN_RESIDUAL, PLANAR_IN, PLANAR_OUT, PLANAR_IO = range(6)
KLOOP = 6                          # Cin beyond MAX_CIN_PAD: mode_of gives it
KLOOP_LAUNCHES = "conv_sm90_kloop"  # the LAUNCHES key of K-loop launches
PLANAR_MODES = (PLANAR_IN, PLANAR_OUT, PLANAR_IO)
PBX, PBX_LEAD = 48, 8              # a planar input's box: columns, lead


def mode_of(sin: Optional[str] = None, planar: Optional[str] = None) -> int:
    """The mode of a launch with ``sin`` ("input", "residual") or
    ``planar`` ("in": planar input; "out": planar residual and output;
    "io": planar input and output)."""
    if sin is not None and planar is not None:
        raise ValueError("a launch takes a sin mode or a planar one")
    if sin is not None:
        return {"input": SIN_INPUT, "residual": SIN_RESIDUAL}[sin]
    return {None: NONE, "in": PLANAR_IN, "out": PLANAR_OUT,
            "io": PLANAR_IO}[planar]


def wide(cin: int, form: int = BF16, mode: int = NONE) -> bool:
    """True where a launch takes the K loop (``KLOOP``, conv_sm90_kloop.cu):
    bf16, no other mode, Cin padded beyond ``MAX_CIN_PAD``."""
    return form == BF16 and mode in (NONE, KLOOP) and cin_pad(cin) > \
        MAX_CIN_PAD


def kloop_pad(cin: int) -> int:
    """The K loop's K: Cin padded to whole chunks of ``KC`` (zeros beyond
    Cin), so that every chunk has the same K steps
    (conv_sm90_kloop.cu's ``cin_all``)."""
    return -(-cin // KC) * KC


def chunks(cin: int):
    """The K loop's chunks of ``cin`` input channels: (first channel,
    channels) of each, KC wide."""
    return [(k0, KC) for k0 in range(0, kloop_pad(cin), KC)]


def chunk_at(s: int, cc: int, nkc: int) -> int:
    """The chunk that slice s takes cc-th (conv_sm90.cuh::chunk_at): even
    slices forward, odd ones backward."""
    return nkc - 1 - cc if s & 1 else cc


def form_of(x: torch.Tensor, w: torch.Tensor) -> int:
    """The operand form of a launch on input x with weight w."""
    if w.dtype != torch.int8:
        return BF16
    return S8 if x.dtype == torch.int8 else S8Q


def op_bytes(form: int) -> int:
    """Bytes of one operand element (conv_sm90.cuh::op_bytes)."""
    return 2 if form == BF16 else 1


def in_bytes(form: int) -> int:
    """Bytes of one input element (conv_sm90.cuh::in_bytes)."""
    return 1 if form == S8 else 2


def rows_at(ns: int, form: int) -> int:
    """Output rows a consumer warpgroup of a launch at N ``ns``
    (conv_sm90.cuh::rows_of): ``ROWS_S8_64`` at the int8 form's N 64,
    else 2."""
    return ROWS_S8_64 if form != BF16 and ns == 64 else 2


def ns_choices(form: int) -> tuple:
    """The N slice widths with an instance in form ``form``."""
    return NS_CHOICES if form == BF16 else NS_CHOICES_S8


def slice_widths(cout: int, form: int = BF16) -> list:
    """The N slice widths for ``cout`` channels, best first."""
    return sorted(ns_choices(form),
                  key=lambda ns: (-(-cout // ns) * (ns + 16), -ns))


def slice_width(cout: int, form: int = BF16) -> int:
    """Output channels per N slice for ``cout`` channels."""
    return slice_widths(cout, form)[0]


@functools.lru_cache(maxsize=None)
def plan(lib, cin: int, cout: int, ks: int, form: int = BF16,
         mode: int = NONE) -> Tuple[int, int]:
    """(slice width, shared-memory bytes) of a launch in ``mode``: the
    first width of ``slice_widths(cout, form)`` whose launch fits, or
    (0, -1) where none does.  The sin modes' plan is ``NONE``'s."""
    for ns in slice_widths(cout, form):
        if mode in PLANAR_MODES:
            smem = (lib.bnt_conv_sm90_planar_smem(cin, cout, ns, mode)
                    if ks == 3 else -1)
        elif wide(cin, form, mode):
            smem = lib.bnt_conv_sm90_kloop_smem(cin, cout, ks, ns)
        elif form == BF16:
            smem = lib.bnt_conv_sm90_smem(cin, cout, ks, ns)
        else:
            smem = lib.bnt_conv_sm90_i8_smem(cin, cout, ks, ns, form)
        if smem >= 0:
            return ns, smem
    return 0, -1


def cin_pad(cin: int, form: int = BF16) -> int:
    """Cin padded to whole K steps: 16 channels of bf16, 32 of int8."""
    kstep = 32 // op_bytes(form)
    return -(-cin // kstep) * kstep


def pack_weight(w: torch.Tensor, ns: int) -> torch.Tensor:
    """OHWI [Cout, k, k, Cin] -> the flat packed B operand, in w's dtype:
    [slice][tap][K step][NS/8][2][8][16 bytes] (int8 codes: 16 elements,
    bf16 or any other weight: 8), zero beyond Cout and Cin; for the K loop
    (``wide``) [slice][chunk][tap][K step of the chunk]..."""
    cout, k, _, cin = w.shape
    form = S8 if w.dtype == torch.int8 else BF16
    kstep, chunk = 32 // op_bytes(form), 16 // op_bytes(form)
    loop = wide(cin, form)
    nsl = -(-cout // ns)
    cp = kloop_pad(cin) if loop else cin_pad(cin, form)
    wp = torch.zeros((nsl * ns, k * k, cp), dtype=w.dtype, device=w.device)
    wp[:cout, :, :cin] = w.reshape(cout, k * k, cin)
    parts = chunks(cin) if loop else [(0, cp)]
    return torch.cat([
        wp[:, :, k0:k0 + kc].reshape(nsl, ns // 8, 8, k * k, kc // kstep, 2,
                                     chunk)
        .permute(0, 3, 4, 1, 5, 2, 6).reshape(nsl, -1)
        for k0, kc in parts], dim=1).reshape(-1)


def packed(w: torch.Tensor, ns: int) -> torch.Tensor:
    """``pack_weight(w, ns)``, cached on the tensor (and repacked after an
    in-place change of w)."""
    hit = getattr(w, "_conv_sm90_packed", None)
    if hit is None or hit[:2] != (w._version, ns):
        hit = (w._version, ns, pack_weight(w, ns))
        w._conv_sm90_packed = hit
    return hit[2]


def b_offsets(ns: int, e: int = 2) -> torch.Tensor:
    """[ns, 32 / e] element offsets, within one K step of a block packed in
    e-byte elements, of B[n, k]: core matrix (n // 8, k // (16 / e)) at
    (n // 8) * 256 + (k // (16 / e)) * 128 bytes (the descriptor's stride
    and leading byte offsets), row n % 8 at 16 bytes, element k % (16 / e)
    at e."""
    chunk = 16 // e
    n = torch.arange(ns)[:, None]
    q = torch.arange(2 * chunk)[None, :]
    return ((n // 8) * 256 + (q // chunk) * 128 + (n % 8) * 16) // e \
        + q % chunk


def group_stride(k: int, th: int = TH) -> int:
    """Pixels between 16-byte channel groups of the operand tile of th
    rows: its pixel count rounded to 1 modulo 8
    (conv_sm90.cuh::group_stride)."""
    return (th + k - 1) * (TW + k - 1) // 8 * 8 + 9


def a_offsets(gs: int, e: int = 2) -> torch.Tensor:
    """[64, 32 / e] element offsets, from an m64 tile's first pixel within
    one K step of the operand tile of e-byte elements, of A[i, k]: core
    matrix (i // 8, k // (16 / e)) at (i // 8) * 128 + (k // (16 / e)) *
    gs * 16 bytes (the descriptor's stride and leading byte offsets),
    pixel i % 8 at 16 bytes, element k % (16 / e) at e."""
    chunk = 16 // e
    i = torch.arange(64)[:, None]
    q = torch.arange(2 * chunk)[None, :]
    return ((i // 8) * 128 + (q // chunk) * gs * 16 + (i % 8) * 16) // e \
        + q % chunk


def stage_floats(ns: int, mode: int = NONE) -> int:
    """Staged floats of one warpgroup's output row
    (conv_sm90.cuh::stage_floats): [pixel][ns + 4], or in ``PLANAR_OUT``
    and ``PLANAR_IO`` [channel][TW + 4] where that is larger."""
    if mode in (PLANAR_OUT, PLANAR_IO):
        return max(ns * (TW + 4), TW * (ns + 4))
    return TW * (ns + 4)


def _smem_bytes(kbytes, k, raw, ns, nwg, ws, rows=2, mode=NONE) -> int:
    """conv_sm90.cuh::mode_layout's total bytes."""
    th = rows * nwg
    pad = -(-(kbytes // 16 * group_stride(k, th) * 16) // 128) * 128
    return (pad + (th + k - 1) * raw + ws * ns * kbytes
            + nwg * stage_floats(ns, mode) * 4 + 2 * (1 + ws) * 8)


def planar_rows(nwg: int) -> int:
    """Planar rows of a planar input's box (conv_sm90.cuh::planar_rows):
    the tile's 2 nwg fine rows and their halo."""
    return nwg + 2


def planar_raw_pitch(cin: int, nwg: int) -> int:
    """conv_sm90.cuh::planar_raw_pitch: a planar input's box (PBX x
    planar_rows x cin x 4 planes of bf16) over the raw buffer's 2 nwg + 2
    slots, rounded up to 16 bytes."""
    box, slots = PBX * planar_rows(nwg) * cin * 8, 2 * nwg + 2
    return (-(-box // slots) + 15) // 16 * 16


def fit(cin: int, cout: int, k: int, ns: int, form: int = BF16,
        mode: int = NONE):
    """The kernel's shared-memory plan of a launch in ``mode``
    (conv_sm90.cuh::fit, which chip_smoke.py holds this to): (consumer
    warpgroups, weight ring depth, resident, bytes), or None for a shape it
    does not take."""
    cp = cin_pad(cin, form)
    stream = wide(cin, form, mode)   # the K loop: streamed, KC a chunk
    if (k not in (1, 3, 5) or cin < 1 or cout < 1
            or cp > (MAX_CIN_KLOOP if stream else MAX_CIN_PAD)
            or ns not in ns_choices(form)
            or (mode != NONE and form != BF16)
            or (mode in PLANAR_MODES and k != 3)):
        return None
    kblocks = -(-cout // ns) * k * k
    raw = ((TW + k - 1) * cin * in_bytes(form) + 30 + 15) // 16 * 16
    for nwg in (2, 1):
        if mode in (PLANAR_IN, PLANAR_IO):
            raw = planar_raw_pitch(cin, nwg)
        ws = MAX_WS if stream else kblocks
        while True:
            total = _smem_bytes((KC if stream else cp) * op_bytes(form), k,
                                raw, ns, nwg, ws, rows_at(ns, form), mode)
            if total <= MAX_SMEM:
                return nwg, ws, not stream and ws == kblocks, total
            ws = (min(kblocks - 1, MAX_WS) if not stream and ws == kblocks
                  else ws - 1)
            if ws < 2:
                break
    return None


def tiles(n: int, h: int, w: int, nwg: int, rows: int = 2) -> int:
    """Output tiles of a launch: (rows x nwg) x 64 pixels each
    (conv_sm90.cuh::prepare's tiles_w x tiles_h x n)."""
    return n * -(-h // (rows * nwg)) * -(-w // TW)


def blocks(n_tiles: int, g: int, sms: int, per_sm: int) -> int:
    """Blocks of one slice group of a launch (conv_sm90.cuh::blocks)."""
    return max(1, min(n_tiles, sms * max(per_sm, 1) // g))


def groups(n_tiles: int, nslices: int, sms: int, per_sm: int,
           mode: int = NONE) -> int:
    """The slice-group plan of a bf16 launch (conv_sm90.cuh::groups, which
    chip_smoke.py holds this to): 1 where the tiles fill ``FULL_WAVES``
    waves of blocks or more, else the G groups of consecutive N slices,
    none empty, that minimise rounds x (REPACK_COST + SLICE_COST x slices
    a group), rounds being the tiles one block walks; the least such G.
    A launch in a mode takes one group (its instances have no SPLIT
    form)."""
    if mode != NONE or n_tiles >= FULL_WAVES * sms * max(per_sm, 1):
        return 1
    best, best_cost = 1, None
    for g in range(1, nslices + 1):
        per = -(-nslices // g)
        if -(-nslices // per) != g:  # a group would be empty
            continue
        bx = blocks(n_tiles, g, sms, per_sm)
        cost = -(-n_tiles // bx) * (REPACK_COST + SLICE_COST * per)
        if best_cost is None or cost < best_cost:
            best, best_cost = g, cost
    return best


def group_slices(nslices: int, g: int, group: int) -> Tuple[int, int]:
    """The N slices [s0, s1) of slice group ``group`` of ``g``
    (conv_sm90.cuh::slice_range)."""
    per = -(-nslices // g)
    return group * per, min(nslices, (group + 1) * per)


def work_items(n_tiles: int, nslices: int, g: int) -> list:
    """The work items of a launch of ``g`` slice groups, (tile, s0, s1):
    every tile once per group, with the group's slices."""
    return [(t, *group_slices(nslices, g, grp)) for grp in range(g)
            for t in range(n_tiles)]


def launch_plan(lib, n: int, h: int, w: int, cin: int, cout: int, ks: int,
                mode: int = NONE) -> Tuple[int, int, int, int, int]:
    """The library's slice-group plan of a bf16 launch in ``mode`` (G,
    tiles, N slices, SMs, blocks an SM), from ``bnt_conv_sm90_groups`` or,
    in a mode, its entry point's plan (a planar launch's fine grid h x w,
    planar tensors of round16 channels, h / 2 rows, 128 or more
    columns)."""
    ns = plan(lib, cin, cout, ks, BF16, mode)[0]
    info = (ctypes.c_int * 4)()
    if mode in (SIN_INPUT, SIN_RESIDUAL):
        g = lib.bnt_conv_sm90_sin(*[None] * 9, n, h, w, cin, cout, 0, ks, ns,
                                  mode, info, None)
    elif wide(cin, BF16, mode):
        g = lib.bnt_conv_sm90_kloop(*[None] * 10, n, h, w, cin, cout, 0, 0,
                                    ks, ns, info, None)
    elif mode != NONE:
        cp, cpo = (-(-c // 16) * 16 for c in (cin, cout))
        g = lib.bnt_conv_sm90_planar(
            *[None] * 9, h, w, cin, cout, 0, ns, mode,
            cpo if mode == PLANAR_OUT else cp, cpo, h // 2,
            max(128, w // 2), info, None)
    else:
        g = lib.bnt_conv_sm90_groups(n, h, w, cin, cout, ks, ns, info)
    if g < 1:
        raise ValueError(f"conv_sm90 takes no {cin}->{cout} k{ks} launch")
    return (g, *info)


def smem(lib, cin: int, cout: int, ks: int, form: int = BF16,
         mode: int = NONE) -> int:
    """Shared memory of one launch, or -1 for a shape it does not take."""
    return plan(lib, cin, cout, ks, form, mode)[1]


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def launch(lib, x, w, b, out, *, act="none", shuffle=False, in_affine=None,
           out_affine=None, residual=None, out_inv=None, scale=None,
           in_inv=None, schedule=None, sin=None, planar=None,
           image=None) -> None:
    """One launch: a same-padded k x k conv of NHWC x with the OHWI weight
    w [Cout, k, k, Cin] into ``out`` (see conv_sm90.cu); with int8 weight
    codes w, the int8 form (conv_sm90_i8.cu): ``scale`` and b are the
    float32 dequant scale and bias, a bf16 x is quantised at ``in_inv``
    (int8 codes x are taken as they are).  ``schedule`` (bf16 only, for
    measuring the plan): (slice groups, 0 for the plan's; at most that
    many warpgroups).  The bf16 modes (``mode_of``; conv_sm90_sin.cu,
    conv_sm90_planar.cu): ``sin`` "input" stages sin(x) before the input
    affine, "residual" adds sin(residual); ``planar`` "in" reads x as a
    planar (4 Cp, Hc, Wd) tensor holding the fine image of ``out``'s
    [1, H, W, Cout] in its first H / 2 rows and W / 2 columns, "out" adds
    the planar ``residual`` and stores into the planar ``out`` (its
    elements outside the image stay as they are; bias and residual only:
    act "none", no ``out_affine``), "io" reads x as "in" does and stores
    act(conv + b) into the planar ``out`` as "out" does (no residual, no
    ``out_affine``), the fine image ``image`` = (H, W)."""
    form = form_of(x, w)
    mode = mode_of(sin, planar)
    cin, cout, k = w.shape[3], w.shape[0], w.shape[1]
    ns = plan(lib, cin, cout, k, form, mode)[0]
    s_in, h_in = in_affine if in_affine is not None else (None, None)
    s_out, h_out = out_affine if out_affine is not None else (None, None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = (_ptr(x), _ptr(packed(w, ns)), _ptr(b), _ptr(s_in), _ptr(h_in),
            _ptr(s_out), _ptr(h_out), _ptr(residual))
    if mode in PLANAR_MODES:
        if mode == PLANAR_IO:
            (h, wd), plane = image, x
        else:
            fine, plane = (out, x) if mode == PLANAR_IN else (x, out)
            h, wd = fine.shape[1], fine.shape[2]
        err = lib.bnt_conv_sm90_planar(
            *ptrs, _ptr(out), h, wd, cin, cout, ACT_CODES[act], ns, mode,
            plane.shape[0] // 4, out.shape[0] // 4, plane.shape[1],
            plane.shape[2], None, stream)
        _build.check(err, "conv_sm90 planar launch")
        return
    n, h, wd, _ = x.shape
    if wide(cin, form, mode):
        if schedule is not None:
            raise ValueError("a K-loop launch takes the plan's schedule")
        err = lib.bnt_conv_sm90_kloop(
            *ptrs, _ptr(out_inv), _ptr(out), n, h, wd, cin, cout,
            ACT_CODES[act], int(shuffle), k, ns, None, stream)
        _build.check(err, "conv_sm90 K-loop launch")
        LAUNCHES[KLOOP_LAUNCHES] += 1
        return
    if mode != NONE:
        err = lib.bnt_conv_sm90_sin(*ptrs, _ptr(out), n, h, wd, cin, cout,
                                    ACT_CODES[act], k, ns, mode, None,
                                    stream)
        _build.check(err, "conv_sm90 sin launch")
        return
    if form == BF16:
        args = (*ptrs, _ptr(out_inv), _ptr(out), n, h, wd, cin, cout,
                ACT_CODES[act], int(shuffle), k, ns)
        err = (lib.bnt_conv_sm90(*args, stream) if schedule is None else
               lib.bnt_conv_sm90_at(*args, *schedule, stream))
    else:
        err = lib.bnt_conv_sm90_i8(
            _ptr(x), _ptr(packed(w, ns)), _ptr(scale), _ptr(b),
            _ptr(in_inv) if form == S8Q else None, _ptr(s_in), _ptr(h_in),
            _ptr(s_out), _ptr(h_out), _ptr(residual), _ptr(out_inv),
            _ptr(out), n, h, wd, cin, w.shape[0], ACT_CODES[act],
            int(shuffle), w.shape[1], ns, stream)
    _build.check(err, "conv_sm90 launch")


def _operand(tile, k, form):
    """The flat operand tile [cin_pad * e / 16][group_stride(k)][16 / e]
    (e = op_bytes(form)) of a staged tile [TH + k - 1, TW + k - 1,
    cin_pad]; bf16 values rounded to bf16."""
    chunk = 16 // op_bytes(form)
    ph, pw, cp = tile.shape
    flat = torch.zeros((cp // chunk, group_stride(k), chunk))
    flat[:, :ph * pw] = tile.reshape(ph * pw, -1, chunk).transpose(0, 1)
    if form == BF16:
        flat = flat.to(torch.bfloat16).float()
    return flat.reshape(-1)


def _stage_tile(virt, base, shape, b, ty0, tx0, k, in_mul, in_add,
                form=BF16, in_inv=None, sin_input=False):
    """The staged tile [TH + k - 1, TW + k - 1, cin_pad] (the operand tile
    before ``_operand``) of the output tile at (ty0, tx0) of image b,
    staged from the 16-byte-widened flat span of each in-image row of
    ``virt`` (x flat, ``base`` elements after a 16-byte boundary, NaN
    elsewhere): with ``sin_input`` sin(x), then the prologue affine; in
    ``S8Q`` quantised at ``in_inv`` after the prologue."""
    _, h, w, c = shape
    halo, ph, pw = (k - 1) // 2, TH + k - 1, TW + k - 1
    per16 = 16 // in_bytes(form)         # input elements in 16 bytes
    cp = cin_pad(c, form)
    xs, xe = max(tx0 - halo, 0), min(tx0 - halo + pw, w)
    tile = torch.zeros((ph, pw, cp))
    for r in range(ph):
        iy = ty0 - halo + r
        if not 0 <= iy < h:
            continue
        row = (b * h + iy) * w
        a0, a1 = base + (row + xs) * c, base + (row + xe) * c
        lo, hi = a0 // per16 * per16, -(-a1 // per16) * per16
        raw = virt[lo:hi]
        span = raw[a0 - lo:a0 - lo + (xe - xs) * c].reshape(xe - xs, c)
        v = (torch.sin(span) if sin_input else span) * in_mul + in_add
        if form == S8Q:
            v = quant.quant_act(v, in_inv).float()
        col = xs - (tx0 - halo)
        tile[r, col:col + xe - xs, :c] = v
    return tile


def _stage_planar(xp, image, ty0, tx0, in_mul, in_add):
    """The flat operand tile of the output tile at (ty0, tx0) of a
    ``PLANAR_IN`` launch, staged from its box as the kernel stages it: the
    box [plane][channel][planar_rows(2)][PBX] at planar (tx0 / 2 -
    PBX_LEAD, ty0 / 2 - 1) of the real region (image: H x W fine, C
    channels) of planar xp, zero outside it (the tensor copy's fill); then
    the repack (conv_sm90.cuh::repack_planar): the tile's pixel (r, col),
    fine (ty0 - 1 + r, tx0 - 1 + col), read from plane 2 ((r + 1) & 1) +
    ((col + 1) & 1), box row (r + 1) // 2, column (col + 1) // 2 +
    PBX_LEAD - 1, with the prologue affine on in-image taps, zero
    elsewhere."""
    h, w, c = image
    planes = xp.reshape(4, xp.shape[0] // 4, *xp.shape[1:])
    real = planes[:, :c, :h // 2, :w // 2].float()
    rows, y0, x0 = planar_rows(2), ty0 // 2 - 1, tx0 // 2 - PBX_LEAD
    box = torch.zeros((4, c, rows, PBX))
    ya, yb = max(y0, 0), min(y0 + rows, h // 2)
    xa, xb = max(x0, 0), min(x0 + PBX, w // 2)
    box[:, :, ya - y0:yb - y0, xa - x0:xb - x0] = real[:, :, ya:yb, xa:xb]
    r = torch.arange(TH + 2)[:, None]
    col = torch.arange(TW + 2)[None, :]
    vals = box[2 * ((r + 1) % 2) + (col + 1) % 2, :, (r + 1) // 2,
               (col + 1) // 2 + PBX_LEAD - 1]        # [TH + 2, TW + 2, C]
    fy, fx = ty0 - 1 + r, tx0 - 1 + col
    inside = ((fy >= 0) & (fy < h) & (fx >= 0) & (fx < w))[..., None]
    tile = torch.zeros((TH + 2, TW + 2, cin_pad(c)))
    tile[..., :c] = torch.where(inside, vals * in_mul + in_add, 0.0)
    return _operand(tile, 3, BF16)


def act_zero(act: str) -> float:
    """act(0): what a planar conv's output holds outside the image (0.5
    for outimg, else 0)."""
    from .planar import ACTS

    return float(ACTS[act](torch.zeros(())))


def planar_offsets(h: int, w: int, c: int, cp: int, hc: int, wd: int
                   ) -> torch.Tensor:
    """[h, w, c] element offsets, in a planar (4 cp, hc, wd) tensor, of the
    fine image's pixel (oy, ox), channel n: plane 2 (oy & 1) + (ox & 1),
    row oy // 2, column ox // 2 (conv_sm90.cuh::epilogue_planar)."""
    oy = torch.arange(h)[:, None, None]
    ox = torch.arange(w)[None, :, None]
    n = torch.arange(c)[None, None, :]
    return (((2 * (oy % 2) + ox % 2) * cp + n) * hc + oy // 2) * wd + ox // 2


def emulate(x: torch.Tensor, wpk: torch.Tensor, b: torch.Tensor, *,
            cout: int, k: int, act: str = "none", shuffle: bool = False,
            in_affine=None, out_affine=None, residual=None, out_inv=None,
            scale=None, in_inv=None, groups: int = 1,
            ns: Optional[int] = None, sin: Optional[str] = None,
            planar: Optional[str] = None, image=None,
            out_shape=None) -> torch.Tensor:
    """The kernel's output for NHWC x and the packed weight ``wpk``
    (``pack_weight(w, ns)``, ns by default ``slice_width(cout, form)``,
    the plan's first choice), computed as the kernel
    does on a CPU tensor: bf16, or int8 codes at ``out_inv``.  Int8 codes
    ``wpk`` give the int8 form: x int8 codes, or bf16 quantised at
    ``in_inv``; the exact int32 sums dequantised by ``scale`` and b.  It
    walks the launch's work items (``work_items``) at ``groups`` slice
    groups: each item stages its tile anew and computes its slices.  The
    modes as ``launch`` takes them: ``sin``; ``planar`` "in" with x planar
    and ``image`` = (H, W, Cin) of the fine image it holds, "out" with
    ``residual`` planar (the output: a copy of it, the image's elements
    replaced), "io" with x and ``image`` as "in" and the planar output of
    ``out_shape`` (4 Cpo, Hc, Wd): act(0) (``act_zero``), the image's
    elements replaced."""
    from .planar import ACTS

    mode = mode_of(sin, planar)
    if mode == PLANAR_OUT and (act != "none" or out_affine is not None):
        raise ValueError("a planar output takes bias and residual only")
    if mode == PLANAR_IO and (residual is not None or out_affine is not None):
        raise ValueError("a planar conv takes bias and act only")
    if mode in (PLANAR_IN, PLANAR_IO):
        (h, w, c), n = image, 1
    else:
        n, h, w, c = x.shape
    form = form_of(x, wpk)
    e = op_bytes(form)
    ns = slice_width(cout, form) if ns is None else ns
    cp, pw, gs = cin_pad(c, form), TW + k - 1, group_stride(k)
    kstep, chunk = 32 // e, 16 // e
    nsl = -(-cout // ns)
    base = (x.data_ptr() % 16) // x.element_size()
    virt = torch.full((base + x.numel() + 16,), float("nan"))
    virt[base:base + x.numel()] = x.reshape(-1).float()
    if in_affine is not None:
        in_mul, in_add = in_affine[0].float() + 1, in_affine[1].float()
    else:
        in_mul, in_add = torch.ones(c), torch.zeros(c)
    dtype = torch.float32 if form == BF16 else torch.float64
    wf, a_offs, b_offs = wpk.to(dtype), a_offsets(gs, e), b_offsets(ns, e)
    acc = torch.zeros((n, -(-h // TH) * TH, -(-w // TW) * TW, nsl * ns),
                      dtype=dtype)
    tw, th = -(-w // TW), -(-h // TH)
    # the K loop's chunks (one chunk of every channel without it), each
    # repacked from the staged rows into an operand tile of its own
    loop = wide(c, form, mode)
    parts = chunks(c) if loop else [(0, cp)]
    cp = kloop_pad(c) if loop else cp
    for t, s0, s1 in work_items(n * th * tw, nsl, groups):
        bi, ty0, tx0 = t // (th * tw), t // tw % th * TH, t % tw * TW
        if mode in (PLANAR_IN, PLANAR_IO):
            ops = [_stage_planar(x, image, ty0, tx0, in_mul,
                                 in_add).to(dtype)]
        else:
            staged = _stage_tile(virt, base, x.shape, bi, ty0, tx0, k, in_mul,
                                 in_add, form, in_inv, mode == SIN_INPUT)
            staged = F.pad(staged, (0, cp - staged.shape[-1]))
            ops = [_operand(staged[..., k0:k0 + kc], k, form).to(dtype)
                   for k0, kc in parts]
        for s in range(s0, s1):
            for cc in range(len(parts)):
                ci = chunk_at(s, cc, len(parts))
                (k0, kc), tile = parts[ci], ops[ci]
                for tap in range(k * k):
                    dy, dx = divmod(tap, k)
                    blk = ((s * cp + k0) * k * k + tap * kc) * ns
                    for kk in range(kc // kstep):
                        bmat = wf[blk + kk * ns * kstep + b_offs]
                        for r in range(TH):  # one m64 tile a row
                            p0 = (r + dy) * pw + dx
                            a = tile[(p0 + 2 * kk * gs) * chunk + a_offs]
                            acc[bi, ty0 + r, tx0:tx0 + TW,
                                s * ns:(s + 1) * ns] += a @ bmat.T
    acc = acc[:, :h, :w, :cout].float()
    if form != BF16:
        acc = acc * scale.float()
    v = ACTS[act](acc + b.float())
    if out_affine is not None:
        v = v * (out_affine[0].float() + 1) + out_affine[1].float()
    if shuffle:
        v = F.pixel_shuffle(v.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    if mode in (PLANAR_OUT, PLANAR_IO):
        out = (residual.clone() if mode == PLANAR_OUT else
               torch.full(out_shape, act_zero(act), dtype=torch.bfloat16))
        offs = planar_offsets(h, w, cout, out.shape[0] // 4, *out.shape[1:])
        flat = out.view(-1)
        if mode == PLANAR_OUT:
            v = v + flat[offs].float()
        flat[offs] = v[0].to(out.dtype)
        return out
    if residual is not None:
        r = residual.float()
        v = v + (torch.sin(r) if mode == SIN_RESIDUAL else r)
    if out_inv is not None:
        return quant.quant_act(v, out_inv)
    return v.to(torch.bfloat16)


Conv = Callable[..., torch.Tensor]


def cuda_conv(lib) -> Conv:
    """A conv of the chains' form (x, w, b, output shape, launch options)
    that launches the kernel."""
    def conv(x, w, b, shape, **kw):
        dtype = torch.bfloat16 if kw.get("out_inv") is None else torch.int8
        if kw.get("planar") == "out":  # outside the image: the residual's
            out = kw["residual"].clone()
        elif kw.get("planar") == "io":  # outside the image: act(0)
            out = torch.full(shape, act_zero(kw.get("act", "none")),
                             dtype=dtype, device=x.device)
        else:
            out = torch.empty(shape, dtype=dtype, device=x.device)
        launch(lib, x, w, b, out, **kw)
        return out
    return conv


def emulated_conv(x, w, b, shape, **kw) -> torch.Tensor:
    """A conv of the chains' form computed by ``emulate``."""
    ns = slice_width(w.shape[0], form_of(x, w))
    if kw.get("planar") == "in":
        kw["image"] = (shape[1], shape[2], w.shape[3])
    elif kw.get("planar") == "io":
        kw["image"], kw["out_shape"] = (*kw["image"], w.shape[3]), shape
    return emulate(x, pack_weight(w, ns), b, cout=w.shape[0], k=w.shape[1],
                   **kw)


def _w8a8(weights, **fields) -> dict:
    """The launch options of one conv of a W8A8 stage (``StageWeightsI8``):
    option -> the weights' field of that name (dequant scale, input
    multiplier, int8 output multiplier); {} for bf16 weights."""
    if not hasattr(weights, "scale0"):
        return {}
    return {opt: getattr(weights, f) for opt, f in fields.items()}


def rsft(conv: Conv, y, weights, sft, out_inv=None, input_sin=False
         ) -> torch.Tensor:
    """ResBlockSFT of NHWC y as two convs: t = SFT1(gelu(conv0(SFT0(y)) +
    b0)); y + conv1(t) + b1, stored bf16 or as int8 codes at ``out_inv``.
    ``weights``: (w0, b0, w1, b1) OHWI, or a stage's weights with those
    fields; in W8A8 t is int8 codes at ``inv_t1``.  With ``input_sin``
    (bf16) the block input is sin(y): conv0 stages it (``sin="input"``),
    conv1 adds it (``sin="residual"``)."""
    w0, b0, w1, b1 = (weights if isinstance(weights, tuple) else
                      (weights.w0, weights.b0, weights.w1, weights.b1))
    sins = ({"sin": "input"}, {"sin": "residual"}) if input_sin else ({}, {})
    t = conv(y, w0, b0, y.shape, act="gelu", in_affine=(sft[0], sft[1]),
             out_affine=(sft[2], sft[3]), **sins[0],
             **_w8a8(weights, scale="scale0", in_inv="inv_t0",
                     out_inv="inv_t1"))
    return conv(t, w1, b1, y.shape, residual=y, out_inv=out_inv, **sins[1],
                **_w8a8(weights, scale="scale1"))


def rsft_planar(conv: Conv, xp, weights, sft, hc_real: int, wc_real: int
                ) -> torch.Tensor:
    """The ResBlockSFT of the fine image held in the first hc_real rows and
    wc_real columns of planar xp (4 Cp, Hc, Wd), as two convs: conv0 reads
    xp (``planar="in"``) into fine NHWC t; conv1 adds xp's elements and
    stores into a copy of xp (``planar="out"``).  ``weights``: (w0, b0, w1,
    b1) OHWI."""
    w0, b0, w1, b1 = weights
    shape = (1, 2 * hc_real, 2 * wc_real, w0.shape[0])
    t = conv(xp, w0, b0, shape, act="gelu", in_affine=(sft[0], sft[1]),
             out_affine=(sft[2], sft[3]), planar="in")
    return conv(t, w1, b1, xp.shape, residual=xp, planar="out")


def conv_planar(conv: Conv, xp, w, b, act: str, hc_real: int, wc_real: int,
                cpo: int) -> torch.Tensor:
    """act(conv3x3(x) + b) of the fine image held in the first hc_real rows
    and wc_real columns of planar xp (4 Cp, Hc, Wd), w OHWI, as one conv
    (``planar="io"``) into a planar (4 cpo, Hc, Wd) tensor that holds
    act(0) outside the image."""
    return conv(xp, w, b, (4 * cpo, *xp.shape[1:]), act=act, planar="io",
                image=(2 * hc_real, 2 * wc_real))


def upconv_rsft(conv: Conv, x, weights, sft, out_inv=None) -> torch.Tensor:
    """The stride-2 stage as three convs: y = sin(PixelShuffle2(conv(x) +
    b)), then ``rsft(y)``."""
    n, h, wd, _ = x.shape
    c = weights.w0.shape[0]
    y = conv(x, weights.conv_w, weights.conv_b, (n, 2 * h, 2 * wd, c),
             act="sin", shuffle=True,
             **_w8a8(weights, scale="conv_scale", in_inv="inv_x"))
    return rsft(conv, y, weights, sft, out_inv)


def conv_rsft(conv: Conv, x, weights, sft, head=False, out_inv=None
              ) -> torch.Tensor:
    """The stride-1 stage as three convs, four with the head: y =
    sin(conv(x) + b), then ``rsft(y)``; with ``head`` the conv (3x3 or
    1x1) to 3
    channels with act outimg (tanh(v) * 0.5 + 0.5) on it (N slice 8), whose
    input is, in W8A8, int8 codes at ``inv_h``."""
    c = weights.w0.shape[0]
    y = conv(x, weights.conv_w, weights.conv_b, x.shape[:3] + (c,),
             act="sin", **_w8a8(weights, scale="conv_scale", in_inv="inv_x"))
    if head:  # in W8A8 the head's input: int8 codes at inv_h
        out_inv = getattr(weights, "inv_h", None)
    out = rsft(conv, y, weights, sft, out_inv)
    if head:
        out = conv(out, weights.head_w, weights.head_b, x.shape[:3] + (3,),
                   act="outimg", **_w8a8(weights, scale="head_scale"))
    return out
