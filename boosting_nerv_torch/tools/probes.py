"""Probes of the conv kernels on the card: the port's counterpart of the
Pallas measurement kernels in the repository's ``tools/``, and the same
phase knockouts of the Hopper kernel.

    PYTHONPATH=. python3 -m boosting_nerv_torch.tools.probes [SITE ...]
        [--device cpu] [--size tiny]

SITE is a TPU probe's ``pallas_call`` site (``tools/r3_prologue_probe.py:194``)
or a file (``tools/planar_diag2.py``: all of its sites); none runs all 23.
Each TPU probe split a stage kernel's time on the TPU into phases, timed a
dot ceiling or a K-buffer build.  ``PROBES`` maps every site to what it
measured and to the Hopper probe variants that ask the same question of the
port's kernels (``VARIANTS``; the wrappers are ``ops/kernels/probes.py``):

- K1 ``stage_conv_probe``: the bf16 stage kernel with one phase knocked
  out (staging, GEMM, epilogue, store), or with DIRECT / UNMASKED staging;
- K2 ``stage_conv_i8_probe``: the same for the W8A8 kernel, with PACK and
  ASYNC staging;
- K3 ``gemm_probe``: the kernels' fragment loop on resident operands (the
  tensor-core ceiling), per-tap against flat K, M / N / K / reps sweeps;
- K4 ``stage_build_probe``: the staging of the input tiles alone;
- K5 ``conv_sm90_probe``: the Hopper kernel ``conv_sm90.cu`` with one
  phase knocked out (the repack into the operand tile, the wgmma GEMM, the
  epilogue, the store), at the stage chains and the conv_tile call that K1
  probes, the counterpart of K1 on the kernel that now serves them.

Mosaic's tactics (K-buffers, lane rolls, VMEM slots, compiler-crash
bisects on a deviceless TPU) have no counterpart; where a TPU variant
computes what another one does, its site's note says so.

One line per variant and site: its ms on the card (CUDA events, 5
iterations after 2 warm-ups), its bound (the larger of its bytes at
3.35 TB/s and its multiply-adds at 989 TFLOP/s bf16 / 1979 TOP/s int8,
H100 SXM) and the bound's share of the time; then the phase breakdown of
each stage.  It runs on the card unless ``--device cpu`` is given, which
runs the plain versions (``--size tiny``: small shapes) and prints no
time.  ``chip_smoke.py`` runs every variant as its probe phase, checks
each against its plain version and prints each probe instance's
registers and tensor-core instruction count.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import re
import shutil
import subprocess
import sys
import types
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..ops.kernels import _build, planar, quant, tile_conv
from ..ops.kernels import probes as kp

BF16, F32, I8 = torch.bfloat16, torch.float32, torch.int8
HBM_BYTES_S = 3.35e12                       # H100 SXM, NVIDIA data sheet
PEAK_OPS_S = {"bf16": 989e12, "int8": 1979e12}
TOL = 2e-2            # x max(|plain|, 1), as chip_smoke.py's kernel checks
KNOCKOUTS = ("all", "nostage", "nogemm", "noepi", "nostore")
GEMM_TARGET_OPS = 1e12   # a timed K3 launch's multiply-adds (~1-2 ms)
# (H, W, C_in, C_out) of a stage or conv, at full size and tiny (CPU)
SHAPES = {
    "s7": ((1080, 1920, 51, 51), (9, 50, 40, 40)),
    "s5": ((540, 960, 61, 61), (9, 50, 36, 36)),
    "s3": ((270, 480, 73, 73), (9, 50, 70, 70)),
    "ct6": ((540, 960, 61, 204), (9, 50, 36, 44)),
}
FAMILIES = {  # family: (wrapper, source, the variant of its headline)
    "K1": ("stage_conv_probe",
           "boosting_nerv_torch/ops/csrc/stage_conv_probe.cu", "conv7.all"),
    "K2": ("stage_conv_i8_probe",
           "boosting_nerv_torch/ops/csrc/stage_conv_i8_probe.cu",
           "s7.i8.all"),
    "K3": ("gemm_probe", "boosting_nerv_torch/ops/csrc/gemm_probe.cu",
           "gemm.im2col.flat.r1"),
    "K4": ("stage_build_probe",
           "boosting_nerv_torch/ops/csrc/stage_build_probe.cu", "build.f32"),
    "K5": ("conv_sm90_probe",
           "boosting_nerv_torch/ops/csrc/conv_sm90_probe.cu", "s7.sm90.all"),
}
PROBE_SOURCES = tuple(os.path.basename(src) for _, src, _ in
                      FAMILIES.values()) + tuple(
    f"conv_sm90_probe_{ns}.cu" for ns in (56, 64, 80))
NO_GEMM = kp.PHASES["nogemm"]
# K5 knocks out the repack, its kernel's STAGE phase
LABELS = {"K5": {"nostage": "norepack"}}


def _label(family, phases):
    return LABELS.get(family, {}).get(phases, phases)


class ProbeFailure(Exception):
    pass


@dataclasses.dataclass
class Ctx:
    """Where and at what size variants are built; inputs made once."""
    device: str
    size: str
    gen: torch.Generator
    cache: dict = dataclasses.field(default_factory=dict)

    @staticmethod
    def make(device: str, size: str) -> "Ctx":
        return Ctx(device, size, torch.Generator(device=device).manual_seed(0))

    def shape(self, name):
        full, tiny = SHAPES[name]
        return full if self.size == "full" else tiny

    def rand(self, *shape, scale=1.0, dtype=BF16):
        u = torch.rand(shape, generator=self.gen, device=self.device)
        return ((u * 2 - 1) * scale).to(dtype)

    def codes(self, *shape):
        return torch.randint(-127, 128, shape, generator=self.gen,
                             device=self.device, dtype=I8)

    def once(self, key, make):
        if key not in self.cache:
            self.cache[key] = make()
        return self.cache[key]


@dataclasses.dataclass
class Call:
    """One built variant: ``run`` times it through its wrapper; ``check``
    is (got, want, rule) with rule "exact" (equal bits), "tol" (TOL, int8
    codes dequantised at ``out_inv``) or "sentinel" (untouched output)."""
    run: Callable[[], torch.Tensor]
    ops: float
    nbytes: float
    kind: str = "bf16"
    check: Optional[Tuple[Callable, Optional[Callable], str]] = None
    out_inv: Optional[torch.Tensor] = None
    plain: Optional[Callable] = None
    library: Optional[Callable] = None


@dataclasses.dataclass(frozen=True)
class Variant:
    family: str           # K1..K4, or "library" for a yardstick
    what: str
    make: Callable[[Ctx], Call]


@dataclasses.dataclass(frozen=True)
class Site:
    measured: str         # what the TPU probe measured
    variants: Tuple[str, ...]
    shape: str
    bound: str            # the bound's formula
    note: str = ""


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(ops: float, nbytes: float, kind: str = "bf16"):
    """(least ms for the work, "bytes" or "operations")."""
    t_ops, t_bytes = ops / PEAK_OPS_S[kind], nbytes / HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _buf(shape, dtype, store, device):
    """A preallocated output; SENTINEL-filled where the store is off."""
    if store:
        return torch.empty(shape, dtype=dtype, device=device)
    return torch.full(shape, kp.SENTINEL[dtype], dtype=dtype, device=device)


def _conv_w(ctx, cin, cout):
    return (ctx.rand(cout, 3, 3, cin, scale=(9 * cin) ** -0.5),
            ctx.rand(cout, scale=0.1))


def _sft(ctx, c):
    return ctx.rand(4, c, scale=0.3, dtype=F32)


def _stage_ops(h, w, cin, c, head):
    return 2 * 9 * h * w * (cin * c + 2 * c * c + (3 * c if head else 0))


def _checks(run, plain, reference, phases):
    if phases == "nostore":
        return (run, None, "sentinel")
    if reference is not None:
        return (run, reference, "exact")
    return (run, plain, "tol")


# --------------------------------------------------------------------- #
# K1: the bf16 stage kernel
# --------------------------------------------------------------------- #

def _stage_bf16(ctx, name, head):
    def make():
        h, w, cin, c = ctx.shape(name)
        x = ctx.rand(1, h, w, cin)
        ws = planar.StageWeights(
            *_conv_w(ctx, cin, c), *_conv_w(ctx, c, c), *_conv_w(ctx, c, c),
            *(_conv_w(ctx, c, 3) if head else (None, None)))
        return x, ws, _sft(ctx, c)
    return ctx.once(("bf16", name, head), make)


def _k1_stage(name, head, phases):
    def make(ctx):
        x, ws, sft = _stage_bf16(ctx, name, head)
        _, h, w, cin = x.shape
        c = ws.w0.shape[0]
        store = phases != "nostore"
        bufs = [_buf((1, h, w, c), BF16, store, x.device) for _ in range(3)]
        bufs.append(_buf((1, h, w, 3), BF16, store, x.device) if head
                    else None)

        def run():
            return kp.conv_rsft_probe(x, ws, sft, head=head, phases=phases,
                                      bufs=bufs)

        def plain():
            return kp.conv_rsft_probe(x, ws, sft, head=head, phases=phases,
                                      plain=True)

        ref = ((lambda: kp.conv_rsft_stage(x, ws, sft, head=head))
               if phases == "all" else None)
        return Call(run, _stage_ops(h, w, cin, c, head),
                    _nbytes(x, bufs[3] if head else bufs[2], sft,
                            *vars(ws).values()),
                    check=_checks(run, plain, ref, phases), plain=plain)
    return make


def _conv_inputs(ctx, name):
    def make():
        h, w, cin, cout = ctx.shape(name)
        return (ctx.rand(1, h, w, cin), *_conv_w(ctx, cin, cout))
    return ctx.once(("conv", name), make)


def _k1_conv(name, phases, staging="smem"):
    def make(ctx):
        x, wt, b = _conv_inputs(ctx, name)
        _, h, w, cin = x.shape
        cout = wt.shape[0]
        out = _buf((1, h, w, cout), BF16, phases != "nostore", x.device)
        mode = {"phases": phases, "staging": staging}

        def run():
            return kp.stage_conv_probe(x, wt, b, out=out, **mode)

        def plain():
            return kp.stage_conv_probe_plain(x, wt, b, **mode)

        ref = ((lambda: _stage_conv(x, wt, b))
               if phases == "all" else None)
        lib = ((lambda: F.conv2d(planar.nchw(x), wt.permute(0, 3, 1, 2), b,
                                 padding=1))
               if phases == "all" and staging == "smem" else None)
        return Call(run, 2 * 9 * h * w * cin * cout, _nbytes(x, out, wt, b),
                    check=_checks(run, plain, ref, phases), plain=plain,
                    library=lib)
    return make


def _stage_conv(x, wt, b):
    """One launch of the stage kernel's production instance (K1's exact
    reference for a conv + bias)."""
    out = torch.empty(x.shape[:3] + (wt.shape[0],), dtype=x.dtype,
                      device=x.device)
    planar.launch_conv(_build.load_library(), x, wt, b, out)
    return out


def _k1_rsft(rung):
    """The ResBlockSFT launch pair of the planar phase's stage 7 (C 51 at
    1080 x 1920), one piece of it toggled (rsft_planar_bisect.py)."""
    def make(ctx):
        def inputs():
            h, w, c, _ = ctx.shape("s7")
            return (ctx.rand(1, h, w, c), *_conv_w(ctx, c, c),
                    *_conv_w(ctx, c, c), _sft(ctx, c))
        x, w0, b0, w1, b1, sft = ctx.once(("rsft", "s7"), inputs)
        t_buf = torch.empty_like(x)
        o_buf = torch.empty_like(x)

        def chain(launch, bufs=(None, None)):
            t = launch(x, w0, b0, act="none" if rung == "nogelu" else "gelu",
                       in_affine=(sft[0], sft[1]),
                       out_affine=(sft[2], sft[3]),
                       staging="unmasked" if rung == "unmasked" else "smem",
                       out=bufs[0])
            if rung == "conv0only":
                return t
            return launch(t, w1, b1, residual=x, out=bufs[1])

        def run():
            return chain(kp.stage_conv_probe, (t_buf, o_buf))

        def plain():
            return chain(kp.stage_conv_probe_plain)

        ref = ((lambda: tile_conv.resblock_sft_tile(x, w0, b0, w1, b1, sft))
               if rung == "full" else None)
        _, h, w, c = x.shape
        launches = 1 if rung == "conv0only" else 2
        return Call(run, 2 * 9 * h * w * c * c * launches,
                    _nbytes(x, o_buf, w0, b0, w1, b1, sft),
                    check=_checks(run, plain, ref, "all"), plain=plain)
    return make


# --------------------------------------------------------------------- #
# K5: the Hopper conv kernel
# --------------------------------------------------------------------- #

def _k5_stage(name, head, phases):
    """K1's stage chain on conv_sm90.cu, the production wrapper
    ``planar.fused_conv_rsft`` "all"'s exact reference."""
    def make(ctx):
        x, ws, sft = _stage_bf16(ctx, name, head)
        _, h, w, cin = x.shape
        c = ws.w0.shape[0]
        store = phases != "nostore"
        bufs = [_buf((1, h, w, c), BF16, store, x.device) for _ in range(3)]
        bufs.append(_buf((1, h, w, 3), BF16, store, x.device) if head
                    else None)
        mode = {"head": head, "phases": phases, "sm90": True}

        def run():
            return kp.conv_rsft_probe(x, ws, sft, bufs=bufs, **mode)

        def plain():
            return kp.conv_rsft_probe(x, ws, sft, plain=True, **mode)

        ref = ((lambda: planar.fused_conv_rsft(x, ws, sft, head=head))
               if phases == "all" else None)
        return Call(run, _stage_ops(h, w, cin, c, head),
                    _nbytes(x, bufs[3] if head else bufs[2], sft,
                            *vars(ws).values()),
                    check=_checks(run, plain, ref, phases), plain=plain)
    return make


def _k5_conv(name, phases):
    """A conv + bias on conv_sm90.cu (``tile_conv.conv_tile``'s launch,
    "all"'s exact reference)."""
    def make(ctx):
        x, wt, b = _conv_inputs(ctx, name)
        _, h, w, cin = x.shape
        cout = wt.shape[0]
        out = _buf((1, h, w, cout), BF16, phases != "nostore", x.device)

        def run():
            return kp.conv_sm90_probe(x, wt, b, phases=phases, out=out)

        def plain():
            return kp.stage_conv_probe_plain(x, wt, b, phases=phases)

        ref = ((lambda: tile_conv.conv_tile(x, wt, b, k=3))
               if phases == "all" else None)
        return Call(run, 2 * 9 * h * w * cin * cout, _nbytes(x, out, wt, b),
                    check=_checks(run, plain, ref, phases), plain=plain)
    return make


# --------------------------------------------------------------------- #
# K2: the W8A8 stage kernel
# --------------------------------------------------------------------- #

def _stage_i8(ctx, name, head):
    """A codes-in W8A8 stride-1 stage: int8 x, folded weights and random
    bounds; codes out (``out_inv``) without the head."""
    def make():
        h, w, cin, c = ctx.shape(name)

        def conv(ci, co):
            wt, b = _conv_w(ctx, ci, co)
            return types.SimpleNamespace(weight=wt.permute(0, 3, 1, 2),
                                         bias=b)

        def bnd(n):
            return ctx.rand(n, dtype=F32).abs() + 0.5

        bounds = {"x": bnd(cin), "t0": bnd(c), "t1": bnd(c), "h": bnd(c)}
        ws = planar.StageWeightsI8.from_oihw(
            conv(cin, c), conv(c, c), conv(c, c),
            conv(c, 3) if head else None, bounds=bounds)
        out_inv = None if head else quant.inv_from_bound(bnd(c)).to(
            ctx.device)
        return ctx.codes(1, h, w, cin), ws, _sft(ctx, c), out_inv
    return ctx.once(("i8", name, head), make)


def _k2_stage(name, head, phases, staging="smem"):
    def make(ctx):
        x, ws, sft, out_inv = _stage_i8(ctx, name, head)
        _, h, w, cin = x.shape
        c = ws.w0.shape[0]
        store = phases != "nostore"
        bufs = [_buf((1, h, w, c), BF16, store, x.device),
                _buf((1, h, w, c), I8, store, x.device),
                _buf((1, h, w, c), I8 if head or out_inv is not None
                     else BF16, store, x.device),
                _buf((1, h, w, 3), BF16, store, x.device) if head else None]
        mode = {"head": head, "out_inv": out_inv, "phases": phases,
                "staging": staging}

        def run():
            return kp.conv_rsft_i8_probe(x, ws, sft, bufs=bufs, **mode)

        def plain():
            return kp.conv_rsft_i8_probe(x, ws, sft, plain=True, **mode)

        ref = ((lambda: planar.fused_conv_rsft_i8(x, ws, sft, head=head,
                                                  out_inv=out_inv))
               if phases == "all" else None)
        return Call(run, _stage_ops(h, w, cin, c, head),
                    _nbytes(x, bufs[3] if head else bufs[2], sft,
                            *vars(ws).values()), kind="int8",
                    check=_checks(run, plain, ref, phases),
                    out_inv=out_inv, plain=plain)
    return make


def _k2_conv(variant):
    """Stage 7's first launch, codes in, bf16 sin(y) out: the production
    staging ("all"), the same on codes whose channels are padded to 64
    ("pad64"), and cp.async staging of the padded codes ("async")."""
    def make(ctx):
        x, ws, _, _ = _stage_i8(ctx, "s7", True)
        cin = x.shape[3]
        pad = (cin + 31) // 32 * 32 - cin
        xp, wp = ctx.once(("i8pad", "s7"), lambda: (
            F.pad(x, (0, pad)), F.pad(ws.conv_w, (0, pad))))
        args = {"all": (x, ws.conv_w), "pad64": (xp, wp),
                "async": (xp, ws.conv_w)}[variant]
        staging = "async" if variant == "async" else "smem"
        out = torch.empty(x.shape[:3] + (ws.conv_w.shape[0],), dtype=BF16,
                          device=x.device)

        def launch(xx, codes, stg, fn=kp.stage_conv_i8_probe, **kw):
            return fn(xx, codes, ws.conv_scale, ws.conv_b, act="sin",
                      staging=stg, **kw)

        def run():
            return launch(*args, staging, out=out)

        def plain():
            return launch(*args, staging, fn=kp.stage_conv_i8_probe_plain)

        ref = (None if variant == "all"
               else lambda: launch(x, ws.conv_w, "smem"))
        _, h, w, _ = x.shape
        return Call(run, 2 * 9 * h * w * cin * ws.conv_w.shape[0],
                    _nbytes(x, out, ws.conv_w, ws.conv_scale, ws.conv_b),
                    kind="int8", check=_checks(run, plain, ref, "all"),
                    plain=plain)
    return make


# --------------------------------------------------------------------- #
# K3: the fragment loop's ceiling
# --------------------------------------------------------------------- #

def _k3(taps=(3, 3), kt=64, n=64, rows=4, i8=False, n_chunk=8, act="none",
        reps=None, real=False):
    """A GEMM-probe point.  ``real``: as many A tiles as blocks and one
    pass (a plain GEMM, beside torch.matmul); else 8 tiles shared by the
    blocks that fill the card, reps chosen for ~GEMM_TARGET_OPS."""
    def make(ctx):
        cuda = ctx.device != "cpu"
        grid = kp.gemm_probe_fill(rows, taps, kt, n, i8, n_chunk) if cuda \
            else 2
        tiles = grid if real else min(grid, 8)
        th, tw = taps
        shape_a = (tiles, rows + th - 1, 32 + tw - 1, kt)
        shape_b = (th * tw, n, kt)
        if i8:
            a, b = ctx.codes(*shape_a), ctx.codes(*shape_b)
        else:
            a, b = ctx.rand(*shape_a), ctx.rand(*shape_b)
        step = 32 if i8 else 16
        kpad = -(-kt // step) * step
        mma_ops = 2 * grid * 32 * rows * -(-n // 8) * 8 * th * tw * kpad
        r = reps or (max(1, round(GEMM_TARGET_OPS / mma_ops)) if cuda
                     and ctx.size == "full" else 1)
        mode = {"taps": taps, "n_chunk": n_chunk, "act": act,
                "alpha": 1e-4 if i8 else 1.0}

        def run():
            return kp.gemm_probe(a, b, reps=r, grid=grid, **mode)

        def plain():
            return kp.gemm_probe_plain(a, b, reps=r, **mode)

        check = (lambda: kp.gemm_probe(a, b, reps=1, **mode),
                 lambda: kp.gemm_probe_plain(a, b, reps=1, **mode), "tol")
        lib = ((lambda: torch.matmul(a.reshape(-1, kt), b[0].t()))
               if real and taps == (1, 1) and not i8 else None)
        c_bytes = tiles * 32 * rows * n * 4
        return Call(run, 2 * grid * 32 * rows * n * th * tw * kt * r,
                    _nbytes(a, b) + c_bytes, kind="int8" if i8 else "bf16",
                    check=check, plain=plain, library=lib)
    return make


def _matmul(ctx):
    """planar_diag4.py's control: one large bf16 product, a library
    yardstick (torch.matmul), not a port of anything."""
    m, k, n = (4096, 4096, 8192) if ctx.size == "full" else (64, 64, 128)
    a, b = ctx.rand(m, k), ctx.rand(k, n)
    return Call(lambda: torch.matmul(a, b), 2 * m * k * n,
                _nbytes(a, b) + m * n * 2)


# --------------------------------------------------------------------- #
# K4: staging alone
# --------------------------------------------------------------------- #

def _k4(mode, affine=False):
    """Staging of stage 7's input tiles (1080 x 1920 x 51) at the
    production launch's shared memory, so at its occupancy."""
    def make(ctx):
        def inputs():
            h, w, c, _ = ctx.shape("s7")
            inv = quant.inv_from_bound(ctx.rand(c, dtype=F32).abs() + 0.5)
            return ctx.rand(1, h, w, c), _sft(ctx, c), inv.to(ctx.device)
        x, sft, inv = ctx.once(("build", "s7"), inputs)
        c = x.shape[3]
        i8 = mode.startswith("i8")
        smem = 0
        if ctx.device != "cpu":
            lib = _build.load_library()
            smem = (lib.bnt_stage_conv3x3_i8_smem(c, c) if i8
                    else lib.bnt_stage_conv_smem(c, c, 3))
        kw = {"mode": mode, "in_affine": (sft[0], sft[1]) if affine else None,
              "in_inv": inv if i8 else None, "smem": smem}

        def run():
            return kp.stage_build_probe(x, store=False, **kw)

        def plain():
            return kp.stage_build_probe_plain(x, **kw)

        # the bf16 affine may be contracted to one fma on the card
        rule = "tol" if affine and not i8 else "exact"
        check = (lambda: kp.stage_build_probe(x, store=True, **kw), plain,
                 rule)
        return Call(run, 0, _nbytes(x), check=check, plain=plain)
    return make


# --------------------------------------------------------------------- #
# the registry
# --------------------------------------------------------------------- #

def _variants() -> Dict[str, Variant]:
    v: Dict[str, Variant] = {}
    stages = (("s7.bf16", "s7", True, "fused_conv_rsft + head, 4 launches, "
               "1080x1920x51 (stage 7)"),
              ("s5.bf16", "s5", False, "fused_conv_rsft, 3 launches, "
               "540x960x61 (stage 5)"),
              ("s3.bf16", "s3", False, "fused_conv_rsft, 3 launches, "
               "270x480x73 (stage 3, CK 3)"))
    for key, name, head, what in stages:
        for ph in KNOCKOUTS:
            v[f"{key}.{ph}"] = Variant("K1", f"{what}, {ph}",
                                       _k1_stage(name, head, ph))
    for key, name, what in (
            ("conv7", "s7", "conv 51->51 + bias, 1080x1920 (v2 conv_tile "
             "stage 7; pallas_conv_probe's conv)"),
            ("ct6", "ct6", "conv 61->204 + bias, 540x960 (v2 conv_tile "
             "stage 6)")):
        for ph in KNOCKOUTS:
            v[f"{key}.{ph}"] = Variant("K1", f"{what}, {ph}",
                                       _k1_conv(name, ph))
    v["conv7.direct"] = Variant(
        "K1", "conv 51->51 + bias, 1080x1920, A fragments from device "
        "memory per tap (no s_in tile)", _k1_conv("s7", "all", "direct"))
    for key, name, head, what in (
            ("s7.sm90", "s7", True, "fused_conv_rsft + head on conv_sm90.cu, "
             "4 launches, 1080x1920x51 (stage 7)"),
            ("s5.sm90", "s5", False, "fused_conv_rsft on conv_sm90.cu, 3 "
             "launches, 540x960x61 (stage 5)"),
            ("s3.sm90", "s3", False, "fused_conv_rsft on conv_sm90.cu, 3 "
             "launches, 270x480x73 (stage 3)")):
        for ph in KNOCKOUTS:
            v[f"{key}.{ph}"] = Variant("K5", f"{what}, {_label('K5', ph)}",
                                       _k5_stage(name, head, ph))
    for ph in KNOCKOUTS:
        v[f"ct6.sm90.{ph}"] = Variant(
            "K5", f"conv 61->204 + bias on conv_sm90.cu, 540x960 (v2 "
            f"conv_tile stage 6), {_label('K5', ph)}", _k5_conv("ct6", ph))
    for rung, what in (("full", "conv0 (gelu, SFT, in-image test) + conv1"),
                       ("conv0only", "conv0 alone (second launch off)"),
                       ("nogelu", "conv0 with act none + conv1"),
                       ("unmasked", "conv0 with the affine on padding taps "
                        "(in-image test off) + conv1")):
        v[f"rsft7.{rung}"] = Variant(
            "K1", f"ResBlockSFT 51 at 1080x1920: {what}", _k1_rsft(rung))
    for key, name, head, what in (
            ("s7.i8", "s7", True, "fused_conv_rsft_i8 + head, codes in, "
             "1080x1920x51 (stage 7)"),
            ("s5.i8", "s5", False, "fused_conv_rsft_i8, codes in and out, "
             "540x960x61 (stage 5)")):
        for ph in KNOCKOUTS:
            v[f"{key}.{ph}"] = Variant("K2", f"{what}, {ph}",
                                       _k2_stage(name, head, ph))
        v[f"{key}.pack"] = Variant("K2", f"{what}, PACK staging",
                                   _k2_stage(name, head, "all", "pack"))
    for var, what in (("all", "production staging, 51 channels"),
                      ("pad64", "thread stores, codes padded to 64 channels"),
                      ("async", "cp.async, codes padded to 64 channels")):
        v[f"s7conv.i8.{var}"] = Variant(
            "K2", f"stage 7 conv, codes in, bf16 sin out: {what}",
            _k2_conv(var))
    gemms = {
        "gemm.im2col.pertap": ("per-tap 3x3, K 9 x 51 (64), N 51, M 128",
                               _k3(kt=51, n=51)),
        "gemm.im2col.flat": ("flat K 459 (464), N 51, M 128",
                             _k3(taps=(1, 1), kt=459, n=51)),
        "gemm.im2col.flat.r1": ("flat K 459, N 51, M 128, one pass, a tile "
                                "a block (a plain GEMM)",
                                _k3(taps=(1, 1), kt=459, n=51, reps=1,
                                    real=True)),
        "gemm.im2col.pertap.int8": ("int8 per-tap 3x3, K 9 x 51 (64), N 51, "
                                    "M 128", _k3(kt=51, n=51, i8=True)),
        "gemm.base": ("per-tap 3x3, K 9 x 64, N 64, M 128", _k3()),
        "gemm.int8.base": ("int8 per-tap 3x3, K 9 x 64, N 64, M 128",
                           _k3(i8=True)),
        "gemm.r1": ("per-tap, one pass", _k3(reps=1)),
        "gemm.r1.sin": ("per-tap, one pass, sine epilogue",
                        _k3(reps=1, act="sin")),
        "gemm.r8": ("per-tap, 8 passes", _k3(reps=8)),
        "gemm.chunk2": ("per-tap, accumulators 2 n8 tiles a pass",
                        _k3(n_chunk=2)),
        "gemm.chunk4": ("per-tap, accumulators 4 n8 tiles a pass",
                        _k3(n_chunk=4)),
        "gemm.k768.bf16": ("flat K 768, N 64, M 64",
                           _k3(taps=(1, 1), kt=768, rows=2)),
        "gemm.k768.int8": ("int8 flat K 768, N 64, M 64",
                           _k3(taps=(1, 1), kt=768, rows=2, i8=True)),
        "gemm.dy3": ("3 x 1 taps, K 3 x 192, N 64, M 128",
                     _k3(taps=(3, 1), kt=192)),
        "gemm.m32": ("per-tap, M 32 (1 warp)", _k3(rows=1)),
        "gemm.m64": ("per-tap, M 64", _k3(rows=2)),
        "gemm.m256": ("per-tap, M 256 (8 warps)", _k3(rows=8)),
        "gemm.n32": ("per-tap, N 32", _k3(n=32)),
        "gemm.k32": ("per-tap, K 9 x 32", _k3(kt=32)),
        "gemm.k128": ("per-tap, K 9 x 128", _k3(kt=128)),
    }
    for key, (what, make) in gemms.items():
        v[key] = Variant("K3", what, make)
    v["lib.matmul4096"] = Variant("library", "torch.matmul 4096x4096 @ "
                                  "4096x8192 bf16", _matmul)
    for key, mode, affine, what in (
            ("build.f32", "f32", False, "bf16 -> f32 -> bf16, no affine"),
            ("build.f32_affine", "f32", True, "bf16 -> f32, SFT affine, "
             "-> bf16"),
            ("build.raw16", "raw16", False, "16-bit copies, two channels a "
             "32-bit load where aligned"),
            ("build.i8", "i8", True, "affine, quantise, one byte store a "
             "code"),
            ("build.i8_pack", "i8_pack", True, "affine, quantise, four "
             "codes a 32-bit store")):
        v[key] = Variant("K4", f"staging of 1080x1920x51: {what}",
                         _k4(mode, affine))
    return v


VARIANTS = _variants()

_STAGE7 = ("B+head@540 is stage 7 + head: 1080x1920x51 -> RGB, NHWC here "
           "(planar 4 x 64 x 540 x 1024 on the TPU)")
_STAGE_BOUND = ("2 * 9 * H * W * (Cin * C + 2 * C * C [+ 3 * C]) operations "
                "at the operand type's peak, or the bytes of x, the output "
                "and the weights at 3.35 TB/s")
_GEMM_BOUND = ("2 * blocks * M * N * taps * K * reps operations (real "
               "channels) at the operand type's peak")
_BUILD_BOUND = "x's bytes (read once) at 3.35 TB/s"
_PACK = ("The TPU ladder bisected a Mosaic compiler abort (deviceless v5e): "
         "no counterpart; on Hopper each rung is checked and its registers "
         "and spills are reported (stage_build_probe.cu and "
         "stage_conv_i8_probe.cu instances).")

PROBES: Dict[str, Site] = {
    "tools/im2col_probe.py:40": Site(
        "9 small (51,51)@(51,1920) dots against one concatenated-K "
        "(51,459)@(459,1920) dot",
        ("gemm.im2col.pertap", "gemm.im2col.flat", "gemm.im2col.flat.r1",
         "gemm.im2col.pertap.int8"),
        "K3: per-tap K 9 x 51 (padded to 64) against flat K 459 (padded "
        "to 464), N 51, M 128 a block", _GEMM_BOUND,
        "flat.r1 is a real GEMM beside torch.matmul on the same operands"),
    "tools/pallas_conv_probe.py:64": Site(
        "a CHW 3x3 conv 51->51 at 1080x1920 against XLA's conv",
        ("conv7.all",), "K1 PHASE_ALL, act none, 51->51 at 1080x1920; "
        "library: F.conv2d bf16 channels_last",
        "2 * 9 * H * W * 51 * 51 operations or the bytes of x, out, w"),
    "tools/planar_diag.py:65": Site(
        "the planar conv kernel: dots only, + DMA, + K-buffer build "
        "(f32 and bf16-copy builds)",
        ("conv7.nostage", "conv7.direct", "conv7.all"),
        "K1 at stage 7's conv, 1080x1920x51 (Cp 64): no STAGE (dots only), "
        "DIRECT (operands from device memory, no tile), ALL (the staged "
        "tile)", "2 * 9 * H * W * 51 * 51 operations",
        "the bf16-copy K-buffer build is a Mosaic tactic; its question "
        "(staging without the f32 round trip) is K4 raw16"),
    "tools/planar_diag2.py:63": Site(
        "the dot ceiling's sine epilogue, chunked accumulators (nc), one "
        "K = 768 bf16 dot",
        ("gemm.r1", "gemm.r1.sin", "gemm.base", "gemm.chunk4", "gemm.chunk2",
         "gemm.k768.bf16"), "K3", _GEMM_BOUND),
    "tools/planar_diag2.py:148": Site(
        "one K = 768 int8 dot, int32 accumulation, sine epilogue",
        ("gemm.k768.int8", "gemm.k768.bf16", "gemm.int8.base"),
        "K3 flat K 768, N 64, M 64; int8 per-tap at the stage shape",
        _GEMM_BOUND),
    "tools/planar_diag2.py:187": Site(
        "the dy3 fine-grid dots: 3 x (64,192)@(192,16384)",
        ("gemm.dy3",), "K3: 3 x 1 taps of K 192, N 64, M 128", _GEMM_BOUND),
    "tools/planar_diag3.py:67": Site(
        "the pure dot's M sweep (M 64..512, K 768)",
        ("gemm.m32", "gemm.m64", "gemm.base", "gemm.m256"),
        "K3 per-tap: M = 32 rows a warp, 1-8 warps", _GEMM_BOUND),
    "tools/planar_diag3.py:115": Site(
        "merged-py planar dots (one wide dot against two half dots)",
        ("gemm.n32", "gemm.base"), "K3 per-tap: N 64 in one block against "
        "N 32", _GEMM_BOUND),
    "tools/planar_diag4.py:84": Site(
        "the dot ceiling's M / K / th / nrep sweep against XLA's 4096 x "
        "4096 x 8192 bf16 product",
        ("gemm.k32", "gemm.base", "gemm.k128", "gemm.r1", "gemm.r8",
         "gemm.m64", "gemm.m256", "lib.matmul4096"),
        "K3 (th is the warps a block, as M); control torch.matmul 4096 x "
        "4096 x 8192 bf16", _GEMM_BOUND,
        "lib.matmul4096 is a library yardstick, not a port"),
    "tools/r3_prologue_probe.py:194": Site(
        "B+head@540: cur / sslot / nodots / noprolog",
        ("s7.bf16.all", "s7.bf16.nogemm", "s7.bf16.nostage", "s7.sm90.all",
         "s7.sm90.nogemm", "s7.sm90.nostage"),
        "K1 on fused_conv_rsft + head (4 launches) at 1080x1920x51, on the "
        "stage kernel; K5 the same on conv_sm90.cu: " + _STAGE7,
        _STAGE_BOUND,
        "sslot computes exactly what cur computes (a VMEM slot tactic): "
        "both are s7.bf16.all"),
    "tools/rsft_planar_bisect.py:125": Site(
        "rsft_planar variants with the in-image mask, conv2 and gelu "
        "toggled (a Mosaic compile bisect)",
        ("rsft7.full", "rsft7.conv0only", "rsft7.nogelu", "rsft7.unmasked"),
        "K1 on the ResBlockSFT launch pair at the planar phase's shape (C "
        "51, 1080x1920)", "2 * 9 * H * W * 51 * 51 per launch",
        "registers per rung: full, conv0only and nogelu run the PHASE_ALL "
        "instance (CK 2), unmasked the STAGE_UNMASKED one"),
    "tools/r3_v6_probe.py:158": Site(
        "the planar conv without the K-buffer build (taps as windows on "
        "the loaded tile)", ("conv7.direct", "conv7.all"),
        "K1 DIRECT against ALL, conv 51->51 at 1080x1920",
        "2 * 9 * H * W * 51 * 51 operations"),
    "tools/r4_int8_probe.py:168": Site(
        "int8 B+head@540 without the K-buffer builds (noprolog)",
        ("s7.i8.nostage", "s7.i8.all"),
        "K2 no STAGE on fused_conv_rsft_i8 + head at 1080x1920x51",
        _STAGE_BOUND),
    "tools/r4_int8_probe.py:225": Site(
        "the int8 K-buffer build (quantise, roll, int8 stores)",
        ("build.i8", "build.f32_affine"), "K4 I8 at stage 7's tile",
        _BUILD_BOUND),
    "tools/r4_roll_i16_probe.py:56": Site(
        "16-bit lane rolls (bf16 moved without the f32 round trip), a "
        "deviceless compile check", ("build.raw16", "build.f32"),
        "K4 RAW16 against F32 at stage 7's tile", _BUILD_BOUND),
    "tools/r4_layout_probe.py:168": Site(
        "int8 operands written by the VPU (touch) against by DMA (dma)",
        ("s7conv.i8.all", "s7conv.i8.pad64", "s7conv.i8.async"),
        "K2 ASYNC against thread-store staging, codes in, stage 7's conv",
        "2 * 9 * H * W * 51 * 51 operations at 1979 TOP/s",
        "pad64 isolates the padded layout that cp.async needs (16-byte "
        "pieces) from the copy path"),
    "tools/r4_i8_build_probe.py:202": Site(
        "int8 B+head@540 without the dots (nodots)",
        ("s7.i8.nogemm", "s7.i8.all"),
        "K2 no GEMM on fused_conv_rsft_i8 + head at 1080x1920x51",
        _STAGE_BOUND),
    "tools/r4_i8_build_probe.py:299": Site(
        "K-buffer build strategies bf16 / i8_f32 / i8_i8roll / i8_pack, "
        "timed", ("build.f32", "build.i8", "build.i8_pack"),
        "K4 F32 / I8 / I8_PACK at stage 7's tile", _BUILD_BOUND,
        "i8_i8roll and i8_pack differ only in the TPU's roll; both are "
        "I8_PACK"),
    "tools/r4_i8_build_probe.py:320": Site(
        "the build strategies' K-buffers, checked for equal codes",
        ("build.i8", "build.i8_pack"),
        "K4 I8 and I8_PACK checked against quant.py's codes", _BUILD_BOUND),
    "tools/r5_pack_bisect.py:131": Site(
        "the packed-int8 K-buffer ladder (pack build, one r1 group, + dot)",
        ("build.i8_pack", "s7.i8.pack"),
        "K4 I8_PACK (micro) -> K2 PACK (full kernel)", _BUILD_BOUND, _PACK),
    "tools/r5_pack_bisect.py:147": Site(
        "the micro rungs: int8 store, bitcast, roll, mask",
        ("build.i8", "build.i8_pack"), "K4 I8 -> I8_PACK", _BUILD_BOUND,
        _PACK),
    "tools/r5_pack_bisect2.py:66": Site(
        "one ingredient at a time from a passing roll to the failing build",
        ("build.i8_pack",), "K4 I8_PACK", _BUILD_BOUND, _PACK),
    "tools/r5_pack_aot.py:107": Site(
        "the pack build from micro kernel to the full stage kernels",
        ("build.i8_pack", "s7.i8.pack", "s5.i8.pack"),
        "K4 I8_PACK (micro) -> K2 PACK in the full stage-7 + head and "
        "stage-5 chains", _STAGE_BOUND, _PACK),
}

BREAKDOWNS = (
    ("stage 7 + head, bf16 (K1)", "s7.bf16"),
    ("stage 7 + head, int8 (K2)", "s7.i8"),
    ("stage 5, bf16 (K1)", "s5.bf16"),
    ("stage 5, int8 (K2)", "s5.i8"),
    ("stage 3, bf16 (K1)", "s3.bf16"),
    ("conv_tile stage 6, v2 (K1)", "ct6"),
    ("conv 51->51 (conv_tile stage 7, v2; K1)", "conv7"),
    ("stage 7 + head, bf16 on conv_sm90.cu (K5)", "s7.sm90"),
    ("stage 5, bf16 on conv_sm90.cu (K5)", "s5.sm90"),
    ("stage 3, bf16 on conv_sm90.cu (K5)", "s3.sm90"),
    ("conv_tile stage 6, v2, on conv_sm90.cu (K5)", "ct6.sm90"),
)


# --------------------------------------------------------------------- #
# running
# --------------------------------------------------------------------- #

def cuda_ms(fn, iters: int = 5, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_call(key: str, call: Call) -> float:
    """Hold the variant against its plain version or reference; returns
    the max abs error (0 for an exact rule).  Raises ProbeFailure."""
    got_fn, want_fn, rule = call.check
    got = got_fn()
    if rule == "sentinel":
        bad = (got.float() != float(kp.SENTINEL[got.dtype])).sum().item()
        if bad:
            raise ProbeFailure(f"{key}: {bad} stored elements with the "
                               "store off")
        return 0.0
    want = want_fn()
    if rule == "exact":
        if got.dtype != want.dtype or not torch.equal(got, want):
            diff = (got.float() - want.float()).abs().max().item()
            raise ProbeFailure(f"{key}: not bitwise equal to its reference "
                               f"(max abs diff {diff})")
        return 0.0
    g, w = got.float(), want.float()
    if got.dtype == I8:
        inv = call.out_inv
        scale = torch.where(inv > 0, 1 / inv, torch.zeros_like(inv))
        g, w = g * scale, w * scale
    err = (g - w).abs().max().item()
    tol = TOL * max(w.abs().max().item(), 1.0)
    if not err <= tol:
        raise ProbeFailure(f"{key}: max abs error {err} > {tol}")
    return err


def run(keys: Sequence[str], ctx: Ctx, *, check: bool = False,
        time: bool = True, extras: Sequence[str] = ()) -> Dict[str, dict]:
    """Build each variant, check it (``check``) and time it on the card
    (``time``; the plain version and library call too for ``extras``).
    Returns per key: family, ms, bound_ms, bound_by, share, err, and
    plain_ms / library_ms for the extras."""
    cuda = ctx.device != "cpu"
    out: Dict[str, dict] = {}
    for key in dict.fromkeys(keys):
        variant = VARIANTS[key]
        call = variant.make(ctx)
        b_ms, b_by = bound(call.ops, call.nbytes, call.kind)
        res = {"family": variant.family, "bound_ms": b_ms, "bound_by": b_by,
               "ms": None, "share": None, "err": None}
        if check and call.check is not None:
            res["err"] = check_call(key, call)
        if time:
            if cuda:
                res["ms"] = cuda_ms(call.run)
                res["share"] = b_ms / res["ms"]
            else:
                call.run()
            if key in extras and cuda:
                res["plain_ms"] = (cuda_ms(call.plain, iters=2, warmup=1)
                                   if call.plain else None)
                res["library_ms"] = (cuda_ms(call.library)
                                     if call.library else None)
        out[key] = res
        del call
    if cuda:
        torch.cuda.synchronize()
    return out


def site_keys(selected: Sequence[str] = ()) -> List[str]:
    """The sites named by ``selected`` (a site or a file), or all."""
    if not selected:
        return list(PROBES)
    sites = []
    for sel in selected:
        found = [s for s in PROBES if s == sel or s.split(":")[0] == sel]
        if not found:
            raise ValueError(f"no TPU probe site {sel!r}; known: "
                             f"{sorted(PROBES)}")
        sites += found
    return list(dict.fromkeys(sites))


def _fmt(v, spec=".4f"):
    return "-" if v is None else format(v, spec)


def variant_lines(sites: Sequence[str], results: Dict[str, dict]
                  ) -> List[str]:
    """One line per site and variant."""
    lines = []
    for site in sites:
        for key in PROBES[site].variants:
            r = results[key]
            share = None if r["share"] is None else 100 * r["share"]
            lines.append(
                f"probe {site} {key} [{r['family']}]: ms {_fmt(r['ms'])} "
                f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']}) share "
                f"{_fmt(share, '.2f')}%")
    return lines


def breakdown_lines(results: Dict[str, dict]) -> List[str]:
    """Per stage: ALL's ms and each knockout's, with the share of ALL's
    time that the knocked-out phase takes, (ALL - knockout) / ALL."""
    lines = []
    for label, group in BREAKDOWNS:
        base = results.get(f"{group}.all")
        if base is None or base["ms"] is None:
            continue
        parts = []
        for ph in KNOCKOUTS[1:]:
            r = results.get(f"{group}.{ph}")
            if r is not None and r["ms"] is not None:
                share = 100 * (base["ms"] - r["ms"]) / base["ms"]
                parts.append(f"{_label(base['family'], ph)} {r['ms']:.4f} ms "
                             f"({share:.1f}% of all)")
        lines.append(f"breakdown {label}: all {base['ms']:.4f} ms (bound "
                     f"{base['bound_ms']:.4f}); " + "; ".join(parts))
    return lines


# --------------------------------------------------------------------- #
# the built instances: registers, spills, tensor-core instructions
# --------------------------------------------------------------------- #

_NAMES = (
    ("K1", re.compile(r"stage_conv_kernelILi(\d+)ELi(\d+)ELb([01])ELi(\d+)"
                      r"ELi(\d+)E"), ("KS", "CK", "Q", "S", "P")),
    ("K2", re.compile(r"stage_conv3x3_i8_kernelILi(\d+)ELi(\d+)ELi(\d+)"
                      r"ELi(\d+)E"), ("IK", "OK", "CK", "P")),
    ("K3", re.compile(r"gemm_probe_kernelILb([01])ELi(\d+)E"),
     ("I8", "NTC")),
    ("K4", re.compile(r"stage_build_kernelILi(\d+)ELi(\d+)E"),
     ("MODE", "CK")),
    ("K5", re.compile(r"conv_sm90_kernelILi(\d+)ELi(\d+)E"), ("NS", "P")),
)


def describe(name: str) -> Optional[Tuple[str, Dict[str, int]]]:
    """(family, template arguments) of a kernel instance's mangled name."""
    for family, pattern, args in _NAMES:
        m = pattern.search(name)
        if m:
            return family, dict(zip(args, map(int, m.groups())))
    return None


def source_of(name: str) -> Optional[str]:
    """The .cu source of a kernel instance: nvcc names each translation
    unit's anonymous namespace after its file
    (``_GLOBAL__N__<hash>_13_stage_conv_cu_<hash>``)."""
    m = re.search(r"_GLOBAL__N__[0-9a-f]+_\d+_(\w+?)_cu_[0-9a-f]+", name)
    return m.group(1) + ".cu" if m else None


def ptxas_instances(log_path: str) -> List[dict]:
    """Per kernel instance in ptxas's report (``_build``'s log): source,
    name, registers, spill bytes."""
    out, source, cur = [], None, None
    for line in open(log_path):
        if line.startswith("# "):
            source = line[2:].strip()
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"source": source, "name": m.group(1), "registers": None,
                   "spills": 0}
            out.append(cur)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur is not None:
            cur["spills"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return out


def sass_mma_counts(lib_path: str) -> Dict[str, int]:
    """Tensor-core instructions (HMMA, IMMA, and wgmma's HGMMA) per kernel
    instance (mangled name) in the library's SASS (``cuobjdump -sass``)."""
    tool = next((c for c in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                     "cuobjdump"), shutil.which("cuobjdump"))
        if c and os.path.exists(c)), None)
    if tool is None:
        raise RuntimeError("cuobjdump not found (the CUDA toolkit's bin)")
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    counts: Dict[str, int] = {}
    name = None
    for line in text.splitlines():
        m = re.search(r"Function\s*:\s*(\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name is not None and re.search(r"\b(?:[HI]|HG)MMA\b", line):
            counts[name] += 1
    return counts


def mma_rule_failures(counts) -> List[str]:
    """The probe instances whose tensor-core instruction count breaks the
    rule: a no-GEMM instance has none (the knockout was not folded into
    something else), every other K1-K3 and K5 instance some, K4 none."""
    bad = []
    for name, n in counts.items():
        d = describe(name)
        if d is None or source_of(name) not in PROBE_SOURCES:
            continue
        family, args = d
        want_zero = family == "K4" or args.get("P") == NO_GEMM
        if want_zero != (n == 0):
            bad.append(f"{name}: {n} HMMA/IMMA")
    return bad


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m boosting_nerv_torch.tools.probes",
        description="Run the Hopper counterparts of the tools/ TPU probes.")
    ap.add_argument("sites", nargs="*",
                    help="tools/<file>.py:<line> or tools/<file>.py "
                         "(default: every site)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu runs the plain versions (no times)")
    ap.add_argument("--size", default="full", choices=("full", "tiny"),
                    help="tiny: small shapes, for a CPU run")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("probes: no CUDA device (pass --device cpu for the plain "
              "versions)", file=sys.stderr)
        return 2
    sites = site_keys(args.sites)
    keys = [k for s in sites for k in PROBES[s].variants]
    if args.device == "cuda":
        print(f"card: {torch.cuda.get_device_name(0)}", flush=True)
    ctx = Ctx.make(args.device, args.size)
    results = run(keys, ctx)
    for line in variant_lines(sites, results) + breakdown_lines(results):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
