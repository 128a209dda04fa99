"""The host side of the Hopper conv kernel (``ops/kernels/conv_sm90.py``) on
the CPU: its N-slice plan, its weight packing and operand layouts, and
``emulate`` (the kernel's staging, descriptor addressing and epilogue in
plain torch, consuming the packed weights and the padded operand tile)
against the Pallas kernels it replaces in interpret mode:
``tile_conv.py:144`` conv_tile at k = 1, 3 and 5 and ``planar.py:1308``
fused_upconv_rsft with and without ``out_inv``.  The CUDA kernel runs only
on the card: chip_smoke.py holds it against the wrappers' plain versions
there.

Tolerance: 2e-2 * max(|Pallas|, 1), both sides storing bf16; int8 codes
are compared after dequantising with 1 / out_inv (the Pallas stage keeps y
in float32 where the port's chain stores it in bf16, so single codes may
differ by one step), as tests/test_torch_w8a8.py compares them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boosting_nerv_torch.ops.kernels import conv_sm90, planar, quant
from boosting_nerv_torch.ops.pixelshuffle import jax_to_torch_shuffle_perm
from boosting_nerv_tpu.ops.pallas import planar as pk
from boosting_nerv_tpu.ops.pallas import tile_conv as tk
from boosting_nerv_tpu.ops.pixelshuffle import depth_to_space

TOL = 2e-2
WD = 128   # the Pallas kernels' lane-padded width


def _bf16(a):
    return np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _rand(r, *shape, s=1.0):
    return _bf16(r.normal(size=shape).astype(np.float32) * s)


def _ohwi(hwio, perm=None):
    k = hwio.transpose(3, 0, 1, 2)
    return torch.from_numpy(np.ascontiguousarray(k if perm is None
                                                 else k[perm]))


def _chw(x):
    """NHWC [1, H, W, C] -> the Pallas (C, H, 128) bf16 layout."""
    return jnp.pad(jnp.asarray(x[0].transpose(2, 0, 1)),
                   ((0, 0), (0, 0), (0, WD - x.shape[2]))).astype(
        jnp.bfloat16)


def _conv_tile_case(r, k, h, w):
    c, co = 6, 7
    x, kern, bias = _rand(r, 1, h, w, c), _rand(r, k, k, c, co, s=0.2), \
        _rand(r, co, s=0.1)
    want = tk.conv_tile(_chw(x), kern, bias, k=k, w_real=w, interpret=True)
    want = np.asarray(want[:, :, :w].astype(jnp.float32)).transpose(
        1, 2, 0)[None]
    wt = _ohwi(kern).to(torch.bfloat16)
    got = conv_sm90.emulate(
        torch.from_numpy(x).to(torch.bfloat16),
        conv_sm90.pack_weight(wt, conv_sm90.slice_width(co)),
        torch.from_numpy(bias).to(torch.bfloat16), cout=co, k=k)
    return got.float().numpy(), want, None


def _upconv_case(r, out_inv, h, w):
    c_in, c = 6, 5
    p = {"ck": _rand(r, 3, 3, c_in, 4 * c, s=0.2),
         "cb": _rand(r, 4 * c, s=0.1), "w0": _rand(r, 3, 3, c, c, s=0.2),
         "b0": _rand(r, c, s=0.1), "w1": _rand(r, 3, 3, c, c, s=0.2),
         "b1": _rand(r, c, s=0.1)}
    sft = [r.normal(size=c).astype(np.float32) * 0.3 for _ in range(4)]
    x = _rand(r, 1, h, w, c_in)
    perm = jax_to_torch_shuffle_perm(c, 2)
    weights = planar.StageWeights(
        _ohwi(p["ck"], perm), torch.from_numpy(p["cb"][perm]),
        _ohwi(p["w0"]), torch.from_numpy(p["b0"]), _ohwi(p["w1"]),
        torch.from_numpy(p["b1"]))
    weights = planar.StageWeights(*(t.to(torch.bfloat16).contiguous()
                                    for t in vars(weights).values()
                                    if t is not None))
    inv = jinv = None
    if out_inv:
        # the stage output's bound from the fp32 composition, as
        # calibration sets it (x 1.05)
        y = np.sin(np.asarray(depth_to_space(
            jnp.asarray(_conv_ref(x, p["ck"], p["cb"])), 2)))
        s0, h0, s1, h1 = sft
        t = _gelu(_conv_ref(y * (s0 + 1) + h0, p["w0"], p["b0"]))
        out = y + _conv_ref(t * (s1 + 1) + h1, p["w1"], p["b1"])
        bound = np.abs(out).max(axis=(0, 1, 2)) * 1.05
        inv = quant.out_quant_vec(torch.from_numpy(bound))
        jinv = pk.out_quant_vec(jnp.asarray(bound), 16)
    prep = pk.prepare_upconv_rsft(*(jnp.asarray(p[k]) for k in
                                    ("ck", "cb", "w0", "b0", "w1", "b1")),
                                  c_in=c_in, c=c)
    res = pk.fused_upconv_rsft(
        _chw(x), prep, pk.sft_planar_vectors(*map(jnp.asarray, sft), 16),
        c_in=c_in, c=c, wc_real=w, th=4, out_inv=jinv, interpret=True)
    want = np.asarray(pk.from_planar(res, c)[:, :, :2 * w].astype(
        jnp.float32)).transpose(1, 2, 0)[None]
    got = conv_sm90.upconv_rsft(
        conv_sm90.emulated_conv, torch.from_numpy(x).to(torch.bfloat16),
        weights, torch.from_numpy(np.stack(sft)), inv)
    return got.float().numpy(), want, inv


def _conv_ref(x, k, b):
    """Same-padded 3x3 conv of NHWC float32 numpy x with an HWIO kernel."""
    t = torch.nn.functional.conv2d(
        torch.from_numpy(np.asarray(x, np.float32)).permute(0, 3, 1, 2),
        torch.from_numpy(np.asarray(k)).permute(3, 2, 0, 1),
        torch.from_numpy(np.asarray(b)), padding=1)
    return t.permute(0, 2, 3, 1).numpy()


def _gelu(v):
    return torch.nn.functional.gelu(torch.from_numpy(v)).numpy()


@pytest.mark.parametrize("case", [
    ("conv_tile", 1, 9, 70), ("conv_tile", 3, 16, 70),
    ("conv_tile", 5, 9, 50), ("fused_upconv_rsft", False, 9, 50),
    ("fused_upconv_rsft", True, 9, 50)],
    ids=["conv_tile_k1", "conv_tile_k3", "conv_tile_k5", "upconv",
         "upconv_out_inv"])
def test_emulation_matches_pallas(case):
    name, arg, h, w = case
    r = np.random.default_rng(sum(map(ord, str(case))))
    fn = _conv_tile_case if name == "conv_tile" else _upconv_case
    got, want, inv = fn(r, arg, h, w)
    assert got.shape == want.shape
    if inv is not None:
        scale = (1 / inv).numpy()
        got, want = got * scale, want * scale
    err = float(np.abs(got - want).max())
    assert err < TOL * max(float(np.abs(want).max()), 1.0), err


def test_slice_plan_at_the_bench_shapes():
    # (Cout, slice width, slices): v2 conv_tile and v5 upconv/rsft widths
    plan = {co: (conv_sm90.slice_width(co),
                 -(-co // conv_sm90.slice_width(co)))
            for co in (3, 51, 61, 73, 204, 244, 292, 792)}
    assert plan == {3: (8, 1), 51: (56, 1), 61: (64, 1), 73: (80, 1),
                    204: (80, 3), 244: (64, 4), 292: (80, 4),
                    792: (80, 10)}
    assert all(ns in conv_sm90.NS_CHOICES for ns, _ in plan.values())


def test_plan_falls_back_to_a_narrower_slice_that_fits():
    """``plan`` takes the first slice width, best first, whose launch the
    library's shared-memory fit accepts, and (0, -1) where none does."""
    class Lib:  # the library's fit: only N 8 fits, or nothing
        def __init__(self, fits):
            self.fits = fits

        def bnt_conv_sm90_smem(self, cin, cout, ks, ns):
            return 1000 + ns if ns in self.fits else -1

    assert conv_sm90.slice_widths(80)[0] == 80
    assert conv_sm90.plan(Lib({8}), 128, 80, 5) == (8, 1008)
    assert conv_sm90.plan(Lib({8, 64, 80}), 128, 80, 5) == (80, 1080)
    assert conv_sm90.plan(Lib(set()), 200, 8, 3) == (0, -1)


@pytest.mark.parametrize("cout,k,cin", [(7, 5, 6), (20, 3, 17), (51, 1, 51)])
def test_packed_weight_reads_back_through_the_descriptor(cout, k, cin):
    """Each (slice, tap, k16 step) block read through ``b_offsets`` is the
    weight, zero beyond Cout and Cin."""
    w = torch.randn(cout, k, k, cin)
    ns = conv_sm90.slice_width(cout)
    cp = conv_sm90.cin_pad(cin)
    wpk = conv_sm90.pack_weight(w, ns)
    full = torch.zeros(-(-cout // ns) * ns, k * k, cp)
    full[:cout, :, :cin] = w.reshape(cout, k * k, cin)
    offs = conv_sm90.b_offsets(ns)
    for s in range(-(-cout // ns)):
        for tap in range(k * k):
            for kk in range(cp // 16):
                blk = (s * k * k + tap) * ns * cp + kk * ns * 16
                assert torch.equal(wpk[blk + offs],
                                   full[s * ns:(s + 1) * ns, tap,
                                        kk * 16:(kk + 1) * 16])


def test_operand_tile_layout_is_bank_conflict_free():
    """A warp's repack store touches the eight 8-channel groups of one
    pixel: group_stride * 16 bytes apart, ≡ 16 modulo 128, so the groups
    land in eight distinct 16-byte bank quads; A's core-matrix rows are
    consecutive pixels 16 bytes apart, so a tap's pixel shift only moves
    the start address."""
    for k in (1, 3, 5):
        gs = conv_sm90.group_stride(k)
        assert gs >= (conv_sm90.TH + k - 1) * (conv_sm90.TW + k - 1)
        assert sorted(g * gs * 16 % 128 for g in range(8)) == list(
            range(0, 128, 16))
        offs = conv_sm90.a_offsets(gs)
        assert torch.equal(offs[:, 0], torch.arange(64) * 8)
