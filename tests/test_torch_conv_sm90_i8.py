"""The int8 form of the Hopper conv kernel (``ops/csrc/conv_sm90_i8.cu``)
on the CPU, through its host side ``ops/kernels/conv_sm90.py``: the s8
weight packing read back through the s8 descriptor offsets, the s8 N-slice
plan and the shared-memory plan mirror at the W8A8 stages' shapes, and
``emulate`` (the kernel's repack, exact int32 sums through the descriptor
offsets, dequantisation and epilogue in plain torch) in the chains
``conv_sm90.upconv_rsft`` / ``conv_rsft`` on ``StageWeightsI8``, against
the Pallas int8 stage kernels in interpret mode (``planar.py:1308``
fused_upconv_rsft and ``:1541`` fused_conv_rsft with i8 / i8_in /
out_inv) and against the wrappers' plain versions.  The CUDA kernel runs
only on the card: chip_smoke.py holds it against the plain versions there.

Stages are built as tests/test_torch_w8a8.py builds them (C = 20 channels,
bounds from the float32 reference).  Tolerance against Pallas: 2e-2 *
max(|Pallas|, 1), int8 codes compared after dequantising with 1 / inv
(the Pallas stage keeps y in float32 where the port's chain stores it in
bf16, so single codes may differ by one step).  Against the plain versions
the emulation computes the same float32 steps, so each launch's codes and
bf16 values are exact but for rounding ties (an activation's last bit on
the CPU depends on the tensor's layout), whose share is bounded; a tie
flips one code of an intermediate, which moves a few outputs of the chain
by a step, so the chain's outputs are held to the Pallas tolerance and a
share."""

import functools

import numpy as np
import pytest
import torch

import test_torch_w8a8 as w8
from boosting_nerv_torch.ops.kernels import conv_sm90, planar, probes, quant

S8, S8Q = conv_sm90.S8, conv_sm90.S8Q
TIE_SHARE = 1e-3     # a launch's outputs that may differ from plain (ties)
CHAIN_SHARE = 0.05   # the chain's outputs that a tie upstream may move


@pytest.mark.parametrize("cout,k,cin", [(7, 5, 6), (20, 3, 17), (51, 1, 51),
                                        (204, 3, 61)])
def test_s8_packed_weight_reads_back_through_the_descriptor(cout, k, cin):
    """Each (slice, tap, k32 step) block of int8 codes read through the s8
    ``b_offsets`` is the weight, zero beyond Cout and Cin."""
    g = torch.Generator().manual_seed(cout)
    w = torch.randint(-127, 128, (cout, k, k, cin), generator=g,
                      dtype=torch.int8)
    ns = conv_sm90.slice_width(cout, S8)
    cp = conv_sm90.cin_pad(cin, S8)
    assert cp % 32 == 0 and cp - cin < 32
    wpk = conv_sm90.pack_weight(w, ns)
    assert wpk.dtype == torch.int8
    assert wpk.numel() == -(-cout // ns) * ns * k * k * cp
    full = torch.zeros(-(-cout // ns) * ns, k * k, cp, dtype=torch.int8)
    full[:cout, :, :cin] = w.reshape(cout, k * k, cin)
    offs = conv_sm90.b_offsets(ns, e=1)
    assert offs.shape == (ns, 32)
    for s in range(-(-cout // ns)):
        for tap in range(k * k):
            for kk in range(cp // 32):
                blk = (s * k * k + tap) * ns * cp + kk * ns * 32
                assert torch.equal(wpk[blk + offs],
                                   full[s * ns:(s + 1) * ns, tap,
                                        kk * 32:(kk + 1) * 32])


def test_s8_operand_offsets_are_the_bf16_bytes():
    """A k32 step of int8 spans the bytes of a k16 step of bf16: the s8
    descriptor offsets, in bytes, are the bf16 ones with each 2-byte
    element split in two."""
    gs = conv_sm90.group_stride(3)
    for s8, bf in ((conv_sm90.a_offsets(gs, e=1), conv_sm90.a_offsets(gs)),
                   (conv_sm90.b_offsets(80, e=1), conv_sm90.b_offsets(80))):
        assert torch.equal(s8[:, 0::2], 2 * bf)
        assert torch.equal(s8[:, 1::2], 2 * bf + 1)


def test_s8_slice_plan_at_the_w8a8_shapes():
    """(Cout, slice width, slices) of the W8A8 stages' convs: no N 56 in
    int8, so 51 and 61 take N 64, the 61 -> 204 upconv 3 x 80, the head
    N 8; the same in both int8 forms."""
    for form in (S8, S8Q):
        plan = {co: (conv_sm90.slice_width(co, form),
                     -(-co // conv_sm90.slice_width(co, form)))
                for co in (3, 51, 61, 204)}
        assert plan == {3: (8, 1), 51: (64, 1), 61: (64, 1), 204: (80, 3)}
    assert 56 not in conv_sm90.NS_CHOICES_S8
    assert conv_sm90.slice_width(51) == 56   # bf16 keeps its N 56


def _mirror_lib():
    class Lib:  # the library's fits, as conv_sm90.fit computes them
        @staticmethod
        def bnt_conv_sm90_smem(cin, cout, ks, ns):
            plan = conv_sm90.fit(cin, cout, ks, ns)
            return -1 if plan is None else plan[-1]

        @staticmethod
        def bnt_conv_sm90_i8_smem(cin, cout, ks, ns, form):
            plan = conv_sm90.fit(cin, cout, ks, ns, form)
            return -1 if plan is None else plan[-1]
    return Lib


def test_s8_shared_memory_plan_at_the_w8a8_shapes(monkeypatch):
    """The int8 plans of the bench config's W8A8 convs: two warpgroups
    with every weight block resident, stage 6's 61 -> 204 upconv too
    (27 blocks of 80 x 64 bytes, where bf16 streams), the N 64 launches
    on 3-row tiles a warpgroup; an operand tile of 64 channels in 4 groups
    of 16 bytes; nothing at N 56 or beyond 128 input channels; and
    ``plan`` and the wrappers' fit take the int8 library entry."""
    shapes = [(61, 61, S8), (61, 61, S8Q), (61, 204, S8), (51, 51, S8),
              (51, 51, S8Q), (51, 3, S8)]
    for cin, cout, form in shapes:
        ns = conv_sm90.slice_width(cout, form)
        plan = conv_sm90.fit(cin, cout, 3, ns, form)
        assert plan[:3] == (2, 9 * -(-cout // ns), True), (cin, cout, form)
        assert plan[-1] <= conv_sm90.MAX_SMEM
        assert conv_sm90.cin_pad(cin, form) == 64
    bf = conv_sm90.fit(61, 204, 3, conv_sm90.slice_width(204))
    assert bf[2] is False      # bf16 streams stage 6's upconv weights
    assert conv_sm90.rows_at(64, S8) == conv_sm90.rows_at(64, S8Q) == 3
    assert conv_sm90.rows_at(80, S8) == conv_sm90.rows_at(8, S8) == 2
    assert conv_sm90.rows_at(64, conv_sm90.BF16) == 2
    assert conv_sm90.fit(51, 51, 3, 56, S8) is None
    assert all(conv_sm90.fit(c, c, 3, ns, S8) is None
               for c in (129, 200) for ns in conv_sm90.NS_CHOICES_S8)
    # int8 takes half the bf16 operand tile at the same channels
    kb = conv_sm90.cin_pad(61, S8)
    assert conv_sm90._smem_bytes(kb, 3, 0, 64, 2, 0) < \
        conv_sm90._smem_bytes(2 * conv_sm90.cin_pad(61), 3, 0, 64, 2, 0)

    lib = _mirror_lib()
    conv_sm90.plan.cache_clear()
    assert conv_sm90.plan(lib, 61, 204, 3, S8) == (
        80, conv_sm90.fit(61, 204, 3, 80, S8)[-1])
    assert conv_sm90.plan(lib, 51, 3, 3, S8)[0] == 8
    monkeypatch.setattr(planar._build, "load_library", lambda: lib)
    with pytest.raises(ValueError, match="Cin <= 128"):
        planar.check_fit(planar.sm90_smem, [(200, 200, 3, S8)])
    planar.check_fit(planar.sm90_smem, [(61, 204, 3, S8), (61, 61, 3, S8Q),
                                        (51, 3, 3, S8)])
    conv_sm90.plan.cache_clear()


# --------------------------------------------------------------------- #
# the emulated int8 chains
# --------------------------------------------------------------------- #

@functools.lru_cache(maxsize=None)
def _chain(name):
    """(emulated chain, Pallas int8 kernel, plain version, out_inv, the
    chain's launches) of one W8A8 stage: "upconv" (stride 2, codes in),
    "conv_codes" (stride 1, codes in and out), "conv_head" (stride 1, bf16
    in, with the head).  A launch: (x, w, b, options, emulated out)."""
    w8.rng = np.random.default_rng(sum(map(ord, name)))
    up, head = name == "upconv", name == "conv_head"
    p, bounds, x, out = w8._stage_case(up, head, w8.HC)
    w = w8._port_weights(p, bounds, up=up, head=head)
    sft = w8._sft(p)
    inv_out = jinv = None
    if name == "conv_codes":
        bound_out = w8._chmax(out) * 1.05
        inv_out = quant.out_quant_vec(torch.from_numpy(bound_out))
        jinv = w8.pk.out_quant_vec(w8.jnp.asarray(bound_out), w8.CP)
    if head:
        xt = torch.from_numpy(x).to(torch.bfloat16)
        want = w8._pallas(p, bounds, x, up, head, w8.HC)
    else:
        xt = quant.quant_act(torch.from_numpy(x), w.inv_x)
        want = w8._pallas(p, bounds, xt.numpy(), up, head, w8.HC,
                          i8_in=True, out_inv=jinv)
    launches = []

    def conv(x, w, b, shape, **kw):
        out = conv_sm90.emulated_conv(x, w, b, shape, **kw)
        launches.append((x, w, b, kw, out))
        return out

    if up:
        got = conv_sm90.upconv_rsft(conv, xt, w, sft)
        plain = planar.fused_upconv_rsft_i8_plain(xt, w, sft)
    else:
        got = conv_sm90.conv_rsft(conv, xt, w, sft, head, inv_out)
        plain = planar.fused_conv_rsft_i8_plain(xt, w, sft, head=head,
                                                out_inv=inv_out)
    return got, want, plain, inv_out, launches


CHAINS = ["upconv", "conv_codes", "conv_head"]


def _dequant(v, inv):
    return v if inv is None else v * (1 / inv).numpy()


@pytest.mark.parametrize("name", CHAINS)
def test_emulated_i8_chain_matches_pallas_int8(name):
    got, want, _, inv, _ = _chain(name)
    assert got.dtype == (torch.int8 if inv is not None else torch.bfloat16)
    assert got.shape == want.shape
    w8._err_bound(_dequant(got.float().numpy(), inv), _dequant(want, inv))
    if inv is not None:
        assert np.mean(got.numpy() != want) < 0.05


@pytest.mark.parametrize("name", CHAINS)
def test_emulated_i8_chain_matches_the_plain_version(name):
    """The same chain against ``fused_*_rsft_i8_plain``, and each of its
    launches (the stage conv, conv0 with its int8 codes t, conv1, the
    head) against that launch's plain version on the same input
    (``probes.stage_conv_i8_probe_plain``): exact but for rounding ties,
    one code step or one bf16 ulp each."""
    got, _, plain, inv, launches = _chain(name)
    assert got.dtype == plain.dtype and got.shape == plain.shape
    g, want = got.float(), plain.float()
    assert (g != want).float().mean().item() <= CHAIN_SHARE
    w8._err_bound(_dequant(g.numpy(), inv), _dequant(want.numpy(), inv))
    assert len(launches) == (4 if name == "conv_head" else 3)
    for x, w, b, kw, out in launches:
        kw = dict(kw)
        if x.dtype == torch.int8:
            kw.pop("in_inv", None)
        ref = probes.stage_conv_i8_probe_plain(x, w, kw.pop("scale"), b,
                                               **kw)
        assert out.dtype == ref.dtype and out.shape == ref.shape
        o, r = out.float(), ref.float()
        differ = o != r
        assert differ.float().mean().item() <= TIE_SHARE
        if out.dtype == torch.int8:
            assert (o - r).abs().max().item() <= 1
        else:  # one bf16 ulp
            assert ((o - r).abs() <= r.abs() * 2 ** -7 + 1e-30)[
                differ].all()


def test_every_c_entry_point_is_bound_to_its_signature():
    """``_build._bind`` gives every ``extern "C"`` entry point of
    ``ops/csrc`` argtypes of its arity, a ``c_void_p`` for each pointer
    and the stream (a Python int passed without them is cut to 32 bits),
    a ``c_int`` for each int and a ``c_float`` for each float."""
    import ctypes
    import glob
    import os
    import re
    import types

    from boosting_nerv_torch.ops.kernels import _build

    sigs = {}
    for src in glob.glob(os.path.join(_build.CSRC, "*.cu")):
        text = open(src).read()
        for block in re.findall(r'extern "C" \{(.*?)\}  // extern "C"',
                                text, re.S):
            for name, args in re.findall(r"^\w[\w\s\*]*?\b(bnt_\w+)\(([^)]*)\)"
                                         r"\s*\{", block, re.M):
                sigs[name] = [a.strip() for a in args.split(",") if a.strip()]
    assert {"bnt_conv_sm90_i8", "bnt_conv_sm90_i8_smem",
            "bnt_conv_sm90"} <= set(sigs)
    lib = types.SimpleNamespace(**{n: types.SimpleNamespace() for n in sigs})
    _build._bind(lib)
    for name, args in sigs.items():
        want = [ctypes.c_void_p if "*" in a else
                ctypes.c_float if a.startswith("float") else ctypes.c_int
                for a in args]
        assert getattr(lib, name).argtypes == want, name


def test_rows_a_warpgroup_agree_with_the_kernel():
    """The int8 form's rows a warpgroup at N 64 in the plan mirror
    (conv_sm90.py) is the header's, at which its instances are built."""
    import os
    import re

    from boosting_nerv_torch.ops.kernels import _build

    with open(os.path.join(_build.CSRC, "conv_sm90.cuh")) as f:
        m = re.search(r"constexpr int ROWS_S8_64 = (\d+);", f.read())
    assert int(m.group(1)) == conv_sm90.ROWS_S8_64
    assert conv_sm90.rows_at(64, S8) == conv_sm90.ROWS_S8_64


@pytest.mark.parametrize("up", [False, True], ids=["s7_head", "s6"])
def test_int8_k5_chain_runs_the_plain_launches_on_cpu(up):
    """The K5 probe chains on the int8 form (``sm90=True``) run each
    launch's plain version on the CPU: with every phase the production
    wrapper's plain version (rounding ties aside), each knockout what
    K2's computes; the bf16 probe refuses int8-code output."""
    from boosting_nerv_torch.tools import probes as tp

    ctx = tp.Ctx.make("cpu", "tiny")
    if up:
        x, w, sft, inv = tp._stage_i8(ctx, "s6", False, up=True)
        chain = probes.upconv_rsft_i8_probe
        want = planar.fused_upconv_rsft_i8_plain(x, w, sft, inv)
    else:
        x, w, sft, inv = tp._stage_i8(ctx, "s7", True)
        chain = functools.partial(probes.conv_rsft_i8_probe, head=True)
        want = planar.fused_conv_rsft_i8_plain(x, w, sft, head=True)
    before = dict(probes.LAUNCHES)
    got = chain(x, w, sft, out_inv=inv, sm90=True)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert (got.float() != want.float()).float().mean().item() <= CHAIN_SHARE
    for ph in ("nostage", "nogemm", "noepi", "nostore"):
        assert torch.equal(chain(x, w, sft, out_inv=inv, phases=ph,
                                 sm90=True),
                           chain(x, w, sft, out_inv=inv, phases=ph)), ph
    assert probes.LAUNCHES == before   # the CPU launches no kernel
    with pytest.raises(ValueError, match="bf16 probe"):
        probes.conv_sm90_probe(x.to(torch.bfloat16), w.w1.float().to(
            torch.bfloat16), w.b1.to(torch.bfloat16), out_inv=w.inv_t1)
