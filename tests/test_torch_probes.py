"""The probes of the stage kernels (``ops/kernels/probes.py``, the entry
point ``tools/probes.py``) on the CPU, where each wrapper runs its plain
version.

The plain versions are held to the TPU probes of the repository's
``tools/`` where those run on the CPU: ``r3_prologue_probe.b_head_var``
(cur and sslot) and ``r3_v6_probe.conv_planar_v6`` in Pallas interpret
mode, ``r4_int8_probe.kbuf_i8_build`` likewise (its K-buffer compared per
fine pixel, channel and tap), and ``im2col_probe``'s arithmetic in numpy.
Those modules are loaded without their script part (which runs a whole
probe, or TPU-only code, at import); probes that need a TPU to import at
all (``r4_roll_i16_probe``, ``planar_diag*``) are held through the JAX
package's own functions (``planar._quant_act``) or numpy.  The knockouts'
semantics are pinned: no GEMM is the output of zero weights, no STAGE of a
zero staged tile, no EPI a bias-free conv, no STORE the untouched output,
and "all" is the production wrapper's plain version, bit for bit.  A scan
of ``tools/*.py`` keeps every ``pallas_call`` site in ``PROBES``.  The CUDA
kernels run only on the card: chip_smoke.py holds them to these plain
versions there.

Tolerance against a Pallas kernel: 2e-2 * max(|Pallas|, 1), the rule of
the other port tests (the plain versions run in float32 on bf16-exact
inputs, the Pallas kernels store bf16); int8 codes are compared exactly.
"""

import ast
import os
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from boosting_nerv_torch.ops.kernels import LAUNCHES, planar, quant
from boosting_nerv_torch.ops.kernels import probes as kp
from boosting_nerv_torch.tools import probes as tp
from boosting_nerv_tpu.ops.pallas import planar as jp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
TOL = 2e-2   # x max(|Pallas|, 1)
rng = np.random.default_rng(43)


def _bf16(a):
    return np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _rand(*shape, s=1.0):
    return _bf16(rng.normal(size=shape).astype(np.float32) * s)


def _close(got, want):
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err < TOL * max(float(np.abs(want).max()), 1.0), err


def _load_defs(name):
    """A tools/ probe's imports, functions and constants, without its
    script part."""
    path = os.path.join(TOOLS, name)
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    keep = (ast.Import, ast.ImportFrom, ast.FunctionDef, ast.Assign)
    tree.body = [n for n in tree.body if isinstance(n, keep)]
    mod = types.ModuleType(name[:-3])
    exec(compile(tree, path, "exec"), mod.__dict__)
    return mod


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ohwi(k_hwio):
    return _t(k_hwio.transpose(3, 0, 1, 2))


def _planar_in(x_fine, wd, wc_real):
    """A fine (c, 2 hc, 2 wc) array as planar bf16 (4 cp, hc, wd), zero
    beyond wc_real."""
    xp = jp.to_planar(jnp.asarray(x_fine)).astype(jnp.bfloat16)
    return jnp.pad(xp, ((0, 0), (0, 0), (0, wd - wc_real)))


# --------------------------------------------------------------------- #
# the TPU probes that run on the CPU
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def b_head_case():
    """r3_prologue_probe's B+head (stage 7 + head) at c 5, 16 x 200."""
    probe = _load_defs("r3_prologue_probe.py")
    c, hc, wc, wd = 5, 8, 100, 128
    x = _rand(c, 2 * hc, 2 * wc)
    k = {n: _rand(*s, s=0.3) for n, s in (
        ("ck", (3, 3, c, c)), ("w0", (3, 3, c, c)), ("w1", (3, 3, c, c)),
        ("hk", (3, 3, c, 3)))}
    b = {n: _rand(s, s=0.1) for n, s in (("cb", c), ("b0", c), ("b1", c),
                                         ("hb", 3))}
    sft = [_rand(c, s=0.3) for _ in range(4)]
    prep = jp.prepare_conv_rsft(
        *(jnp.asarray(a) for a in (k["ck"], b["cb"], k["w0"], b["b0"],
                                   k["w1"], b["b1"])),
        c=c, head_k=jnp.asarray(k["hk"]), head_b=jnp.asarray(b["hb"]))
    vecs = jp.sft_planar_vectors(*map(jnp.asarray, sft), 16)
    xp = _planar_in(x, wd, wc)
    tpu = {mode: np.asarray(jp.rgb_planar_to_nhwc(
        probe.b_head_var(xp, prep, vecs, mode=mode, c=c, wc_real=wc, th=4,
                         interpret=True), hc, wc).astype(jnp.float32))
        for mode in ("cur", "sslot")}
    weights = planar.StageWeights(
        _ohwi(k["ck"]), _t(b["cb"]), _ohwi(k["w0"]), _t(b["b0"]),
        _ohwi(k["w1"]), _t(b["b1"]), _ohwi(k["hk"]), _t(b["hb"]))
    port = kp.conv_rsft_probe(_t(x.transpose(1, 2, 0)[None]), weights,
                              _t(np.stack(sft)), head=True).numpy()
    return tpu, port


def test_b_head_cur_and_sslot_compute_one_function(b_head_case):
    tpu, _ = b_head_case
    assert np.array_equal(tpu["cur"], tpu["sslot"])


@pytest.mark.parametrize("mode", ["cur", "sslot"])
def test_stage_probe_all_matches_b_head_var(b_head_case, mode):
    tpu, port = b_head_case
    _close(port, tpu[mode])


@pytest.mark.parametrize("act", ["none", "sin"])
def test_direct_plain_matches_conv_planar_v6(act):
    """r3_v6_probe's conv without the K-buffer build against K1 DIRECT."""
    probe = _load_defs("r3_v6_probe.py")
    c, hc, wc, wd = 5, 6, 100, 128
    x = _rand(c, 2 * hc, 2 * wc)
    k, b = _rand(3, 3, c, c, s=0.3), _rand(c, s=0.1)
    out = probe.conv_planar_v6(_planar_in(x, wd, wc), jnp.asarray(k),
                               jnp.asarray(b), c_in=c, c_out=c, wc_real=wc,
                               act=act, th=4, interpret=True)
    tpu = np.asarray(jp.from_planar(out, c)[:, :, :2 * wc].astype(
        jnp.float32)).transpose(1, 2, 0)[None]
    port = kp.stage_conv_probe_plain(_t(x.transpose(1, 2, 0)[None]),
                                     _ohwi(k), _t(b), act=act,
                                     staging="direct").numpy()
    _close(port, tpu)


def _fine_codes(staged, h, w):
    """The fine code image [h, w, C] held in the centres (rows 1-4,
    columns 1-32) of K4's staged 6 x 34 tiles."""
    th, tw = -(-h // 4), -(-w // 32)
    t = staged.reshape(th, tw, 6, 34, -1)[:, :, 1:5, 1:33]
    return t.permute(0, 2, 1, 3, 4).reshape(4 * th, 32 * tw, -1)[:h, :w]


def test_i8_build_matches_kbuf_i8_build_per_pixel_channel_and_tap():
    """r4_int8_probe's int8 K-buffer build against K4 I8's codes: each
    K-buffer row (r1, r2) is the fine pixel (2y + r1, 2col + r2), and the
    shifted planes vm / vp its left (2col - 1) and right (2col + 2)
    neighbours, zero past the image's edge."""
    probe = _load_defs("r4_int8_probe.py")
    c, cp, rows, wc, wd = 5, 16, 2, 100, 1024
    x = _rand(c, 2 * rows, 2 * wc)
    inv_c = rng.uniform(50.0, 200.0, c).astype(np.float32)
    inv = np.tile(np.pad(inv_c, (0, cp - c)), 4)[:, None]
    xk = _planar_in(x, wd, wc).reshape(4 * cp, rows * wd)
    kb = np.asarray(probe.kbuf_i8_build(xk, jnp.asarray(inv), wc_real=wc,
                                        interpret=True).astype(jnp.float32))
    kb = kb.reshape(2, 4, cp, rows, wd)[:, :, :c, :, :wc]
    staged = kp.stage_build_probe_plain(
        _t(x.transpose(1, 2, 0)[None]).to(torch.bfloat16), mode="i8",
        in_inv=_t(inv_c))
    q = _fine_codes(staged, 2 * rows, 2 * wc)[:, :, :c].numpy().astype(
        np.float32)
    qpad = np.pad(q, ((0, 0), (1, 2), (0, 0)))   # fine columns -1 .. 2 wc + 1
    for r1 in (0, 1):
        fine = qpad[r1::2]                          # [rows, 2 wc + 3, c]
        for plane, dx in ((0, 0), (1, 1), (2, -1), (3, 2)):
            want = fine[:, 1 + dx:1 + dx + 2 * wc:2].transpose(2, 0, 1)
            assert np.array_equal(kb[r1, plane], want), (r1, plane)


@pytest.mark.parametrize("i8", [False, True])
def test_gemm_plain_matches_im2col_probe_math(i8):
    """im2col_probe's 9 per-tap dots sum_k w[k] @ x[k] against one flat-K
    dot: K3's per-tap plain version on a halo tile and its flat plain
    version on the same tile's im2col, in numpy."""
    rows, c, n = 2, 7, 6
    if i8:
        a = rng.integers(-127, 128, (1, rows + 2, 34, c)).astype(np.int8)
        b = rng.integers(-127, 128, (9, n, c)).astype(np.int8)
    else:
        a, b = _rand(1, rows + 2, 34, c), _rand(9, n, c)
    xs = [a[0, dy:dy + rows, dx:dx + 32].reshape(-1, c).T.astype(np.float64)
          for dy in range(3) for dx in range(3)]        # x[k]: (C, M)
    nine = sum(b[k].astype(np.float64) @ xs[k] for k in range(9)).T
    wflat = b.transpose(1, 0, 2).reshape(n, 9 * c).astype(np.float64)
    flat = (wflat @ np.concatenate(xs, axis=0)).T
    assert np.allclose(nine, flat)
    a_t, b_t = _t(a), _t(b)
    per_tap = kp.gemm_probe_plain(a_t, b_t).numpy()[0]
    im2col = _t(np.concatenate(xs, axis=0).T.reshape(1, rows, 32, 9 * c)
                .astype(a.dtype))
    flat_k3 = kp.gemm_probe_plain(im2col, _t(wflat[None].astype(b.dtype)),
                                  taps=(1, 1)).numpy()[0]
    assert np.allclose(per_tap, nine, rtol=1e-6, atol=1e-3)
    assert np.allclose(flat_k3, nine, rtol=1e-6, atol=1e-3)
    assert np.allclose(kp.gemm_probe_plain(a_t, b_t, reps=3).numpy(),
                       3 * per_tap[None], rtol=1e-6)


def test_gemm_plain_sin_epilogue():
    a, b = _t(_rand(2, 3, 34, 5)), _t(_rand(9, 4, 5))
    c = kp.gemm_probe_plain(a, b).double()
    got = kp.gemm_probe_plain(a, b, act="sin", alpha=0.5, reps=2)
    assert torch.allclose(got.double(), torch.sin(c * 2 * 0.5), atol=1e-6)


@pytest.mark.parametrize("mode", ["i8", "i8_pack"])
def test_i8_build_codes_are_the_jax_quant_rule(mode):
    """K4's int8 staging: planar._quant_act of the in-image affine, code 0
    in the padding and beyond Cin (r4_i8_build_probe's i8_f32 / i8_pack
    strategies stage equal codes)."""
    h, w, c = 5, 37, 6
    x = _rand(1, h, w, c)
    s, sh = _rand(c, s=0.3), _rand(c, s=0.3)
    inv = rng.uniform(20.0, 90.0, c).astype(np.float32)
    staged = kp.stage_build_probe_plain(
        _t(x).to(torch.bfloat16), mode=mode, in_affine=(_t(s), _t(sh)),
        in_inv=_t(inv))
    assert staged.dtype == torch.int8 and staged.shape == (2 * 2, 204, 32)
    want = np.asarray(jp._quant_act(jnp.asarray(x[0] * (s + 1) + sh),
                                    jnp.asarray(inv)))
    q = _fine_codes(staged, h, w).numpy()
    assert np.array_equal(q[:, :, :c], want)
    assert not q[:, :, c:].any()
    assert not staged.reshape(2, 2, 6, 34, 32)[0, :, 0].any()  # above row 0


def test_raw16_and_f32_stage_the_same_bits():
    """r4_roll_i16_probe's question: 16-bit data moved without the f32
    round trip; with no affine both stagings hold x's bits."""
    x = _t(_rand(1, 6, 40, 9)).to(torch.bfloat16)
    f32 = kp.stage_build_probe_plain(x, mode="f32")
    raw = kp.stage_build_probe_plain(x, mode="raw16")
    assert f32.dtype == torch.bfloat16 and torch.equal(f32, raw)
    assert torch.equal(_fine_codes(f32, 6, 40)[:, :, :9], x[0])


# --------------------------------------------------------------------- #
# the knockouts' semantics and "all" against the production plain
# --------------------------------------------------------------------- #

def _launch_case():
    x = _t(_rand(1, 7, 11, 6)).to(torch.bfloat16)
    w = _t(_rand(8, 3, 3, 6, s=0.3)).to(torch.bfloat16)
    b = _t(_rand(8, s=0.1)).to(torch.bfloat16)
    res = _t(_rand(1, 7, 11, 8)).to(torch.bfloat16)
    aff = lambda c: (_t(_rand(c, s=0.3)), _t(_rand(c, s=0.3)))  # noqa: E731
    return x, w, b, {"act": "gelu", "in_affine": aff(6),
                     "out_affine": aff(8), "residual": res}


def test_knockouts_compute_what_they_state():
    x, w, b, kw = _launch_case()
    all_ = kp.stage_conv_probe(x, w, b, **kw)
    zero_w = kp.stage_conv_probe(x, torch.zeros_like(w), b, **kw)
    assert torch.equal(kp.stage_conv_probe(x, w, b, phases="nogemm", **kw),
                       zero_w)
    no_in = {k: v for k, v in kw.items() if k != "in_affine"}
    assert torch.equal(kp.stage_conv_probe(x, w, b, phases="nostage", **kw),
                       kp.stage_conv_probe(torch.zeros_like(x), w, b, **no_in))
    xs = planar.nchw(x) * (kw["in_affine"][0].to(x.dtype)[:, None, None] + 1)
    xs = xs + kw["in_affine"][1].to(x.dtype)[:, None, None]
    raw = planar.nhwc(F.conv2d(xs, w.permute(0, 3, 1, 2), padding=1))
    assert torch.equal(kp.stage_conv_probe(x, w, b, phases="noepi", **kw),
                       raw)
    out = kp.stage_conv_probe(x, w, b, phases="nostore", **kw)
    assert torch.equal(out, torch.full_like(all_, kp.SENTINEL[x.dtype]))
    mine = torch.zeros_like(all_)
    assert kp.stage_conv_probe(x, w, b, phases="nostore", out=mine,
                               **kw) is mine and not mine.any()
    assert torch.equal(kp.stage_conv_probe(x, w, b, act="gelu",
                                           staging="direct"),
                       planar.conv_act_plain(x, w, b, "gelu"))


def test_unmasked_staging_shifts_the_padding():
    """rsft_planar_bisect's in-image test off: the input affine reaches the
    zero padding, which then holds the shift."""
    x, w, b, kw = _launch_case()
    s, sh = kw["in_affine"]
    got = kp.stage_conv_probe(x, w, b, in_affine=(s, sh), staging="unmasked")
    xp = F.pad(planar.nchw(x), (1, 1, 1, 1))
    xp = xp * (s.to(x.dtype)[:, None, None] + 1) + sh.to(x.dtype)[:, None,
                                                                  None]
    want = planar.nhwc(F.conv2d(xp, w.permute(0, 3, 1, 2), b))
    assert torch.equal(got, want)
    assert not torch.equal(got, kp.stage_conv_probe(x, w, b,
                                                    in_affine=(s, sh)))


@pytest.mark.parametrize("head", [False, True])
def test_stage_chain_all_is_the_production_plain_bit_for_bit(head):
    c = 6
    g = torch.Generator().manual_seed(3)
    r = lambda *s: ((torch.rand(*s, generator=g) - 0.5) * 0.6).to(  # noqa
        torch.bfloat16)
    w = planar.StageWeights(r(c, 3, 3, c), r(c), r(c, 3, 3, c), r(c),
                            r(c, 3, 3, c), r(c),
                            r(3, 3, 3, c) if head else None,
                            r(3) if head else None)
    x, sft = r(1, 9, 13, c), (torch.rand(4, c, generator=g) - 0.5) * 0.6
    assert torch.equal(kp.conv_rsft_probe(x, w, sft, head=head),
                       planar.fused_conv_rsft_plain(x, w, sft, head=head))
    y = r(1, 9, 13, c)
    t = kp.stage_conv_probe(y, w.w0, w.b0, act="gelu",
                            in_affine=(sft[0], sft[1]),
                            out_affine=(sft[2], sft[3]))
    assert torch.equal(kp.stage_conv_probe(t, w.w1, w.b1, residual=y),
                       planar.rsft_nhwc_plain(y, *w.rsft, sft))


def _i8_stage(head, codes_out):
    c, g = 6, torch.Generator().manual_seed(4)

    def conv(ci, co):
        wt = (torch.rand(co, ci, 3, 3, generator=g) - 0.5) * 0.4
        return types.SimpleNamespace(weight=wt, bias=torch.rand(co) * 0.1)

    bounds = {k: torch.rand(c, generator=g) + 0.5 for k in ("x", "t0",
                                                            "t1", "h")}
    w = planar.StageWeightsI8.from_oihw(conv(c, c), conv(c, c), conv(c, c),
                                        conv(c, 3) if head else None,
                                        bounds=bounds)
    x = torch.randint(-127, 128, (1, 8, 11, c), generator=g,
                      dtype=torch.int8)
    out_inv = (quant.inv_from_bound(torch.rand(c, generator=g) + 0.5)
               if codes_out else None)
    return x, w, (torch.rand(4, c, generator=g) - 0.5) * 0.6, out_inv


@pytest.mark.parametrize("head,codes_out", [(True, False), (False, True),
                                            (False, False)])
def test_i8_chain_all_and_pack_are_the_production_plain(head, codes_out):
    x, w, sft, out_inv = _i8_stage(head, codes_out)
    want = planar.fused_conv_rsft_i8_plain(x, w, sft, head=head,
                                           out_inv=out_inv)
    for staging in ("smem", "pack"):
        got = kp.conv_rsft_i8_probe(x, w, sft, head=head, out_inv=out_inv,
                                    staging=staging)
        assert got.dtype == want.dtype and torch.equal(got, want), staging


def test_i8_knockouts_and_async_staging():
    x, w, _, _ = _i8_stage(True, False)
    args = (w.conv_w, w.conv_scale, w.conv_b)
    all_ = kp.stage_conv_i8_probe(x, *args, act="sin")
    xp = F.pad(x, (0, 32 - x.shape[3]))
    assert torch.equal(kp.stage_conv_i8_probe(xp, *args, act="sin",
                                              staging="async"), all_)
    zero = kp.stage_conv_i8_probe(x, torch.zeros_like(w.conv_w), *args[1:],
                                  act="sin")
    for ph in ("nogemm", "nostage"):
        assert torch.equal(kp.stage_conv_i8_probe(x, *args, act="sin",
                                                  phases=ph), zero), ph
    acc = F.conv2d(planar.nchw(x).double(),
                   w.conv_w.permute(0, 3, 1, 2).double(), padding=1)
    assert torch.equal(kp.stage_conv_i8_probe(x, *args, phases="noepi"),
                       planar.nhwc(acc).to(torch.bfloat16))
    assert not (kp.stage_conv_i8_probe(x, *args, phases="nostore")
                != kp.SENTINEL[torch.bfloat16]).any()


def test_wrappers_run_plain_on_cpu_and_check_their_modes():
    x, w, b, kw = _launch_case()
    before = dict(LAUNCHES)
    kp.stage_conv_probe(x, w, b, **kw)
    kp.gemm_probe(_t(_rand(1, 3, 34, 4)), _t(_rand(9, 5, 4)))
    kp.stage_build_probe(x, mode="f32")
    assert LAUNCHES == before  # counts kernel launches only
    for bad in ({"phases": "nothing"}, {"staging": "tile"},
                {"phases": "nogemm", "staging": "direct"}):
        with pytest.raises(ValueError):
            kp.stage_conv_probe(x, w, b, **bad)
    with pytest.raises(ValueError, match="raw16"):
        kp.stage_build_probe(x, mode="raw16", in_affine=kw["in_affine"])
    with pytest.raises(ValueError, match="device"):
        kp.stage_conv_probe(x.to("meta"), w, b)


# --------------------------------------------------------------------- #
# the registry and the entry point
# --------------------------------------------------------------------- #

def _tools_sites():
    sites = set()
    for name in sorted(os.listdir(TOOLS)):
        if name.endswith(".py"):
            with open(os.path.join(TOOLS, name)) as f:
                for i, line in enumerate(f, 1):
                    if "pallas_call(" in line:
                        sites.add(f"tools/{name}:{i}")
    return sites


def test_every_tools_pallas_call_has_a_probe():
    sites = _tools_sites()
    assert len(sites) == 23
    assert sites == set(tp.PROBES)


@pytest.mark.parametrize("site", sorted(tp.PROBES))
def test_site_names_launched_variants(site):
    entry = tp.PROBES[site]
    assert entry.measured and entry.shape and entry.bound and entry.variants
    families = {tp.VARIANTS[k].family for k in entry.variants}
    assert families & {"K1", "K2", "K3", "K4"}


def test_registry_covers_four_families_and_every_variant_is_used():
    used = {k for s in tp.PROBES.values() for k in s.variants}
    groups = {g for _, g in tp.BREAKDOWNS}
    breakdown = {f"{g}.{ph}" for g in groups for ph in tp.KNOCKOUTS}
    assert set(tp.VARIANTS) == used | breakdown
    assert {v.family for v in tp.VARIANTS.values()} == {
        "K1", "K2", "K3", "K4", "K5", "library"}


def test_entry_point_plumbing_on_cpu():
    res = subprocess.run(
        [sys.executable, "-m", "boosting_nerv_torch.tools.probes",
         "--device", "cpu", "--size", "tiny"], cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    for site, entry in tp.PROBES.items():
        mine = [ln for ln in lines if ln.startswith(f"probe {site} ")]
        assert len(mine) == len(entry.variants), site
        assert all(" ms - " in ln for ln in mine)   # no time on the CPU
    one = subprocess.run(
        [sys.executable, "-m", "boosting_nerv_torch.tools.probes",
         "tools/planar_diag2.py", "--device", "cpu", "--size", "tiny"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert {ln.split()[1] for ln in one.stdout.splitlines()} == {
        "tools/planar_diag2.py:63", "tools/planar_diag2.py:148",
        "tools/planar_diag2.py:187"}


def test_entry_point_refuses_without_a_card():
    res = subprocess.run(
        [sys.executable, "-m", "boosting_nerv_torch.tools.probes"], cwd=REPO,
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0 and "no CUDA device" in res.stderr
    assert "probe " not in res.stdout


def _mangled(unit, kernel):
    """An instance name as nvcc mangles it: the translation unit's
    anonymous namespace carries the file's name."""
    ns = f"_GLOBAL__N__7625cca0_{len(unit)}_{unit.replace('.', '_')}_aa907fff"
    return f"_ZN{len(ns)}{ns}{len(kernel[0])}{kernel[0]}{kernel[1]}"


def test_instance_report_parsers(tmp_path):
    k1 = _mangled("stage_conv_probe.cu", (
        "stage_conv_kernel", "ILi3ELi2ELb0ELi0ELi13EEEvN3bnt6ParamsE"))
    k2 = _mangled("stage_conv_i8_probe.cu", (
        "stage_conv3x3_i8_kernel", "ILi0ELi1ELi2ELi31EEEvNS_8ParamsI8E"))
    k3 = _mangled("gemm_probe.cu", (
        "gemm_probe_kernel", "ILb1ELi8EEEvNS_10GemmParamsE"))
    k4 = _mangled("stage_build_probe.cu", (
        "stage_build_kernel", "ILi3ELi2EEEvNS_11BuildParamsE"))
    prod = _mangled("stage_conv.cu", (
        "stage_conv_kernel", "ILi3ELi2ELb0ELi0ELi15EEEvN3bnt6ParamsE"))
    assert tp.describe(k1) == ("K1", {"KS": 3, "CK": 2, "Q": 0, "S": 0,
                                      "P": 13})
    assert tp.describe(k2) == ("K2", {"IK": 0, "OK": 1, "CK": 2, "P": 31})
    assert tp.describe(k3) == ("K3", {"I8": 1, "NTC": 8})
    assert tp.describe(k4) == ("K4", {"MODE": 3, "CK": 2})
    assert [tp.source_of(k) for k in (k1, k2, k3, k4, prod)] == [
        "stage_conv_probe.cu", "stage_conv_i8_probe.cu", "gemm_probe.cu",
        "stage_build_probe.cu", "stage_conv.cu"]
    ok = {k1: 0, k2: 40, k3: 16, k4: 0, prod: 30}
    assert tp.mma_rule_failures(ok) == []
    bad = dict(ok, **{k1: 4, k3: 0, prod: 0})   # production is not a probe
    assert len(tp.mma_rule_failures(bad)) == 2
    log = tmp_path / "lib.so.log"
    src = "stage_conv_probe.cu"
    log.write_text(
        f"# {src}\nptxas info    : Compiling entry function '{k1}' for "
        "'sm_90a'\n    0 bytes stack frame, 8 bytes spill stores, 4 bytes "
        "spill loads\nptxas info    : Used 232 registers, 380 bytes cmem[0]\n")
    assert tp.ptxas_instances(str(log)) == [
        {"source": src, "name": k1, "registers": 232, "spills": 12}]


def test_k5_instances_are_told_by_their_unit_and_need_hgmma():
    """K5's instances carry their probe unit's name; the no-GEMM mask
    (P 13) must have no HGMMA, the others some; the production unit's
    instances are not probes."""
    def k5(unit, ns, mask):
        return _mangled(unit, ("conv_sm90_kernel",
                               f"ILi{ns}ELi{mask}EEEvN4sm906ParamsE"))
    nogemm, all_ = k5("conv_sm90_probe_56.cu", 56, 13), k5(
        "conv_sm90_probe_80.cu", 80, 15)
    head = k5("conv_sm90_probe.cu", 8, 11)
    prod = k5("conv_sm90.cu", 64, 15)
    assert tp.describe(nogemm) == ("K5", {"NS": 56, "P": 13})
    assert {tp.source_of(k) for k in (nogemm, all_, head)} <= set(
        tp.PROBE_SOURCES)
    assert tp.source_of(prod) not in tp.PROBE_SOURCES
    ok = {nogemm: 0, all_: 90, head: 9, prod: 0}
    assert tp.mma_rule_failures(ok) == []
    assert len(tp.mma_rule_failures({nogemm: 18, all_: 0, head: 9})) == 2


@pytest.mark.parametrize("head", [False, True])
def test_k5_chain_all_is_the_production_plain(head):
    """On the CPU the K5 chain runs the plain launches: with every phase
    it is the production wrapper's plain version, bit for bit; its
    knockouts compute what K1's do."""
    c = 6
    g = torch.Generator().manual_seed(5)
    r = lambda *s: ((torch.rand(*s, generator=g) - 0.5) * 0.6).to(  # noqa
        torch.bfloat16)
    w = planar.StageWeights(r(c, 3, 3, c), r(c), r(c, 3, 3, c), r(c),
                            r(c, 3, 3, c), r(c),
                            r(3, 3, 3, c) if head else None,
                            r(3) if head else None)
    x, sft = r(1, 9, 13, c), (torch.rand(4, c, generator=g) - 0.5) * 0.6
    assert torch.equal(kp.conv_rsft_probe(x, w, sft, head=head, sm90=True),
                       planar.fused_conv_rsft(x, w, sft, head=head))
    for ph in ("nostage", "nogemm", "noepi", "nostore"):
        assert torch.equal(
            kp.conv_rsft_probe(x, w, sft, head=head, phases=ph, sm90=True),
            kp.conv_rsft_probe(x, w, sft, head=head, phases=ph)), ph
    with pytest.raises(ValueError):
        kp.conv_sm90_probe(x, w.w0, w.b0, staging="direct")


def test_bound_takes_the_larger_of_bytes_and_operations():
    ms, by = tp.bound(989e9, 0.0)
    assert by == "operations" and abs(ms - 1.0) < 1e-12
    ms, by = tp.bound(1.0, 3.35e9, "int8")
    assert by == "bytes" and abs(ms - 1.0) < 1e-12
