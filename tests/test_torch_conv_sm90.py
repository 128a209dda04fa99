"""The host side of the Hopper conv kernel (``ops/kernels/conv_sm90.py``) on
the CPU: its N-slice plan, its weight packing and operand layouts, and
``emulate`` (the kernel's staging, descriptor addressing and epilogue in
plain torch, consuming the packed weights and the padded operand tile)
against the Pallas kernels it replaces in interpret mode:
``tile_conv.py:144`` conv_tile at k = 1, 3 and 5, ``planar.py:1308``
fused_upconv_rsft with and without ``out_inv``, ``planar.py:1541``
fused_conv_rsft without and with the head and with ``out_inv`` (planar in
and out), ``tile_conv.py:788`` resblock_sft_tile_v3 (mode "dy3"),
``tile_conv.py:473`` conv_tile_v3 (k = 3 with act sin and outimg, k = 1
with gelu), ``tile_conv.py:951`` resblock_sft_tile, ``fused_sft.py:138``
resblock_sft_chw with ``input_sin`` (the sin modes), ``planar.py:484``
rsft_planar at a ragged real region (the planar modes), ``planar.py:398``
conv_planar with act sin and outimg (the planar in-and-out mode) and
``conv_chw.py:88`` conv3x3_act_chw and ``:95`` head_conv_chw; the
slice-group plan of small grids (``groups``, ``work_items``) and the
modes' shared-memory and slice-group plans.
The CUDA kernel runs only on the card: chip_smoke.py holds it against the
wrappers' plain versions there.

Tolerance: 2e-2 * max(|Pallas|, 1), both sides storing bf16 (a planar
conv's pads, which the emulation fills with act(0), compared exactly, 0.5
for outimg); int8 codes
are compared after dequantising with 1 / out_inv (the Pallas stage keeps y
in float32 where the port's chain stores it in bf16, so single codes may
differ by one step), as tests/test_torch_w8a8.py compares them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boosting_nerv_torch.ops.kernels import conv_sm90, planar, quant
from boosting_nerv_torch.ops.pixelshuffle import jax_to_torch_shuffle_perm
from boosting_nerv_tpu.ops.pallas import conv_chw as ck
from boosting_nerv_tpu.ops.pallas import fused_sft as fk
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


def _conv_tile_case(r, k, h, w, act=None):
    """``emulate`` against Pallas conv_tile, or with ``act`` conv_tile_v3
    (the act in the epilogue)."""
    c, co = 6, 7
    x, kern, bias = _rand(r, 1, h, w, c), _rand(r, k, k, c, co, s=0.2), \
        _rand(r, co, s=0.1)
    if act is None:
        want = tk.conv_tile(_chw(x), kern, bias, k=k, w_real=w,
                            interpret=True)
    else:
        want = tk.conv_tile_v3(_chw(x), kern, bias, k=k, w_real=w, act=act,
                               interpret=True)
    want = np.asarray(want[:, :, :w].astype(jnp.float32)).transpose(
        1, 2, 0)[None]
    wt = _ohwi(kern).to(torch.bfloat16)
    got = conv_sm90.emulate(
        torch.from_numpy(x).to(torch.bfloat16),
        conv_sm90.pack_weight(wt, conv_sm90.slice_width(co)),
        torch.from_numpy(bias).to(torch.bfloat16), cout=co, k=k,
        act=act or "none")
    return got.float().numpy(), want, None


def _conv_tile_v3_case(r, k_act, h, w):
    return _conv_tile_case(r, *k_act[:1], h, w, act=k_act[1])


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


def _conv_rsft_case(r, mode, h, w):
    """``conv_rsft`` on ``emulated_conv`` against the Pallas stride-1 stage
    on the planar form of an h x w fine frame (h, w even)."""
    c, hc, wc = 5, h // 2, w // 2
    p = {"ck": _rand(r, 3, 3, c, c, s=0.2), "cb": _rand(r, c, s=0.1),
         "w0": _rand(r, 3, 3, c, c, s=0.2), "b0": _rand(r, c, s=0.1),
         "w1": _rand(r, 3, 3, c, c, s=0.2), "b1": _rand(r, c, s=0.1)}
    hk, hb = _rand(r, 3, 3, c, 3, s=0.2), _rand(r, 3, s=0.1)
    sft = [r.normal(size=c).astype(np.float32) * 0.3 for _ in range(4)]
    x = _rand(r, 1, h, w, c)
    head = mode == "head"
    inv = jinv = None
    if mode == "out_inv":
        s0, h0, s1, h1 = sft
        y = np.sin(_conv_ref(x, p["ck"], p["cb"]))
        t = _gelu(_conv_ref(y * (s0 + 1) + h0, p["w0"], p["b0"]))
        out = y + _conv_ref(t * (s1 + 1) + h1, p["w1"], p["b1"])
        bound = np.abs(out).max(axis=(0, 1, 2)) * 1.05
        inv = quant.out_quant_vec(torch.from_numpy(bound))
        jinv = pk.out_quant_vec(jnp.asarray(bound), 16)
    prep = pk.prepare_conv_rsft(
        *(jnp.asarray(p[k]) for k in ("ck", "cb", "w0", "b0", "w1", "b1")),
        c=c, head_k=jnp.asarray(hk) if head else None,
        head_b=jnp.asarray(hb) if head else None)
    xp = pk.to_planar(jnp.asarray(x[0].transpose(2, 0, 1)).astype(
        jnp.bfloat16))
    xp = jnp.pad(xp, ((0, 0), (0, 0), (0, WD - wc)))
    res = pk.fused_conv_rsft(
        xp, prep, pk.sft_planar_vectors(*map(jnp.asarray, sft), 16), c=c,
        wc_real=wc, head=head, th=4, out_inv=jinv, interpret=True)
    if head:
        want = pk.rgb_planar_to_nhwc(res, hc, wc)
    else:
        want = pk.from_planar(res, c)[:, :, :w].transpose(1, 2, 0)[None]
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    weights = planar.StageWeights(*(
        t.to(torch.bfloat16).contiguous() for t in (
            _ohwi(p["ck"]), torch.from_numpy(p["cb"]), _ohwi(p["w0"]),
            torch.from_numpy(p["b0"]), _ohwi(p["w1"]),
            torch.from_numpy(p["b1"]))), *((
                _ohwi(hk).to(torch.bfloat16),
                torch.from_numpy(hb).to(torch.bfloat16)) if head else ()))
    got = conv_sm90.conv_rsft(
        conv_sm90.emulated_conv, torch.from_numpy(x).to(torch.bfloat16),
        weights, torch.from_numpy(np.stack(sft)), head, inv)
    return got.float().numpy(), want, inv


def _rsft_case(r, v2, h, w):
    """``rsft`` on ``emulated_conv`` against the Pallas v3 ResBlockSFT, or
    with ``v2`` the v2 one (resblock_sft_tile)."""
    c = 6
    x = _rand(r, 1, h, w, c)
    w0, w1 = _rand(r, 3, 3, c, c, s=0.2), _rand(r, 3, 3, c, c, s=0.2)
    b0, b1 = _rand(r, c, s=0.1), _rand(r, c, s=0.1)
    sft = [r.normal(size=c).astype(np.float32) * 0.3 for _ in range(4)]
    if v2:
        want = tk.resblock_sft_tile(_chw(x), w0, b0, w1, b1, *sft, w_real=w,
                                    interpret=True)
    else:
        want = tk.resblock_sft_tile_v3(_chw(x), w0, b0, w1, b1, *sft,
                                       w_real=w, mode="dy3", interpret=True)
    want = np.asarray(want[:, :, :w].astype(jnp.float32)).transpose(
        1, 2, 0)[None]
    bf = torch.bfloat16
    got = conv_sm90.rsft(
        conv_sm90.emulated_conv, torch.from_numpy(x).to(bf),
        (_ohwi(w0).to(bf), torch.from_numpy(b0).to(bf), _ohwi(w1).to(bf),
         torch.from_numpy(b1).to(bf)), torch.from_numpy(np.stack(sft)))
    return got.float().numpy(), want, None


def _rsft_chw_case(r, _, h, w):
    """``rsft`` with ``input_sin`` on ``emulated_conv`` (conv0 in
    SIN_INPUT, conv1 in SIN_RESIDUAL) against the Pallas v1 ResBlockSFT
    with ``input_sin``, whose block input and residual are sin(x)."""
    c = 6
    x = _rand(r, 1, h, w, c, s=2.0)
    w0, w1 = _rand(r, 3, 3, c, c, s=0.2), _rand(r, 3, 3, c, c, s=0.2)
    b0, b1 = _rand(r, c, s=0.1), _rand(r, c, s=0.1)
    sft = [r.normal(size=c).astype(np.float32) * 0.3 for _ in range(4)]

    def taps(k):  # HWIO -> (9, Cout, Cin)
        return jnp.asarray(k.transpose(0, 1, 3, 2).reshape(9, c, c),
                           jnp.bfloat16)

    want = fk.resblock_sft_chw(
        jnp.asarray(x[0].transpose(2, 0, 1), jnp.bfloat16), taps(w0),
        jnp.asarray(b0), taps(w1), jnp.asarray(b1), *map(jnp.asarray, sft),
        interpret=True, input_sin=True)
    want = np.asarray(want.astype(jnp.float32)).transpose(1, 2, 0)[None]
    bf = torch.bfloat16
    got = conv_sm90.rsft(
        conv_sm90.emulated_conv, torch.from_numpy(x).to(bf),
        (_ohwi(w0).to(bf), torch.from_numpy(b0).to(bf), _ohwi(w1).to(bf),
         torch.from_numpy(b1).to(bf)), torch.from_numpy(np.stack(sft)),
        input_sin=True)
    return got.float().numpy(), want, None


def _rsft_planar_case(r, hc, hc_real, wc_real):
    """``rsft_planar`` on ``emulated_conv`` (conv0 staging the planar box
    in PLANAR_IN, conv1 adding the planar residual and storing in
    PLANAR_OUT) against the Pallas planar ResBlockSFT, on the real region
    of a planar (4 Cp, hc, WD) input whose pad rows, columns and channels
    hold random values, which the output keeps."""
    c = 6
    xp = np.asarray(pk.to_planar(jnp.asarray(
        _rand(r, c, 2 * hc_real, 2 * wc_real))))
    xp = np.pad(xp, ((0, 0), (0, hc - hc_real), (0, WD - wc_real)))
    real = np.zeros(xp.shape, bool)
    real.reshape(4, -1, hc, WD)[:, :c, :hc_real, :wc_real] = True
    xp = np.where(real, xp, _rand(r, *xp.shape))
    w0, w1 = _rand(r, 3, 3, c, c, s=0.2), _rand(r, 3, 3, c, c, s=0.2)
    b0, b1 = _rand(r, c, s=0.1), _rand(r, c, s=0.1)
    sft = r.normal(size=(4, c)).astype(np.float32) * 0.3
    want = pk.rsft_planar(jnp.asarray(xp, jnp.bfloat16), jnp.asarray(w0),
                          jnp.asarray(b0), jnp.asarray(w1), jnp.asarray(b1),
                          *map(jnp.asarray, sft), c=c, hc_real=hc_real,
                          wc_real=wc_real, th=4, interpret=True)
    bf = torch.bfloat16
    xt = torch.from_numpy(xp).to(bf)
    got = conv_sm90.rsft_planar(
        conv_sm90.emulated_conv, xt,
        (_ohwi(w0).to(bf), torch.from_numpy(b0).to(bf), _ohwi(w1).to(bf),
         torch.from_numpy(b1).to(bf)), torch.from_numpy(sft), hc_real,
        wc_real)
    assert got.shape == xt.shape
    assert torch.equal(got[torch.from_numpy(~real)], xt[~real])

    def fine(out):  # the real region, NHWC [1, 2 hc_real, 2 wc_real, C]
        out = np.asarray(jnp.asarray(out, jnp.float32))[:, :hc_real]
        return np.asarray(pk.from_planar(jnp.asarray(out), c))[
            :, :, :2 * wc_real].transpose(1, 2, 0)[None]

    return fine(got.float().numpy()), fine(want), None


def _conv_planar_case(r, co_act, hc, wc_real):
    """``conv_planar`` on ``emulated_conv`` (PLANAR_IO: the planar box
    staged, act(conv + b) stored into the planar output) against the Pallas
    planar conv, on the real region (hc rows, wc_real columns) of a planar
    (4 Cp, hc + 1, WD) input whose pad row, columns and channels hold
    random values; the output's pad channels, row and columns hold act(0)
    exactly."""
    c, (co, act) = 6, co_act
    xp = np.asarray(pk.to_planar(jnp.asarray(
        _rand(r, c, 2 * hc, 2 * wc_real))))
    xp = np.pad(xp, ((0, 0), (0, 1), (0, WD - wc_real)))
    real = np.zeros(xp.shape, bool)
    real.reshape(4, -1, hc + 1, WD)[:, :c, :hc, :wc_real] = True
    xp = np.where(real, xp, _rand(r, *xp.shape))
    kern, bias = _rand(r, 3, 3, c, co, s=0.2), _rand(r, co, s=0.1)
    want = pk.conv_planar(jnp.asarray(xp[:, :hc], jnp.bfloat16),
                          jnp.asarray(kern), jnp.asarray(bias), c_in=c,
                          c_out=co, wc_real=wc_real, act=act, th=4,
                          interpret=True)
    bf, cpo = torch.bfloat16, planar._round16(co)
    got = conv_sm90.conv_planar(
        conv_sm90.emulated_conv, torch.from_numpy(xp).to(bf),
        _ohwi(kern).to(bf), torch.from_numpy(bias).to(bf), act, hc, wc_real,
        cpo)
    assert got.shape == (4 * cpo, hc + 1, WD)
    image = torch.zeros(got.shape, dtype=torch.bool)
    image.view(4, cpo, hc + 1, WD)[:, :co, :hc, :wc_real] = True
    assert torch.all(got[~image] == {"sin": 0.0, "outimg": 0.5}[act])

    def fine(out):  # the real region, NHWC [1, 2 hc, 2 wc_real, Co]
        out = np.asarray(jnp.asarray(out, jnp.float32))[:, :hc]
        return np.asarray(pk.from_planar(jnp.asarray(out), co))[
            :, :, :2 * wc_real].transpose(1, 2, 0)[None]

    return fine(got.float().numpy()), fine(want), None


def _conv_chw_case(r, name, h, w):
    """One ``conv_sm90.launch`` at k = 3, emulated (the body of the v1
    wrappers: act sin at C 6 -> 7, act outimg at 6 -> 3 on the N 8 slice),
    against the Pallas conv_chw entry point of that name (``_run``)."""
    c, co, act = {"conv3x3_act_chw": (6, 7, "sin"),
                  "head_conv_chw": (6, 3, "outimg")}[name]
    x, kern, bias = (_rand(r, 1, h, w, c), _rand(r, 3, 3, c, co, s=0.2),
                     _rand(r, co, s=0.1))
    w9 = jnp.asarray(kern.transpose(0, 1, 3, 2).reshape(9, co, c),
                     jnp.bfloat16)
    want = getattr(ck, name)(jnp.asarray(x[0].transpose(2, 0, 1),
                                         jnp.bfloat16), w9,
                             jnp.asarray(bias), interpret=True)
    want = np.asarray(want.astype(jnp.float32)).transpose(1, 2, 0)[None]
    wt = _ohwi(kern).to(torch.bfloat16)
    got = conv_sm90.emulate(
        torch.from_numpy(x).to(torch.bfloat16),
        conv_sm90.pack_weight(wt, conv_sm90.slice_width(co)),
        torch.from_numpy(bias).to(torch.bfloat16), cout=co, k=3, act=act)
    return got.float().numpy(), want, None


CASES = {"conv_tile": _conv_tile_case, "conv_tile_v3": _conv_tile_v3_case,
         "fused_upconv_rsft": _upconv_case,
         "fused_conv_rsft": _conv_rsft_case,
         "resblock_sft_tile_v3": _rsft_case,
         "resblock_sft_tile": lambda r, _, h, w: _rsft_case(r, True, h, w),
         "resblock_sft_chw": _rsft_chw_case,
         "rsft_planar": _rsft_planar_case,
         "conv_planar": _conv_planar_case, "conv_chw": _conv_chw_case}


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
    ("fused_upconv_rsft", True, 9, 50), ("fused_conv_rsft", "nohead", 10, 50),
    ("fused_conv_rsft", "head", 10, 50),
    ("fused_conv_rsft", "out_inv", 10, 50),
    ("resblock_sft_tile_v3", None, 9, 50),
    ("conv_tile_v3", (3, "sin"), 9, 50),
    ("conv_tile_v3", (3, "outimg"), 9, 50),
    ("conv_tile_v3", (1, "gelu"), 9, 70),
    ("resblock_sft_tile", None, 9, 50),
    ("resblock_sft_chw", None, 9, 50),
    ("rsft_planar", 6, 5, 50),
    ("conv_planar", (7, "sin"), 5, 50),
    ("conv_planar", (3, "outimg"), 5, 50),
    ("conv_chw", "conv3x3_act_chw", 9, 50),
    ("conv_chw", "head_conv_chw", 9, 50)],
    ids=["conv_tile_k1", "conv_tile_k3", "conv_tile_k5", "upconv",
         "upconv_out_inv", "conv_rsft", "conv_rsft_head",
         "conv_rsft_out_inv", "rsft_v3", "conv_tile_v3_k3_sin",
         "conv_tile_v3_k3_outimg", "conv_tile_v3_k1_gelu", "rsft_v2",
         "rsft_chw_input_sin", "rsft_planar_ragged", "conv_planar_sin",
         "conv_planar_outimg_head", "conv3x3_act_chw", "head_conv_chw"])
def test_emulation_matches_pallas(case):
    name, arg, h, w = case
    r = np.random.default_rng(sum(map(ord, str(case))))
    got, want, inv = CASES[name](r, arg, h, w)
    assert got.shape == want.shape
    if inv is not None:
        scale = (1 / inv).numpy()
        got, want = got * scale, want * scale
    err = float(np.abs(got - want).max())
    assert err < TOL * max(float(np.abs(want).max()), 1.0), err


# (h, w, Cin, Cout) of every conv_sm90.cu / conv_sm90_i8.cu launch grid of
# the v5, W8A8, v3, v2 and hybrid decodes at the bench config
# (chip_smoke.py::bench_config): the conv input's grid, 3 x 3 convs
_BENCH_LAUNCHES = {
    "v3/v2 stage 0 rsft": (45, 80, 106, 106),
    "v3/v2 stage 1 conv": (45, 80, 106, 792),
    "v3/v2 stage 1 rsft": (135, 240, 88, 88),
    "v5 stage 2 upconv, v3/v2 stage 2 conv": (135, 240, 88, 292),
    "stage 2-3 rsft, stage 3 conv": (270, 480, 73, 73),
    "v5 stage 4 upconv, v3/v2 stage 4 conv": (270, 480, 73, 244),
    "stage 4-5 rsft, stage 5 conv": (540, 960, 61, 61),
    "v5 stage 6 upconv, v3/v2 stage 6 conv": (540, 960, 61, 204),
    "stage 6-7 rsft, stage 7 conv": (1080, 1920, 51, 51),
    "head": (1080, 1920, 51, 3),
}


def _bench_plan(h, w, cin, cout, sms=132):
    """(G, tiles, N slices) of a bf16 launch, at the blocks an SM holds
    by shared memory alone (228 KB an SM, 1 KB of it reserved a block)."""
    ns = conv_sm90.slice_width(cout)
    nwg, _, _, smem = conv_sm90.fit(cin, cout, 3, ns)
    tiles = conv_sm90.tiles(1, h, w, nwg)
    nsl = -(-cout // ns)
    per_sm = 233472 // (smem + 1024)
    return conv_sm90.groups(tiles, nsl, sms, per_sm), tiles, nsl


def test_slice_group_plan():
    """The work items of every slice-group plan cover each (tile, slice)
    exactly once; the plan keeps G = 1 at every launch of 270 rows and
    more at the bench config (whose tiles fill the card's 132 SMs several
    times over) and splits the 45 x 80 stage-1 conv's ten N slices; and
    ``emulate`` with G > 1 is ``emulate`` with G = 1, bit for bit."""
    for n_tiles in (1, 7, 46, 136):
        for nsl in (1, 2, 4, 10):
            for sms, per_sm in ((132, 1), (132, 2), (8, 1)):
                g = conv_sm90.groups(n_tiles, nsl, sms, per_sm)
                items = conv_sm90.work_items(n_tiles, nsl, g)
                covered = sorted((t, s) for t, s0, s1 in items
                                 for s in range(s0, s1))
                assert covered == [(t, s) for t in range(n_tiles)
                                   for s in range(nsl)], (n_tiles, nsl, g)
                assert all(s1 > s0 for _, s0, s1 in items)
    for name, (h, w, cin, cout) in _BENCH_LAUNCHES.items():
        g, tiles, nsl = _bench_plan(h, w, cin, cout)
        if h >= 270:
            assert g == 1, (name, g, tiles, nsl)
    assert _bench_plan(45, 80, 106, 792)[0] > 1
    r = np.random.default_rng(9)
    x = torch.from_numpy(_rand(r, 1, 9, 70, 5)).to(torch.bfloat16)
    wt = torch.from_numpy(_rand(r, 20, 3, 3, 5, s=0.2)).to(torch.bfloat16)
    b = torch.from_numpy(_rand(r, 20, s=0.1)).to(torch.bfloat16)
    wpk = conv_sm90.pack_weight(wt, 8)   # three N 8 slices
    one = conv_sm90.emulate(x, wpk, b, cout=20, k=3, act="gelu", ns=8)
    for g in (2, 3):
        assert torch.equal(conv_sm90.emulate(x, wpk, b, cout=20, k=3,
                                             act="gelu", groups=g, ns=8),
                           one)


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

        bnt_conv_sm90_kloop_smem = bnt_conv_sm90_smem  # Cin beyond 128

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


def test_check_rsft_on_the_hopper_kernel_refuses_wide_cin(monkeypatch):
    """``_check_rsft`` fitted by ``sm90_smem``: a meta tensor is refused
    (no card), and on the card a ResBlockSFT of more than 256 channels
    (beyond the K loop's) fails the Hopper kernel's fit (the library's fit
    here is its mirror, ``conv_sm90.fit``, which chip_smoke.py holds to
    the library); 200 channels fit through the K loop."""
    c = 264
    x = torch.zeros(1, 4, 9, c)
    w, b = torch.zeros(c, 3, 3, c), torch.zeros(c)
    with pytest.raises(ValueError, match="device"):
        planar._check_rsft(x.to("meta"), w, b, w, b, torch.zeros(4, c),
                           planar.sm90_smem)

    class Lib:  # the library's fit, as conv_sm90.fit computes it
        @staticmethod
        def bnt_conv_sm90_smem(cin, cout, ks, ns):
            plan = conv_sm90.fit(cin, cout, ks, ns)
            return -1 if plan is None else plan[-1]

        bnt_conv_sm90_kloop_smem = bnt_conv_sm90_smem

    conv_sm90.plan.cache_clear()
    monkeypatch.setattr(planar._build, "load_library", lambda: Lib)
    with pytest.raises(ValueError, match="Cin <= 128"):
        planar.check_fit(planar.sm90_smem, [(c, c, 3)])
    planar.check_fit(planar.sm90_smem,
                     [(128, 128, 3), (51, 51, 3), (200, 200, 3)])
    conv_sm90.plan.cache_clear()


def test_shared_memory_plan_at_the_bench_shapes():
    """Two warpgroups on a 4 x 64 tile with every weight block resident
    where that fits (the 51- and 61-channel convs, the 3-channel head),
    else with a weight ring (73 channels, the upconvs), else one
    warpgroup; every plan within the card's shared memory; beyond 128
    input channels only the K loop's plan (streamed weights, one
    warpgroup at E-NeRV-Boost's 172 and 213 -> 4 x C upconvs), nothing
    beyond 256."""
    def plan(cin, cout, k=3):
        return conv_sm90.fit(cin, cout, k, conv_sm90.slice_width(cout))
    assert all(plan(*s)[:3] == (2, 9, True)
               for s in ((51, 51), (61, 61), (51, 3)))
    assert all(plan(*s)[0] == 2 and not plan(*s)[2]
               for s in ((73, 73), (61, 204), (73, 244), (88, 292)))
    assert plan(106, 792)[0] == 1
    assert conv_sm90.fit(128, 80, 5, 80) is None
    assert conv_sm90.fit(128, 80, 5, 8)[0] == 1
    assert all(conv_sm90.fit(c, c, 3, ns) is None
               for c in (257, 300) for ns in conv_sm90.NS_CHOICES)
    assert all(not conv_sm90.fit(c, c, 3, ns)[2]
               for c in (129, 200) for ns in conv_sm90.NS_CHOICES)
    assert plan(172, 344)[:3] == (1, 8, False)
    assert plan(213, 424)[:3] == (1, 8, False)
    for cin, cout, k in ((6, 7, 5), (51, 459, 1), (106, 106, 3)):
        assert plan(cin, cout, k)[-1] <= conv_sm90.MAX_SMEM


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


@pytest.mark.parametrize("mode", ["sin_input", "sin_residual", "planar_in",
                                  "planar_out", "planar_io"])
def test_mode_plans(mode, monkeypatch):
    """The modes' plans (the mirrors ``fit`` and ``groups`` of their
    instances, which chip_smoke.py holds to the library): one slice group
    a launch, even where the plan would split a small grid's slices; the
    sin modes' shared memory is the NONE launch's; the planar modes take
    3 x 3 only; PLANAR_IN's raw buffer holds its box (two warpgroups, the
    weights resident at the planar phase's C 51), PLANAR_OUT's transposed
    staging needs more only at N 80, PLANAR_IO takes both (PLANAR_IN's
    plan below N 80) and fits the planar phase's C 51 -> 51 at N 56 and
    51 -> 3 at N 8 with two warpgroups; the planar wrappers' fit check
    (``sm90_smem`` in their mode, here on a library whose fit is the
    mirror) takes C 51 and refuses C 200."""
    m = getattr(conv_sm90, mode.upper())
    assert conv_sm90.groups(46, 10, 132, 1) > 1
    assert conv_sm90.groups(46, 10, 132, 1, mode=m) == 1
    assert conv_sm90.work_items(3, 2, 1) == [(0, 0, 2), (1, 0, 2),
                                             (2, 0, 2)]
    for c in (5, 16, 51, 61, 73, 128):
        for ns in conv_sm90.NS_CHOICES:
            none, got = (conv_sm90.fit(c, c, 3, ns),
                         conv_sm90.fit(c, c, 3, ns, mode=m))
            if m in (conv_sm90.SIN_INPUT, conv_sm90.SIN_RESIDUAL):
                assert got == none
                continue
            assert conv_sm90.fit(c, c, 5, ns, mode=m) is None
            if got is None:  # only a planar box's larger raw buffer misses
                assert m != conv_sm90.PLANAR_OUT and none is not None
                continue
            assert got[-1] <= conv_sm90.MAX_SMEM
            if m == conv_sm90.PLANAR_OUT:
                extra = 0 if ns < 80 else got[0] * (80 * 68 - 64 * 84) * 4
                assert got[:3] == none[:3] and got[-1] == none[-1] + extra
            else:
                if m == conv_sm90.PLANAR_IO and ns < 80:
                    assert got == conv_sm90.fit(c, c, 3, ns,
                                                mode=conv_sm90.PLANAR_IN)
                nwg = got[0]
                box = conv_sm90.PBX * conv_sm90.planar_rows(nwg) * c * 8
                assert (2 * nwg + 2) * conv_sm90.planar_raw_pitch(
                    c, nwg) >= box
    assert conv_sm90.fit(51, 51, 3, 56, mode=m)[:3] == (2, 9, True)
    assert conv_sm90.fit(51, 51, 3, 64, form=conv_sm90.S8, mode=m) is None
    if m == conv_sm90.PLANAR_IO:
        assert conv_sm90.fit(51, 51, 3, 56, mode=m)[-1] == 225056
        assert conv_sm90.fit(51, 3, 3, 8, mode=m)[:3] == (2, 9, True)
    if m in conv_sm90.PLANAR_MODES:
        class Lib:  # the library's planar fit, as the mirror computes it
            @staticmethod
            def bnt_conv_sm90_planar_smem(cin, cout, ns, mode):
                plan = conv_sm90.fit(cin, cout, 3, ns, mode=mode)
                return -1 if plan is None else plan[-1]

        conv_sm90.plan.cache_clear()
        monkeypatch.setattr(planar._build, "load_library", lambda: Lib)
        bf = conv_sm90.BF16
        planar.check_fit(planar.sm90_smem, [(51, 51, 3, bf, m)])
        with pytest.raises(ValueError, match="Cin <= 128"):
            planar.check_fit(planar.sm90_smem, [(200, 200, 3, bf, m)])
        conv_sm90.plan.cache_clear()
