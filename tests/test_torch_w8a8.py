"""The port's W8A8 serving decode against the JAX one, on the CPU: int8
weight preparation against ``prepare_*_i8``, the plain versions of the
int8 stage wrappers against the Pallas int8 kernels (interpret mode) at
the shapes of tests/test_planar_int8.py, the calibration pass, the whole
decode against ``build_fast_decode_v5(w8a8_bounds=...)``, the stage
selection and the contract.  Inputs come from numpy seeds; a model's
weights reach both packages through ``bridge.torch_state_from_flax``, a
stage's through the same HWIO -> OIHW rule.  The CUDA kernels
run only on the card: chip_smoke.py holds them against these plain
versions there."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from boosting_nerv_torch import config as port_config
from boosting_nerv_torch.bridge import torch_state_from_flax
from boosting_nerv_torch.ops.kernels import planar, quant
from boosting_nerv_torch.ops.pixelshuffle import jax_to_torch_shuffle_perm
from boosting_nerv_torch.runtime import fast_decode as port_fd
from boosting_nerv_tpu import config as jax_config
from boosting_nerv_tpu.models import build_model as build_flax_model
from boosting_nerv_tpu.ops.pallas import planar as pk
from boosting_nerv_tpu.ops.pixelshuffle import depth_to_space
from boosting_nerv_tpu.runtime import fast_decode as jax_fd

rng = np.random.default_rng(11)
C, CP, HC, WC, WD, TH = 20, 32, 9, 50, 128, 4
STAGE_TOL = 2e-2   # x max(|Pallas|, 1)
# the TINY HNeRV-Boost of tests/test_planar_int8.py's W8A8 decode test:
# fc_dim 30 gives tail channels 30/25/21, all round16 -> 32, so both tail
# stages serve int8; fc_dim 12 gives 16s, so none does
TINY = dict(
    model="HNeRV_Boost", embed="pe_1.25_20", fc_dim=30,
    dec_strds=[2, 2], dec_blks=[1, 2], ks="0_1_5",
    conv_type=["convnext", "pshuffel_3x3"], act="sin", norm="none",
    sft_block="res_sft", ch_t=8, reduce=1.2, lower_width=4,
    enc_strds=[2, 2], enc_dim="8_4")


def _rand(*shape, s=0.2):
    return rng.normal(size=shape).astype(np.float32) * s


def _module(hwio, bias, perm=None):
    """An nn.Conv2d-like OIHW (weight, bias) from a JAX HWIO kernel; perm
    reorders the output channels (JAX -> torch PixelShuffle order)."""
    w, b = hwio.transpose(3, 2, 0, 1), bias
    if perm is not None:
        w, b = w[perm], b[perm]
    return types.SimpleNamespace(
        weight=torch.from_numpy(np.ascontiguousarray(w)),
        bias=torch.from_numpy(np.ascontiguousarray(b)))


def _expected(w_ohwi, bound):
    """(codes, scale) of the fold rule, in numpy float32."""
    kf = w_ohwi * (bound / np.float32(127))
    s = np.maximum(np.abs(kf).max(axis=(1, 2, 3)), np.float32(1e-12)) \
        / np.float32(127)
    return np.clip(np.rint(kf / s[:, None, None, None]), -127, 127), s


def _conv_ref(x_nhwc, k, b):
    return lax.conv_general_dilated(
        jnp.asarray(x_nhwc), jnp.asarray(k), (1, 1), [(1, 1), (1, 1)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=lax.Precision.HIGHEST) + b


def _chmax(v):
    return np.abs(np.asarray(v)).max(axis=(0, 1, 2))


def _taps(y, p, sft):
    """f32 ResBlockSFT of NHWC y: (out, t0, t1), for the bounds."""
    s0, h0, s1, h1 = sft
    t0 = y * (s0 + 1) + h0
    t1 = jax.nn.gelu(_conv_ref(t0, p["w0"], p["b0"]), approximate=False) \
        * (s1 + 1) + h1
    return y + _conv_ref(t1, p["w1"], p["b1"]), t0, t1


def _kernel(c_in, c_out):
    """HWIO kernel and bias drawn as the model draws them (torch's default,
    U(+-1/sqrt(fan_in))): the gain of the decoder's convs, so that a
    one-code flip moves a stage's output as little as it does there."""
    b = (9 * c_in) ** -0.5
    return (rng.uniform(-b, b, (3, 3, c_in, c_out)).astype(np.float32),
            rng.uniform(-b, b, (c_out,)).astype(np.float32))


def _stage_params(c_in, c_out):
    p = dict(zip(("ck", "cb", "w0", "b0", "w1", "b1", "hk", "hb"),
                 _kernel(c_in, c_out) + _kernel(C, C) + _kernel(C, C)
                 + _kernel(C, 3)))
    p["sft"] = [_rand(C, s=0.3) for _ in range(4)]
    return p


def _port_weights(p, bounds, up=False, head=False):
    perm = jax_to_torch_shuffle_perm(C, 2) if up else None
    return planar.StageWeightsI8.from_oihw(
        _module(p["ck"], p["cb"], perm), _module(p["w0"], p["b0"]),
        _module(p["w1"], p["b1"]),
        _module(p["hk"], p["hb"]) if head else None,
        bounds={k: torch.from_numpy(np.asarray(v)) for k, v in bounds.items()},
        dtype=torch.float32)


def _jax_prep(p, bounds, up=False, head=False):
    args = [jnp.asarray(p[k]) for k in ("ck", "cb", "w0", "b0", "w1", "b1")]
    b8 = {k: jnp.asarray(v) for k, v in bounds.items()}
    if up:
        return pk.prepare_upconv_rsft_i8(*args, c_in=C, c=C, bounds=b8)
    return pk.prepare_conv_rsft_i8(
        *args, c=C, bounds=b8, head_k=jnp.asarray(p["hk"]) if head else None,
        head_b=jnp.asarray(p["hb"]) if head else None)


def _sft(p):
    return torch.from_numpy(np.stack(p["sft"]))


# --------------------------------------------------------------------- #
# weight preparation
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("up", [False, True], ids=["conv_head", "upconv"])
def test_weight_prep_matches_jax(up):
    p = _stage_params(C, 4 * C if up else C)
    keys = ("x", "t0", "t1") + (() if up else ("h",))
    bounds = {k: np.abs(_rand(C, s=1.0)) + 0.1 for k in keys}
    w = _port_weights(p, bounds, up=up, head=not up)
    prep = _jax_prep(p, bounds, up=up, head=not up)
    scq = np.asarray(prep["scq"])[..., 0]
    invq = np.asarray(prep["invq"])[..., 0]
    rows = np.arange(C)
    if up:  # JAX channel (r1, r2, c) sits on planar row (2 r1 + r2) Cp + c
        jch = jax_to_torch_shuffle_perm(C, 2)
        conv_rows = (jch // C) * CP + jch % C
        np.testing.assert_allclose(w.conv_scale, scq[0, conv_rows], rtol=1e-6)
    for plane in range(4):
        if not up:
            np.testing.assert_allclose(w.conv_scale, scq[0, plane * CP + rows],
                                       rtol=1e-6)
            np.testing.assert_allclose(w.head_scale,
                                       scq[3, plane * 16 + np.arange(3)],
                                       rtol=1e-6)
        np.testing.assert_allclose(w.scale0, scq[1, plane * CP + rows],
                                   rtol=1e-6)
        np.testing.assert_allclose(w.scale1, scq[2, plane * CP + rows],
                                   rtol=1e-6)
        np.testing.assert_allclose(w.inv_t0, invq[1, plane * CP + rows],
                                   rtol=1e-6)
    np.testing.assert_allclose(w.inv_x, invq[0, :C], rtol=1e-6)

    perm = jax_to_torch_shuffle_perm(C, 2) if up else slice(None)
    folds = [(w.conv_w, w.conv_scale, p["ck"].transpose(3, 0, 1, 2)[perm],
              "x"), (w.w0, w.scale0, p["w0"].transpose(3, 0, 1, 2), "t0"),
             (w.w1, w.scale1, p["w1"].transpose(3, 0, 1, 2), "t1")]
    if not up:
        folds.append((w.head_w, w.head_scale, p["hk"].transpose(3, 0, 1, 2),
                      "h"))
    for codes, scale, ohwi, key in folds:
        want_codes, want_scale = _expected(ohwi, bounds[key])
        assert codes.dtype == torch.int8
        np.testing.assert_array_equal(codes.numpy(), want_codes)
        np.testing.assert_array_equal(scale.numpy(), want_scale)


def test_dead_channel_gives_zero_columns_and_zero_multiplier():
    p = _stage_params(C, C)
    bounds = {k: np.abs(_rand(C, s=1.0)) + 0.1 for k in ("x", "t0", "t1")}
    bounds["x"][3] = 0.0
    w = _port_weights(p, bounds)
    assert int(w.conv_w[..., 3].abs().max()) == 0
    assert float(w.inv_x[3]) == 0.0
    codes = quant.quant_act(torch.full((1, 1, 1, C), 5.0), w.inv_x)
    assert int(codes[..., 3]) == 0 and int(codes[..., 0]) != 0


def test_quant_act_rounds_half_to_even_and_clips():
    v = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 300.0, -300.0])
    assert quant.quant_act(v, torch.ones(())).tolist() == [
        0, 2, 2, 0, -2, 127, -127]


# --------------------------------------------------------------------- #
# stage plain versions against the Pallas int8 kernels
# --------------------------------------------------------------------- #

def _stage_case(up, head, hc):
    """(params, bounds, x NHWC f32, f32 reference out) of one stage, its
    bounds taken from the reference as tests/test_planar_int8.py does."""
    p = _stage_params(C, 4 * C if up else C)
    if up:
        x = _rand(1, hc, WC, C)
        y = jnp.sin(depth_to_space(_conv_ref(x, p["ck"], p["cb"]), 2))
    else:
        x = _rand(1, 2 * hc, 2 * WC, C)
        y = jnp.sin(_conv_ref(x, p["ck"], p["cb"]))
    out, t0, t1 = _taps(y, p, p["sft"])
    bounds = {"x": _chmax(x), "t0": _chmax(t0), "t1": _chmax(t1)}
    if head:
        bounds["h"] = _chmax(out)
    return p, bounds, x, out


def _pallas(p, bounds, x, up, head, hc, i8_in=False, out_inv=None):
    prep = _jax_prep(p, bounds, up=up, head=head)
    sft = pk.sft_planar_vectors(*map(jnp.asarray, p["sft"]), CP)
    chw = jnp.asarray(x[0].transpose(2, 0, 1))
    if not i8_in:
        chw = chw.astype(jnp.bfloat16)
    if up:
        xp = jnp.pad(chw, ((0, 0), (0, 0), (0, WD - WC)))
        out = pk.fused_upconv_rsft(xp, prep, sft, c_in=C, c=C, wc_real=WC,
                                   th=TH, i8_in=i8_in, out_inv=out_inv,
                                   interpret=True)
    else:
        xp = jnp.pad(pk.to_planar(chw), ((0, 0), (0, 0), (0, WD - WC)))
        out = pk.fused_conv_rsft(xp, prep, sft, c=C, wc_real=WC, head=head,
                                 th=TH, i8_in=i8_in, out_inv=out_inv,
                                 interpret=True)
    if head:
        return np.asarray(pk.rgb_planar_to_nhwc(out, hc, WC).astype(
            jnp.float32))
    fine = pk.from_planar(out, C)[:, :, :2 * WC]
    return np.asarray(fine.transpose(1, 2, 0)[None].astype(jnp.float32))


def _err_bound(got, want):
    err = float(np.abs(got - want).max())
    assert err < STAGE_TOL * max(float(np.abs(want).max()), 1.0), err


@pytest.mark.parametrize("up,head,hc", [(False, True, 11), (False, False, 9),
                                        (True, False, 9)],
                         ids=["conv_head", "conv", "upconv"])
def test_stage_plain_matches_pallas_int8(up, head, hc):
    p, bounds, x, _ = _stage_case(up, head, hc)
    want = _pallas(p, bounds, x, up, head, hc)
    w = _port_weights(p, bounds, up=up, head=head)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    if up:
        got = planar.fused_upconv_rsft_i8_plain(xt, w, _sft(p))
    else:
        got = planar.fused_conv_rsft_i8_plain(xt, w, _sft(p), head=head)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    _err_bound(got.float().numpy(), want)


def test_zero_convert_stage_matches_pallas_int8():
    """int8 codes in (i8_in) and int8 codes out (out_inv) of a stride-1
    stage: the codes are compared after dequantising with 1/inv."""
    p, bounds, x, out = _stage_case(False, False, HC)
    inv_x = quant.inv_from_bound(torch.from_numpy(bounds["x"]))
    codes = quant.quant_act(torch.from_numpy(x), inv_x)
    bound_out = _chmax(out) * 1.05
    inv_out = quant.out_quant_vec(torch.from_numpy(bound_out))
    want = _pallas(p, bounds, codes.numpy(), False, False, HC, i8_in=True,
                   out_inv=pk.out_quant_vec(jnp.asarray(bound_out), CP))
    w = _port_weights(p, bounds)
    got = planar.fused_conv_rsft_i8_plain(codes, w, _sft(p), out_inv=inv_out)
    assert got.dtype == torch.int8 and got.shape == want.shape
    scale = (1 / inv_out).numpy()
    _err_bound(got.float().numpy() * scale, want * scale)
    assert np.mean(got.numpy() != want) < 0.05  # share of codes that differ


def test_bf16_stage_emits_codes_like_pallas():
    """The bf16 upconv with out_inv: the producer of the zero-convert
    chain (stage 4 at the bench config, planar.py:1297-1301)."""
    p, bounds, x, out = _stage_case(True, False, HC)
    bound_out = _chmax(out) * 1.05
    prep = pk.prepare_upconv_rsft(
        *(jnp.asarray(p[k]) for k in ("ck", "cb", "w0", "b0", "w1", "b1")),
        c_in=C, c=C)
    xp = jnp.pad(jnp.asarray(x[0].transpose(2, 0, 1)),
                 ((0, 0), (0, 0), (0, WD - WC))).astype(jnp.bfloat16)
    res = pk.fused_upconv_rsft(
        xp, prep, pk.sft_planar_vectors(*map(jnp.asarray, p["sft"]), CP),
        c_in=C, c=C, wc_real=WC, th=TH,
        out_inv=pk.out_quant_vec(jnp.asarray(bound_out), CP), interpret=True)
    want = np.asarray(pk.from_planar(res, C)[:, :, :2 * WC]).transpose(
        1, 2, 0)[None]
    perm = jax_to_torch_shuffle_perm(C, 2)
    w = planar.StageWeights(
        torch.from_numpy(np.ascontiguousarray(p["ck"].transpose(3, 0, 1, 2)[perm])),
        torch.from_numpy(p["cb"][perm]),
        *(torch.from_numpy(np.ascontiguousarray(v)) for v in (
            p["w0"].transpose(3, 0, 1, 2), p["b0"],
            p["w1"].transpose(3, 0, 1, 2), p["b1"])))
    inv_out = quant.out_quant_vec(torch.from_numpy(bound_out))
    got = planar.fused_upconv_rsft_plain(torch.from_numpy(x), w, _sft(p),
                                         out_inv=inv_out)
    assert got.dtype == torch.int8 and got.shape == want.shape
    scale = (1 / inv_out).numpy()
    _err_bound(got.float().numpy() * scale, want * scale)


# --------------------------------------------------------------------- #
# the wrappers' CPU contract
# --------------------------------------------------------------------- #

def _small_i8(head):
    p = _stage_params(C, C)
    keys = ("x", "t0", "t1") + (("h",) if head else ())
    bounds = {k: np.abs(_rand(C, s=1.0)) + 0.1 for k in keys}
    return _rand(1, 6, 7, C), _port_weights(p, bounds, head=head), _sft(p)


@pytest.mark.parametrize("head", [False, True])
def test_i8_wrapper_runs_the_plain_version_on_cpu(head):
    x, w, sft = _small_i8(head)
    x = torch.from_numpy(x)
    before = dict(planar.LAUNCHES)
    got = planar.fused_conv_rsft_i8(x, w, sft, head=head)
    assert torch.equal(got, planar.fused_conv_rsft_i8_plain(x, w, sft, head))
    assert planar.LAUNCHES == before


@pytest.mark.parametrize("bad", ["sft", "channels", "head_and_out_inv",
                                 "device"])
def test_i8_wrapper_checks_its_inputs(bad):
    x, w, sft = _small_i8(head=True)
    x, kw = torch.from_numpy(x), {}
    if bad == "sft":
        sft = sft[:3]
    elif bad == "channels":
        x = x[..., :3]
    elif bad == "head_and_out_inv":
        kw = {"head": True, "out_inv": w.inv_t0}
    else:
        x = x.to("meta")
    with pytest.raises(ValueError):
        planar.fused_conv_rsft_i8(x, w, sft, **kw)


# --------------------------------------------------------------------- #
# calibration and the whole decode
# --------------------------------------------------------------------- #

def _flax_params(model, seed):
    """flax params drawn with numpy from ``seed`` (no jax compile):
    kernels U(+-1/sqrt(fan_in)), biases U(+-0.1), LayerNorm scales near 1,
    layer-scale gammas in [0.3, 0.7]."""
    r = np.random.default_rng(seed)
    shapes = jax.eval_shape(model.init, jax.random.key(0),
                            jnp.zeros((1, 16, 16, 3)), jnp.array([0.4]))

    def draw(path, s):
        name = path[-1].key
        if name == "kernel":
            b = float(np.prod(s.shape[:-1])) ** -0.5
            return r.uniform(-b, b, s.shape).astype(np.float32)
        if name == "scale":
            return (1 + 0.1 * r.normal(size=s.shape)).astype(np.float32)
        if name == "gamma":
            return r.uniform(0.3, 0.7, s.shape).astype(np.float32)
        return r.uniform(-0.1, 0.1, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _tiny(**over):
    kw = {**TINY, **over}
    cfg, jcfg = port_config.BoostConfig(**kw), jax_config.BoostConfig(**kw)
    fmodel = build_flax_model(jcfg)
    params = _flax_params(fmodel, seed=6)
    img = jnp.asarray(rng.uniform(size=(1, 16, 16, 3)).astype(np.float32))
    embed = np.array(fmodel.apply(params, img, method="encode"))
    frames = [(torch.from_numpy(embed), torch.tensor([tv], dtype=torch.float32))
              for tv in (0.1, 0.4, 0.9)]
    return cfg, jcfg, params, torch_state_from_flax(params, cfg), frames


@pytest.fixture(scope="module")
def tiny30():
    return _tiny()


def test_calibration_matches_jax(tiny30):
    cfg, jcfg, params, state, frames = tiny30
    got = port_fd.calibrate_planar_bounds(cfg, state, frames,
                                          planar_from_h=1)
    want = jax_fd.calibrate_planar_bounds(
        jcfg, params, [(jnp.asarray(e.numpy()), jnp.asarray(t.numpy()))
                       for e, t in frames], planar_from_h=1)
    assert sorted(got) == sorted(want) == sorted(
        [f"{bi}.{k}" for bi in (1, 2) for k in ("x", "t0", "t1")] + ["2.h"])
    for k, v in want.items():
        # both sides run the decode in bf16, rounding at other places:
        # measured 1.8e-2 relative at most
        np.testing.assert_allclose(got[k].numpy(), v, rtol=3e-2, atol=1e-3,
                                   err_msg=k)


def test_w8a8_decode_matches_jax(tiny30):
    cfg, jcfg, params, state, frames = tiny30
    bounds = port_fd.calibrate_planar_bounds(cfg, state, frames,
                                             planar_from_h=1, margin=1.05)
    jdec = jax_fd.build_fast_decode_v5(
        jcfg, params, planar_from_h=1, th=4, interpret=True,
        w8a8_bounds={k: v.numpy() for k, v in bounds.items()})
    dec = port_fd.build_serving_decode(cfg, state, w8a8_calib=frames,
                                       planar_from_h=1)
    assert dec.w8a8_stages == jdec.w8a8_stages == [1, 2]
    assert dec.w8a8_zc == jdec.w8a8_zc == [2]
    assert dec.launches_per_frame == {"fused_upconv_rsft_i8": 1,
                                      "fused_conv_rsft_i8": 1}
    embed, t = frames[0][0], torch.tensor([0.4])
    before = dict(planar.LAUNCHES)
    out = dec(embed, t)
    assert planar.LAUNCHES == before  # the CPU path launches no kernel
    assert out.dtype == torch.bfloat16 and out.shape == (1, 16, 16, 3)
    want = np.asarray(jdec(jnp.asarray(embed.numpy()),
                           jnp.asarray(t.numpy())).astype(jnp.float32))
    diff = out.float().numpy() - want
    # measured 3.9e-3 max (one bf16 ulp near 1) and 1.09e-3 RMS; the
    # bounds are a quarter or less of the JAX W8A8 decode's own bounds
    # against flax (0.2 and 0.03)
    assert np.abs(diff).max() <= 0.05
    assert np.sqrt(np.mean(diff ** 2)) <= 5e-3


def test_stage_selection():
    bench = port_config.resolve_sizes(port_config.BoostConfig(
        model="HNeRV_Boost", embed="pe_1.25_80", enc_strds=[5, 3, 2, 2, 2],
        enc_dim="64_16", dec_strds=[5, 3, 2, 2, 2], dec_blks=[1, 1, 2, 2, 2],
        ks="0_1_5", reduce=1.2, lower_width=12, modelsize=2.8,
        conv_type=["convnext", "pshuffel_3x3"], act="sin", norm="none",
        sft_block="res_sft", ch_t=32), final_size=1920 * 1080,
        full_data_length=120)
    assert port_fd.w8a8_stage_plan(bench) == ([5, 6, 7], [5, 6, 7])
    tiny = port_config.BoostConfig(**TINY)
    assert port_fd.w8a8_stage_plan(tiny, planar_from_h=1) == ([1, 2], [2])
    assert port_fd.w8a8_stage_plan(tiny.replace(fc_dim=12),
                                   planar_from_h=1) == ([], [])


def test_no_eligible_stage_serves_the_bf16_decode():
    cfg, _, _, state, frames = _tiny(fc_dim=12)
    dec = port_fd.build_serving_decode(cfg, state, w8a8_calib=frames,
                                       planar_from_h=1)
    bf16 = port_fd.build_serving_decode(cfg, state, planar_from_h=1)
    assert dec.w8a8_stages == dec.w8a8_zc == []
    assert torch.equal(dec(*frames[1]), bf16(*frames[1]))


@pytest.mark.parametrize("calib", [[], [None], 7], ids=["empty", "not_pairs",
                                                        "not_iterable"])
def test_malformed_calibration_raises(tiny30, calib):
    cfg, _, _, state, _ = tiny30
    with pytest.raises(ValueError, match="w8a8_calib"):
        port_fd.build_serving_decode(cfg, state, w8a8_calib=calib,
                                     planar_from_h=1)
