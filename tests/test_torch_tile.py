"""The fine-grid tail of the port on the CPU: the plain versions of the four
tile wrappers (``ops.kernels.tile_conv``) against the Pallas kernels of
``boosting_nerv_tpu/ops/pallas/tile_conv.py`` in interpret mode (the v3
ones in the serving mode "dy3"); the v3 and v2 decodes, the v5 hybrid
tail (bf16 and W8A8) and the serving fallback against the JAX builders
(Pallas in interpret mode) and the flax decode; and the wrappers' contract.
Inputs come from numpy seeds; a model's weights reach both packages through
``bridge.torch_state_from_flax``.  The CUDA kernels run only on the card:
chip_smoke.py holds them against these plain versions there.

Tolerances: a wrapper's plain version (float32 on bf16-rounded inputs) is
within 2e-2 * max(|Pallas|, 1) of the Pallas kernel, which stores bf16; a
decode is within 2e-2 of the JAX decode and of flax (frames in [0, 1],
both sides in bf16)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boosting_nerv_torch import config as port_config
from boosting_nerv_torch.bridge import torch_state_from_flax
from boosting_nerv_torch.ops.kernels import LAUNCHES, tile_conv
from boosting_nerv_torch.runtime import fast_decode as port_fd
from boosting_nerv_tpu import config as jax_config
from boosting_nerv_tpu.models import build_model as build_flax_model
from boosting_nerv_tpu.ops.pallas import tile_conv as tk
from boosting_nerv_tpu.runtime import fast_decode as jax_fd

rng = np.random.default_rng(17)
WRAPPER_TOL = 2e-2   # x max(|Pallas|, 1)
DECODE_TOL = 2e-2
H = 9                # rows: two 8-row Pallas tiles, the second ragged
# the tiny HNeRV-Boost of tests/test_tile_kernels.py's v2/v3 decode tests
TINY = dict(
    model="HNeRV_Boost", embed="pe_1.25_20", fc_dim=12,
    dec_strds=[2, 2], dec_blks=[1, 2], ks="0_1_5",
    conv_type=["convnext", "pshuffel_3x3"], act="sin", norm="none",
    sft_block="res_sft", ch_t=8, reduce=1.2, lower_width=4,
    enc_strds=[2, 2], enc_dim="8_4")
# one planar stage before the fine tail: span heights 8, 16, 32, 32 on a
# 32x32 frame, stage 0 has ks 1, so _planar_tail_span gives (1, 2) at
# fine_from_h 32; fc_dim 30 makes stage 1 int8-eligible
HYBRID = {**TINY, "fc_dim": 30, "dec_strds": [2, 2, 2], "dec_blks": [1, 1, 2],
          "enc_strds": [2, 2, 2], "fc_hw": "4_4"}
# no stride-2 stage, so no planar tail: span heights 16, 48, 48 on a 48x48
# frame; v3 at tile_from_h 45 switches at stage 1
NO_PLANAR = {**TINY, "dec_strds": [4, 3], "dec_blks": [1, 2],
             "enc_strds": [4, 3], "fc_hw": "4_4"}


def _bf16(a):
    """numpy float32 rounded to bf16 (the Pallas kernels' operand type)."""
    return np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _rand(*shape, s=1.0):
    return _bf16(rng.normal(size=shape).astype(np.float32) * s)


def _pallas_in(x_nhwc):
    """NHWC [1, H, W, C] -> the Pallas (C, H, Wpad) bf16 layout."""
    x = x_nhwc[0].transpose(2, 0, 1)
    wd = -(-x.shape[2] // 128) * 128
    return jnp.pad(jnp.asarray(x), ((0, 0), (0, 0), (0, wd - x.shape[2]))
                   ).astype(jnp.bfloat16)


def _pallas_out(out, w_real):
    return np.asarray(out[:, :, :w_real].astype(jnp.float32)
                      ).transpose(1, 2, 0)[None]


def _ohwi(hwio):
    return torch.from_numpy(np.ascontiguousarray(hwio.transpose(3, 0, 1, 2)))


def _close(got, want, tol=WRAPPER_TOL):
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err < tol * max(float(np.abs(want).max()), 1.0), err


# --------------------------------------------------------------------- #
# the wrappers' plain versions against the Pallas kernels
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("c,co,w,k", [
    (5, 7, 100, 3), (6, 4, 250, 3), (6, 4, 100, 5), (8, 8, 250, 5),
    (3, 12, 100, 1)])
def test_conv_tile_plain_matches_pallas(c, co, w, k):
    x, kern, bias = _rand(1, H, w, c), _rand(k, k, c, co, s=0.2), \
        _rand(co, s=0.1)
    want = _pallas_out(tk.conv_tile(_pallas_in(x), kern, bias, k=k,
                                    w_real=w, interpret=True), w)
    got = tile_conv.conv_tile_plain(torch.from_numpy(x), _ohwi(kern),
                                    torch.from_numpy(bias), k=k)
    _close(got.numpy(), want)


@pytest.mark.parametrize("k,act,w", [
    (3, "none", 100), (3, "sin", 250), (3, "outimg", 100), (3, "gelu", 250),
    (1, "none", 250), (1, "sin", 100), (1, "outimg", 250), (1, "gelu", 100)])
def test_conv_tile_v3_plain_matches_pallas(k, act, w):
    c, co = 6, 5
    x, kern, bias = _rand(1, H, w, c), _rand(k, k, c, co, s=0.3), \
        _rand(co, s=0.1)
    want = _pallas_out(tk.conv_tile_v3(_pallas_in(x), kern, bias, k=k,
                                       w_real=w, act=act, mode="dy3",
                                       interpret=True), w)
    got = tile_conv.conv_tile_v3_plain(torch.from_numpy(x), _ohwi(kern),
                                       torch.from_numpy(bias), k=k, act=act)
    _close(got.numpy(), want)


def _rsft_case(c, w):
    x = _rand(1, H, w, c)
    w0, w1 = _rand(3, 3, c, c, s=0.2), _rand(3, 3, c, c, s=0.2)
    b0, b1 = _rand(c, s=0.1), _rand(c, s=0.1)
    sft = [rng.normal(size=(c,)).astype(np.float32) * 0.3 for _ in range(4)]
    port_args = (torch.from_numpy(x), _ohwi(w0), torch.from_numpy(b0),
                 _ohwi(w1), torch.from_numpy(b1),
                 torch.from_numpy(np.stack(sft)))
    return x, (w0, b0, w1, b1, *sft), port_args


@pytest.mark.parametrize("v3", [False, True], ids=["v2", "v3"])
@pytest.mark.parametrize("c,w", [(5, 100), (4, 250)])
def test_resblock_sft_tile_plain_matches_pallas(v3, c, w):
    x, jargs, port_args = _rsft_case(c, w)
    if v3:
        out = tk.resblock_sft_tile_v3(_pallas_in(x), *jargs, w_real=w,
                                      mode="dy3", interpret=True)
        got = tile_conv.resblock_sft_tile_v3_plain(*port_args)
    else:
        out = tk.resblock_sft_tile(_pallas_in(x), *jargs, w_real=w,
                                   interpret=True)
        got = tile_conv.resblock_sft_tile_plain(*port_args)
    _close(got.numpy(), _pallas_out(out, w))


# --------------------------------------------------------------------- #
# the wrappers' contract
# --------------------------------------------------------------------- #

def _small(name):
    g = torch.Generator().manual_seed(1)
    r = lambda *s: torch.rand(*s, generator=g) - 0.5  # noqa: E731
    c = 5
    x = r(1, 6, 7, c)
    if name.startswith("conv_tile"):
        return x, (r(4, 3, 3, c), r(4)), {"k": 3}
    return x, (r(c, 3, 3, c), r(c), r(c, 3, 3, c), r(c), r(4, c)), {}


@pytest.mark.parametrize("name", ["conv_tile", "conv_tile_v3",
                                  "resblock_sft_tile", "resblock_sft_tile_v3"])
def test_wrapper_runs_the_plain_version_on_cpu(name):
    x, args, kw = _small(name)
    before = dict(LAUNCHES)
    got = getattr(tile_conv, name)(x, *args, **kw)
    assert torch.equal(got, getattr(tile_conv, name + "_plain")(x, *args,
                                                                  **kw))
    assert LAUNCHES == before  # counts kernel launches only


@pytest.mark.parametrize("name", ["conv_tile", "conv_tile_v3",
                                  "resblock_sft_tile", "resblock_sft_tile_v3"])
def test_wrapper_raises_off_cpu_and_cuda(name):
    x, args, kw = _small(name)
    with pytest.raises(ValueError, match="device"):
        getattr(tile_conv, name)(x.to("meta"), *args, **kw)


@pytest.mark.parametrize("bad", ["k_v2", "k_v3", "act", "kernel_shape",
                                 "bias", "channels", "sft"])
def test_wrapper_checks_its_inputs(bad):
    x, (w, b), _ = _small("conv_tile")
    if bad == "k_v2":  # conv_tile takes k in {1, 3, 5}
        call = lambda: tile_conv.conv_tile(x, w, b, k=7)  # noqa: E731
    elif bad == "k_v3":  # conv_tile_v3 takes k in {1, 3}
        call = lambda: tile_conv.conv_tile_v3(x, w, b, k=5)  # noqa: E731
    elif bad == "act":
        call = lambda: tile_conv.conv_tile_v3(x, w, b, k=3,  # noqa: E731
                                              act="relu")
    elif bad == "kernel_shape":
        call = lambda: tile_conv.conv_tile(x, w, b, k=1)  # noqa: E731
    elif bad == "bias":
        call = lambda: tile_conv.conv_tile(x, w, b[:3], k=3)  # noqa: E731
    elif bad == "channels":
        call = lambda: tile_conv.conv_tile(x[..., :3], w, b,  # noqa: E731
                                           k=3)
    else:
        xr, args, _ = _small("resblock_sft_tile")
        call = lambda: tile_conv.resblock_sft_tile(  # noqa: E731
            xr, *args[:4], args[4][:3])
    with pytest.raises(ValueError):
        call()


# --------------------------------------------------------------------- #
# the decodes
# --------------------------------------------------------------------- #

def _flax_params(model, seed, hw):
    """flax params drawn with numpy from ``seed`` (no jax compile):
    kernels U(+-1/sqrt(fan_in)), biases U(+-0.1), LayerNorm scales near 1,
    layer-scale gammas in [0.3, 0.7]."""
    r = np.random.default_rng(seed)
    shapes = jax.eval_shape(model.init, jax.random.key(0),
                            jnp.zeros((1, hw, hw, 3)), jnp.array([0.4]))

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


def _setup(kw, hw, seed):
    """(port cfg, JAX cfg, flax params, port state, embed, t, flax frame)
    of one model drawn from ``seed`` and one hw x hw frame."""
    cfg, jcfg = port_config.BoostConfig(**kw), jax_config.BoostConfig(**kw)
    fmodel = build_flax_model(jcfg)
    params = _flax_params(fmodel, seed, hw)
    img = jnp.asarray(rng.uniform(size=(1, hw, hw, 3)).astype(np.float32))
    t = jnp.array([0.4])
    embed = fmodel.apply(params, img, method="encode")
    flax_out = np.asarray(fmodel.apply(params, embed, t, method="decode"))
    return (cfg, jcfg, params, torch_state_from_flax(params, cfg),
            np.array(embed), np.array(t, np.float32), flax_out)


def _serve(dec, embed, t):
    """One frame on the CPU, which launches no kernel."""
    before = dict(LAUNCHES)
    out = dec(torch.from_numpy(embed), torch.from_numpy(t))
    assert LAUNCHES == before
    assert out.dtype == torch.bfloat16
    return out.float().numpy()


def _jax(dec, embed, t):
    return np.asarray(dec(jnp.asarray(embed), jnp.asarray(t)
                          ).astype(jnp.float32))


@pytest.fixture(scope="module")
def tiny():
    return _setup(TINY, 16, seed=2)


@pytest.mark.parametrize("v3", [False, True], ids=["v2", "v3"])
def test_fine_decode_matches_jax_and_flax(tiny, v3):
    cfg, jcfg, params, state, embed, t, flax_out = tiny
    name = "build_fast_decode_v3" if v3 else "build_fast_decode_v2"
    build, jbuild = getattr(port_fd, name), getattr(jax_fd, name)
    dec = build(cfg, state, tile_from_h=1)
    conv, rsft = dec.fine.wrappers
    assert conv == ("conv_tile_v3" if v3 else "conv_tile")
    # stage 0 switches (its upconv in torch), stages 1-2 and the head on
    # the conv wrapper
    assert [st.upconv is not None for st in dec.fine.stages] == [
        True, False, False]
    assert dec.launches_per_frame == {conv: 3, rsft: 3}
    out = _serve(dec, embed, t)
    want = _jax(jbuild(jcfg, params, tile_from_h=1, interpret=True), embed, t)
    assert out.shape == want.shape == (1, 16, 16, 3)
    assert np.abs(out - want).max() < DECODE_TOL
    assert np.abs(out - flax_out).max() < DECODE_TOL
    plain = build(cfg, state, tile_from_h=1, plain=True)
    assert np.array_equal(_serve(plain, embed, t), out)  # CPU: both plain


@pytest.fixture(scope="module")
def hybrid():
    return _setup(HYBRID, 32, seed=8)


@pytest.mark.parametrize("w8a8", [False, True], ids=["bf16", "w8a8"])
def test_hybrid_tail_matches_jax(hybrid, w8a8):
    cfg, jcfg, params, state, embed, t, flax_out = hybrid
    plan = port_config.decoder_stage_plan(cfg, cfg.fc_dim, hnerv_style=True)
    out_hw = port_fd.stage_out_hw(cfg, plan)
    assert [h for h, _ in out_hw] == [8, 16, 32, 32]
    assert port_fd._planar_tail_span(cfg, plan, out_hw, 1, 32) == (1, 2)
    calib = [(torch.from_numpy(embed), torch.tensor([tv])) for tv in
             (0.1, 0.4, 0.9)] if w8a8 else None
    dec = port_fd.build_fast_decode_v5(cfg, state, calib, planar_from_h=1,
                                       fine_from_h=32)
    bounds = None
    if w8a8:
        assert dec.w8a8_stages == [1] and dec.w8a8_zc == []
        bounds = port_fd.calibrate_planar_bounds(
            cfg, state, calib, planar_from_h=1, fine_from_h=32, margin=1.05)
        assert sorted(bounds) == ["1.t0", "1.t1", "1.x"]  # planar only
        bounds = {k: v.numpy() for k, v in bounds.items()}
    assert [st.index for st in dec.tail] == [1]
    assert [st.index for st in dec.fine.stages] == [2, 3]
    assert dec.launches_per_frame == {
        "fused_upconv_rsft" + ("_i8" if w8a8 else ""): 1,
        "conv_tile_v3": 3, "resblock_sft_tile_v3": 2}
    jdec = jax_fd.build_fast_decode_v5(jcfg, params, planar_from_h=1, th=4,
                                       fine_from_h=32, w8a8_bounds=bounds,
                                       interpret=True)
    if w8a8:
        assert jdec.w8a8_stages == [1] and jdec.w8a8_zc == []
    out = _serve(dec, embed, t)
    assert out.shape == (1, 32, 32, 3)
    assert np.abs(out - _jax(jdec, embed, t)).max() < DECODE_TOL
    if not w8a8:
        assert np.abs(out - flax_out).max() < DECODE_TOL


def test_serving_falls_back_to_v3_without_a_planar_tail():
    cfg, jcfg, params, state, embed, t, flax_out = _setup(NO_PLANAR, 48,
                                                          seed=4)
    plan = port_config.decoder_stage_plan(cfg, cfg.fc_dim, hnerv_style=True)
    assert [h for h, _ in port_fd.stage_out_hw(cfg, plan)] == [16, 48, 48]
    with pytest.raises(ValueError, match="no planar-eligible tail"):
        port_fd.build_fast_decode_v5(cfg, state)
    dec = port_fd.build_serving_decode(cfg, state)
    assert [(st.index, st.upconv is not None) for st in dec.fine.stages] == [
        (1, True), (2, False)]
    assert dec.launches_per_frame == {"conv_tile_v3": 2,
                                      "resblock_sft_tile_v3": 2}
    out = _serve(dec, embed, t)
    want = _jax(jax_fd.build_fast_decode_v3(jcfg, params, tile_from_h=45,
                                            interpret=True), embed, t)
    assert out.shape == want.shape == (1, 48, 48, 3)
    assert np.abs(out - want).max() < DECODE_TOL
    assert np.abs(out - flax_out).max() < DECODE_TOL
    with pytest.raises(ValueError, match="W8A8 serving needs a planar tail"):
        port_fd.build_serving_decode(
            cfg, state, w8a8_calib=[(torch.from_numpy(embed),
                                     torch.from_numpy(t))])
