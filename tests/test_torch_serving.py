"""The port's serving decode (its plain path on the CPU) against the JAX
v5 decode (Pallas in interpret mode) and the flax decode, with the same
weights; and build_serving_decode's stage selection and contract."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boosting_nerv_torch import config as port_config
from boosting_nerv_torch.bridge import torch_state_from_flax
from boosting_nerv_torch.models import build_model, decoder_only_params
from boosting_nerv_torch.ops.kernels import planar
from boosting_nerv_torch.runtime import fast_decode as port_fd
from boosting_nerv_tpu import config as jax_config
from boosting_nerv_tpu.models import build_model as build_flax_model
from boosting_nerv_tpu.runtime import fast_decode as jax_fd

rng = np.random.default_rng(3)
# the tiny HNeRV-Boost of tests/test_planar_kernels.py (v5 decode test)
TINY = dict(
    model="HNeRV_Boost", embed="pe_1.25_20", fc_dim=12,
    dec_strds=[2, 2], dec_blks=[1, 2], ks="0_1_5",
    conv_type=["convnext", "pshuffel_3x3"], act="sin", norm="none",
    sft_block="res_sft", ch_t=8, reduce=1.2, lower_width=4,
    enc_strds=[2, 2], enc_dim="8_4")
BENCH = dict(  # bench.py's UVG-1080p serving config
    model="HNeRV_Boost", embed="pe_1.25_80", enc_strds=[5, 3, 2, 2, 2],
    enc_dim="64_16", dec_strds=[5, 3, 2, 2, 2], dec_blks=[1, 1, 2, 2, 2],
    ks="0_1_5", reduce=1.2, lower_width=12, modelsize=2.8,
    conv_type=["convnext", "pshuffel_3x3"], act="sin", norm="none",
    sft_block="res_sft", ch_t=32)


def _cfgs(kw, **over):
    """(port config, JAX config) of the same flags."""
    kw = {**kw, **over}
    return port_config.BoostConfig(**kw), jax_config.BoostConfig(**kw)


def _tiny():
    return port_config.BoostConfig(**TINY)


def _bench():
    return port_config.resolve_sizes(port_config.BoostConfig(**BENCH),
                                     final_size=1920 * 1080,
                                     full_data_length=120)


def _flax_params(model, seed):
    """flax params of ``model`` drawn with numpy from ``seed`` (no jax
    compile): conv/dense kernels U(+-1/sqrt(fan_in)) as torch's default,
    biases U(+-0.1), LayerNorm scales near 1 and layer-scale gammas near
    0.5 so that every encoder block moves its output."""
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


@pytest.fixture(scope="module")
def decoded():
    cfg, jcfg = _cfgs(TINY)
    fmodel = build_flax_model(jcfg)
    img = jnp.asarray(rng.uniform(size=(1, 16, 16, 3)).astype(np.float32))
    t = jnp.array([0.4])
    params = _flax_params(fmodel, seed=2)
    embed = fmodel.apply(params, img, method="encode")
    flax_out = fmodel.apply(params, embed, t, method="decode")
    v5 = jax_fd.build_fast_decode_v5(jcfg, params, planar_from_h=1, th=4,
                                     interpret=True)(embed, t)
    state = torch_state_from_flax(params, cfg)
    return (cfg, state, np.array(embed), np.array(t),
            np.asarray(flax_out), np.asarray(v5.astype(jnp.float32)))


def test_decode_matches_pallas_v5_and_flax(decoded):
    cfg, state, embed, t, flax_out, v5 = decoded
    dec = port_fd.build_serving_decode(cfg, state, planar_from_h=1)
    before = dict(planar.LAUNCHES)
    out = dec(torch.from_numpy(embed), torch.from_numpy(t))
    assert out.dtype == torch.bfloat16 and out.shape == (1, 16, 16, 3)
    out = out.float().numpy()
    assert np.abs(out - v5).max() < 0.02
    assert np.abs(out - flax_out).max() < 0.02
    assert planar.LAUNCHES == before  # the CPU path launches no kernel
    assert dec.launches_per_frame == {"fused_upconv_rsft": 1,
                                      "fused_conv_rsft": 1}


def test_stride2_final_stage_serves_the_head_in_plain_torch():
    # last stage stride 2: no stride-1 stage to fuse the head into
    cfg, jcfg = _cfgs(TINY, dec_blks=[1, 1])
    fmodel = build_flax_model(jcfg)
    params = _flax_params(fmodel, seed=4)
    embed = rng.normal(size=(1, 4, 4, 4)).astype(np.float32)
    t = np.array([0.7], np.float32)
    want = np.asarray(fmodel.apply(params, jnp.asarray(embed), jnp.asarray(t),
                                   method="decode"))
    dec = port_fd.build_serving_decode(
        cfg, torch_state_from_flax(params, cfg), planar_from_h=1)
    assert [s.head for s in dec.tail] == [False]
    out = dec(torch.from_numpy(embed), torch.from_numpy(t)).float().numpy()
    assert out.shape == want.shape == (1, 16, 16, 3)
    assert np.abs(out - want).max() < 0.02


def test_model_and_decoder_only_state_serve_alike(decoded):
    cfg, state, embed, t, _, _ = decoded
    model = build_model(cfg, seed=None, device="cpu")
    model.load_state_dict(state)
    a = port_fd.build_serving_decode(cfg, model, planar_from_h=1)
    b = port_fd.build_serving_decode(cfg, decoder_only_params(state),
                                     planar_from_h=1)
    e, tt = torch.from_numpy(embed), torch.from_numpy(t)
    assert torch.equal(a(e, tt), b(e, tt))


@pytest.mark.parametrize("cfg_fn,planar_from_h", [
    (_tiny, 1), (_tiny, 30), (_bench, 200), (_bench, 1), (_bench, 1000),
    (_bench, 5000)])
def test_tail_span_matches_jax(cfg_fn, planar_from_h):
    cfg = cfg_fn()
    plan = port_config.decoder_stage_plan(cfg, cfg.fc_dim, hnerv_style=True)
    out_hw = port_fd.stage_out_hw(cfg, plan)
    jcfg = jax_config.BoostConfig(**dataclasses.asdict(cfg))
    jplan = jax_config.decoder_stage_plan(jcfg, cfg.fc_dim, hnerv_style=True)

    def span(fn):
        try:
            return fn()
        except ValueError as e:
            return str(e)

    # serving never sets the hybrid split (fine_from_h beyond any height);
    # the hybrid's split is held at every stage height and beyond them
    for fine_from_h in sorted({h for h, _ in out_hw} | {10 ** 9}):
        kw = {} if fine_from_h == 10 ** 9 else {"fine_from_h": fine_from_h}
        assert span(lambda: port_fd._planar_tail_span(
            cfg, plan, out_hw, planar_from_h, **kw)) == span(
            lambda: jax_fd._planar_tail_span(jcfg, jplan, out_hw,
                                             planar_from_h, fine_from_h))


def test_bench_config_tail_is_the_six_kernel_stages():
    cfg = _bench()
    dec = port_fd.build_serving_decode(
        cfg, build_model(cfg, seed=None, device="cpu"))
    assert [(s.index, s.strd, s.head, s.in_shape) for s in dec.tail] == [
        (2, 2, False, (1, 135, 240, 88)), (3, 1, False, (1, 270, 480, 73)),
        (4, 2, False, (1, 270, 480, 73)), (5, 1, False, (1, 540, 960, 61)),
        (6, 2, False, (1, 540, 960, 61)), (7, 1, True, (1, 1080, 1920, 51))]
    assert dec.launches_per_frame == {"fused_upconv_rsft": 3,
                                      "fused_conv_rsft": 3}


def test_build_serving_decode_contract(decoded):
    cfg, state, embed, t, _, _ = decoded
    frame = (torch.from_numpy(embed), torch.from_numpy(t))
    with pytest.raises(ValueError, match="no frame"):
        port_fd.build_serving_decode(cfg, state, w8a8_calib=[],
                                     planar_from_h=1)
    with pytest.raises(ValueError, match="pairs"):
        port_fd.build_serving_decode(cfg, state, w8a8_calib=[frame[0]],
                                     planar_from_h=1)
    # fc_dim 12: no tail stage is int8-eligible, the decode stays bf16
    dec8 = port_fd.build_serving_decode(cfg, state, w8a8_calib=[frame],
                                        planar_from_h=1)
    assert dec8.w8a8_stages == dec8.w8a8_zc == []
    assert dec8.launches_per_frame == {"fused_upconv_rsft": 1,
                                       "fused_conv_rsft": 1}
    # no planar tail: the v3 decode serves, as in JAX (fast_decode.py:596);
    # tile_from_h 45 is above every stage of this 16x16 config, so it runs
    # in torch alone and agrees with the planar decode
    fallback = port_fd.build_serving_decode(cfg, state, planar_from_h=10 ** 6)
    assert fallback.fine is None and fallback.launches_per_frame == {}
    assert np.abs(fallback(*frame).float().numpy()
                  - dec8(*frame).float().numpy()).max() < 0.02
    with pytest.raises(ValueError, match="W8A8 serving needs a planar tail"):
        port_fd.build_serving_decode(cfg, state, w8a8_calib=[frame],
                                     planar_from_h=10 ** 6)
    with pytest.raises(ValueError, match="paper config"):
        port_fd.build_serving_decode(cfg.replace(act="gelu"), state)
    with pytest.raises(ValueError, match="paper config"):
        port_fd.build_serving_decode(cfg.replace(model="HNeRV"), state)
    dec = port_fd.build_serving_decode(cfg, state, planar_from_h=1)
    with pytest.raises(ValueError, match="batch 1"):
        dec(torch.from_numpy(np.concatenate([embed, embed])),
            torch.from_numpy(np.concatenate([t, t])))
