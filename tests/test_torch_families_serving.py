"""The serving decode of NeRV-Boost (and, in
tests/test_torch_families_serving_enerv.py, of E-NeRV-Boost: the port's
v5 decode on the stage wrappers' plain versions, on the CPU) against the
JAX v5
decode (the Pallas stage kernels in interpret mode) and the flax forward;
the W8A8 stage plan against the JAX rule at the UVG-1080p configurations;
the calibration bounds against JAX's; and the K loop of the Hopper conv
kernel (``conv_sm90.emulate`` at Cin > 128) against the Pallas
``fused_upconv_rsft`` in interpret mode.

Tiny configs (fc 2 x 4, strides 2 2 2 and a stride-1 last stage, so that
the 1x1 head is fused into it), block_dim 16.  Tolerance 0.02: both
decodes run in bf16 and round at other places.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boosting_nerv_torch.bridge import torch_state_from_flax
from boosting_nerv_torch.config import BoostConfig, resolve_sizes
from boosting_nerv_torch.models import build_model
from boosting_nerv_torch.ops.kernels import conv_sm90, planar
from boosting_nerv_torch.ops.pixelshuffle import jax_to_torch_shuffle_perm
from boosting_nerv_torch.runtime import fast_decode as port_fd
from boosting_nerv_tpu import config as jax_config
from boosting_nerv_tpu.models import build_model as build_flax_model
from boosting_nerv_tpu.ops.pallas import planar as pk
from boosting_nerv_tpu.runtime import fast_decode as jax_fd

TOL = 0.02


def tiny(model: str, **kw) -> dict:
    base = dict(model=model, embed="pe_1.25_4", fc_dim=16, fc_hw="2_4",
                dec_strds=[2, 2, 2], dec_blks=[1, 1, 2], ks="0_1_5",
                conv_type=["convnext", "pshuffel_3x3"], act="sin",
                norm="none", sft_block="res_sft", ch_t=8, reduce=1.2,
                lower_width=4, block_dim=16)
    base.update(kw)
    return base


FAMILIES = {"NeRV_Boost": tiny("NeRV_Boost"),
            "ENeRV_Boost": tiny("ENeRV_Boost", fc_dim=8)}


def uvg(model: str, size: float) -> BoostConfig:
    """scripts/regression/UVG/{nerv_boost,enerv_boost}.sh at ``size``,
    sized for a 120-frame 1080p clip."""
    cfg = BoostConfig(
        model=model, sft_block="res_sft", ch_t=32, block_dim=128,
        conv_type=["convnext", "pshuffel_3x3"], act="sin", norm="none",
        crop_list="1080_1920", embed="pe_1.25_80", fc_hw="9_16",
        dec_strds=[5, 3, 2, 2, 2], ks="0_3_3", reduce=2,
        dec_blks=[1, 1, 2, 2, 2], modelsize=size, lower_width=12)
    return resolve_sizes(cfg, final_size=1920 * 1080, full_data_length=120)


def serve_family(name):
    """(port config, JAX config, flax params, bridged state, t, flax
    frame, JAX v5 frame, calibration frames) of the tiny ``name``."""
    kw = FAMILIES[name]
    jcfg, cfg = jax_config.BoostConfig(**kw), BoostConfig(**kw)
    fmodel = build_flax_model(jcfg)
    t = jnp.array([0.4])
    params = jax.jit(fmodel.init)(jax.random.PRNGKey(2), t)
    flax_out = np.asarray(jax.jit(fmodel.apply)(params, t))
    v5 = jax_fd.build_fast_decode_v5(jcfg, params, planar_from_h=1, th=4,
                                     interpret=True)(None, t)
    state = torch_state_from_flax(params, cfg)
    frames = [(None, torch.tensor([v])) for v in (0.1, 0.4, 0.9)]
    return (cfg, jcfg, params, state, np.asarray(t), flax_out,
            np.asarray(v5.astype(jnp.float32)), frames)


@pytest.fixture(scope="module")
def served():
    """NeRV-Boost's; E-NeRV-Boost's runs the same tests in
    tests/test_torch_families_serving_enerv.py (a file of its own, so that
    each file's JAX interpret decode stays within one worker's share)."""
    return serve_family("NeRV_Boost")


def test_decode_matches_pallas_v5_and_flax(served):
    cfg, _, _, state, t, flax_out, v5, _ = served
    dec = port_fd.build_serving_decode(cfg, state, planar_from_h=1)
    # stage 0: a 1x1 conv (NeRV-Boost) or the ConvUpBlock (E-NeRV-Boost)
    assert [st.index for st in dec.tail] == [1, 2, 3]
    assert dec.tail[-1].head
    before = dict(planar.LAUNCHES)
    out = dec(None, torch.from_numpy(t))
    assert planar.LAUNCHES == before  # the CPU path launches no kernel
    assert out.dtype == torch.bfloat16 and out.shape == flax_out.shape
    out = out.float().numpy()
    assert np.abs(out - v5).max() < TOL
    assert np.abs(out - flax_out).max() < TOL
    # the model itself serves alike, its embed ignored
    model = build_model(cfg, seed=None, device="cpu")
    model.load_state_dict(state)
    same = port_fd.build_serving_decode(cfg, model, planar_from_h=1)
    assert torch.equal(same(torch.zeros(1, 2, 2, 2), torch.from_numpy(t)),
                       dec(None, torch.from_numpy(t)))
    # the hybrid: stages 2-3 and the 1x1 head on the fine-grid wrappers
    # (the JAX hybrid passes k=3 for the head and fails on these
    # families, runtime/fast_decode.py:1050-1052: held to flax alone)
    hybrid = port_fd.build_fast_decode_v5(cfg, state, planar_from_h=1,
                                          fine_from_h=16)
    assert [st.index for st in hybrid.tail] == [1]
    assert [st.index for st in hybrid.fine.stages] == [2, 3]
    assert hybrid.fine.head_w.shape[1:3] == (1, 1)
    out = hybrid(None, torch.from_numpy(t)).float().numpy()
    assert np.abs(out - flax_out).max() < TOL


def test_calibration_matches_jax(served):
    cfg, jcfg, params, state, _, _, _, frames = served
    got = port_fd.calibrate_planar_bounds(cfg, state, frames,
                                          planar_from_h=1)
    want = jax_fd.calibrate_planar_bounds(
        jcfg, params, [(None, jnp.asarray(t.numpy())) for _, t in frames],
        planar_from_h=1)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v, rtol=1e-2, atol=1e-3,
                                   err_msg=k)


def test_w8a8_decode_serves_the_jax_stages(served):
    """W8A8 on the CPU: the stages of the JAX rule go int8, and the frame
    stays within the W8A8 decode's bound of the bf16 one."""
    cfg, jcfg, params, state, t, _, _, frames = served
    dec = port_fd.build_serving_decode(cfg, state, w8a8_calib=frames,
                                       planar_from_h=1)
    stages, _ = _jax_rule(jcfg, planar_from_h=1)
    assert dec.w8a8_stages == stages
    bf16 = port_fd.build_serving_decode(cfg, state, planar_from_h=1)
    tt = torch.from_numpy(t)
    assert np.abs(dec(None, tt).float().numpy()
                  - bf16(None, tt).float().numpy()).max() < 0.05


def _jax_rule(jcfg, planar_from_h=200):
    """The JAX decode's int8 stages and the port's code-receiving ones:
    the tail of ``_planar_tail_span``; int8 where round16(new_ngf) % 32 ==
    0 and, stride 2, round16(ngf) % 32 == 0 (``_i8_bounds``,
    fast_decode.py:833-842); codes into every int8 stage but the first."""
    from boosting_nerv_tpu.config import decoder_stage_plan, model_expansion

    plan = decoder_stage_plan(jcfg, jcfg.fc_dim,
                              expansion=model_expansion(jcfg.model))
    out_hw, h, w = [], jcfg.fc_h, jcfg.fc_w
    for spec in plan:
        h, w = h * spec.strd, w * spec.strd
        out_hw.append((h, w))
    s0, s1 = jax_fd._planar_tail_span(jcfg, plan, out_hw, planar_from_h,
                                      10 ** 9)

    def r16(c):
        return (c + 15) // 16 * 16

    stages = [bi for bi in range(s0, s1) if r16(plan[bi].new_ngf) % 32 == 0
              and (plan[bi].strd == 1 or r16(plan[bi].ngf) % 32 == 0)]
    return stages, [bi for bi in stages if bi != s0]


@pytest.mark.parametrize("model,size,want", [
    ("NeRV_Boost", 5.2, [3]), ("ENeRV_Boost", 4.3, [3, 7]),
    ("ENeRV_Boost", 2.6, [2, 3, 4, 5]), ("ENeRV_Boost", 5.8, [5, 6, 7])])
def test_w8a8_stage_plan_at_uvg_1080p(model, size, want):
    """The port's W8A8 stage plan is the JAX rule's at the UVG-1080p
    configurations (fc_dim 131 for NeRV-Boost 10M and 115 for E-NeRV-Boost
    10M, whatever the clip length)."""
    cfg = uvg(model, size)
    jcfg = jax_config.resolve_sizes(
        jax_config.BoostConfig(**{f: getattr(cfg, f) for f in (
            "model", "sft_block", "ch_t", "block_dim", "conv_type", "act",
            "norm", "crop_list", "embed", "fc_hw", "dec_strds", "ks",
            "reduce", "dec_blks", "modelsize", "lower_width")}),
        final_size=1920 * 1080, full_data_length=120)
    assert cfg.fc_dim == jcfg.fc_dim
    assert port_fd.w8a8_stage_plan(cfg) == _jax_rule(jcfg) == (
        want, want[1:] if model == "ENeRV_Boost" and size == 2.6 else want)
    if size in (5.2, 4.3):
        assert cfg.fc_dim == {5.2: 131, 4.3: 115}[size]
        assert resolve_sizes(cfg.replace(fc_dim=None), 1920 * 1080,
                             600).fc_dim == cfg.fc_dim


def test_other_families_are_not_served():
    for model in ("HNeRV", "ENeRV"):
        cfg = BoostConfig(**tiny(model, sft_block="none"))
        with pytest.raises(ValueError, match="paper config"):
            port_fd.build_serving_decode(cfg, {})
    with pytest.raises(ValueError, match="paper config"):
        port_fd.build_fast_decode_v3(BoostConfig(**FAMILIES["NeRV_Boost"]),
                                     {})


def _rand(r, *shape, s=1.0):
    x = r.normal(size=shape).astype(np.float32) * s
    return np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("c_in", [144, 176])
def test_k_loop_emulation_matches_pallas(c_in):
    """The K-chunked kernel's emulation (Cin beyond 128: chunks of 64
    channels, Cin padded to whole chunks; weights packed
    [slice][chunk][tap]...) of a
    stride-2 upconv + ResBlockSFT stage against the Pallas stage kernel."""
    r = np.random.default_rng(c_in)
    c, h, w = 5, 4, 8
    ck = _rand(r, 3, 3, c_in, 4 * c, s=0.05)
    cb, w0 = _rand(r, 4 * c, s=0.1), _rand(r, 3, 3, c, c, s=0.2)
    b0, w1, b1 = _rand(r, c, s=0.1), _rand(r, 3, 3, c, c, s=0.2), _rand(
        r, c, s=0.1)
    sft = [r.normal(size=c).astype(np.float32) * 0.3 for _ in range(4)]
    x = _rand(r, 1, h, w, c_in)
    perm = jax_to_torch_shuffle_perm(c, 2)

    def ohwi(k, p=None):
        k = k.transpose(3, 0, 1, 2)
        return torch.from_numpy(np.ascontiguousarray(
            k if p is None else k[p])).to(torch.bfloat16)

    weights = planar.StageWeights(
        ohwi(ck, perm), torch.from_numpy(cb[perm]).to(torch.bfloat16),
        ohwi(w0), torch.from_numpy(b0).to(torch.bfloat16), ohwi(w1),
        torch.from_numpy(b1).to(torch.bfloat16))
    assert conv_sm90.wide(c_in)
    assert conv_sm90.chunks(c_in) == [(0, 64), (64, 64), (128, 64)]
    got = conv_sm90.upconv_rsft(conv_sm90.emulated_conv,
                                torch.from_numpy(x).to(torch.bfloat16),
                                weights, torch.from_numpy(np.stack(sft)))
    prep = pk.prepare_upconv_rsft(*(jnp.asarray(a) for a in
                                    (ck, cb, w0, b0, w1, b1)),
                                  c_in=c_in, c=c)
    chw = jnp.pad(jnp.asarray(x[0].transpose(2, 0, 1)).astype(jnp.bfloat16),
                  ((0, 0), (0, 0), (0, 128 - w)))
    res = pk.fused_upconv_rsft(
        chw, prep, pk.sft_planar_vectors(*map(jnp.asarray, sft), 16),
        c_in=c_in, c=c, wc_real=w, th=4, interpret=True)
    want = np.asarray(pk.from_planar(res, c)[:, :, :2 * w].astype(
        jnp.float32)).transpose(1, 2, 0)[None]
    got = got.float().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() < TOL * max(np.abs(want).max(), 1.0)
