"""The port's config gives the same sizes and decoder plans as the JAX
package's for the same flags."""

import dataclasses

import pytest

from boosting_nerv_torch import config as port
from boosting_nerv_tpu import config as ref

BENCH = dict(  # bench.py's UVG-1080p serving config
    model="HNeRV_Boost", embed="pe_1.25_80", enc_strds=[5, 3, 2, 2, 2],
    enc_dim="64_16", dec_strds=[5, 3, 2, 2, 2], dec_blks=[1, 1, 2, 2, 2],
    ks="0_1_5", reduce=1.2, lower_width=12, modelsize=2.8,
    conv_type=["convnext", "pshuffel_3x3"], act="sin", sft_block="res_sft",
    ch_t=32)
CASES = [
    (BENCH, 1920 * 1080, 120),
    ({**BENCH, "enc_dim": "64_0.2", "modelsize": 1.5}, 1280 * 720, 600),
    ({**BENCH, "reduce": 1.5, "saturate_stages": 3}, 1920 * 1080, 120),
    ({**BENCH, "interpolation": True, "ks": "0_3_3"}, 640 * 1280, 300),
    ({**BENCH, "fc_dim": 40}, 1920 * 1080, 120),
    ({**BENCH, "reduce": -1, "fc_dim": 64}, 1920 * 1080, 120),  # sqrt(strd)
    (dict(model="NeRV_Boost", embed="pe_1.25_80", fc_hw="9_16",
          modelsize=3.0), 1920 * 1080, 600),
    (dict(model="ENeRV_Boost", embed="pe_1.25_80", fc_hw="8_16",
          dec_strds=[4, 2, 2, 2, 2], modelsize=1.5), 1024 * 2048, 300),
]


def test_port_fields_keep_the_reference_names_and_defaults():
    ref_defaults = {f.name: f for f in dataclasses.fields(ref.BoostConfig)}
    for f in dataclasses.fields(port.BoostConfig):
        r = ref_defaults[f.name]
        if f.default_factory is not dataclasses.MISSING:
            assert f.default_factory() == r.default_factory(), f.name
        else:
            assert f.default == r.default, f.name


@pytest.mark.parametrize("kw,final_size,n_frames", CASES)
def test_resolve_sizes_and_plans_match_jax(kw, final_size, n_frames):
    got = port.resolve_sizes(port.BoostConfig(**kw), final_size, n_frames)
    want = ref.resolve_sizes(ref.BoostConfig(**kw), final_size, n_frames)
    assert (got.fc_dim, got.enc_dim, got.enc_dim2) == (
        want.fc_dim, want.enc_dim, want.enc_dim2)
    for style in (False, True):
        for expansion in (1.0, 3.0):
            a = port.decoder_stage_plan(got, got.fc_dim, expansion, style)
            b = ref.decoder_stage_plan(want, want.fc_dim, expansion, style)
            assert [dataclasses.astuple(s) for s in a] == [
                dataclasses.astuple(s) for s in b]
    assert (got.fc_h, got.fc_w, got.ks_triple) == (
        want.fc_h, want.fc_w, want.ks_triple)


def test_bench_config_resolves_to_the_serving_model():
    cfg = port.resolve_sizes(port.BoostConfig(**BENCH), 1920 * 1080, 120)
    plan = port.decoder_stage_plan(cfg, cfg.fc_dim, hnerv_style=True)
    assert (cfg.fc_dim, cfg.enc_dim2) == (127, 16)
    assert [(s.ngf, s.new_ngf, s.strd) for s in plan] == [
        (127, 106, 5), (106, 88, 3), (88, 73, 2), (73, 73, 1), (73, 61, 2),
        (61, 61, 1), (61, 51, 2), (51, 51, 1)]
