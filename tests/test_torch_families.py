"""The other model families of the port (NeRV-Boost, E-NeRV, E-NeRV-Boost,
the HNeRV baseline) against the JAX package's flax modules, on the CPU.

Each family's flax init goes through ``bridge.torch_state_from_flax`` into
the port's model; its forward must match flax within 1e-5 (float32), and
the bridge must give the same parameters back both ways.  Tiny configs:
fc 2 x 4, strides 2 2 2, widths <= 16.  The blocks alone:
tests/test_torch_families_blocks.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boosting_nerv_torch import bridge
from boosting_nerv_torch.config import BoostConfig
from boosting_nerv_torch.models import build_model
from boosting_nerv_tpu.config import BoostConfig as JBoostConfig
from boosting_nerv_tpu.models import build_model as jbuild_model

TOL = 1e-5


def tiny(model: str, **kw) -> dict:
    base = dict(model=model, embed="pe_1.25_4", fc_dim=16, fc_hw="2_4",
                dec_strds=[2, 2, 2], dec_blks=[1, 1, 1], ks="0_1_5",
                conv_type=["convnext", "pshuffel_3x3"], act="sin",
                norm="none", sft_block="res_sft", ch_t=8, reduce=1.2,
                lower_width=4, block_dim=16, enc_strds=[], enc_dim="8_4")
    base.update(kw)
    return base


# name: (config, input: "t" or "img")
CASES = {
    "NeRV_Boost": (tiny("NeRV_Boost"), "t"),
    "ENeRV_Boost": (tiny("ENeRV_Boost", fc_dim=12), "t"),
    "ENeRV": (tiny("ENeRV", sft_block="none", act="gelu",
                   dec_blks=[2, 1, 1]), "t"),
    "HNeRV_pe": (tiny("HNeRV", sft_block="none", act="gelu",
                      conv_type=["convnext", "pshuffel"], ks="0_3_5"), "t"),
    "HNeRV_encoder": (tiny("HNeRV", sft_block="none", norm="in",
                           enc_strds=[2, 2, 2, 2], enc_dim="8_6",
                           conv_type=["convnext", "conv"]), "img"),
}


def _inputs(kind: str):
    rng = np.random.default_rng(0)
    if kind == "t":
        return np.array([0.3, 0.8], np.float32)
    return rng.uniform(size=(2, 16, 32, 3)).astype(np.float32)


@pytest.fixture(scope="module", params=sorted(CASES))
def family(request):
    kw, kind = CASES[request.param]
    jmodel = jbuild_model(JBoostConfig(**kw))
    x = _inputs(kind)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(1), jnp.asarray(x))
    want = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(x)))
    cfg = BoostConfig(**kw)
    return cfg, params, x, want


def test_family_forward_matches_flax(family):
    cfg, params, x, want = family
    model = build_model(cfg, seed=None, device="cpu")
    model.load_state_dict(bridge.torch_state_from_flax(params, cfg))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL


def test_bridge_round_trips(family):
    """flax -> torch -> flax gives the flax leaves back; torch -> flax ->
    torch the state dict; every torch parameter is covered."""
    cfg, params, _, _ = family
    state = bridge.torch_state_from_flax(params, cfg)
    model = build_model(cfg, seed=0, device="cpu")
    assert sorted(state) == sorted(model.state_dict())
    back = bridge.flax_params_from_torch_state(state, cfg)
    flat = dict(bridge._flatten(params["params"]))
    flat_back = dict(bridge._flatten(back["params"]))
    assert sorted(flat) == sorted(flat_back)
    for k, v in flat.items():
        assert np.array_equal(np.asarray(v), flat_back[k]), k
    own = model.state_dict()
    again = bridge.torch_state_from_flax(
        bridge.flax_params_from_torch_state(own, cfg), cfg)
    assert all(torch.equal(own[k], again[k]) for k in own)


def test_family_config_fields_match_jax():
    """``model_expansion``, ``uses_frame_input`` and ``resolve_sizes``
    (the index-only models' fc_dim, embed_param 0) as the JAX config's."""
    from boosting_nerv_torch.config import (model_expansion, model_stage_plan,
                                            resolve_sizes)
    from boosting_nerv_tpu.config import decoder_stage_plan as j_plan
    from boosting_nerv_tpu.config import model_expansion as j_expansion
    from boosting_nerv_tpu.config import resolve_sizes as j_resolve

    for name in ("NeRV_Boost", "ENeRV", "ENeRV_Boost", "HNeRV_Boost",
                 "HNeRV"):
        for embed in ("pe_1.25_4", "none"):
            kw = tiny(name, embed=embed, fc_dim=None, modelsize=0.05,
                      enc_strds=[2, 2, 2])
            cfg, jcfg = BoostConfig(**kw), JBoostConfig(**kw)
            assert model_expansion(name) == j_expansion(name)
            assert cfg.uses_frame_input == jcfg.uses_frame_input
            if embed == "none" and name != "HNeRV":
                continue
            got, want = (resolve_sizes(cfg, 16 * 32, 7),
                         j_resolve(jcfg, 16 * 32, 7))
            assert (got.fc_dim, got.embed_param, got.enc_dim) == (
                want.fc_dim, want.embed_param, want.enc_dim)
            # each JAX model's own plan (ENeRV widens stage 0 by 3)
            jplan = (j_plan(want, want.fc_dim, hnerv_style=True)
                     if "HNeRV" in name else j_plan(
                         want, want.fc_dim, expansion=(
                             3 if name == "ENeRV" else j_expansion(name))))
            assert [(s.ngf, s.new_ngf, s.ks, s.strd)
                    for s in model_stage_plan(got)] == [
                (s.ngf, s.new_ngf, s.ks, s.strd) for s in jplan]


def test_registry_builds_every_family_and_refuses_unknown_names():
    for name in ("NeRV_Boost", "ENeRV", "ENeRV_Boost", "HNeRV_Boost",
                 "HNeRV"):
        kw = tiny(name, enc_strds=[2, 2, 2], enc_dim="8_4")
        model = build_model(BoostConfig(**kw), device="cpu")
        assert next(model.parameters()).device.type == "cpu"
    with pytest.raises(KeyError, match="Unknown model"):
        build_model(BoostConfig(model="SIREN"), device="cpu")
    with pytest.raises(KeyError, match="Unknown model"):
        bridge.torch_state_from_flax({}, BoostConfig(model="SIREN"))
