"""The port's decode split by rows (the mesh's 'spatial' axis) on gloo CPU
ranks, and its 'bn' repair at dp 2:

- ``TestSpatialSharding``'s config (tests/test_sharding.py:118-147:
  HNeRV-Boost, two 16x16 frames, its flax init bridged, the embedding
  from JAX's encoder): the port's split decode at sp 2 and 4 against
  JAX's unsharded decode, rtol 1e-4 / atol 1e-5, the JAX test's own;
- NeRV-Boost, E-NeRV-Boost, E-NeRV (its per-stage InstanceNorm), the
  HNeRV baseline with a ConvNeXt encoder and 'in' (tests/
  test_torch_families.py's tiny configs, 16x32 frames; the baseline's with
  PixelShuffle upsampling) and with transposed-conv upsampling (its maps,
  1-9 rows, all whole): the split decode at sp 2 and 4 against the port's
  whole decode, the same tolerances;
- ``norm="bn"`` at dp 2: the config of tests/test_torch_parallel_dp.py
  with 'bn', as the encoder-less HNeRV baseline (the port's trainer
  refuses a Boost family outside its paper config, norm 'none'), the
  port's step on two gloo ranks from the JAX trainer's bridged init
  against the JAX trainer's dp=2 step on the virtual devices, loss rtol
  1e-5: JAX's batch statistics are the global batch's, so the ranks sum
  their moments over the data group.

sp 4 runs on a 1 x 4 mesh and sp 2 on 2 x 2 (each data group decoding the
same frames), both in one launch of four ranks; the dp=2 step in a
launch of two.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boosting_nerv_torch import config as port_config
from boosting_nerv_torch.bridge import torch_state_from_flax
from boosting_nerv_torch.data import synthetic_video
from boosting_nerv_torch.models import build_model
from boosting_nerv_torch.parallel import launch
from boosting_nerv_torch.parallel.steps import (run_jobs, split_decode,
                                                train_steps)
from boosting_nerv_tpu.config import BoostConfig as RefConfig
from boosting_nerv_tpu.data import VideoData as RefVideoData
from boosting_nerv_tpu.models import build_model as build_flax_model
from boosting_nerv_tpu.training import trainer as ref_trainer
from boosting_nerv_tpu.utils.logger import RunLogger as RefLogger
from test_torch_families import CASES as FAMILY_CASES
from test_torch_families import tiny
from test_torch_parallel_dp import BASE as DP_BASE
from test_torch_parallel_dp import _JitInit, port_cfg

RTOL, ATOL = 1e-4, 1e-5
LOSS_RTOL = 1e-5
LR = 1e-3
TIMEOUT = 120.0  # seconds a rank waits in a collective
MESHES = {4: (1, 4), 2: (2, 2)}  # sp: the mesh it runs on
T = [0.3, 0.7]
FAMILIES = ["NeRV_Boost", "ENeRV_Boost", "ENeRV", "HNeRV_in",
            "HNeRV_encoder"]
CASES = {**FAMILY_CASES, "HNeRV_in": (
    tiny("HNeRV", sft_block="none", norm="in", enc_strds=[2, 2, 2, 2],
         enc_dim="8_6", conv_type=["convnext", "pshuffel_3x3"]), "img")}
# tests/test_sharding.py::TestSpatialSharding
SHARDING_CFG = dict(
    model="HNeRV_Boost", embed="pe_1.25_20", fc_dim=12,
    dec_strds=[2, 2], dec_blks=[1, 1], ks="0_1_5",
    conv_type=["convnext", "pshuffel_3x3"], act="sin", norm="none",
    sft_block="res_sft", ch_t=8, reduce=1.2, lower_width=4,
    enc_strds=[2, 2], enc_dim="8_4")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_case():
    """(the port's config, the bridged init, the embedding, JAX's decode)."""
    cfg = RefConfig(**SHARDING_CFG)
    model = build_flax_model(cfg)
    img = jnp.asarray(np.random.default_rng(0).uniform(
        size=(2, 16, 16, 3)).astype(np.float32))
    t = jnp.array(T)
    params = jax.jit(model.init)(jax.random.key(0), img, t)
    embed = jax.jit(lambda p, x: model.apply(p, x, method="encode"))(
        params, img)
    ref = jax.jit(lambda p, e, tt: model.apply(p, e, tt, method="decode"))(
        params, embed, t)
    pcfg = port_cfg(cfg)
    state = {k: v.numpy() for k, v in torch_state_from_flax(
        jax.device_get(params), pcfg).items()}
    return pcfg, state, np.asarray(embed), np.asarray(ref)


def family_case(name):
    """(the port's config, the embedding for the HNeRV baseline or None,
    the port's whole decode from its seeded init)."""
    kw, kind = CASES[name]
    cfg = port_config.BoostConfig(**kw)
    model = build_model(cfg, seed=cfg.manualSeed, device="cpu")
    t = torch.tensor(T)
    with torch.no_grad():
        if kind == "img":
            img = torch.from_numpy(np.random.default_rng(0).uniform(
                size=(2, 16, 32, 3)).astype(np.float32))
            embed = model.encode(img)
            return cfg, embed.numpy(), model.decode(embed).numpy()
        return cfg, None, model(t).numpy()


@pytest.fixture(scope="module")
def decodes():
    """{case: (want, {sp: every rank's split_decode})}, one launch."""
    cases = {"jax": jax_case()}
    cases.update({n: family_case(n) for n in FAMILIES})
    jobs, keys = [], []
    for sp, mesh in MESHES.items():
        for name, case in cases.items():
            if name == "jax":
                cfg, state, embed, _ = case
            else:
                (cfg, embed, _), state = case, None
            jobs.append((split_decode, (cfg, state, T, embed), mesh))
            keys.append((name, sp))
    ranks = launch(run_jobs, dict(dp=1, sp=4, devices=["cpu"] * 4),
                   args=(jobs,), timeout=TIMEOUT)
    out = {name: (case[-1], {}) for name, case in cases.items()}
    for j, (name, sp) in enumerate(keys):
        out[name][1][sp] = [r[j] for r in ranks]
    return out


def assert_split(want, ranks, sp, splits=True):
    for r in ranks:
        np.testing.assert_allclose(r["frame"], want, rtol=RTOL, atol=ATOL,
                                   err_msg=f"rank {r['device']} sp {sp}")
    # the last decoder stage's output is split at both sp
    assert any(": split" in line for line in ranks[0]["split_plan"]) \
        == splits, ranks[0]["split_plan"]


def test_split_decode_matches_jax(decodes):
    want, got = decodes["jax"]
    for sp in MESHES:
        assert_split(want, got[sp], sp)
        assert got[sp][0]["split_plan"][-1] == "frame 16: gathered"


@pytest.mark.parametrize("name", FAMILIES)
def test_family_split_decode_matches_whole(decodes, name):
    want, got = decodes[name]
    for sp in MESHES:
        assert_split(want, got[sp], sp, splits=name != "HNeRV_encoder")


def test_bn_dp2_step_matches_jax_dp2(tmp_path):
    cfg = RefConfig(**{**DP_BASE, "model": "HNeRV", "norm": "bn",
                       "enc_strds": [], "sft_block": "none"},
                    dp=2, outf=str(tmp_path))
    frames = synthetic_video(8, 8, 16)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_trainer, "build_model",
                   lambda c: _JitInit(build_flax_model(c)))
        tr = ref_trainer.RegressionTrainer(
            cfg, video=RefVideoData(frames),
            logger=RefLogger(cfg.outf, enable_tb=False))
    pcfg = port_cfg(tr.cfg0)
    init = {k: v.numpy() for k, v in torch_state_from_flax(
        jax.device_get(tr.params), pcfg).items()}
    idx = list(range(8))
    img, t = tr._device_batch(tr.video.get_batch(idx))
    _, _, want, _ = tr.train_step(tr.params, tr.opt_state, img, t,
                                  jnp.float32(LR))
    got = launch(train_steps, dict(dp=2, devices=["cpu"] * 2),
                 args=(pcfg, frames, init, idx, LR), timeout=TIMEOUT)
    assert got[0]["losses"] == got[1]["losses"]
    np.testing.assert_allclose(got[0]["losses"][0], float(want),
                               rtol=LOSS_RTOL)
