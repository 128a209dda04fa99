"""The port's regression step split by rows (the mesh's 'spatial' axis)
against the JAX package's unsharded step, on gloo CPU ranks.

``TestTrainerSpatialSharding``'s config (tests/test_sharding.py:203-266:
HNeRV-Boost, batch 4, L2, Adan, lr 1e-3) on four 24x32 frames, so that at
sp 4 the frame (6 rows a shard), the encoder's first stage (12 rows, 3 a
shard: its ConvNeXt block's 7x7 halo fills a shard) and the decoder's
last two stages (12 and 24 rows) are split, and the encoder's second
patchify gathers.  The JAX trainer's 1 x 1 step from its seeded init,
bridged to the port; the port at dp x sp = 2 x 2 and 1 x 4 (and 2 x 2
with ``micro_batch`` 1 and ``remat``), two steps each, in one launch of
four ranks.  The JAX test's own gates: step-1 loss rtol 1e-5, the raw
gradients of step 1 within 5e-5 of each leaf's largest, step-2 loss rtol
1e-3.  JAX's sp=4 doubles some conv gradients on ragged shards
(__graft_entry__.py:122-124); the port's sp=4 is held to JAX's 1 x 1 (not
to its sp=4), so a doubled gradient would fail the gate.  The JAX step
and gradient compile with LLVM's optimisation off (the same HLO).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from boosting_nerv_torch.bridge import torch_state_from_flax
from boosting_nerv_torch.data import synthetic_video
from boosting_nerv_torch.parallel import launch
from boosting_nerv_torch.parallel.steps import run_jobs, train_steps
from boosting_nerv_tpu.config import BoostConfig as RefConfig
from boosting_nerv_tpu.data import VideoData as RefVideoData
from boosting_nerv_tpu.models import build_model as build_flax_model
from boosting_nerv_tpu.ops.losses import loss_fn as ref_loss_fn
from boosting_nerv_tpu.training import trainer as ref_trainer
from boosting_nerv_tpu.utils.logger import RunLogger as RefLogger
from test_torch_compress_trainer import FAST_COMPILE
from test_torch_parallel_dp import _JitInit, port_cfg

LOSS1_RTOL, LOSS2_RTOL = 1e-5, 1e-3
GRAD_TOL = 5e-5  # of each leaf's largest
LR = 1e-3
TIMEOUT = 120.0  # seconds a rank waits in a collective
IDX = [0, 1, 2, 3]
# tests/test_sharding.py::TestTrainerSpatialSharding
BASE = dict(
    model="HNeRV_Boost", embed="pe_1.25_20", fc_hw="2_4", fc_dim=12,
    dec_strds=[2, 2], dec_blks=[1, 1], ks="0_1_5",
    conv_type=["convnext", "pshuffel_3x3"], act="sin", norm="none",
    sft_block="res_sft", ch_t=8, reduce=1.2, lower_width=4,
    enc_strds=[2, 2], enc_dim="8_4", enc_blks=1,
    epochs=1, batchSize=4, lr=1e-3, loss="L2", eval_freq=1000,
    not_resume=True)
RUNS = {"2x2": ((2, 2), {}), "1x4": ((1, 4), {}),
        "2x2 micro_batch remat": ((2, 2), {"micro_batch": 1,
                                          "remat": True})}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def frames():
    return synthetic_video(4, 24, 32)


@pytest.fixture(scope="module")
def jax_1x1(tmp_path_factory):
    """(the port's config, the bridged init, JAX's step-1 raw gradients as
    a torch state, its two losses)."""
    cfg = RefConfig(**BASE, outf=str(tmp_path_factory.mktemp("ref")))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_trainer, "build_model",
                   lambda c: _JitInit(build_flax_model(c)))
        tr = ref_trainer.RegressionTrainer(
            cfg, video=RefVideoData(frames()),
            logger=RefLogger(cfg.outf, enable_tb=False))
    pcfg = port_cfg(tr.cfg0)
    init = {k: v.numpy() for k, v in torch_state_from_flax(
        jax.device_get(tr.params), pcfg).items()}
    img, t = tr._device_batch(tr.video.get_batch(IDX))

    def loss(p):
        return ref_loss_fn(tr._forward(p, img, t), img, cfg.loss)

    # the JAX step (trainer.py:240-285: value_and_grad, the optimizer's
    # update), in parts, so that its raw gradients are read
    loss1, grads = jax.jit(jax.value_and_grad(loss)).lower(
        tr.params).compile(FAST_COMPILE)(tr.params)
    params = jax.jit(lambda g, s, p: optax.apply_updates(p, tr.opt.update(
        g, s, p, lr=jnp.float32(LR))[0]))(grads, tr.opt_state, tr.params)
    loss2 = jax.jit(loss).lower(params).compile(FAST_COMPILE)(params)
    grads = {k: v.numpy().astype(np.float64) for k, v in
             torch_state_from_flax(jax.device_get(grads), pcfg).items()}
    return pcfg, init, grads, (float(loss1), float(loss2))


@pytest.fixture(scope="module")
def port_runs(jax_1x1):
    """{run: rank 0's two steps}, the replicas checked equal."""
    pcfg, init = jax_1x1[:2]
    jobs = [(train_steps, (pcfg.replace(dp=dp, sp=sp, **kw), frames(), init,
                           IDX, LR, 2), (dp, sp))
            for (dp, sp), kw in RUNS.values()]
    ranks = launch(run_jobs, dict(dp=1, sp=4, devices=["cpu"] * 4),
                   args=(jobs,), timeout=TIMEOUT)
    for r in ranks[1:]:  # every rank holds the same replica
        for got, want in zip(r, ranks[0]):
            assert got["losses"] == want["losses"]
            for k, v in want["states"][-1].items():
                np.testing.assert_array_equal(got["states"][-1][k], v,
                                              err_msg=k)
    return dict(zip(RUNS, ranks[0]))


@pytest.mark.parametrize("run", list(RUNS))
def test_split_step_matches_jax_1x1(jax_1x1, port_runs, run):
    _, _, want_grads, (loss1, loss2) = jax_1x1
    got = port_runs[run]
    np.testing.assert_allclose(got["losses"][0], loss1, rtol=LOSS1_RTOL)
    np.testing.assert_allclose(got["losses"][1], loss2, rtol=LOSS2_RTOL)
    g = got["grads"][0]
    assert sorted(g) == sorted(want_grads)
    for k, want in want_grads.items():
        scale = max(float(np.abs(want).max()), 1e-12)
        np.testing.assert_allclose(g[k] / scale, want / scale,
                                   atol=GRAD_TOL, err_msg=k)


def test_sp4_splits_encoder_and_decoder_stages(port_runs):
    plan = port_runs["1x4"]["split_plan"]
    assert plan == [
        "frame 24: split (rows taken)", "encoder 12: split",
        "encoder 12 -> 6: gathers", "encoder 6: whole", "embedding 6: whole",
        "upconv 12: split (rows taken)", "upconv 24: split",
        "frame 24: gathered"], plan
    assert port_runs["2x2"]["split_plan"][:2] == [
        "frame 24: split (rows taken)", "encoder 12: split"]
