"""The port's data-parallel regression step (``RegressionTrainer`` over a
``parallel.MeshPlan``, DDP over gloo on CPU processes) against the JAX
package's sharded step and against its own dp=1 step:

- ``TestDataParallelEquivalence``'s config (tests/test_sharding.py:30-68:
  NeRV-Boost, 8 frames of 8x16, batch 8, L2): the JAX trainer's dp=4 step
  on the 8 virtual devices from its seeded init, bridged to the port;
  the port's dp=1 and dp=4 steps from the same weights; loss rtol 1e-5,
  parameters rtol 1e-4 and atol 1e-6 (the JAX test's), and the four
  ranks' parameters identical.  The port's dp=4 step is held to its dp=1
  step at those tolerances alone; against JAX, an element whose gradient
  is below 1e-6 of the step's largest may differ by up to a flipped
  step, 2 lr (1 + 1e-3), the rule of tests/test_torch_compress_trainer.py:
  Adan moves such an element by ~lr g / (|g| + eps), so where |g| is
  near eps (1e-8) float32 rounding in either framework moves the update
  (one element of 24,576 in the stem, gradient -2.9e-9, differs by
  3.6e-6, at dp=1 as at dp=4);
- HNeRV-Boost with ``micro_batch`` 2 and a ``clip_max_norm`` that clips,
  two steps, dp=2 against dp=1, the same tolerances;
- ``__graft_entry__.py::dryrun_multichip``'s check at dp=4, sp=1 (the
  flagship channels at 240x240, Fusion10_freq, batch 8): the raw
  gradients within 2e-3 of each leaf's largest, loss within 1.5e-3 and
  PSNR within 1e-3 relative, its gates.

The ranks run ``parallel.steps.train_steps`` (the port's rank worker) in
processes that import no jax, the two dp=4 checks in one launch
(``run_jobs``); torch runs on one thread here and in them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boosting_nerv_torch import config as port_config
from boosting_nerv_torch.bridge import torch_state_from_flax
from boosting_nerv_torch.data import VideoData, synthetic_video
from boosting_nerv_torch.parallel import launch
from boosting_nerv_torch.parallel.steps import run_jobs, train_steps
from boosting_nerv_torch.training.trainer import RegressionTrainer
from boosting_nerv_torch.utils.logger import NullLogger
from boosting_nerv_tpu.config import BoostConfig as RefConfig
from boosting_nerv_tpu.data import VideoData as RefVideoData
from boosting_nerv_tpu.models import build_model as build_flax_model
from boosting_nerv_tpu.training import trainer as ref_trainer
from boosting_nerv_tpu.utils.logger import RunLogger as RefLogger

LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-6
TINY_GRAD = 1e-6  # of the step's largest gradient: Adan's eps-scale updates
LR = 1e-3
TIMEOUT = 120.0  # seconds a rank waits in a collective
# tests/test_sharding.py::TestDataParallelEquivalence
BASE = dict(
    model="NeRV_Boost", embed="pe_1.25_20", fc_hw="2_4", fc_dim=12,
    dec_strds=[2, 2], dec_blks=[1, 1], ks="0_1_5",
    conv_type=["convnext", "pshuffel_3x3"], act="sin", norm="none",
    sft_block="res_sft", ch_t=8, reduce=1.2, lower_width=4,
    enc_strds=[2, 2], enc_dim="8_4",
    epochs=1, batchSize=8, lr=1e-3, loss="L2", eval_freq=1000,
    not_resume=True)
IDX = list(range(8))
DRYRUN_B = 8  # __graft_entry__.py: max(2 * dp, 4) frames at dp=4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _JitInit:
    """A flax model whose ``init`` runs as one compiled function."""

    def __init__(self, model):
        self._model = model
        self.init = jax.jit(model.init)

    def __getattr__(self, name):
        return getattr(self._model, name)


def port_cfg(ref_cfg, **kw):
    names = {f.name for f in dataclasses.fields(port_config.BoostConfig)}
    return port_config.BoostConfig(**{
        **{k: v for k, v in dataclasses.asdict(ref_cfg).items()
           if k in names}, **kw})


@pytest.fixture(scope="module")
def jax_dp4(tmp_path_factory):
    """(the JAX trainer's config, its init as a torch state, its loss and
    parameters as a torch state after one dp=4 step)."""
    tmp = tmp_path_factory.mktemp("ref")
    cfg = RefConfig(**BASE, dp=4, outf=str(tmp))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_trainer, "build_model",
                   lambda c: _JitInit(build_flax_model(c)))
        tr = ref_trainer.RegressionTrainer(
            cfg, video=RefVideoData(synthetic_video(8, 8, 16)),
            logger=RefLogger(cfg.outf, enable_tb=False))
    pcfg = port_cfg(tr.cfg)
    init = {k: v.numpy() for k, v in torch_state_from_flax(
        jax.device_get(tr.params), pcfg).items()}
    img, t = tr._device_batch(tr.video.get_batch(IDX))
    params, _, loss, _ = tr.train_step(tr.params, tr.opt_state, img, t,
                                       jnp.float32(LR))
    after = {k: v.numpy() for k, v in torch_state_from_flax(
        jax.device_get(params), pcfg).items()}
    return tr.cfg0, init, float(loss), after


def port_dp1(cfg, frames, state, idx, steps):
    """The port's dp=1 steps in this process: (losses, PSNRs, state,
    gradients of the last step)."""
    tr = RegressionTrainer(cfg.replace(dp=1), video=VideoData(frames),
                           logger=NullLogger(), device="cpu")
    if state is not None:
        tr.model.load_state_dict({k: torch.from_numpy(v)
                                  for k, v in state.items()})
    losses, psnrs = [], []
    for _ in range(steps):
        loss, psnr = tr.train_step_idx(idx, tr.video.norm_idx(idx), LR)
        losses.append(float(loss))
        psnrs.append(float(psnr.mean()))
    return (losses, psnrs,
            {k: v.detach().numpy() for k, v in tr.model.state_dict().items()},
            {n: p.grad.numpy() for n, p in tr.model.named_parameters()})


def port_dp(cfg, dp, jobs):
    """``train_steps`` of each (frames, state, idx, steps) of ``jobs`` at
    ``dp`` ranks in one launch: rank 0's results, the replicas checked
    equal."""
    ranks = launch(run_jobs, dict(dp=dp, devices=["cpu"] * dp), args=([
        (train_steps, (cfg.replace(dp=dp), frames, state, idx, LR, steps))
        for cfg, frames, state, idx, steps in jobs],), timeout=TIMEOUT)
    for r in ranks[1:]:  # DDP keeps the replicas equal
        for got, want in zip(r, ranks[0]):
            assert got["losses"] == want["losses"]
            for k, v in want["states"][-1].items():
                np.testing.assert_array_equal(got["states"][-1][k], v,
                                              err_msg=k)
    return ranks[0]


def dryrun_cfg(outf):
    """``dryrun_multichip``'s config: the flagship channels (the
    bunny-720p recipe resolved at the 720p budget) on 240x240 frames."""
    cfg = port_config.BoostConfig(
        model="HNeRV_Boost", embed="pe_1.25_80",
        enc_strds=[5, 2, 2, 2, 2], enc_dim="64_16",
        dec_strds=[5, 2, 2, 2, 2], dec_blks=[1, 1, 2, 2, 2],
        ks="0_1_5", reduce=1.2, lower_width=12, modelsize=1.275,
        conv_type=["convnext", "pshuffel_3x3"], act="sin",
        norm="none", sft_block="res_sft", ch_t=32,
        crop_list="240_240", loss="Fusion10_freq",
        epochs=1, batchSize=DRYRUN_B, lr=1e-3, outf=outf, not_resume=True)
    return port_config.resolve_sizes(cfg, final_size=720 * 1280,
                                     full_data_length=132)


@pytest.fixture(scope="module")
def dp4(jax_dp4, tmp_path_factory):
    """Rank 0's results of the two dp=4 checks, in one launch: (the JAX
    config's step from the bridged init, the dryrun config's step)."""
    ref_cfg, init = jax_dp4[:2]
    return port_dp(port_cfg(ref_cfg), 4, [
        (port_cfg(ref_cfg), synthetic_video(8, 8, 16), init, IDX, 1),
        (dryrun_cfg(str(tmp_path_factory.mktemp("dryrun"))),
         synthetic_video(DRYRUN_B, 240, 240), None,
         list(range(DRYRUN_B)), 1)])


@pytest.fixture(scope="module")
def jax_cfg_dp1(jax_dp4):
    """The port's dp=1 step of the JAX config from the bridged init."""
    ref_cfg, init = jax_dp4[:2]
    return port_dp1(port_cfg(ref_cfg), synthetic_video(8, 8, 16), init, IDX,
                    1)


def assert_states_close(got, want, grads=None):
    """``got`` within the JAX test's tolerances of ``want``; with
    ``grads`` (the step's), within a flipped step where the gradient is
    below TINY_GRAD of the largest."""
    assert sorted(got) == sorted(want)
    tiny = (None if grads is None else
            TINY_GRAD * max(float(np.abs(g).max()) for g in grads.values()))
    for k in want:
        err = np.abs(got[k] - want[k])
        bad = err > PARAM_ATOL + PARAM_RTOL * np.abs(want[k])
        if tiny is not None and k in grads:
            bad &= ~((np.abs(grads[k]) <= tiny)
                     & (err <= 2 * LR * (1 + 1e-3)))
        assert not bad.any(), (k, got[k][bad], want[k][bad])


@pytest.mark.parametrize("dp", [1, 4])
def test_port_step_matches_jax_dp4_step(jax_dp4, jax_cfg_dp1, dp4, dp):
    _, _, want_loss, want = jax_dp4
    (loss_1,), _, state_1, grads = jax_cfg_dp1
    if dp == 1:
        loss, state = loss_1, state_1
    else:
        (loss,), state = dp4[0]["losses"], dp4[0]["states"][-1]
        np.testing.assert_allclose(loss, loss_1, rtol=LOSS_RTOL)
        assert_states_close(state, state_1)
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
    assert_states_close(state, want, grads)


def test_micro_batch_and_clip_dp2_match_dp1(tmp_path):
    # TestTrainerSpatialSharding's HNeRV-Boost; a clip far below the
    # gradient's norm, so that every step clips
    cfg = port_config.BoostConfig(
        **{**BASE, "model": "HNeRV_Boost", "enc_blks": 1},
        micro_batch=2, clip_max_norm=1e-3, outf=str(tmp_path))
    frames = synthetic_video(8, 8, 16)
    losses, _, state, grads = port_dp1(cfg, frames, None, IDX, 2)
    norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                       for g in grads.values()))
    assert abs(norm - 1e-3) < 1e-6  # the last step's gradient was clipped
    got, = port_dp(cfg, 2, [(cfg, frames, None, IDX, 2)])
    np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_RTOL)
    assert_states_close(got["states"][-1], state)


def test_dryrun_multichip_gradients_at_dp4(dp4, tmp_path):
    cfg = dryrun_cfg(str(tmp_path))
    idx = list(range(DRYRUN_B))
    (loss_1,), (psnr_1,), _, g_1 = port_dp1(
        cfg, synthetic_video(DRYRUN_B, 240, 240), None, idx, 1)
    got = dp4[1]
    (loss_sh,), (psnr_sh,), (g_sh,) = (got["losses"], got["psnrs"],
                                        got["grads"])
    assert abs(psnr_sh - psnr_1) <= 1e-3 * max(abs(psnr_1), 1.0)
    assert abs(loss_sh - loss_1) <= 1.5e-3 * max(abs(loss_1), 1.0)
    assert sorted(g_sh) == sorted(g_1)
    worst = max(float(np.abs(g_sh[k].astype(np.float64) - g_1[k]).max())
                / max(float(np.abs(g_1[k]).max()), 1e-12) for k in g_1)
    assert worst < 2e-3, f"dp=4 / dp=1 grad drift {worst:.2e}"
