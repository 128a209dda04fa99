"""The port's data-parallel CEM step (``CompressionTrainer`` over a
``parallel.MeshPlan``, gloo on CPU processes):

- ``TestCEMDataParallel``'s config (tests/test_sharding.py:150-200:
  NeRV-Boost, 8 frames of 8x16, batch 8, scale / scale / scalebeta at 8
  bits, lambda 0.05, target_bit 4, Adan): one dp=4 step of the port fed
  the JAX step's noise, from the JAX trainer's (bridged) init, against the
  JAX trainer's dp=4 step on the 8 virtual devices: loss and bpp within
  rtol 1e-5; and against the port's dp=1 step, parameters and quantiser
  parameters within rtol 1e-4 and atol 1e-6 as well, except where the
  dp=1 gradient is below 1e-6 of the step's largest, where they may
  differ by a flipped step, 2 lr (1 + 1e-3) (the rule of
  tests/test_torch_compress_trainer.py: the scalebeta embedding
  quantiser's beta gets ~0, 1.3e-7 at dp=1 and -1.1e-6 at dp=4 beside
  the scale's -24.7, and Adan's first step moves it by ~lr times that
  sign);
- HNeRV-Boost with ``embed_entropy``, its target chosen so that the four
  ranks' own estimates of the bits a pixel lie on both sides of it while
  the global batch's lies above: dp=4 equals dp=1 (loss, bpp rtol 1e-5;
  parameters rtol 1e-4, atol 1e-6) only when the embedding's bits are
  the global batch's before the rate term's ``where``.

The ranks run ``parallel.steps.cem_steps`` in processes that import no
jax, both cases in one launch (``run_jobs``); torch runs on one thread
here and in them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boosting_nerv_torch import config as port_config
from boosting_nerv_torch.bridge import torch_state_from_flax
from boosting_nerv_torch.data import VideoData, synthetic_video
from boosting_nerv_torch.ops.entropy import rate_bits
from boosting_nerv_torch.parallel import launch
from boosting_nerv_torch.parallel.steps import cem_steps, run_jobs
from boosting_nerv_torch.training import compress_trainer as port_ct
from boosting_nerv_torch.utils.logger import NullLogger
from boosting_nerv_tpu.config import BoostConfig as RefConfig
from boosting_nerv_tpu.data import VideoData as RefVideoData
from boosting_nerv_tpu.models import build_model as build_flax_model
from boosting_nerv_tpu.training import compress_trainer as ref_ct
from boosting_nerv_tpu.training import trainer as ref_trainer
from boosting_nerv_tpu.utils.logger import RunLogger as RefLogger
from test_torch_compress_trainer import FAST_COMPILE, _Jitted, jax_noise
from test_torch_parallel_dp import port_cfg

RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-6
TINY_GRAD = 1e-6  # of the step's largest gradient: a flippable sign
LR = 5e-4
TIMEOUT = 120.0  # seconds a rank waits in a collective
IDX = list(range(8))
# tests/test_sharding.py::TestCEMDataParallel
BASE = dict(
    model="NeRV_Boost", embed="pe_1.25_20", fc_hw="2_4", fc_dim=12,
    dec_strds=[2, 2], dec_blks=[1, 1], ks="0_1_5",
    conv_type=["convnext", "pshuffel_3x3"], act="sin", norm="none",
    sft_block="res_sft", ch_t=8, reduce=1.2, lower_width=4,
    enc_strds=[2, 2], enc_dim="8_4", enc_blks=1,
    epochs=1, batchSize=8, lr=5e-4, loss="L2", eval_freq=1000,
    optim_type="Adan", lr_type="cosine_0_1_0.1", not_resume=True,
    quant=True, quant_model_bit=8, quant_bias_bit=8,
    quantizer_w="scale", quantizer_b="scale",
    quantizer_e="scalebeta", lambda_rate=0.05, target_bit=4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def frames():
    return synthetic_video(8, 8, 16)


def port_dp1(cfg, state, noise):
    """The port's dp=1 CEM step in this process: (loss, bpp, trainer)."""
    tr = port_ct.CompressionTrainer(cfg.replace(dp=1),
                                    video=VideoData(frames()),
                                    logger=NullLogger(), device="cpu")
    if state is not None:
        tr.model.load_state_dict({k: torch.from_numpy(v)
                                  for k, v in state.items()})
    tr.init_qparams()
    loss, _, bpp = tr.cem_step_idx(IDX, tr.video.norm_idx(IDX), LR, {
        k: torch.from_numpy(v) for k, v in noise.items()})
    return float(loss), float(bpp), tr


def port_dp4(cases):
    """``cem_steps`` of each (cfg, state, noise) of ``cases`` at dp=4 in one
    launch: rank 0's results, the replicas checked equal."""
    ranks = launch(run_jobs, dict(dp=4, devices=["cpu"] * 4), args=([
        (cem_steps, (cfg.replace(dp=4), frames(), state, IDX, LR, noise))
        for cfg, state, noise in cases],), timeout=TIMEOUT)
    for r in ranks[1:]:  # the replicas stay equal
        for got, want in zip(r, ranks[0]):
            assert (got["losses"], got["bpps"]) == (want["losses"],
                                                    want["bpps"])
            for k, v in want["states"][-1].items():
                np.testing.assert_array_equal(got["states"][-1][k], v,
                                              err_msg=k)
    return ranks[0]


def assert_same_step(got, tr):
    """The dp=4 rank's parameters and quantiser parameters within the JAX
    test's tolerances of the dp=1 trainer ``tr``'s, or within a flipped
    step where ``tr``'s gradient is below TINY_GRAD of its largest."""
    params = dict(tr.model.named_parameters())
    pairs = [(k, got["states"][-1][k], params[k]) for k in params]
    pairs += [(f"{key}/{name}", got["qp"][key][name], v)
              for key, d in tr.qparams.items() for name, v in d.items()]
    if tr.embed_qp is not None:
        pairs += [(f"embed_qp/{name}", got["embed_qp"][name], v)
                  for name, v in tr.embed_qp.items()]
    assert sorted(got["states"][-1]) == sorted(tr.model.state_dict())
    tiny = TINY_GRAD * max(float(v.grad.abs().max()) for *_, v in pairs
                           if v.grad is not None)
    for name, a, v in pairs:
        b = v.detach().numpy()
        err = np.abs(a - b)
        bad = err > PARAM_ATOL + PARAM_RTOL * np.abs(b)
        if v.grad is not None:
            bad &= ~((np.abs(v.grad.numpy()) <= tiny)
                     & (err <= 2 * LR * (1 + 1e-3)))
        assert not bad.any(), (name, a[bad], b[bad])


def jax_case(tmp):
    """(the port's config, the JAX trainer's init as a torch state, JAX's
    noise of its dp=4 step, that step's loss and bpp)."""
    cfg = RefConfig(**BASE, dp=4, outf=str(tmp))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_trainer, "build_model",
                   lambda c: _Jitted(build_flax_model(c)))
        ref = ref_ct.CompressionTrainer(
            cfg, video=RefVideoData(frames()),
            logger=RefLogger(cfg.outf, enable_tb=False))
    ref.init_qparams()
    init = {k: v.numpy() for k, v in torch_state_from_flax(
        jax.device_get(ref.params), port_cfg(ref.cfg)).items()}
    key = jax.random.key(123)
    noise = {k: v.numpy() for k, v in jax_noise(ref, key).items()}
    img, t = ref._device_batch(ref.video.get_batch(IDX))
    args = (ref.state, ref.opt_state, img, t, jnp.float32(LR), key,
            jnp.float32(ref.target_bpp))  # the step donates both states
    step = ref.cem_step.lower(*args).compile(compiler_options=FAST_COMPILE)
    _, _, loss, _, bpp = step(*args)
    return port_cfg(ref.cfg0), init, noise, float(loss), float(bpp)


def straddle_case(tmp):
    """(HNeRV-Boost's config with ``embed_entropy`` and a target between
    the lowest rank's own estimate of the bits a pixel and the global
    batch's, its seeded weights, fixed noise, the target, the global
    estimate a frame)."""
    cfg = port_config.BoostConfig(
        **{**BASE, "model": "HNeRV_Boost"}, embed_entropy=True,
        outf=str(tmp))
    tr = port_ct.CompressionTrainer(cfg, video=VideoData(frames()),
                                    logger=NullLogger(), device="cpu")
    tr.init_qparams()
    rng = np.random.default_rng(7)
    noise = {k: rng.uniform(-0.5, 0.5, s).astype(np.float32)
             for k, s in tr.flax_shapes.items()}
    with torch.no_grad():
        code = tr.e_quant.apply(
            tr.model.encode(tr.gather(IDX)), tr.embed_qp,
            cfg.quant_embed_bit, signed=False,
            per_channel=cfg.per_channel_e)[0]
        noise[port_ct.EMBED] = rng.uniform(-0.5, 0.5, tuple(
            code.shape)).astype(np.float32)
        _, wbits = tr.dequant_params({k: torch.from_numpy(v)
                                      for k, v in noise.items()
                                      if k != port_ct.EMBED})
        ne = torch.from_numpy(noise[port_ct.EMBED])
        n, size = tr.video.n, tr.video.final_size

        def bpp_a_frame(lo, hi):  # frames [lo, hi)'s own estimate
            bits = rate_bits(code[lo:hi], ne[lo:hi], True)["bitrate"]
            return float((wbits + bits * n / (hi - lo)) / size / n)

        local = [bpp_a_frame(2 * r, 2 * r + 2) for r in range(4)]
        whole = bpp_a_frame(0, 8)
    target = 0.5 * (min(local) + whole)
    assert min(local) < target < whole <= max(local)
    cfg = cfg.replace(target_bit=target / tr.target_bpp * cfg.target_bit)
    state = {k: v.detach().numpy() for k, v in tr.model.state_dict().items()}
    return cfg, state, noise, target, whole


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """Both cases and rank 0's results of their dp=4 steps (one launch)."""
    jax_c = jax_case(tmp_path_factory.mktemp("ref"))
    straddle = straddle_case(tmp_path_factory.mktemp("straddle"))
    got = port_dp4([jax_c[:3], straddle[:3]])
    return (jax_c, got[0]), (straddle, got[1])


def test_cem_step_dp4_matches_jax_dp4(cases):
    (pcfg, init, noise, want_loss, want_bpp), got = cases[0]
    np.testing.assert_allclose(got["losses"][0], want_loss, rtol=RTOL)
    np.testing.assert_allclose(got["bpps"][0], want_bpp, rtol=RTOL)
    loss_1, bpp_1, tr = port_dp1(pcfg, init, noise)
    np.testing.assert_allclose(got["losses"][0], loss_1, rtol=RTOL)
    np.testing.assert_allclose(got["bpps"][0], bpp_1, rtol=RTOL)
    assert_same_step(got, tr)


def test_embed_entropy_rate_term_across_the_target_dp4_matches_dp1(cases):
    (cfg, state, noise, target, whole), got = cases[1]
    loss_1, bpp_1, tr1 = port_dp1(cfg, state, noise)
    np.testing.assert_allclose(tr1.target_bpp, target, rtol=1e-6)
    np.testing.assert_allclose(bpp_1 / tr1.video.n, whole, rtol=1e-5)
    np.testing.assert_allclose(got["losses"][0], loss_1, rtol=RTOL)
    np.testing.assert_allclose(got["bpps"][0], bpp_1, rtol=RTOL)
    assert_same_step(got, tr1)
