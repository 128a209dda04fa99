"""The port's CEM ``CompressionTrainer`` against the JAX package's on the
CPU, for HNeRV-Boost with ``embed_entropy`` and for NeRV-Boost (index-only:
no embedding quantiser, no rate term for an embedding): the tiny config of
tests/test_compression_e2e.py (8x16 frames, fc_dim 12, L2, Adan, lr 5e-4,
scale / scale / scalebeta at 8 / 8 / 8 bits, lambda 0.05, target_bit 4)
on ``synthetic_video(4, 8, 16)``, batch 2, from the JAX trainer's
(bridged) seeded init.

The JAX trainer of each family is built once and its step called once;
the two families share one module, so the JAX package's op-by-op work on
shapes they share compiles once.  One CEM step of the port is fed JAX's
own noise (``fold_in(key, i)`` over every flax leaf in key order,
``fold_in(key, 10_000)`` for the embedding).  The JAX step is compiled
with LLVM's optimisation off (the same HLO; it compiles in a third less
time), and the JAX coding eval's ``gaussian_bits`` runs compiled once a
power-of-two size instead of op by op on every tensor's shape.

Tolerances: ``target_bpp`` equal; ``init_qparams`` within rtol 1e-6
(the embedding's, taken from a float32 encoder forward in each
framework, 1e-5); the step's loss and bpp within rtol 1e-4, the updated
flax-view parameters and quantiser parameters within rtol 1e-4 and atol
1e-4 of the leaf's largest value, except where the port's gradient is
below 1e-6 of the step's largest: Adan's first step moves an element by
~lr times the sign of its gradient, which rounding flips there (the
scalebeta embedding quantiser's beta gets ~0 from both the task and the
rate term), so those may differ by a flipped step, at most 2 lr (1 +
1e-3); the coding eval's ``total_bpp`` and
``estimate_bpp`` within rtol 1e-6, ``quant_seen_psnr`` within 1e-3 dB;
checkpoints read across the packages exactly.
"""
import copy
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from boosting_nerv_torch import config as port_config
from boosting_nerv_torch.bridge import (flax_params_from_torch_state,
                                        torch_state_from_flax)
from boosting_nerv_torch.data import VideoData, synthetic_video
from boosting_nerv_torch.training import checkpoint as port_ckpt
from boosting_nerv_torch.training import compress_trainer as port_ct
from boosting_nerv_torch.utils.logger import RunLogger
from boosting_nerv_tpu.data import VideoData as RefVideoData
from boosting_nerv_tpu.models import build_model as build_flax_model
from boosting_nerv_tpu.ops import entropy as ref_entropy
from boosting_nerv_tpu.training import checkpoint as ref_ckpt
from boosting_nerv_tpu.training import compress_trainer as ref_ct
from boosting_nerv_tpu.training import trainer as ref_trainer
from boosting_nerv_tpu.utils.logger import RunLogger as RefLogger
from test_compression_e2e import cfgs

QP_RTOL = 1e-6
EMBED_QP_RTOL = 1e-5
STEP_RTOL = 1e-4
STATE_TOL = 1e-4    # rtol, and atol x the leaf's max |value|
BPP_RTOL = 1e-6
PSNR_ATOL = 1e-3    # dB
LR = 5e-4
IDX = [0, 1]


TINY_GRAD = 1e-6   # of the step's largest gradient: a flippable sign
# the JAX step's compile: LLVM's optimisation off
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
MODELS = {"HNeRV_Boost": {"embed_entropy": True}, "NeRV_Boost": {}}


def frames():
    return synthetic_video(4, 8, 16)


class _Jitted:
    """A flax model whose ``init`` and ``apply`` run compiled: the JAX
    compression trainer's eval applies the model op by op."""

    def __init__(self, model):
        self._model = model
        self.init = jax.jit(model.init)
        self.apply = jax.jit(model.apply, static_argnames="method")

    def __getattr__(self, name):
        return getattr(self._model, name)


def build_ref(tmp_path_factory, model, **kw):
    """The JAX compression trainer of ``model``, its quantisers set from
    its seeded init (``maybe_resume`` + ``init_qparams``, no weight)."""
    tmp = tmp_path_factory.mktemp(f"ref_{model}")
    _, cfg = cfgs(tmp, model)
    cfg = cfg.replace(weight="None", outf=str(tmp / "comp"), **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_trainer, "build_model",
                   lambda c: _Jitted(build_flax_model(c)))
        ref = ref_ct.CompressionTrainer(
            cfg, video=RefVideoData(frames()),
            logger=RefLogger(cfg.outf, enable_tb=False))
    ref.maybe_resume()
    ref.init_qparams()
    return ref


def jax_noise(ref, key, embed_shape=None):
    """JAX's training noise of a step with ``key``, keyed as the port's
    ``cem_step`` takes it (drawn in one compiled function: the same bits
    as the step's draws, one compile instead of one a shape, with LLVM's
    optimisation off as the step's)."""
    flat = flatten_dict(jax.device_get(ref.state["model"]))
    shapes = {}
    for i, (k, v) in enumerate(sorted(flat.items(),
                                      key=lambda kv: "/".join(kv[0]))):
        if "/".join(k) in ref.qparams:
            shapes["/".join(k)] = (i, v.shape)
    if embed_shape is not None:
        shapes[port_ct.EMBED] = (10_000, embed_shape)

    def draw(key):
        return {ks: jax.random.uniform(jax.random.fold_in(key, i), shape,
                                       jnp.float32, -0.5, 0.5)
                for ks, (i, shape) in shapes.items()}

    drawn = jax.jit(draw).lower(key).compile(FAST_COMPILE)(key)
    return {ks: torch.from_numpy(np.array(v))
            for ks, v in jax.device_get(drawn).items()}


def bucketed_gaussian_bits(x, mean, std, distribution="gaussian"):
    """JAX's ``gaussian_bits`` of every element of ``x``, compiled once a
    power-of-two size: the JAX coding eval calls it op by op on each
    tensor's shape, which compiles every primitive anew a shape.  The
    function is elementwise, so the padded elements change none of the
    others."""
    x = np.asarray(x)
    n = x.size
    padded = np.zeros(1 << max(n - 1, 0).bit_length(), np.float32)
    padded[:n] = x.ravel()
    bits = _jit_gaussian_bits(padded, mean, std, distribution)
    return np.asarray(bits)[:n].reshape(x.shape)


_jit_gaussian_bits = jax.jit(ref_entropy.gaussian_bits,
                             static_argnames="distribution")


def run_jax_step(ref):
    """One JAX CEM step on frames IDX from the trainer's state: (new
    state, new opt_state, loss, bpp, the noise as the port takes it)."""
    batch = ref.video.get_batch(IDX)
    key = jax.random.key(11)
    embed_shape = None
    if ref.embed_qp is not None and ref.cfg.embed_entropy:
        embed_shape = ref.encode_step(ref.params,
                                      jnp.asarray(batch["img"])).shape
    args = (jax.tree_util.tree_map(jnp.array, ref.state),
            jax.tree_util.tree_map(jnp.array, ref.opt_state),
            jnp.asarray(batch["img"]), jnp.asarray(batch["norm_idx"]),
            jnp.float32(LR), key, jnp.float32(ref.target_bpp))
    step = ref.cem_step.lower(*args).compile(compiler_options=FAST_COMPILE)
    state, opt_state, loss, _, bpp = step(*args)
    return (jax.device_get(state), jax.device_get(opt_state), float(loss),
            float(bpp), jax_noise(ref, key, embed_shape))


def port_trainer(ref, outf, **kw):
    """A port trainer on the CPU with ``ref``'s config and (bridged)
    weights, quantisers set (``init_qparams``)."""
    names = {f.name for f in dataclasses.fields(port_config.BoostConfig)}
    fields = {k: v for k, v in dataclasses.asdict(ref.cfg0).items()
              if k in names}
    cfg = port_config.BoostConfig(**{**fields, "outf": str(outf), **kw})
    t = port_ct.CompressionTrainer(
        cfg, video=VideoData(frames()),
        logger=RunLogger(cfg.outf, enable_tb=False), device="cpu")
    t.model.load_state_dict(torch_state_from_flax(
        jax.device_get(ref.params), t.cfg))
    t.init_qparams()
    return t


def _np_qp(qp):
    return {k: ({n: np.asarray(v.detach()) for n, v in d.items()}
                if isinstance(d, dict) else np.asarray(d.detach()))
            for k, d in qp.items()}


def _close(name, got, want, rtol, atol_of_max, grad=None, flip=0.0):
    """``got`` within rtol / atol of ``want``; where ``grad`` is below
    TINY_GRAD x ``flip``'s scale, within a flipped step instead."""
    atol = atol_of_max * np.abs(want).max()
    bad = np.abs(got - want) > atol + rtol * np.abs(want)
    if grad is not None:
        flippable = np.abs(grad) <= flip
        bad &= ~(flippable & (np.abs(got - want) <= 2 * LR * (1 + 1e-3)))
    assert not bad.any(), (name, got[bad], want[bad])


def assert_qp_close(got, want, rtol, atol_of_max=0.0, flip=0.0):
    grads = _np_qp({k: ({n: (v.grad if v.grad is not None
                             else torch.zeros_like(v))
                         for n, v in d.items()} if isinstance(d, dict)
                        else (d.grad if d.grad is not None
                              else torch.zeros_like(d)))
                    for k, d in got.items()})
    got, want = _np_qp(got), jax.device_get(want)
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = got[k], want[k]
        if isinstance(w, dict):
            assert sorted(g) == sorted(w), k
            trip = [(f"{k}/{n}", g[n], w[n], grads[k][n]) for n in w]
        else:
            trip = [(k, g, w, grads[k])]
        for name, a, b, gr in trip:
            b = np.asarray(b)
            assert a.shape == b.shape, name
            _close(name, a, b, rtol, atol_of_max, gr, flip)


def assert_flax_close(model, cfg, want, rtol, atol_of_max=0.0, flip=0.0):
    got = flatten_dict(flax_params_from_torch_state(model.state_dict(),
                                                    cfg))
    grads = flatten_dict(flax_params_from_torch_state(
        {n: (p.grad if p.grad is not None else torch.zeros_like(p))
         for n, p in model.named_parameters()}, cfg))
    want = flatten_dict(jax.device_get(want))
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape, k
        _close("/".join(k), got[k], w, rtol, atol_of_max, grads[k], flip)


def largest_grad(port):
    return max(float(p.grad.abs().max()) for p in
               list(port.model.parameters()) + port.qp_tensors()
               if p.grad is not None)


# ----------------------------------------------------------------------- #
@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's tiny CPU work on one thread: the suite runs several
    workers, and torch's default of a thread a core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=list(MODELS))
def ref(request, tmp_path_factory):
    return build_ref(tmp_path_factory, request.param,
                     **MODELS[request.param])


@pytest.fixture(scope="module")
def jax_step(ref):
    return run_jax_step(ref)


# ----------------------------------------------------------------------- #
def test_target_bpp_and_init_qparams_match_jax(ref, tmp_path):
    assert (ref.embed_qp is None) == (ref.cfg.model == "NeRV_Boost")
    port = port_trainer(ref, tmp_path)
    assert port.target_bpp == ref.target_bpp
    assert port.total_param == ref.total_param
    assert [k for k, _ in port.leaves] == sorted(ref.qparams)
    assert_qp_close(port.qparams, ref.qparams, QP_RTOL)
    if ref.embed_qp is None:
        assert port.embed_qp is None
    else:
        assert_qp_close(port.embed_qp, ref.embed_qp, EMBED_QP_RTOL)


def test_one_cem_step_with_jax_noise_matches_jax(ref, jax_step, tmp_path):
    state, _, want_loss, want_bpp, noise = jax_step
    port = port_trainer(ref, tmp_path)
    loss, psnr, bpp = port.cem_step_idx(IDX, ref.video.norm_idx(
        np.asarray(IDX)), LR, noise)
    np.testing.assert_allclose(float(loss), want_loss, rtol=STEP_RTOL)
    np.testing.assert_allclose(float(bpp), want_bpp, rtol=STEP_RTOL)
    assert psnr.shape == (len(IDX),)
    flip = TINY_GRAD * largest_grad(port)
    assert_flax_close(port.model, port.cfg, state["model"], STATE_TOL,
                      STATE_TOL, flip)
    assert_qp_close(port.qparams, state["qp"], STATE_TOL, STATE_TOL, flip)
    if "embed_qp" in state:
        assert_qp_close(port.embed_qp, state["embed_qp"], STATE_TOL,
                        STATE_TOL, flip)


def test_coding_eval_matches_jax(ref, tmp_path, monkeypatch):
    # JAX's fps clock is not compared (it times a flax decode on this CPU)
    monkeypatch.setattr(ref, "measure_fps", lambda params, reps: 1.0)
    monkeypatch.setattr(ref_ct, "gaussian_bits", bucketed_gaussian_bits)
    want = ref.evaluate_cem(coding=True)
    port = port_trainer(ref, tmp_path)
    got = port.evaluate_cem(coding=True)
    assert list(got) == list(want)
    np.testing.assert_allclose(port.total_bpp, ref.total_bpp,
                               rtol=BPP_RTOL)
    np.testing.assert_allclose(port.estimate_bpp, ref.estimate_bpp,
                               rtol=BPP_RTOL)
    for k in got:
        if k.startswith("pred_") or k.endswith("unseen_psnr"):
            assert got[k] == want[k] == 0.0, k
    assert abs(got["quant_seen_psnr"] - want["quant_seen_psnr"]) \
        <= PSNR_ATOL
    assert port.total_bpp > 0 and port.fps > 0


def test_port_cem_checkpoint_is_read_by_jax(ref, tmp_path):
    port = port_trainer(ref, tmp_path / "port")
    port.cem_step_idx(IDX, ref.video.norm_idx(np.asarray(IDX)), LR)
    port.save("model_latest.ckpt", 1)
    jt = copy.copy(ref)  # the module's trainer stays as it is
    jt.cfg = ref.cfg.replace(outf=port.cfg.outf, not_resume=False)
    jt._resume_ck = None
    jt.maybe_resume()
    jt.init_qparams()  # the port's optimizer state: JAX reinitialises it
    assert jt.start_epoch == 1
    assert_flax_close(port.model, port.cfg, jt.state["model"], 0)
    assert_qp_close(port.qparams, jt.state["qp"], 0)
    if port.embed_qp is not None:
        assert_qp_close(port.embed_qp, jt.state["embed_qp"], 0)


def test_jax_cem_checkpoint_is_read_by_port(ref, jax_step, tmp_path,
                                            capsys):
    state, opt_state = jax_step[:2]
    outf = tmp_path / "jax"
    outf.mkdir()
    ref_ckpt.save_checkpoint(str(outf / "model_latest.ckpt"), 1, state,
                             opt_state)
    port = port_trainer(ref, outf, not_resume=False)
    port.maybe_resume()
    port.init_qparams()
    assert port.start_epoch == 1
    assert "=> opt_state not restored" in capsys.readouterr().out
    assert_flax_close(port.model, port.cfg, state["model"], 0)
    assert_qp_close(port.qparams, state["qp"], 0)
    if "embed_qp" in state:
        assert_qp_close(port.embed_qp, state["embed_qp"], 0)
    # --weight takes a plain regression checkpoint (and a CEM one's model)
    for name, params in (("reg.ckpt", ref.params), ("cem.ckpt", state)):
        ref_ckpt.save_checkpoint(str(tmp_path / name), 3, params)
        warm = port_trainer(ref, tmp_path / f"w_{name}",
                            weight=str(tmp_path / name))
        warm.maybe_resume()
        assert warm.start_epoch == 0
        assert_flax_close(warm.model, warm.cfg, params.get("model", params),
                          0)


def test_measure_fps_of_a_copy_leaves_the_model_untouched(ref, tmp_path):
    port = port_trainer(ref, tmp_path)
    before = {k: v.clone() for k, v in port.model.state_dict().items()}
    dq = port.dequant_model()
    assert port.measure_fps(reps=2, model=dq) > 0
    # the tiny NeRV-Boost has no planar tail: its clock times the eager model
    assert port.fps_decode_path == ("serving" if ref.embed_qp is not None
                                    else "eager")
    after = port.model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert any(not torch.equal(dq.state_dict()[k], before[k])
               for k in before)


def test_port_resume_restores_the_whole_cem_state(ref, tmp_path):
    first = port_trainer(ref, tmp_path)
    for _ in range(2):
        first.cem_step_idx(IDX, ref.video.norm_idx(np.asarray(IDX)), LR)
    first.save("model_latest.ckpt", 2)
    again = port_trainer(ref, tmp_path, not_resume=False)
    again.maybe_resume()
    again.init_qparams()
    assert again.start_epoch == 2
    assert_qp_close(again.qparams, _np_qp(first.qparams), 0)
    steps = {st["step"] for st in again.opt.state.values()}
    assert steps == {2}  # Adan's state continues
    assert_flax_close(again.model, again.cfg, flax_params_from_torch_state(
        first.model.state_dict(), first.cfg), 0)
    ck = port_ckpt.load_checkpoint(os.path.join(tmp_path,
                                                "model_latest.ckpt"))
    assert sorted(ck["params"]) == (["model", "qp"] if ref.embed_qp is None
                                    else ["embed_qp", "model", "qp"])
