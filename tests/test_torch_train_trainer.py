"""The port's RegressionTrainer against the JAX package's on the CPU, from
the same (bridged) parameters: ``tiny_cfg`` of tests/test_train_e2e.py
(HNeRV-Boost, 8x16 frames) with the L1_freq loss on
``synthetic_video(4, 8, 16)``, batch 2."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from boosting_nerv_torch import config as port_config
from boosting_nerv_torch.bridge import torch_state_from_flax
from boosting_nerv_torch.data import VideoData, synthetic_video
from boosting_nerv_torch.training import trainer as port_trainer
from boosting_nerv_torch.utils.logger import RunLogger
from boosting_nerv_tpu.data import VideoData as RefVideoData
from boosting_nerv_tpu.data import make_inpaint_mask as ref_inpaint_mask
from boosting_nerv_tpu.models import build_model as build_flax_model
from boosting_nerv_tpu.ops.losses import loss_fn as ref_loss_fn
from boosting_nerv_tpu.training import trainer as ref_trainer
from boosting_nerv_tpu.utils.logger import RunLogger as RefLogger
from test_train_e2e import tiny_cfg

LOSS_RTOL = 1e-4   # float32 forward of ~2k parameters on both sides
GRAD_TOL = 1e-4    # x the leaf's max |g|
LR = 5e-3
H, W = 8, 16


def _frames():
    return synthetic_video(4, H, W)


class _JitInit:
    """A flax model whose ``init`` runs as one compiled function: the JAX
    trainer calls it op by op, ~200 compilations (~25 s) at this size."""

    def __init__(self, model):
        self._model = model
        self.init = jax.jit(model.init)

    def __getattr__(self, name):
        return getattr(self._model, name)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX trainer, built once a module; no test changes its
    parameters.  ``ref.loss_and_grads(params, img, t, mask)`` is its loss
    and gradients (trainer.py:240-252), with ``mask`` all ones for no
    inpainting (the same function: x * 1, and clip(img, 0, 1) of frames in
    [0, 1], change nothing), compiled once; ``ref.update`` its optimizer
    update (trainer.py:281-283), compiled."""
    cfg = tiny_cfg(tmp_path_factory.mktemp("ref"), "HNeRV_Boost",
                   loss="L1_freq", epochs=2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_trainer, "build_model",
                   lambda c: _JitInit(build_flax_model(c)))
        ref = ref_trainer.RegressionTrainer(
            cfg, video=RefVideoData(_frames()),
            logger=RefLogger(cfg.outf, enable_tb=False))

    def lossf(p, img, t, mask):
        out = ref._forward(p, jnp.clip(img * mask, 0, 1), t)
        return ref_loss_fn(out * mask, img * mask, cfg.loss)

    def update(params, opt_state, grads, lr):
        updates, opt_state = ref.opt.update(grads, opt_state, params, lr=lr)
        return optax.apply_updates(params, updates), opt_state

    ref.loss_and_grads = jax.jit(jax.value_and_grad(lossf))
    ref.update = jax.jit(update)
    return ref


def _mask(inpanting="none"):
    mask = ref_inpaint_mask(H, W, inpanting)
    return (jnp.ones((1, H, W, 1)) if mask is None
            else jnp.asarray(mask)[None, :, :, None])


def _port(ref, tmp_path, **kw):
    """A port trainer on the CPU with ``ref``'s config and parameters."""
    names = {f.name for f in dataclasses.fields(port_config.BoostConfig)}
    fields = {k: v for k, v in dataclasses.asdict(ref.cfg0).items()
              if k in names}
    cfg = port_config.BoostConfig(**{**fields, "outf": str(tmp_path / "port"),
                                     **kw})
    t = port_trainer.RegressionTrainer(
        cfg, video=VideoData(_frames()),
        logger=RunLogger(cfg.outf, enable_tb=False), device="cpu")
    t.model.load_state_dict(torch_state_from_flax(
        jax.device_get(ref.params), t.cfg))
    return t


def _assert_grads_close(model, want_state, tol=GRAD_TOL):
    for name, p in model.named_parameters():
        want = np.asarray(want_state[name])
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=tol * np.abs(want).max() + 1e-12,
                                   err_msg=name)


@pytest.mark.parametrize("inpanting", ["none", "inpanting_center"])
def test_one_step_loss_and_gradients_match_jax(ref, tmp_path, inpanting):
    port = _port(ref, tmp_path, inpanting=inpanting)
    batch = ref.video.get_batch([0, 1])
    want_loss, want_grads = ref.loss_and_grads(
        ref.params, jnp.asarray(batch["img"]),
        jnp.asarray(batch["norm_idx"]), _mask(inpanting))
    loss, psnr = port.train_step(torch.from_numpy(batch["img"]),
                                 torch.from_numpy(batch["norm_idx"]), LR)
    np.testing.assert_allclose(float(loss), float(want_loss),
                               rtol=LOSS_RTOL)
    assert psnr.shape == (2,)
    _assert_grads_close(port.model, torch_state_from_flax(
        jax.device_get(want_grads), port.cfg))


def test_three_steps_track_jax_in_loss(ref, tmp_path):
    port = _port(ref, tmp_path)
    params, opt_state = ref.params, ref.opt_state
    for idx in ([0, 1], [2, 3], [1, 2]):
        batch = ref.video.get_batch(idx)
        want, grads = ref.loss_and_grads(params, jnp.asarray(batch["img"]),
                                         jnp.asarray(batch["norm_idx"]),
                                         _mask())
        params, opt_state = ref.update(params, opt_state, grads,
                                       jnp.float32(LR))
        got, _ = port.train_step_idx(idx, batch["norm_idx"], LR)
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


@pytest.mark.parametrize("kw", [dict(micro_batch=1), dict(remat=True)])
def test_micro_batch_and_remat_steps_equal_the_plain_step(ref, tmp_path,
                                                         kw):
    plain, other = _port(ref, tmp_path), _port(ref, tmp_path, **kw)
    img = plain.gather([0, 3])
    t = torch.tensor([0.25, 1.0])
    want, want_psnr = plain.train_step(img, t, LR)
    got, got_psnr = other.train_step(img, t, LR)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(got_psnr.numpy(), want_psnr.numpy(),
                               rtol=1e-6)
    _assert_grads_close(other.model, {n: p.grad for n, p in
                                      plain.model.named_parameters()},
                        tol=1e-5)


def test_evaluate_matches_jax(ref, tmp_path):
    port = _port(ref, tmp_path)
    want = ref.evaluate(huffman_coding=True)
    got = port.evaluate(huffman_coding=True)
    assert list(got) == port_trainer.METRIC_NAMES
    np.testing.assert_allclose([got[k] for k in got],
                               [want[k] for k in got], rtol=1e-4)
    assert (port.bits_per_param, port.full_bits_per_param, port.total_bpp) \
        == (ref.bits_per_param, ref.full_bits_per_param, ref.total_bpp)
    assert port.bits_per_param > 0 and port.total_bpp > 0
    assert port.fps > 0 and port.fps_decode_path == "serving"


@pytest.mark.parametrize("field,value,item", [
    # dp and sp are ported (tests/test_torch_parallel_*.py,
    # tests/test_torch_spatial_*.py): what a later slice's field raised
    # until then is now a mesh's need of that many ranks' process group
    ("sp", 2, "spatial"),
    ("sp", 4, "spatial"),
])
def test_later_slices_raise_naming_their_roadmap_item(field, value, item):
    cfg = port_config.BoostConfig(**{field: value})
    with pytest.raises(RuntimeError, match="parallel.launch or torchrun"):
        port_trainer.RegressionTrainer(
            cfg.replace(data_path="x"), device="cpu")


@pytest.mark.parametrize("field,value", [
    ("interpolation", True),
    ("eval_only", True),
    ("dump_videos", True),
    ("profile", True),
    ("planar_train", 180),
])
def test_task_fields_are_accepted(ref, tmp_path, field, value):
    # refused until the tasks slice ported them: a trainer takes them
    assert getattr(_port(ref, tmp_path, **{field: value}).cfg,
                   field) == value


def test_train_precision_sets_tf32():
    try:
        for precision, tf32 in (("high", True), ("default", True),
                                ("highest", False)):
            port_trainer.set_train_precision(precision)
            assert torch.backends.cuda.matmul.allow_tf32 is tf32
            assert torch.backends.cudnn.allow_tf32 is tf32
        with pytest.raises(ValueError):
            port_trainer.set_train_precision("bf16")
    finally:
        port_trainer.set_train_precision("highest")
