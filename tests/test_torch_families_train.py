"""The port's RegressionTrainer on the other families, on the CPU: one
step's loss and gradients and three steps' losses of NeRV-Boost and
E-NeRV-Boost against the JAX trainer from the same (bridged) parameters
(``tiny_cfg`` of tests/test_train_e2e.py, 8x16 frames, L1_freq, batch 2);
the E-NeRV defaults; an E-NeRV-Boost checkpoint read by each package from
the other; one step and the eager fps clock of HNeRV and E-NeRV; and a
tiny CLI run with ``--model NeRV_Boost``."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from boosting_nerv_torch import config as port_config
from boosting_nerv_torch import train_nerv_all as port_cli
from boosting_nerv_torch.bridge import torch_state_from_flax
from boosting_nerv_torch.data import VideoData, synthetic_video
from boosting_nerv_torch.models import build_model
from boosting_nerv_torch.training import checkpoint as port_ckpt
from boosting_nerv_torch.training import trainer as port_trainer
from boosting_nerv_torch.utils.logger import RunLogger
from boosting_nerv_tpu.data import VideoData as RefVideoData
from boosting_nerv_tpu.models import build_model as build_flax_model
from boosting_nerv_tpu.ops.losses import loss_fn as ref_loss_fn
from boosting_nerv_tpu.training import checkpoint as ref_ckpt
from boosting_nerv_tpu.training import trainer as ref_trainer
from boosting_nerv_tpu.utils.logger import RunLogger as RefLogger
from test_torch_train_trainer import _JitInit
from test_train_e2e import tiny_cfg

LOSS_RTOL = 1e-4   # float32 forwards on both sides
GRAD_TOL = 1e-4    # x the leaf's max |g|
LR = 5e-3
H, W = 8, 16


def _frames():
    return synthetic_video(4, H, W)


@pytest.fixture(scope="module", params=["NeRV_Boost", "ENeRV_Boost"])
def ref(request, tmp_path_factory):
    """The JAX trainer of the family, its loss and gradients
    (trainer.py:240-252) and its optimizer update (:281-283) compiled."""
    cfg = tiny_cfg(tmp_path_factory.mktemp("ref"), request.param,
                   loss="L1_freq", epochs=2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_trainer, "build_model",
                   lambda c: _JitInit(build_flax_model(c)))
        ref = ref_trainer.RegressionTrainer(
            cfg, video=RefVideoData(_frames()),
            logger=RefLogger(cfg.outf, enable_tb=False))

    def lossf(p, img, t):
        return ref_loss_fn(ref._forward(p, img, t), img, cfg.loss)

    def update(params, opt_state, grads, lr):
        updates, opt_state = ref.opt.update(grads, opt_state, params, lr=lr)
        return optax.apply_updates(params, updates), opt_state

    ref.loss_and_grads = jax.jit(jax.value_and_grad(lossf))
    ref.update = jax.jit(update)
    return ref


def _port(ref, tmp_path):
    """A port trainer on the CPU with ``ref``'s config (as given, before
    the E-NeRV defaults) and parameters."""
    names = {f.name for f in dataclasses.fields(port_config.BoostConfig)}
    fields = {k: v for k, v in dataclasses.asdict(ref.cfg0).items()
              if k in names}
    cfg = port_config.BoostConfig(**{**fields,
                                     "outf": str(tmp_path / "port")})
    t = port_trainer.RegressionTrainer(
        cfg, video=VideoData(_frames()),
        logger=RunLogger(cfg.outf, enable_tb=False), device="cpu")
    t.model.load_state_dict(torch_state_from_flax(
        jax.device_get(ref.params), t.cfg))
    return t


def test_one_step_loss_and_gradients_match_jax(ref, tmp_path):
    port = _port(ref, tmp_path)
    assert (port.cfg.train_precision, port.cfg.clip_max_norm) == (
        ref.cfg.train_precision, ref.cfg.clip_max_norm)
    batch = ref.video.get_batch([0, 1])
    want_loss, want_grads = ref.loss_and_grads(
        ref.params, jnp.asarray(batch["img"]),
        jnp.asarray(batch["norm_idx"]))
    port.opt.zero_grad(set_to_none=True)  # the gradients before the clip
    loss, _ = port._loss_backward(torch.from_numpy(batch["img"]),
                                  torch.from_numpy(batch["norm_idx"]))
    np.testing.assert_allclose(float(loss), float(want_loss),
                               rtol=LOSS_RTOL)
    want = torch_state_from_flax(jax.device_get(want_grads), port.cfg)
    for name, p in port.model.named_parameters():
        w = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * np.abs(w).max() + 1e-12,
                                   err_msg=name)


def test_three_steps_track_jax_in_loss(ref, tmp_path):
    port = _port(ref, tmp_path)
    params, opt_state = ref.params, ref.opt_state
    for idx in ([0, 1], [2, 3], [1, 2]):
        batch = ref.video.get_batch(idx)
        want, grads = ref.loss_and_grads(params, jnp.asarray(batch["img"]),
                                         jnp.asarray(batch["norm_idx"]))
        params, opt_state = ref.update(params, opt_state, grads,
                                       jnp.float32(LR))
        got, _ = port.train_step_idx(idx, batch["norm_idx"], LR)
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


def test_enerv_defaults(capsys):
    """E-NeRV and E-NeRV-Boost train at "highest" with a clip of 1.0 when
    it is unset, each change printed; an explicit clip (0 included) stays;
    the other families keep their fields."""
    for model in ("ENeRV", "ENeRV_Boost"):
        cfg = port_trainer.enerv_defaults(port_config.BoostConfig(
            model=model, train_precision="high"))
        assert (cfg.train_precision, cfg.clip_max_norm) == ("highest", 1.0)
        out = capsys.readouterr().out
        assert "'highest'" in out and "clip_max_norm unset -> 1.0" in out
        cfg = port_trainer.enerv_defaults(port_config.BoostConfig(
            model=model, clip_max_norm=0.0))
        assert cfg.clip_max_norm == 0.0
    cfg = port_config.BoostConfig(model="NeRV_Boost", train_precision="high")
    assert port_trainer.enerv_defaults(cfg) is cfg
    assert capsys.readouterr().out == ""


def test_enerv_boost_checkpoints_cross_packages(tmp_path):
    """An E-NeRV-Boost checkpoint of the port read by the JAX package
    (``load_checkpoint`` + ``tree_restore``) and one of the JAX package
    read by the port, each giving the other's output."""
    cfg = tiny_cfg(tmp_path, "ENeRV_Boost")
    pcfg = port_config.BoostConfig(**{
        f.name: getattr(cfg, f.name)
        for f in dataclasses.fields(port_config.BoostConfig)})
    fmodel = build_flax_model(cfg)
    apply = jax.jit(fmodel.apply)
    t = np.array([0.3, 0.8], np.float32)
    port = build_model(pcfg, seed=5, device="cpu")
    path = str(tmp_path / "port.ckpt")
    port_ckpt.save_checkpoint(path, 4, port, pcfg)
    template = jax.eval_shape(fmodel.init, jax.random.key(0), jnp.asarray(t))
    params = ref_ckpt.tree_restore(template,
                                   ref_ckpt.load_checkpoint(path)["params"])
    with torch.no_grad():
        np.testing.assert_allclose(
            np.asarray(apply(params, t)), port(torch.from_numpy(t)).numpy(),
            atol=1e-5, rtol=0)
    params = jax.jit(fmodel.init)(jax.random.key(7), jnp.asarray(t))
    path = str(tmp_path / "jax.ckpt")
    ref_ckpt.save_checkpoint(path, 2, params)
    port = build_model(pcfg, seed=None, device="cpu")
    port_ckpt.restore(port, port_ckpt.load_checkpoint(path), pcfg)
    with torch.no_grad():
        np.testing.assert_allclose(
            port(torch.from_numpy(t)).numpy(), np.asarray(apply(params, t)),
            atol=1e-5, rtol=0)


@pytest.mark.parametrize("model,kw", [
    ("HNeRV", dict(sft_block="none", act="gelu")),
    ("HNeRV", dict(sft_block="none", act="gelu", enc_strds=[])),
    ("ENeRV", dict(sft_block="none", act="gelu")),
    ("NeRV_Boost", {})])
def test_every_family_trains_and_clocks_its_decode(tmp_path, model, kw):
    """One step of each family on the CPU (a finite loss that a second
    step on the same frames lowers), its eval's eight slots, and the fps
    clock's path: the eager decode for HNeRV and E-NeRV, and for an
    index-only Boost config with no planar tail (8x16 frames)."""
    cfg = tiny_cfg(tmp_path, model, loss="L1_freq", epochs=1, **kw)
    pcfg = port_config.BoostConfig(**{
        f.name: getattr(cfg, f.name)
        for f in dataclasses.fields(port_config.BoostConfig)})
    tr = port_trainer.RegressionTrainer(
        pcfg, video=VideoData(_frames()),
        logger=RunLogger(pcfg.outf, enable_tb=False), device="cpu")
    assert tr.fps_decode_path == "eager"
    assert tr.has_embed == (model == "HNeRV" and bool(pcfg.enc_strds))
    first, _ = tr.train_step_idx([0, 1], [0.25, 0.5], LR)
    second, _ = tr.train_step_idx([0, 1], [0.25, 0.5], LR)
    assert np.isfinite(float(first)) and float(second) < float(first)
    res = tr.evaluate(huffman_coding=True)
    assert list(res) == port_trainer.METRIC_NAMES
    assert all(np.isfinite(v) for v in res.values())
    assert tr.fps > 0 and tr.bits_per_param > 0


def test_tiny_cli_run_of_nerv_boost(tmp_path, monkeypatch):
    frames_dir = tmp_path / "frames"
    frames_dir.mkdir()
    for i, f in enumerate(synthetic_video(4, 12, 20, seed=1)):
        Image.fromarray(f).save(frames_dir / f"{i:04d}.png")  # cropped 8x16
    monkeypatch.chdir(tmp_path)
    best = port_cli.main([
        "--model", "NeRV_Boost", "--embed", "pe_1.25_20", "--fc_hw", "2_4",
        "--fc_dim", "12", "--dec_strds", "2", "2", "--dec_blks", "1", "1",
        "--ks", "0_1_5", "--conv_type", "convnext", "pshuffel_3x3",
        "--act", "sin", "--sft_block", "res_sft", "--ch_t", "8",
        "--lower_width", "4", "--crop_list", "8_16", "--loss", "L1_freq",
        "-b", "2", "--lr", "0.005", "--device", "cpu",
        "--data_path", str(frames_dir), "--vid", "syn", "--outf", "tiny",
        "-e", "2", "--eval_freq", "1"])
    outf = os.path.join("output", "tiny", "syn", "Size1.5")
    assert {"epoch2.csv", "model_latest.ckpt"} <= set(os.listdir(outf))
    assert best["pred_seen_psnr"] > 0
