"""The interpolation task on the port against the JAX package on the CPU,
from the same (bridged) parameters: ``tiny_cfg`` of tests/test_train_e2e.py
(HNeRV-Boost, 8x16 frames) with ``interpolation``, ``embed_inter`` and the
``1_1_2`` split on a 6-frame clip, which interpolation cuts to 5.

This module builds one JAX trainer; it holds at most 7 cases, so that the
suite's scheduler hands it out after tests/test_compression_e2e.py."""

import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

from boosting_nerv_torch import config as port_config
from boosting_nerv_torch.bridge import torch_state_from_flax
from boosting_nerv_torch.data import VideoData, synthetic_video
from boosting_nerv_torch.data.png import write_png
from boosting_nerv_torch.ops.metrics import psnr_per_frame
from boosting_nerv_torch.training import trainer as port_trainer
from boosting_nerv_torch.training.compress_trainer import CompressionTrainer
from boosting_nerv_torch.utils.logger import RunLogger
from boosting_nerv_tpu.data import VideoData as RefVideoData
from boosting_nerv_tpu.models import build_model as build_flax_model
from boosting_nerv_tpu.training import trainer as ref_trainer
from boosting_nerv_tpu.utils.logger import RunLogger as RefLogger
from test_torch_train_trainer import _JitInit
from test_train_e2e import tiny_cfg

PSNR_TOL = 1e-3  # dB
SSIM_TOL = 1e-5
H, W = 8, 16
TASK = dict(interpolation=True, embed_inter=True, data_split="1_1_2")


def _frames():
    return synthetic_video(6, H, W, seed=3)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's tiny CPU work on one thread: the suite runs several
    workers, and torch's default of a thread a core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX trainer, built once; its fps clock stubbed."""
    cfg = tiny_cfg(tmp_path_factory.mktemp("ref"), "HNeRV_Boost",
                   loss="L1_freq", epochs=1, batchSize=1, **TASK)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_trainer, "build_model",
                   lambda c: _JitInit(build_flax_model(c)))
        ref = ref_trainer.RegressionTrainer(
            cfg, video=RefVideoData(_frames(), True, True),
            logger=RefLogger(cfg.outf, enable_tb=False))
    ref.measure_fps = lambda params, reps: 1.0
    return ref


def _port(ref, tmp_path, cls=port_trainer.RegressionTrainer, **kw):
    """A port trainer on the CPU with ``ref``'s config and parameters; its
    fps clock stubbed."""
    names = {f.name for f in dataclasses.fields(port_config.BoostConfig)}
    fields = {k: v for k, v in dataclasses.asdict(ref.cfg0).items()
              if k in names}
    cfg = port_config.BoostConfig(**{**fields, "outf": str(tmp_path / "port"),
                                     **kw})
    t = cls(cfg, video=VideoData(_frames(), True, True),
            logger=RunLogger(cfg.outf, enable_tb=False), device="cpu")
    t.model.load_state_dict(torch_state_from_flax(
        jax.device_get(ref.params), t.cfg))
    t.measure_fps = lambda reps=20, model=None: 1.0
    return t


def test_split_and_frame_count_match_jax(ref, tmp_path):
    port = _port(ref, tmp_path)
    assert (port.video.n, port.train_ind, port.val_ind) == \
        (ref.video.n, ref.train_ind, ref.val_ind) == (5, [0, 2, 4], [1, 3])
    assert port.embed_inter and port.cfg.embed_dim == ref.cfg.embed_dim


def test_interpolation_eval_matches_jax_in_all_8_slots(ref, tmp_path):
    port = _port(ref, tmp_path)
    want = ref.evaluate(huffman_coding=True)
    got = port.evaluate(huffman_coding=True)
    assert list(got) == port_trainer.METRIC_NAMES
    for k in got:
        tol = PSNR_TOL if k.endswith("psnr") else SSIM_TOL
        assert abs(got[k] - want[k]) <= tol, (k, got[k], want[k])
        assert got[k] > 0, k
    assert (port.bits_per_param, port.full_bits_per_param, port.total_bpp) \
        == (ref.bits_per_param, ref.full_bits_per_param, ref.total_bpp)


def test_unseen_frames_decode_from_their_neighbours_mean(ref, tmp_path):
    # by hand: each odd frame from 0.5 * (encode(pre) + encode(post)); the
    # quant slot from the quantised decoder on the same average
    port = _port(ref, tmp_path)
    got = port.evaluate()
    model = port.model
    qmodel = copy.deepcopy(model)
    qmodel.load_state_dict(port.quantize_model_params()[0])
    with torch.no_grad():
        psnr = {"pred": [], "quant": []}
        for j in port.val_ind:
            mixed = 0.5 * (model.encode(port.gather([j - 1]))
                           + model.encode(port.gather([j + 1])))
            t = torch.as_tensor(port.video.norm_idx([j]))
            for slot, m in (("pred", model), ("quant", qmodel)):
                psnr[slot].append(float(psnr_per_frame(
                    m.decode(mixed, t), port.gather([j]))[0]))
    for slot in psnr:
        assert abs(got[f"{slot}_unseen_psnr"]
                   - float(np.mean(psnr[slot]))) <= PSNR_TOL, slot
    # without embed_inter the odd frames decode from their own embedding
    plain = _port(ref, tmp_path, embed_inter=False).evaluate()
    assert plain["pred_seen_psnr"] == got["pred_seen_psnr"]
    assert abs(plain["pred_unseen_psnr"] - got["pred_unseen_psnr"]) > 1e-3


def test_cem_trainer_builds_with_the_same_split(ref, tmp_path):
    port = _port(ref, tmp_path, cls=CompressionTrainer, quant=True,
                 quantizer_w="scale", quantizer_b="scale")
    assert (port.video.n, port.train_ind, port.val_ind) == \
        (ref.video.n, ref.train_ind, ref.val_ind)
    port.init_qparams()
    got = port.evaluate_cem()
    assert got["quant_seen_psnr"] > 0 and got["quant_unseen_psnr"] > 0
    assert got["pred_seen_psnr"] == got["pred_unseen_psnr"] == 0.0


def test_clip_from_a_directory_keeps_the_task_flags(ref, tmp_path):
    # the trainer reads its clip with interpolation and embed_inter, as
    # JAX's does
    for i, f in enumerate(_frames()):
        write_png(str(tmp_path / f"{i:04d}.png"), f)
    names = {f.name for f in dataclasses.fields(port_config.BoostConfig)}
    fields = {k: v for k, v in dataclasses.asdict(ref.cfg0).items()
              if k in names}
    cfg = port_config.BoostConfig(**{**fields, "data_path": str(tmp_path),
                                     "crop_list": f"{H}_{W}",
                                     "outf": str(tmp_path / "port")})
    port = port_trainer.RegressionTrainer(
        cfg, logger=RunLogger(cfg.outf, enable_tb=False), device="cpu")
    want = RefVideoData.from_dir(str(tmp_path), cfg.crop_list, True, True)
    assert (port.video.n, port.video.embed_inter) == (want.n, True) == (5,
                                                                        True)
    np.testing.assert_array_equal(port.video.frames, want.frames)
