"""Checkpoints between the packages on the CPU: the bridge's two
directions are inverse, the JAX trainer reads a checkpoint of the port
(``load_checkpoint`` + ``tree_restore``) and the port one of the JAX
trainer, each giving the other's output; the port's ``train`` writes
``model_latest.ckpt`` and resumes from it."""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boosting_nerv_torch.bridge import (flax_params_from_torch_state,
                                        torch_state_from_flax)
from boosting_nerv_torch.config import BoostConfig
from boosting_nerv_torch.data import VideoData, synthetic_video
from boosting_nerv_torch.models import build_model
from boosting_nerv_torch.training import checkpoint as port_ckpt
from boosting_nerv_torch.training.trainer import RegressionTrainer
from boosting_nerv_torch.utils.logger import RunLogger
from boosting_nerv_tpu import config as jax_config
from boosting_nerv_tpu.models import build_model as build_flax_model
from boosting_nerv_tpu.training import checkpoint as ref_ckpt
from test_torch_bridge import TINY, _flax_params

OUT_ATOL = 1e-5   # float32 frames in [0, 1] through both frameworks


@pytest.fixture(scope="module")
def flax_model():
    model = build_flax_model(jax_config.BoostConfig(**TINY))
    return model, jax.jit(model.apply)


def _inputs():
    r = np.random.default_rng(1)
    return (r.uniform(size=(2, 16, 16, 3)).astype(np.float32),
            np.array([0.3, 0.8], np.float32))


def _port_out(model, img, t):
    with torch.no_grad():
        return model(torch.from_numpy(img), torch.from_numpy(t)).numpy()


def test_flax_torch_flax_round_trip_is_identity(flax_model):
    cfg = BoostConfig(**TINY)
    params = {"params": _flax_params(flax_model[0], seed=2)["params"]}
    back = flax_params_from_torch_state(torch_state_from_flax(params, cfg),
                                        cfg)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(params)
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(params),
                                jax.tree_util.tree_leaves_with_path(back)):
        assert pa == pb and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    state = build_model(cfg, seed=4, device="cpu").state_dict()
    again = torch_state_from_flax(flax_params_from_torch_state(state, cfg),
                                  cfg)
    assert again.keys() == state.keys()
    for k in state:
        assert torch.equal(again[k], state[k]), k


def test_jax_reads_a_port_checkpoint(tmp_path, flax_model):
    model, apply = flax_model
    cfg = BoostConfig(**TINY)
    port = build_model(cfg, seed=5, device="cpu")
    opt = torch.optim.SGD(port.parameters(), lr=0.1, momentum=0.9)
    port(*map(torch.from_numpy, _inputs())).mean().backward()
    opt.step()  # an optimizer state to save
    path = str(tmp_path / "port.ckpt")
    port_ckpt.save_checkpoint(path, 7, port, cfg, opt, extra={"k": 1})

    ck = ref_ckpt.load_checkpoint(path)
    assert (ck["epoch"], ck["extra"]) == (7, {"k": 1})
    leaves = jax.tree_util.tree_leaves((ck["params"], ck["opt_state"]))
    assert all(isinstance(x, (np.ndarray, int, float, bool, type(None)))
               for x in leaves)
    template = jax.eval_shape(model.init, jax.random.key(0),
                              jnp.zeros((1, 16, 16, 3)), jnp.array([0.4]))
    params = ref_ckpt.tree_restore(template, ck["params"])
    img, t = _inputs()
    np.testing.assert_allclose(np.asarray(apply(params, img, t)),
                               _port_out(port, img, t), atol=OUT_ATOL,
                               rtol=0)


def test_port_reads_a_jax_checkpoint(tmp_path, flax_model):
    model, apply = flax_model
    cfg = BoostConfig(**TINY)
    params = _flax_params(model, seed=6)
    path = str(tmp_path / "jax.ckpt")
    ref_ckpt.save_checkpoint(path, 3, params)
    port = build_model(cfg, seed=None, device="cpu")
    ck = port_ckpt.load_checkpoint(path)
    port_ckpt.restore(port, ck, cfg)
    img, t = _inputs()
    np.testing.assert_allclose(_port_out(port, img, t),
                               np.asarray(apply(params, img, t)),
                               atol=OUT_ATOL, rtol=0)
    with open(path, "rb") as f:
        bad = pickle.load(f)
    del bad["params"]["params"]["head"]
    with pytest.raises(RuntimeError, match="head"):
        port_ckpt.restore(port, bad, cfg)


def _tiny_trainer(tmp_path, **kw):
    cfg = BoostConfig(
        model="HNeRV_Boost", embed="pe_1.25_20", fc_hw="2_4", fc_dim=12,
        dec_strds=[2, 2], dec_blks=[1, 1], ks="0_1_5",
        conv_type=["convnext", "pshuffel_3x3"], act="sin", norm="none",
        sft_block="res_sft", ch_t=8, reduce=1.2, lower_width=4,
        enc_strds=[2, 2], enc_dim="8_4", epochs=2, batchSize=2, lr=5e-3,
        loss="L1_freq", eval_freq=1000, outf=str(tmp_path / "run"), **kw)
    return RegressionTrainer(cfg, video=VideoData(synthetic_video(4, 8, 16)),
                             logger=RunLogger(cfg.outf, enable_tb=False),
                             device="cpu")


def test_train_writes_model_latest_and_resumes_from_it(tmp_path):
    first = _tiny_trainer(tmp_path, not_resume=True)
    best = first.train()
    outf = first.cfg.outf
    for name in ("model_latest.ckpt", "epoch2.csv", "args.yaml",
                 "rank0.txt"):
        assert os.path.isfile(os.path.join(outf, name)), name
    assert len(first.train_losses) == 4 and len(first.train_psnr) == 2
    assert best["pred_seen_psnr"] > 0 and first.bits_per_param > 0

    again = _tiny_trainer(tmp_path, not_resume=False)
    again.maybe_resume()
    assert again.start_epoch == 2
    want = first.model.state_dict()
    for k, v in again.model.state_dict().items():
        assert torch.equal(v, want[k]), k
