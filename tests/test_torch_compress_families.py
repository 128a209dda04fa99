"""The port's CEM finetune on the CPU beyond the two families held to JAX
(``test_torch_compress_trainer*.py``): the flax view of every parameter
(``bridge.flax_view`` / ``torch_view``, the layout the quantisers see),
and port-only CEM steps of HNeRV and E-NeRV-Boost with their compression
recipes' quantiser flags (scripts/compression/{hnerv,enerv_boost}.sh) and
of HNeRV-Boost with the CLI's default quantisers per channel, each on the
noise of its own generator, then its coding eval.  Tiny configs (8x16
frames, the L2 loss: the recipes' MS-SSIM losses need larger frames).
"""

import numpy as np
import pytest
import torch

from boosting_nerv_torch.bridge import (flax_key,
                                        flax_params_from_torch_state,
                                        flax_view, quantizable_leaves,
                                        torch_view)
from boosting_nerv_torch.config import BoostConfig
from boosting_nerv_torch.data import VideoData, synthetic_video
from boosting_nerv_torch.training.compress_trainer import CompressionTrainer
from boosting_nerv_torch.utils.logger import RunLogger
from test_torch_compress_trainer import one_torch_thread  # noqa: F401

TINY = dict(
    embed="pe_1.25_20", fc_hw="2_4", fc_dim=12, dec_strds=[2, 2],
    dec_blks=[1, 1], ks="0_1_5", conv_type=["convnext", "pshuffel_3x3"],
    act="sin", norm="none", sft_block="res_sft", ch_t=8, block_dim=16,
    reduce=1.2, lower_width=4, enc_strds=[2, 2], enc_dim="8_4", enc_blks=1,
    batchSize=2, loss="L2", eval_freq=1000, not_resume=True,
    optim_type="Adan", epochs=1, lr=5e-4, lr_type="cosine_0_1_0.1",
    quant=True, quant_model_bit=8, quant_bias_bit=8, quant_embed_bit=8)
RECIPES = {  # scripts/compression/*.sh's quantiser flags, and a per-channel
    "HNeRV": dict(model="HNeRV", act="gelu", sft_block="none",
                  quantizer_w="scale", quantizer_b="scale",
                  quantizer_e="scalebeta", embed_entropy=True,
                  lambda_rate=0.2, target_bit=4),
    "ENeRV_Boost": dict(model="ENeRV_Boost", quantizer_w="scale",
                        quantizer_b="scale", lambda_rate=0.2, target_bit=4,
                        clip_max_norm=1.0),
    "HNeRV_Boost_per_channel": dict(
        model="HNeRV_Boost", per_channel_w=True, per_channel_b=True,
        per_channel_e=True, embed_entropy=True, lambda_rate=0.05,
        target_bit=4),
}


def _trainer(tmp_path, **kw):
    cfg = BoostConfig(**{**TINY, "outf": str(tmp_path), **kw})
    return CompressionTrainer(cfg, video=VideoData(synthetic_video(4, 8, 16)),
                              logger=RunLogger(cfg.outf, enable_tb=False),
                              device="cpu")


@pytest.mark.parametrize("model", ["HNeRV_Boost", "NeRV_Boost",
                                   "ENeRV_Boost"])
def test_flax_view_is_the_bridges_layout_and_torch_view_its_inverse(
        tmp_path, model):
    tr = _trainer(tmp_path, model=model)
    state = tr.model.state_dict()
    tree = flax_params_from_torch_state(state, tr.cfg)
    for name, t in state.items():
        node = tree
        for p in flax_key(name, tr.cfg).split("/"):
            node = node[p]
        view = flax_view(name, t, tr.cfg)
        np.testing.assert_array_equal(view.numpy(), node)
        assert torch.equal(torch_view(name, view, tr.cfg), t)
    leaves = quantizable_leaves(state, tr.cfg)
    assert leaves == sorted(leaves)
    assert all("encoder" not in k and k.split("/")[-1] in ("kernel", "bias")
               for k, _ in leaves)
    # every quantised leaf's gradient comes back through the view
    name = leaves[0][1]
    p = dict(tr.model.named_parameters())[name]
    w = torch.randn(flax_view(name, p, tr.cfg).shape)
    (flax_view(name, p, tr.cfg) * w).sum().backward()
    assert torch.equal(p.grad, torch_view(name, w, tr.cfg))


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_port_only_cem_steps_and_coding_eval(tmp_path, recipe):
    tr = _trainer(tmp_path, **RECIPES[recipe])
    tr.maybe_resume()
    tr.init_qparams()
    assert (tr.embed_qp is not None) == tr.has_embed
    before = [v.detach().clone() for v in tr.qp_tensors()]
    losses = []
    for idx in ([0, 1], [2, 3]):
        loss, psnr, bpp = tr.cem_step_idx(idx, tr.video.norm_idx(
            np.asarray(idx)), tr.cfg.lr)
        losses.append(float(loss))
        assert psnr.shape == (2,) and float(bpp) > 0
        # the rate term is on: bpp a frame above the target
        assert float(bpp) / tr.video.n > tr.target_bpp
    assert all(np.isfinite(losses))
    moved = [not torch.equal(a, b.detach())
             for a, b in zip(before, tr.qp_tensors())]
    assert any(moved)
    res = tr.evaluate_cem(coding=True)
    assert all(np.isfinite(v) for v in res.values())
    assert res["quant_seen_psnr"] > 0
    assert 0.5 < tr.total_bpp / tr.estimate_bpp < 2.0
