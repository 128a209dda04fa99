"""flax -> torch parameter bridge: every leaf maps, layouts convert, and the
PixelShuffle channel order is reconciled with the JAX depth_to_space."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax import lax

from boosting_nerv_torch.bridge import torch_state_from_flax
from boosting_nerv_torch.config import BoostConfig
from boosting_nerv_torch.models import build_model
from boosting_nerv_torch.ops.pixelshuffle import jax_to_torch_shuffle_perm
from boosting_nerv_tpu import config as jax_config
from boosting_nerv_tpu.models import build_model as build_flax_model
from boosting_nerv_tpu.ops.pixelshuffle import depth_to_space

rng = np.random.default_rng(7)
# the tiny HNeRV-Boost of tests/test_planar_kernels.py (v5 decode test)
TINY = dict(
    model="HNeRV_Boost", embed="pe_1.25_20", fc_dim=12,
    dec_strds=[2, 2], dec_blks=[1, 2], ks="0_1_5",
    conv_type=["convnext", "pshuffel_3x3"], act="sin", norm="none",
    sft_block="res_sft", ch_t=8, reduce=1.2, lower_width=4,
    enc_strds=[2, 2], enc_dim="8_4")


def _flax_params(model, seed):
    """flax params of ``model`` drawn with numpy from ``seed`` (no jax
    compile): conv/dense kernels U(+-1/sqrt(fan_in)) as torch's default,
    biases U(+-0.1), LayerNorm scales near 1 and layer-scale gammas near
    0.5 so that every encoder block moves its output."""
    r = np.random.default_rng(seed)
    shapes = jax.eval_shape(model.init, jax.random.key(0),
                            jnp.zeros((1, 16, 16, 3)), jnp.array([0.4]))

    def draw(path, s):
        name = path[-1].key
        if name == "kernel":
            b = float(np.prod(s.shape[:-1])) ** -0.5
            return r.uniform(-b, b, s.shape).astype(np.float32)
        if name == "scale":
            return (1 + 0.1 * r.normal(size=s.shape)).astype(np.float32)
        if name == "gamma":
            return r.uniform(0.3, 0.7, s.shape).astype(np.float32)
        return r.uniform(-0.1, 0.1, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def flax_params():
    return BoostConfig(**TINY), _flax_params(
        build_flax_model(jax_config.BoostConfig(**TINY)), seed=0)


def _n_leaves(tree):
    return len(jax.tree_util.tree_leaves(tree))


def test_every_flax_leaf_maps_to_a_torch_parameter(flax_params):
    cfg, params = flax_params
    state = torch_state_from_flax(params, cfg)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state, strict=True)  # no missing, no unexpected
    assert len(state) == _n_leaves(params) == len(model.state_dict())


@pytest.mark.parametrize("path,name,transform", [
    (("stem", "ResBlockSFT_0", "TConv_0", "Conv_0", "kernel"),
     "stem.rsft.conv0.weight", lambda a: a.transpose(3, 2, 0, 1)),
    (("encoder", "ConvNeXtBlock_1", "Conv_0", "kernel"),
     "encoder.blocks.1.dwconv.weight", lambda a: a.transpose(3, 2, 0, 1)),
    (("stem_t", "TDense_1", "Dense_0", "kernel"),
     "stem_t.layers.1.weight", lambda a: a.T),
    (("encoder", "LayerNorm_1", "scale"), "encoder.norms.1.weight",
     lambda a: a),
    # SFTLayer: flax numbers the outer projections first
    (("blocks_2", "ResBlockSFT_0", "SFTLayer_1", "TDense_0", "Dense_0",
      "kernel"), "blocks.2.rsft.sft1.scale_out.weight", lambda a: a.T),
    (("blocks_2", "ResBlockSFT_0", "SFTLayer_1", "TDense_3", "Dense_0",
      "bias"), "blocks.2.rsft.sft1.shift_in.bias", lambda a: a),
])
def test_leaf_layouts(flax_params, path, name, transform):
    cfg, params = flax_params
    leaf = params["params"]
    for k in path:
        leaf = leaf[k]
    state = torch_state_from_flax(params, cfg)
    np.testing.assert_array_equal(state[name].numpy(), transform(leaf))


def test_shuffle_permutation_matches_depth_to_space():
    c, r = 5, 2
    y = rng.normal(size=(1, 3, 4, r * r * c)).astype(np.float32)
    want = np.asarray(depth_to_space(jnp.asarray(y), r))
    perm = jax_to_torch_shuffle_perm(c, r)
    got = F.pixel_shuffle(torch.from_numpy(y[..., perm]).permute(0, 3, 1, 2),
                          r)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_bridged_upconv_matches_jax_upconv(flax_params):
    cfg, params = flax_params
    conv = params["params"]["blocks_1"]["UpConv_0"]["TConv_0"]["Conv_0"]
    x = rng.normal(size=(1, 6, 7, conv["kernel"].shape[2])).astype(np.float32)
    y = lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(conv["kernel"]), (1, 1), [(1, 1), (1, 1)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=lax.Precision.HIGHEST) + conv["bias"]
    want = np.asarray(depth_to_space(y, 2))
    state = torch_state_from_flax(params, cfg)
    got = F.pixel_shuffle(F.conv2d(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        state["blocks.1.conv.conv.weight"], state["blocks.1.conv.conv.bias"],
        padding=1), 2).permute(0, 2, 3, 1).numpy()
    assert np.abs(got - want).max() < 1e-5


def test_bridged_sft_vectors_match_jax(flax_params):
    from boosting_nerv_tpu.runtime.fast_decode import _sft_vectors

    cfg, params = flax_params
    model = build_model(cfg, device="cpu")
    model.load_state_dict(torch_state_from_flax(params, cfg))
    cond = rng.normal(size=(1, cfg.ch_t)).astype(np.float32)
    want = _sft_vectors(
        jax.tree_util.tree_map(jnp.asarray,
                               params["params"]["blocks_0"]["ResBlockSFT_0"]),
        jnp.asarray(cond))
    rsft = model.blocks[0].rsft
    with torch.no_grad():
        got = [layer.vectors(torch.from_numpy(cond))
               for layer in (rsft.sft0, rsft.sft1)]
    for (gs, gh), (ws, wh) in zip(got, want):
        assert np.abs(gs.numpy() - np.asarray(ws)).max() < 1e-5
        assert np.abs(gh.numpy() - np.asarray(wh)).max() < 1e-5


def test_load_flax_checkpoint(flax_params, tmp_path):
    from boosting_nerv_torch.training.checkpoint import load_checkpoint
    from boosting_nerv_tpu.training.checkpoint import save_checkpoint

    cfg, params = flax_params
    path = str(tmp_path / "model_latest.ckpt")
    save_checkpoint(path, 3, params, extra={"note": "x"})
    ckpt = load_checkpoint(path)
    assert ckpt["epoch"] == 3 and ckpt["extra"] == {"note": "x"}
    got = torch_state_from_flax(ckpt["params"], cfg)
    want = torch_state_from_flax(params, cfg)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
