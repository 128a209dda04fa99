"""The blocks of the other model families against their flax modules, on
the CPU: every UpConv and DownConv kind, the transposed conv, the in / bn
norms, both ConvUpBlock branches, a NeRVBlock's norm and its legacy fc_hw
rearrange, the JAX packing of space_to_depth, and HNeRV's NeRVBlock
encoder, each within 1e-5 (float32).

The JAX HNeRV with a NeRVBlock (non-ConvNeXt) encoder does not run: flax
turns the encoder list of its ``setup`` into a tuple, which its ``encode``
then calls (``boosting_nerv_tpu/models/hnerv.py:138-142``).  So the port's
NeRVBlock encoder is held to the flax NeRVBlocks applied in turn.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boosting_nerv_torch import bridge
from boosting_nerv_torch.config import BoostConfig
from boosting_nerv_torch.models import blocks, build_model
from boosting_nerv_torch.ops.pixelshuffle import (jax_to_torch_shuffle_perm,
                                                  space_to_depth)
from boosting_nerv_tpu.models import blocks as jblocks
from boosting_nerv_tpu.ops.pixelshuffle import space_to_depth as j_s2d
from test_torch_families import TOL, tiny

def _conv_leaf(p, transposed=False):
    k = np.asarray(p["kernel"])
    w = k.transpose(2, 3, 0, 1) if transposed else k.transpose(3, 2, 0, 1)
    return torch.from_numpy(np.ascontiguousarray(w)), torch.from_numpy(
        np.asarray(p["bias"]))


def _load(conv, p, transposed=False, out_perm=None, in_perm=None):
    w, b = _conv_leaf(p, transposed)
    if out_perm is not None:
        w, b = w[out_perm], b[out_perm]
    if in_perm is not None:
        w = w[:, in_perm]
    with torch.no_grad():
        conv.weight.copy_(w)
        conv.bias.copy_(b)


def _load_updown(mod, p, conv_type, strd, up):
    """The flax UpConv_0 / DownConv_0 tree ``p`` into the torch module."""
    if conv_type == "conv" and up:
        return _load(mod.conv, p["TConvTranspose_0"], transposed=True)
    inner = p["TConv_0"]["Conv_0"]
    out_perm = in_perm = None
    if conv_type.startswith("pshuffel") and strd > 1:
        c = np.asarray(inner["kernel"]).shape[3 if up else 2] // strd ** 2
        perm = jax_to_torch_shuffle_perm(c, strd)
        out_perm, in_perm = (perm, None) if up else (None, perm)
    _load(mod.conv, inner, out_perm=out_perm, in_perm=in_perm)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _flax(jm, *args):
    """(params, output) of flax module ``jm`` on numpy ``args``, jitted."""
    args = [jnp.asarray(a) for a in args]
    p = jax.jit(jm.init)(jax.random.PRNGKey(0), *args)["params"]
    return p, np.asarray(jax.jit(jm.apply)({"params": p}, *args))


def _x(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("up,conv_type,ks,strd", [
    (True, "pshuffel", 5, 2), (True, "pshuffel_3x3", 5, 2),
    (True, "conv", 3, 2), (True, "conv", 1, 3), (True, "interpolate", 1, 2),
    (False, "conv", 1, 2), (False, "pshuffel", 3, 2),
    (False, "interpolate", 1, 2), (False, "interpolate", 3, 3)])
def test_updown_conv_matches_flax(up, conv_type, ks, strd):
    """Every UpConv / DownConv kind against flax: PixelShuffle and
    PixelUnshuffle in torch's channel order with the bridge's
    permutations, the transposed conv, and the bilinear resizes (JAX's
    antialiased downsampling included)."""
    cin, cout = 6, 5
    x = _x(2, 12, 18, cin)
    jcls = jblocks.UpConv if up else jblocks.DownConv
    jm = jcls(conv_type=conv_type, new_ngf=cout, ks=ks, strd=strd)
    p, want = _flax(jm, x)
    mod = (blocks.UpConv if up else blocks.DownConv)(conv_type, cin, cout,
                                                     ks, strd)
    _load_updown(mod, p, conv_type, strd, up)
    with torch.no_grad():
        got = _nhwc(mod(_nchw(x)))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL


def test_transposed_conv_matches_flax():
    x = _x(1, 5, 7, 4)
    jm = jblocks.TConvTranspose(features=3, kernel=5, stride=3, pad=2)
    p, want = _flax(jm, x)
    mod = blocks.TConvTranspose(4, 3, 5, 3, 2)
    _load(mod, p, transposed=True)
    with torch.no_grad():
        got = _nhwc(mod(_nchw(x)))
    assert got.shape == want.shape == (1, 13, 19, 3)
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("norm", ["none", "in", "bn"])
def test_norm_layer_matches_flax(norm):
    """The biased variance and rsqrt(var + 1e-5); bn on the batch's
    statistics."""
    x = _x(3, 5, 6, 4) * 3 + 1
    want = np.asarray(jblocks.norm_layer(norm, jnp.asarray(x)))
    got = _nhwc(blocks.norm_layer(norm, _nchw(x)))
    assert np.abs(got - want).max() <= TOL
    with pytest.raises(NotImplementedError):
        blocks.norm_layer("ln", _nchw(x))


def _load_rsft(rsft, p):
    for k in (0, 1):
        sft = p[f"SFTLayer_{k}"]
        for flax_name, torch_name in bridge._SFT_DENSE.items():
            lin = getattr(getattr(rsft, f"sft{k}"), torch_name)
            d = sft[flax_name]["Dense_0"]
            with torch.no_grad():
                lin.weight.copy_(torch.from_numpy(np.asarray(d["kernel"]).T))
                lin.bias.copy_(torch.from_numpy(np.asarray(d["bias"])))
        _load(getattr(rsft, f"conv{k}"), p[f"TConv_{k}"]["Conv_0"])


@pytest.mark.parametrize("ngf,new_ngf", [(8, 12), (16, 6)])
def test_conv_up_block_matches_flax(ngf, new_ngf):
    """Both branches of E-NeRV's stage-0 ConvUpBlock (UpConv to ngf / 4
    then a 3x3 conv, or a 3x3 conv then the UpConv), with its TAT
    block and norm in."""
    x, cond = _x(2, 3, 4, ngf), _x(2, 8, seed=1)
    jm = jblocks.ConvUpBlock(conv_type="pshuffel_3x3", ngf=ngf,
                             new_ngf=new_ngf, ks=3, strd=2, norm="in",
                             act="sin", sft=True)
    p, want = _flax(jm, x, cond)
    mod = blocks.ConvUpBlock("pshuffel_3x3", ngf, new_ngf, 3, 2, norm="in",
                             act="sin", cond_ch=8)
    _load_updown(mod.upconv, p["UpConv_0"], "pshuffel_3x3", 2, True)
    _load(mod.conv, p["TConv_0"]["Conv_0"])
    _load_rsft(mod.rsft, p["ResBlockSFT_0"])
    with torch.no_grad():
        got = _nhwc(mod(_nchw(x), torch.from_numpy(cond)))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("norm", ["in", "bn"])
def test_nerv_block_norm_and_legacy_fc_hw_match_flax(norm):
    """An encoder-less stem NeRVBlock with the legacy fc_hw pixel-block
    rearrange before its TAT block, under each norm."""
    x, cond = _x(2, 1, 1, 6), _x(2, 8, seed=1)
    jm = jblocks.NeRVBlock(dec_block=False, conv_type="conv", new_ngf=24,
                           ks=0, strd=1, norm=norm, act="sin", sft=True,
                           has_encoder=False, fc_hw=(2, 3))
    p, want = _flax(jm, x, cond)
    mod = blocks.NeRVBlock(False, "conv", 6, 24, 0, 1, norm=norm, act="sin",
                           cond_ch=8, has_encoder=False, fc_hw=(2, 3))
    _load_updown(mod.conv, p["DownConv_0"], "conv", 1, False)
    _load_rsft(mod.rsft, p["ResBlockSFT_0"])
    with torch.no_grad():
        got = _nhwc(mod(_nchw(x), torch.from_numpy(cond)))
    assert got.shape == want.shape == (2, 2, 3, 4)
    assert np.abs(got - want).max() <= TOL


def test_space_to_depth_is_the_jax_packing():
    x = _x(2, 6, 8, 5)
    assert np.array_equal(space_to_depth(torch.from_numpy(x), 2).numpy(),
                          np.asarray(j_s2d(jnp.asarray(x), 2)))
    torch_order = torch.nn.functional.pixel_unshuffle(_nchw(x), 2)
    perm = jax_to_torch_shuffle_perm(5, 2)
    assert np.array_equal(_nhwc(torch_order),
                          np.asarray(j_s2d(jnp.asarray(x), 2))[..., perm])


def test_nerv_block_encoder_matches_flax_blocks():
    """HNeRV's NeRVBlock encoder (PixelUnshuffle convs) against the flax
    NeRVBlocks applied in turn, through the bridge's encoder_i names and
    its input-channel permutation."""
    kw = tiny("HNeRV", sft_block="none", enc_strds=[2, 2], enc_dim="8_6",
              ks="3_1_5", conv_type=["pshuffel", "pshuffel_3x3"],
              dec_strds=[2, 2], dec_blks=[1, 1])
    cfg = BoostConfig(**kw)
    x = _x(2, 8, 12, 3)
    tree, h = {}, jnp.asarray(x)
    for i, (d, s) in enumerate(zip([8, 6], cfg.enc_strds)):
        jm = jblocks.NeRVBlock(dec_block=False, conv_type="pshuffel",
                               new_ngf=d, ks=3, strd=s, act="sin")
        tree[f"encoder_{i}"] = jm.init(jax.random.PRNGKey(i), h)["params"]
        h = jm.apply({"params": tree[f"encoder_{i}"]}, h)
    model = build_model(cfg, seed=0, device="cpu")
    state = bridge.torch_state_from_flax(tree, cfg)
    res = model.load_state_dict(state, strict=False)
    assert not res.unexpected_keys
    assert all(not k.startswith("encoder.") for k in res.missing_keys)
    with torch.no_grad():
        got = model.encode(torch.from_numpy(x)).numpy()
    assert np.abs(got - np.asarray(h)).max() <= TOL
    back = bridge.flax_params_from_torch_state(state, cfg)["params"]
    for k, v in bridge._flatten(tree):
        node = back
        for p in k:
            node = node[p]
        assert np.array_equal(node, np.asarray(v))


