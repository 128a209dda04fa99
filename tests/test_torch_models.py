"""The eager PyTorch HNeRV-Boost and its ops against the flax/JAX
reference, fp32 on the CPU, same weights (through the bridge) and inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boosting_nerv_torch.bridge import torch_state_from_flax
from boosting_nerv_torch.config import BoostConfig
from boosting_nerv_torch.models import build_model, decoder_only_params
from boosting_nerv_torch.ops.activations import get_activation
from boosting_nerv_torch.ops.losses import out_img
from boosting_nerv_torch.ops.pe import PEConfig, position_encoding
from boosting_nerv_tpu import config as jax_config
from boosting_nerv_tpu.models import build_model as build_flax_model
from boosting_nerv_tpu.ops import activations as jax_acts
from boosting_nerv_tpu.ops import losses as jax_losses
from boosting_nerv_tpu.ops import pe as jax_pe

rng = np.random.default_rng(11)
TOL = 1e-4  # fp32 on both sides; sums run in another order
# the tiny HNeRV-Boost of tests/test_planar_kernels.py (v5 decode test)
TINY = dict(
    model="HNeRV_Boost", embed="pe_1.25_20", fc_dim=12,
    dec_strds=[2, 2], dec_blks=[1, 2], ks="0_1_5",
    conv_type=["convnext", "pshuffel_3x3"], act="sin", norm="none",
    sft_block="res_sft", ch_t=8, reduce=1.2, lower_width=4,
    enc_strds=[2, 2], enc_dim="8_4")


def _cfg():
    return BoostConfig(**TINY)


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
def pair():
    cfg = _cfg()
    fmodel = build_flax_model(jax_config.BoostConfig(**TINY))
    params = _flax_params(fmodel, seed=1)
    img = rng.uniform(size=(1, 16, 16, 3)).astype(np.float32)
    tmodel = build_model(cfg, device="cpu")
    tmodel.load_state_dict(torch_state_from_flax(params, cfg))
    return cfg, fmodel, params, tmodel, img


def test_encode_matches_flax(pair):
    _, fmodel, params, tmodel, img = pair
    want = np.asarray(fmodel.apply(params, jnp.asarray(img), method="encode"))
    with torch.no_grad():
        got = tmodel.encode(torch.from_numpy(img)).numpy()
    assert got.shape == want.shape == (1, 4, 4, 4)
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("t", [0.05, 0.4, 1.0])
def test_decode_matches_flax(pair, t):
    _, fmodel, params, tmodel, img = pair
    embed = rng.normal(size=(1, 4, 4, 4)).astype(np.float32)
    tt = np.array([t], np.float32)
    want = np.asarray(fmodel.apply(params, jnp.asarray(embed),
                                   jnp.asarray(tt), method="decode"))
    with torch.no_grad():
        got = tmodel.decode(torch.from_numpy(embed),
                            torch.from_numpy(tt)).numpy()
    assert got.shape == want.shape == (1, 16, 16, 3)
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("spec", ["pe_1.25_20", "pe_1.25_80", "pe_2_16"])
def test_position_encoding_matches_jax(spec):
    t = np.linspace(0.0, 1.0, 33).astype(np.float32)
    got = position_encoding(torch.from_numpy(t), PEConfig.from_string(spec))
    want = jax_pe.position_encoding(jnp.asarray(t),
                                    jax_pe.PEConfig.from_string(spec))
    assert got.shape == want.shape
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-6


def test_pe_1_25_80_has_160_features():
    assert PEConfig.from_string("pe_1.25_80").embed_length == 160


@pytest.mark.parametrize("name", sorted(jax_acts._ACTS))
def test_activations_match_jax(name):
    x = rng.normal(size=(64,)).astype(np.float32) * 4
    got = get_activation(name)(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_acts.get_activation(name)(jnp.asarray(x)))
    assert np.abs(got - want).max() <= 1e-6


def test_ressin_raises_key_error_like_the_reference():
    with pytest.raises(KeyError):
        get_activation("ressin")


@pytest.mark.parametrize("out_bias", ["tanh", "sigmoid", "0.5"])
def test_out_img_matches_jax(out_bias):
    x = rng.normal(size=(2, 3, 4, 3)).astype(np.float32) * 3
    got = out_img(torch.from_numpy(x), out_bias).numpy()
    want = np.asarray(jax_losses.out_img(jnp.asarray(x), out_bias))
    assert np.abs(got - want).max() <= 1e-6


def test_seeded_init_is_deterministic_and_torch_default():
    a = build_model(_cfg(), seed=3, device="cpu").state_dict()
    b = build_model(_cfg(), seed=3, device="cpu").state_dict()
    c = build_model(_cfg(), seed=4, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["head.weight"], c["head.weight"])
    w = a["blocks.2.rsft.conv0.weight"]           # fan_in 9 * C
    assert w.abs().max() <= w[0].numel() ** -0.5
    d = a["encoder.blocks.0.fc1.weight"]          # trunc_normal(0.02)
    assert d.abs().max() <= 0.04 and 0.01 < d.std() < 0.03
    assert torch.equal(a["encoder.blocks.0.gamma"],
                       torch.full_like(a["encoder.blocks.0.gamma"], 1e-6))


def test_decoder_only_params_drops_the_encoder():
    state = build_model(_cfg(), device="cpu").state_dict()
    dec = decoder_only_params(state)
    assert dec and not any(k.startswith("encoder.") for k in dec)
    assert len(dec) + sum(k.startswith("encoder.") for k in state) == len(
        state)


def test_build_model_defaults_to_the_card():
    import inspect

    assert inspect.signature(build_model).parameters["device"].default == \
        "cuda"
