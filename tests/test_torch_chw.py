"""The v1 decode of the port on the CPU: the plain versions of
``conv3x3_act_chw``, ``head_conv_chw`` (``ops.kernels.conv_chw``) and
``resblock_sft_chw`` (``ops.kernels.fused_sft``) against the Pallas kernels
of ``boosting_nerv_tpu/ops/pallas/conv_chw.py`` and ``fused_sft.py`` in
interpret mode; the v1 ``build_fast_decode`` against the JAX one (Pallas in
interpret mode) and the flax decode; its stage selection at the UVG-1080p
bench config; and the wrappers' contract.  Inputs come from numpy seeds; a
model's weights reach both packages through ``bridge.torch_state_from_flax``.
The CUDA kernels run only on the card: chip_smoke.py holds them against
these plain versions there.

Tolerances: a wrapper's plain version (float32 on bf16-rounded inputs,
bf16-exact biases) is within 2e-2 * max(|Pallas|, 1) of the Pallas kernel,
which stores bf16; the v1 decode is within 4e-3 max abs of the JAX v1
decode (both in bf16, frames in [0, 1]) and within 2e-2 of flax
(tests/test_fast_decode.py's bound)."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boosting_nerv_torch import config as port_config
from boosting_nerv_torch.bridge import torch_state_from_flax
from boosting_nerv_torch.models import build_model
from boosting_nerv_torch.ops.kernels import LAUNCHES, conv_chw, fused_sft
from boosting_nerv_torch.runtime import fast_decode as port_fd
from boosting_nerv_tpu import config as jax_config
from boosting_nerv_tpu.models import build_model as build_flax_model
from boosting_nerv_tpu.ops.pallas import conv_chw as jcc
from boosting_nerv_tpu.ops.pallas import fused_sft as jfs
from boosting_nerv_tpu.runtime import fast_decode as jax_fd

rng = np.random.default_rng(23)
WRAPPER_TOL = 2e-2   # x max(|Pallas|, 1)
JAX_TOL = 4e-3       # v1 decode vs the JAX v1 decode, max abs
FLAX_TOL = 2e-2      # v1 decode vs flax (tests/test_fast_decode.py:41)
C, W = 8, 128        # tests/test_pallas_kernels.py's shape
# the tiny HNeRV-Boost of tests/test_torch_tile.py on a 1x64 fc grid:
# stage widths 128, 256, 256 are multiples of 128, so the JAX v1 decode
# (w_align 1 in interpret mode) and the port (the 128 rule) both switch at
# stage 0 for pallas_from_h=2 (stage heights 2, 4, 4 on a 4x256 frame)
V1 = dict(
    model="HNeRV_Boost", embed="pe_1.25_20", fc_dim=12, fc_hw="1_64",
    dec_strds=[2, 2], dec_blks=[1, 2], ks="0_1_5",
    conv_type=["convnext", "pshuffel_3x3"], act="sin", norm="none",
    sft_block="res_sft", ch_t=8, reduce=1.2, lower_width=4,
    enc_strds=[2, 2], enc_dim="8_4")
BENCH = dict(  # bench.py's UVG-1080p serving config
    model="HNeRV_Boost", embed="pe_1.25_80", enc_strds=[5, 3, 2, 2, 2],
    enc_dim="64_16", dec_strds=[5, 3, 2, 2, 2], dec_blks=[1, 1, 2, 2, 2],
    ks="0_1_5", reduce=1.2, lower_width=12, modelsize=2.8,
    conv_type=["convnext", "pshuffel_3x3"], act="sin", norm="none",
    sft_block="res_sft", ch_t=32)


def _bf16(a):
    """numpy float32 rounded to bf16 (the Pallas kernels' operand type)."""
    return np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _rand(*shape, s=1.0):
    return _bf16(rng.normal(size=shape).astype(np.float32) * s)


def _w9(hwio):
    """HWIO (3, 3, Cin, Cout) -> the Pallas taps (9, Cout, Cin), bf16."""
    k = hwio.transpose(0, 1, 3, 2).reshape(9, hwio.shape[3], hwio.shape[2])
    return jnp.asarray(k, jnp.bfloat16)


def _ohwi(hwio):
    return torch.from_numpy(np.ascontiguousarray(hwio.transpose(3, 0, 1, 2)))


def _chw(x_nhwc):
    return jnp.asarray(x_nhwc[0].transpose(2, 0, 1), jnp.bfloat16)


def _nhwc(out_chw):
    return np.asarray(out_chw.astype(jnp.float32)).transpose(1, 2, 0)[None]


def _close(got, want, tol=WRAPPER_TOL):
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err < tol * max(float(np.abs(want).max()), 1.0), err


# --------------------------------------------------------------------- #
# the wrappers' plain versions against the Pallas kernels
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("name,co,h", [
    ("conv3x3_act_chw", 12, 13), ("head_conv_chw", 3, 16)])
def test_conv_plain_matches_pallas(name, co, h):
    x, kern, bias = _rand(1, h, W, C, s=2.0), _rand(3, 3, C, co, s=0.3), \
        _rand(co, s=0.1)
    want = _nhwc(getattr(jcc, name)(_chw(x), _w9(kern), jnp.asarray(bias),
                                    interpret=True))
    got = getattr(conv_chw, name + "_plain")(
        torch.from_numpy(x), _ohwi(kern), torch.from_numpy(bias))
    _close(got.numpy(), want)


@pytest.mark.parametrize("input_sin,h", [(False, 16), (True, 13)])
def test_resblock_sft_plain_matches_pallas(input_sin, h):
    """With ``input_sin`` the block input and the residual are sin(x)."""
    x = _rand(1, h, W, C, s=2.0)
    w0, w1 = _rand(3, 3, C, C, s=0.2), _rand(3, 3, C, C, s=0.2)
    b0, b1 = _rand(C, s=0.1), _rand(C, s=0.1)
    sft = [rng.normal(size=(C,)).astype(np.float32) * 0.3 for _ in range(4)]
    want = _nhwc(jfs.resblock_sft_chw(
        _chw(x), _w9(w0), jnp.asarray(b0), _w9(w1), jnp.asarray(b1),
        *map(jnp.asarray, sft), interpret=True, input_sin=input_sin))
    got = fused_sft.resblock_sft_chw_plain(
        torch.from_numpy(x), _ohwi(w0), torch.from_numpy(b0), _ohwi(w1),
        torch.from_numpy(b1), torch.from_numpy(np.stack(sft)),
        input_sin=input_sin)
    _close(got.numpy(), want)
    # x (s = 2) and sin(x) differ far beyond the tolerance, so a block that
    # added x instead of sin(x) as its residual would fail above
    assert np.abs(np.sin(x) - x).max() > 10 * WRAPPER_TOL * max(
        float(np.abs(want).max()), 1.0)


# --------------------------------------------------------------------- #
# the wrappers' contract
# --------------------------------------------------------------------- #

def _small(name):
    g = torch.Generator().manual_seed(1)
    r = lambda *s: torch.rand(*s, generator=g) - 0.5  # noqa: E731
    c = 5
    x = r(1, 6, 7, c)
    if name == "resblock_sft_chw":
        return x, (r(c, 3, 3, c), r(c), r(c, 3, 3, c), r(c), r(4, c))
    co = 3 if name == "head_conv_chw" else 4
    return x, (r(co, 3, 3, c), r(co))


NAMES = ["conv3x3_act_chw", "head_conv_chw", "resblock_sft_chw"]


def _fn(name, plain=False):
    module = fused_sft if name == "resblock_sft_chw" else conv_chw
    return getattr(module, name + ("_plain" if plain else ""))


@pytest.mark.parametrize("name", NAMES)
def test_wrapper_runs_the_plain_version_on_cpu(name):
    x, args = _small(name)
    before = dict(LAUNCHES)
    kws = [{}, {"input_sin": True}] if name == "resblock_sft_chw" else [{}]
    for kw in kws:
        assert torch.equal(_fn(name)(x, *args, **kw),
                           _fn(name, plain=True)(x, *args, **kw))
    assert LAUNCHES == before  # counts kernel launches only


@pytest.mark.parametrize("name", NAMES)
def test_wrapper_raises_off_cpu_and_cuda(name):
    x, args = _small(name)
    with pytest.raises(ValueError, match="device"):
        _fn(name)(x.to("meta"), *args)


@pytest.mark.parametrize("bad", ["kernel_size", "bias", "channels", "sft"])
def test_wrapper_checks_its_inputs(bad):
    x, (w, b) = _small("conv3x3_act_chw")
    xr, (w0, b0, w1, b1, sft) = _small("resblock_sft_chw")
    call = {
        "kernel_size": lambda: conv_chw.conv3x3_act_chw(
            x, w[:, :1, :1].contiguous(), b),
        "bias": lambda: conv_chw.head_conv_chw(x, w, b[:3]),
        "channels": lambda: conv_chw.conv3x3_act_chw(x[..., :3], w, b),
        "sft": lambda: fused_sft.resblock_sft_chw(xr, w0, b0, w1, b1,
                                                  sft[:, :3]),
    }[bad]
    with pytest.raises(ValueError):
        call()


# --------------------------------------------------------------------- #
# the v1 decode
# --------------------------------------------------------------------- #

def _flax_params(model, seed, h, w):
    """flax params drawn with numpy from ``seed`` (no jax compile):
    kernels U(+-1/sqrt(fan_in)), biases U(+-0.1), LayerNorm scales near 1,
    layer-scale gammas in [0.3, 0.7]."""
    r = np.random.default_rng(seed)
    shapes = jax.eval_shape(model.init, jax.random.key(0),
                            jnp.zeros((1, h, w, 3)), jnp.array([0.4]))

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
def v1():
    """(port cfg, JAX cfg, flax params, port state, embed, t, flax frame)
    of the V1 model on one 4x256 frame."""
    cfg, jcfg = port_config.BoostConfig(**V1), jax_config.BoostConfig(**V1)
    fmodel = build_flax_model(jcfg)
    params = _flax_params(fmodel, 6, 4, 256)
    img = jnp.asarray(rng.uniform(size=(1, 4, 256, 3)).astype(np.float32))
    t = jnp.array([0.4])
    embed = jax.jit(partial(fmodel.apply, method="encode"))(params, img)
    flax_out = np.asarray(jax.jit(partial(fmodel.apply, method="decode"))(
        params, embed, t))
    return (cfg, jcfg, params, torch_state_from_flax(params, cfg),
            np.array(embed), np.array(t, np.float32), flax_out)


def _serve(dec, embed, t):
    """One frame on the CPU, which launches no kernel."""
    before = dict(LAUNCHES)
    out = dec(torch.from_numpy(embed), torch.from_numpy(t))
    assert LAUNCHES == before
    assert out.dtype == torch.bfloat16
    return out.float().numpy()


def _jax(dec, embed, t):
    """The JAX decode, jitted as one program (eager dispatch of its XLA ops
    costs seconds on the CPU)."""
    return np.asarray(jax.jit(dec)(jnp.asarray(embed), jnp.asarray(t)
                                   ).astype(jnp.float32))


@pytest.mark.parametrize("pallas_from_h", [2, 10 ** 9],
                         ids=["kernels", "all_torch"])
def test_v1_decode_matches_jax_and_flax(v1, pallas_from_h):
    cfg, jcfg, params, state, embed, t, flax_out = v1
    dec = port_fd.build_fast_decode(cfg, state, pallas_from_h)
    if pallas_from_h == 2:
        # stage 0 switches (upconv in torch, its ResBlockSFT with the sin
        # fused in), stages 1-2 on conv3x3_act_chw, the head on head_conv_chw
        assert dec.switch_at == 0
        assert [st.upconv is not None for st in dec.chw.stages] == [
            True, False, False]
        assert dec.launches_per_frame == {
            "conv3x3_act_chw": 2, "resblock_sft_chw": 3, "head_conv_chw": 1}
    else:  # no stage qualifies: the whole decode in plain torch
        assert (dec.switch_at, dec.chw, dec.launches_per_frame) == (3, None,
                                                                     {})
    out = _serve(dec, embed, t)
    jdec = jax_fd.build_fast_decode(jcfg, params, pallas_from_h,
                                    interpret=True)
    want = _jax(jdec, embed, t)
    assert out.shape == want.shape == (1, 4, 256, 3)
    assert np.abs(out - want).max() < JAX_TOL
    assert np.abs(out - flax_out).max() < FLAX_TOL
    plain = port_fd.build_fast_decode(cfg, state, pallas_from_h, plain=True)
    assert np.array_equal(_serve(plain, embed, t), out)  # CPU: both plain


def test_v1_decode_rejects_unsupported_config():
    cfg = port_config.BoostConfig(**V1).replace(act="gelu")
    with pytest.raises(ValueError, match="HNeRV-Boost paper config"):
        port_fd.build_fast_decode(cfg, {})


def test_v1_switch_at_the_bench_config():
    """Fine widths 480 and 960 are not multiples of 128 (the TPU lane rule
    the port keeps), so the v1 tail starts at stage 6 (1080x1920) for any
    pallas_from_h in (0, 1080]; above 1080 no stage qualifies."""
    cfg = port_config.resolve_sizes(port_config.BoostConfig(**BENCH),
                                    final_size=1920 * 1080,
                                    full_data_length=120)
    model = build_model(cfg, seed=None, device="cpu")
    for h in (270, 512, 1080):
        dec = port_fd.build_fast_decode(cfg, model, h)
        assert dec.switch_at == 6, h
        assert [st.index for st in dec.chw.stages] == [6, 7]
        assert dec.launches_per_frame == {
            "conv3x3_act_chw": 1, "resblock_sft_chw": 2, "head_conv_chw": 1}
    assert port_fd.v1_switch(cfg, 1) == 6
    assert port_fd.v1_switch(cfg, 1081) == 8
