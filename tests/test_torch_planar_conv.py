"""The standalone planar entry points of the port on the CPU: the layout
converters (``to_planar``, ``from_planar``, ``upconv_kernel_to_planar``)
against the JAX ones, exactly, and the plain versions of ``conv_planar``
and ``rsft_planar`` (``ops.kernels.planar``) against the Pallas kernels of
``boosting_nerv_tpu/ops/pallas/planar.py`` in interpret mode, at cases of
tests/test_planar_kernels.py; and the wrappers' contract.  Inputs come from
a numpy seed.  The CUDA kernels run only on the card: chip_smoke.py holds
them against these plain versions there.

Tolerance: a plain version (float32 on bf16-rounded inputs, bf16-exact
biases) is within 2e-2 * max(|Pallas|, 1) of the Pallas kernel, which
stores bf16, on the real channels, rows and columns; ``conv_planar``'s pad
channels hold act(0) exactly in both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boosting_nerv_torch.ops.kernels import LAUNCHES, planar
from boosting_nerv_tpu.ops.pallas import planar as jp

rng = np.random.default_rng(29)
TOL = 2e-2   # x max(|Pallas|, 1)
WD = 128     # the planar width: a power of two >= 128
ACT0 = {"none": 0.0, "sin": 0.0, "gelu": 0.0, "outimg": 0.5}


def _bf16(a):
    return np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _rand(*shape, s=1.0):
    return _bf16(rng.normal(size=shape).astype(np.float32) * s)


def _planar_in(c, hc, wc_real, hc_pad=0):
    """A random bf16-exact planar tensor (4 * round16(c), hc + hc_pad, WD)
    of a fine (c, 2 hc, 2 wc_real) one; zero beyond it."""
    xp = np.asarray(jp.to_planar(jnp.asarray(_rand(c, 2 * hc, 2 * wc_real))))
    return np.pad(xp, ((0, 0), (0, hc_pad), (0, WD - wc_real)))


def _fine(out, c, wc_real, hc_real=None):
    """The real region of a planar output as fine (c, 2 hc, 2 wc) float32."""
    out = np.asarray(jnp.asarray(out, jnp.float32))
    return np.asarray(jp.from_planar(jnp.asarray(out[:, :hc_real]), c)
                      )[:, :, :2 * wc_real]


def _close(got, want):
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err < TOL * max(float(np.abs(want).max()), 1.0), err


# --------------------------------------------------------------------- #
# the layout converters
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("c,cp", [(5, None), (17, None), (3, 32)])
def test_converters_match_jax_exactly(c, cp):
    x = rng.normal(size=(c, 8, 12)).astype(np.float32)
    want = np.array(jp.to_planar(jnp.asarray(x), cp))
    got = planar.to_planar(torch.from_numpy(x), cp).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(
        planar.from_planar(torch.from_numpy(want), c).numpy(),
        np.asarray(jp.from_planar(jnp.asarray(want), c)))
    assert np.array_equal(planar.from_planar(torch.from_numpy(got), c).numpy(),
                          x)
    k = rng.normal(size=(3, 3, 6, 4 * c)).astype(np.float32)
    assert np.array_equal(
        planar.upconv_kernel_to_planar(torch.from_numpy(k), cp).numpy(),
        np.asarray(jp.upconv_kernel_to_planar(jnp.asarray(k), cp)))


# --------------------------------------------------------------------- #
# the plain versions against the Pallas kernels
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("c,co,hc,wc_real,act", [
    (5, 7, 6, 64, "none"),
    (5, 7, 6, 50, "sin"),      # ragged coarse width
    (17, 19, 9, 64, "gelu"),   # cp = 32, several row tiles
    (4, 3, 11, 50, "outimg"),  # head-style narrow output
])
def test_conv_planar_plain_matches_pallas(c, co, hc, wc_real, act):
    xp = _planar_in(c, hc, wc_real)
    kern, bias = _rand(3, 3, c, co, s=0.2), _rand(co, s=0.1)
    want = jp.conv_planar(jnp.asarray(xp, jnp.bfloat16), jnp.asarray(kern),
                          jnp.asarray(bias), c_in=c, c_out=co,
                          wc_real=wc_real, act=act, th=4, interpret=True)
    got = planar.conv_planar_plain(
        torch.from_numpy(xp), torch.from_numpy(kern), torch.from_numpy(bias),
        c_in=c, c_out=co, wc_real=wc_real, act=act).numpy()
    cpo = planar._round16(co)
    assert got.shape == want.shape == (4 * cpo, hc, WD)
    _close(_fine(got, co, wc_real), _fine(want, co, wc_real))
    # pad channels (co.. of each of the four planes) hold act(0)
    pad = np.asarray(jnp.asarray(want, jnp.float32)).reshape(
        4, cpo, hc, WD)[:, co:, :, :wc_real]
    assert np.all(pad == ACT0[act])
    assert np.all(got.reshape(4, cpo, hc, WD)[:, co:] == ACT0[act])


@pytest.mark.parametrize("c,hc,wc_real,hc_pad", [
    (6, 11, 50, 3)])   # ragged width, rows >= hc_real padding the input
def test_rsft_planar_plain_matches_pallas(c, hc, wc_real, hc_pad):
    xp = _planar_in(c, hc, wc_real, hc_pad)
    w0, w1 = _rand(3, 3, c, c, s=0.2), _rand(3, 3, c, c, s=0.2)
    b0, b1 = _rand(c, s=0.1), _rand(c, s=0.1)
    sft = rng.normal(size=(4, c)).astype(np.float32) * 0.3
    want = jp.rsft_planar(jnp.asarray(xp, jnp.bfloat16), jnp.asarray(w0),
                          jnp.asarray(b0), jnp.asarray(w1), jnp.asarray(b1),
                          *map(jnp.asarray, sft), c=c, hc_real=hc,
                          wc_real=wc_real, th=4, interpret=True)
    got = planar.rsft_planar_plain(
        torch.from_numpy(xp), torch.from_numpy(w0), torch.from_numpy(b0),
        torch.from_numpy(w1), torch.from_numpy(b1), torch.from_numpy(sft),
        c=c, hc_real=hc, wc_real=wc_real).numpy()
    assert got.shape == want.shape == xp.shape
    _close(_fine(got, c, wc_real, hc), _fine(want, c, wc_real, hc))
    cp = planar._round16(c)   # pad channels: xp's in both
    for out in (got, np.asarray(jnp.asarray(want, jnp.float32))):
        assert np.array_equal(out.reshape(4, cp, -1, WD)[:, c:],
                              xp.reshape(4, cp, -1, WD)[:, c:])


# --------------------------------------------------------------------- #
# the wrappers' contract
# --------------------------------------------------------------------- #

def _small(name, wd=WD):
    g = torch.Generator().manual_seed(1)
    r = lambda *s: torch.rand(*s, generator=g) - 0.5  # noqa: E731
    c = 5
    xp = torch.zeros((64, 4, wd))
    xp[:, :, :7] = r(64, 4, 7)
    if name == "conv_planar":
        return xp, (r(3, 3, c, 3), r(3)), {"c_in": c, "c_out": 3,
                                            "wc_real": 7, "act": "outimg"}
    return xp, (r(3, 3, c, c), r(c), r(3, 3, c, c), r(c), r(4, c)), {
        "c": c, "hc_real": 3, "wc_real": 7}


@pytest.mark.parametrize("name", ["conv_planar", "rsft_planar"])
def test_wrapper_runs_the_plain_version_on_cpu(name):
    xp, args, kw = _small(name)
    before = dict(LAUNCHES)
    got = getattr(planar, name)(xp, *args, **kw)
    assert torch.equal(got, getattr(planar, name + "_plain")(xp, *args, **kw))
    assert LAUNCHES == before  # counts kernel launches only


@pytest.mark.parametrize("name", ["conv_planar", "rsft_planar"])
@pytest.mark.parametrize("bad", ["wd_not_pow2", "wd_small", "rows", "device",
                                 "kernel"])
def test_wrapper_checks_its_inputs(name, bad):
    xp, args, kw = _small(name, wd={"wd_not_pow2": 192,
                                    "wd_small": 64}.get(bad, WD))
    if bad == "rows":      # 4 * round16(c) rows of planes
        xp = xp[:48]
    elif bad == "device":  # neither the CPU nor the card
        xp = xp.to("meta")
    elif bad == "kernel":  # HWIO [3, 3, C, Co]
        args = (args[0][:1],) + args[1:]
    with pytest.raises(ValueError):
        getattr(planar, name)(xp, *args, **kw)
