"""The port's entropy model (``boosting_nerv_torch/ops/entropy.py``) and its
rANS codec (``boosting_nerv_torch/compress/rans.py``, built from its own
``compress/csrc/rans.cpp``) against the JAX package's on the CPU.

Tolerances: bit estimates within rtol 1e-5 plus what the two float32
erf's errors allow: XLA's erf is within 2.7e-7 of the true value on
[-3, 3] and torch's within 3.3e-8 (measured on this CPU), so a probability
p = CDF(x + 1/2) - CDF(x - 1/2) may differ by up to ERF_ATOL 1e-6 and its
-log2(p + 1e-5) by ERF_ATOL / ((p + 1e-5) ln 2) (p in float64); the sums
(rate_bits) within rtol 1e-5; gradients within rtol 1e-3 (a difference
of two densities over a difference of two CDFs, both cancelling in the
tails), plus ERF_ATOL / (p + 1e-5) of the gradient and atol 1e-5 of the
largest; ``lower_bound``'s gradient exact;
the rANS streams identical word for word and every round trip lossless.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import erf

from boosting_nerv_torch.compress import rans as port_rans
from boosting_nerv_torch.ops import entropy as port
from boosting_nerv_tpu.compress import rans as ref_rans
from boosting_nerv_tpu.ops import entropy as ref
from test_torch_compress_trainer import one_torch_thread  # noqa: F401

BITS_RTOL = 1e-5
GRAD_RTOL = 1e-3
ERF_ATOL = 1e-6


def _p64(x, mean, std):
    """The Gaussian model's probability of each code, in float64."""
    x = np.asarray(x, np.float64)
    cdf = lambda v: 0.5 * (1 + erf((v - mean) / (std * np.sqrt(2))))  # noqa
    return cdf(x + 0.5) - cdf(x - 0.5)


def _assert_bits_close(got, want, p):
    bound = BITS_RTOL * np.abs(want) + ERF_ATOL / ((p + 1e-5) * np.log(2))
    bad = np.abs(got - want) > bound
    assert not bad.any(), (got[bad], want[bad], p[bad])


def _assert_grads_close(got, want, p):
    bound = ((GRAD_RTOL + ERF_ATOL / (p + 1e-5)) * np.abs(want)
             + 1e-5 * np.abs(want).max())
    bad = np.abs(got - want) > bound
    assert not bad.any(), (got[bad], want[bad], p[bad])


def _codes(seed=0, shape=(6, 5, 4, 8), scale=20.0):
    r = np.random.default_rng(seed)
    return (r.normal(size=shape) * scale + 3.0).astype(np.float32)


@pytest.mark.parametrize("distribution", ["gaussian", "laplace"])
def test_gaussian_bits_and_gradient_match_jax(distribution):
    x = _codes()
    mean, std = float(x.mean()), float(x.std(ddof=1))
    want = np.asarray(ref.gaussian_bits(jnp.asarray(x), mean, std,
                                        distribution))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = port.gaussian_bits(xt, mean, std, distribution)
    p = (_p64(x, mean, std) if distribution == "gaussian"
         else np.ones_like(want))  # Laplace: expm1 of both, no erf
    _assert_bits_close(got.detach().numpy(), want, p)
    assert np.all(want >= 0)
    want_g = np.asarray(jax.grad(lambda v: jnp.sum(ref.gaussian_bits(
        v, mean, std, distribution)))(jnp.asarray(x)))
    got.sum().backward()
    _assert_grads_close(xt.grad.numpy(), want_g, p)


@pytest.mark.parametrize("x,g,passes", [
    (0.5, 1.0, True),     # above the bound: passes
    (-0.5, -1.0, True),   # below, the gradient pushes it up: passes
    (-0.5, 1.0, False),   # below, pushed further down: stopped
])
def test_lower_bound_gradient_cases(x, g, passes):
    xt = torch.tensor([x], requires_grad=True)
    y = port.lower_bound(xt, 0.0)
    assert float(y) == max(x, 0.0)
    y.backward(torch.tensor([g]))
    _, vjp = jax.vjp(lambda v: ref.lower_bound(v, 0.0), jnp.asarray([x]))
    want = float(vjp(jnp.asarray([g]))[0][0])
    assert float(xt.grad) == want == (g if passes else 0.0)


@pytest.mark.parametrize("training", [False, True])
def test_rate_bits_matches_jax_with_its_noise(training):
    code = _codes(1, (16, 12))
    key = jax.random.key(3)
    want = ref.rate_bits(jnp.asarray(code), key, training)
    noise = (torch.from_numpy(np.asarray(jax.random.uniform(
        key, code.shape, jnp.float32, -0.5, 0.5))) if training else None)
    ct = torch.from_numpy(code).requires_grad_(True)
    got = port.rate_bits(ct, noise, training)
    for k in ("bitrate", "mean", "std"):
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=BITS_RTOL, err_msg=k)
    want_g = np.asarray(jax.grad(lambda c: ref.rate_bits(
        c, key, training)["bitrate"])(jnp.asarray(code)))
    got["bitrate"].backward()
    x = code + (noise.numpy() if training else 0)
    _assert_grads_close(ct.grad.numpy(), want_g,
                        _p64(x, float(want["mean"]), float(want["std"])))
    if training:
        with pytest.raises(ValueError):
            port.rate_bits(ct, None, True)


def test_code_stats_of_one_element():
    mean, std = port.code_stats(torch.tensor([2.5]))
    assert (float(mean), float(std)) == (2.5, 0.0)


def _symbols(kind):
    r = np.random.default_rng(7)
    if kind == "gaussian":
        return np.round(r.normal(size=5000) * 6.0 + 1.0).astype(np.int32)
    if kind == "wide":
        return np.round(r.normal(size=3000) * 90.0).astype(np.int32)
    return np.full(700, -3, np.int32)  # constant: the degenerate range


@pytest.mark.parametrize("kind", ["gaussian", "wide", "constant"])
def test_gaussian_rans_streams_equal_jax_and_round_trip(kind):
    sym = _symbols(kind)
    mean = float(sym.astype(np.float32).mean())
    std = float(sym.astype(np.float32).std(ddof=1))
    got, lo, hi = port_rans.gaussian_ans_encode(sym, mean, std)
    want, wlo, whi = ref_rans.gaussian_ans_encode(sym, mean, std)
    assert (lo, hi) == (wlo, whi)
    np.testing.assert_array_equal(got, want)
    assert port_rans.gaussian_ans_bits(sym, mean, std) == \
        ref_rans.gaussian_ans_bits(sym, mean, std) == 32 * got.size
    back = port_rans.gaussian_ans_decode(got, sym.size, mean, std, lo, hi)
    np.testing.assert_array_equal(back, sym)


@pytest.mark.parametrize("kind", ["gaussian", "constant"])
def test_categorical_rans_streams_equal_jax_and_round_trip(kind):
    vals = _symbols(kind) * 7  # arbitrary integer values
    got, unique, counts = port_rans.categorical_ans_encode(vals)
    want, wu, wc = ref_rans.categorical_ans_encode(vals)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(unique, wu)
    np.testing.assert_array_equal(counts, wc)
    back = port_rans.categorical_ans_decode(got, vals.size, unique, counts)
    np.testing.assert_array_equal(back, vals)


def test_codec_builds_from_the_ports_own_source_into_build():
    port_rans.gaussian_ans_bits(np.arange(10, dtype=np.int32), 4.5, 3.0)
    assert port_rans.SRC.endswith(os.path.join(
        "boosting_nerv_torch", "compress", "csrc", "rans.cpp"))
    assert port_rans.LIB.endswith(os.path.join(
        "boosting_nerv_torch", "build", "librans.so"))
    assert os.path.getmtime(port_rans.LIB) >= \
        os.path.getmtime(port_rans.SRC)
    with pytest.raises(ValueError):
        port_rans.gaussian_ans_encode(np.zeros(0, np.int32), 0.0, 1.0)
