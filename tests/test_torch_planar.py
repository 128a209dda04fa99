"""Plain versions of the two stage kernels against the Pallas kernels
(interpret mode, bf16) and the fp32 fine-grid reference, at the shapes of
tests/test_planar_kernels.py; and the wrappers' CPU/device contract.  The
CUDA kernels themselves run only on the card: chip_smoke.py holds them
against these plain versions there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from boosting_nerv_torch.ops.kernels import planar
from boosting_nerv_torch.ops.pixelshuffle import jax_to_torch_shuffle_perm
from boosting_nerv_tpu.ops.pallas import planar as pk
from boosting_nerv_tpu.ops.pixelshuffle import depth_to_space

rng = np.random.default_rng(5)
C_IN, C, WC, WD, TH = 6, 5, 50, 128, 4


def _rand(*shape, s=0.2):
    return rng.normal(size=shape).astype(np.float32) * s


def _conv_ref(x_nhwc, k, b):
    return lax.conv_general_dilated(
        jnp.asarray(x_nhwc), jnp.asarray(k), (1, 1), [(1, 1), (1, 1)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=lax.Precision.HIGHEST) + b


def _rsft_ref(y, p, sft):
    s0, h0, s1, h1 = sft
    t = jax.nn.gelu(_conv_ref(y * (s0 + 1) + h0, p["w0"], p["b0"]),
                    approximate=False)
    return y + _conv_ref(t * (s1 + 1) + h1, p["w1"], p["b1"])


def _ohwi(k_hwio, perm=None):
    k = k_hwio.transpose(3, 0, 1, 2)
    return torch.from_numpy(np.ascontiguousarray(
        k if perm is None else k[perm]))


def _stage(up, hwio, head=None):
    """JAX-layout weights -> planar.StageWeights (fp32)."""
    perm = jax_to_torch_shuffle_perm(C, 2) if up else None
    return planar.StageWeights(
        _ohwi(hwio["ck"], perm),
        torch.from_numpy(hwio["cb"][perm] if up else hwio["cb"]),
        _ohwi(hwio["w0"]), torch.from_numpy(hwio["b0"]),
        _ohwi(hwio["w1"]), torch.from_numpy(hwio["b1"]),
        None if head is None else _ohwi(head[0]),
        None if head is None else torch.from_numpy(head[1]))


def _weights(c_in, c_out):
    return {"ck": _rand(3, 3, c_in, c_out), "cb": _rand(c_out, s=0.1),
            "w0": _rand(3, 3, C, C), "b0": _rand(C, s=0.1),
            "w1": _rand(3, 3, C, C), "b1": _rand(C, s=0.1)}


def _err_bound(got, want, tol):
    err = float(np.abs(got - want).max())
    assert err < tol * max(float(np.abs(want).max()), 1.0), err


@pytest.fixture(scope="module")
def upconv_case():
    hc = 9
    x = _rand(1, hc, WC, C_IN)
    p = _weights(C_IN, 4 * C)
    sft = [_rand(C, s=0.3) for _ in range(4)]
    fine = jnp.sin(depth_to_space(_conv_ref(x, p["ck"], p["cb"]), 2))
    ref = np.asarray(_rsft_ref(fine, p, sft))
    prep = pk.prepare_upconv_rsft(*(jnp.asarray(p[k]) for k in
                                    ("ck", "cb", "w0", "b0", "w1", "b1")),
                                  c_in=C_IN, c=C)
    xp = jnp.pad(jnp.asarray(x[0].transpose(2, 0, 1)),
                 ((0, 0), (0, 0), (0, WD - WC))).astype(jnp.bfloat16)
    out = pk.fused_upconv_rsft(
        xp, prep, pk.sft_planar_vectors(*map(jnp.asarray, sft), 16),
        c_in=C_IN, c=C, wc_real=WC, th=TH, interpret=True)
    pallas = np.asarray(pk.from_planar(out, C)[:, :, :2 * WC].astype(
        jnp.float32)).transpose(1, 2, 0)[None]
    got = planar.fused_upconv_rsft_plain(
        torch.from_numpy(x), _stage(True, p),
        torch.from_numpy(np.stack(sft))).numpy()
    return got, ref, pallas


def test_upconv_plain_matches_pallas(upconv_case):
    got, _, pallas = upconv_case
    assert got.shape == pallas.shape == (1, 18, 100, C)
    _err_bound(got, pallas, 0.05)  # Pallas side stores bf16


def test_upconv_plain_matches_fp32_reference(upconv_case):
    got, ref, _ = upconv_case
    assert np.abs(got - ref).max() <= 1e-4


@pytest.fixture(scope="module", params=[False, True], ids=["nohead", "head"])
def conv_case(request):
    head, hc = request.param, 11
    x = _rand(1, 2 * hc, 2 * WC, C)
    p = _weights(C, C)
    sft = [_rand(C, s=0.3) for _ in range(4)]
    hk, hb = _rand(3, 3, C, 3), _rand(3, s=0.1)
    ref = _rsft_ref(jnp.sin(_conv_ref(x, p["ck"], p["cb"])), p, sft)
    if head:
        ref = jnp.tanh(_conv_ref(ref, hk, hb)) * 0.5 + 0.5
    prep = pk.prepare_conv_rsft(*(jnp.asarray(p[k]) for k in
                                  ("ck", "cb", "w0", "b0", "w1", "b1")),
                                c=C, head_k=jnp.asarray(hk) if head else None,
                                head_b=jnp.asarray(hb) if head else None)
    xp = pk.to_planar(jnp.asarray(x[0].transpose(2, 0, 1)).astype(
        jnp.bfloat16))
    xp = jnp.pad(xp, ((0, 0), (0, 0), (0, WD - WC)))
    out = pk.fused_conv_rsft(
        xp, prep, pk.sft_planar_vectors(*map(jnp.asarray, sft), 16), c=C,
        wc_real=WC, head=head, th=TH, interpret=True)
    if head:
        pallas = pk.rgb_planar_to_nhwc(out, hc, WC)
    else:
        pallas = pk.from_planar(out, C)[:, :, :2 * WC].transpose(1, 2, 0)[None]
    got = planar.fused_conv_rsft_plain(
        torch.from_numpy(x), _stage(False, p, (hk, hb) if head else None),
        torch.from_numpy(np.stack(sft)), head=head).numpy()
    return got, np.asarray(ref), np.asarray(pallas.astype(jnp.float32))


def test_conv_plain_matches_pallas(conv_case):
    got, _, pallas = conv_case
    assert got.shape == pallas.shape
    _err_bound(got, pallas, 0.05)  # Pallas side stores bf16


def test_conv_plain_matches_fp32_reference(conv_case):
    got, ref, _ = conv_case
    assert np.abs(got - ref).max() <= 1e-4


def _small_stage(head):
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.rand(*s, generator=g) - 0.5  # noqa: E731
    w = planar.StageWeights(r(C, 3, 3, C), r(C), r(C, 3, 3, C), r(C),
                            r(C, 3, 3, C), r(C),
                            r(3, 3, 3, C) if head else None,
                            r(3) if head else None)
    return r(1, 6, 7, C), w, r(4, C)


@pytest.mark.parametrize("head", [False, True])
def test_wrapper_runs_the_plain_version_on_cpu(head):
    x, w, sft = _small_stage(head)
    before = dict(planar.LAUNCHES)
    got = planar.fused_conv_rsft(x, w, sft, head=head)
    assert torch.equal(got, planar.fused_conv_rsft_plain(x, w, sft, head))
    assert planar.LAUNCHES == before  # counts kernel launches only


def test_wrapper_raises_off_cpu_and_cuda():
    x, w, sft = _small_stage(False)
    with pytest.raises(ValueError, match="device"):
        planar.fused_conv_rsft(x.to("meta"), w, sft)


@pytest.mark.parametrize("bad", ["sft", "channels", "rank", "head"])
def test_wrapper_checks_shapes(bad):
    x, w, sft = _small_stage(False)
    kwargs = {}
    if bad == "sft":
        sft = sft[:3]
    elif bad == "channels":
        x = x[..., :3]
    elif bad == "rank":
        x = x[0]
    else:
        kwargs["head"] = True  # no head weights
    with pytest.raises(ValueError):
        planar.fused_conv_rsft(x, w, sft, **kwargs)
