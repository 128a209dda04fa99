"""The port's nine CEM quantisers (``boosting_nerv_torch/ops/quantize.py``)
against the JAX package's on the CPU: the same seeded numpy tensor (a flax
conv kernel, a Dense kernel, a bias, and an NHWC embedding quantised
unsigned), per tensor and, where the quantiser allows it, per channel.

Tolerances: ``init_params`` within rtol 1e-6; ``code`` within rtol 1e-5
and atol 1e-5 (a hundred-thousandth of a step: ``exp``'s code is
(exp(y) - 1) * 64, which cancels to a few ulp of 1 times 64);
``quant`` equal, but for codes within 1e-5 of a half-integer, which may
round either way (off by one, at most 1 in 10^4 elements and never more
than one); ``dequant`` within rtol 1e-6 where ``quant`` agrees; the
gradients of a fixed scalar function of (code, dequant) to ``x`` and to
every quantiser parameter within rtol 1e-5 (atol 1e-5 of the leaf's
largest gradient: sums over every element, reduced in another order).
``log``'s gradients are taken at shift +1: at its init's shift -1 the
clamp of the log's argument sends codes of small |x| to -1326 and their
dequantised values to ~e^20.7, where the gradient sums (~1e9) cancel
beyond float32 (the JAX package keeps that domain behaviour).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boosting_nerv_torch.ops import quantize as port
from boosting_nerv_tpu.ops import quantize as ref
from test_torch_compress_trainer import one_torch_thread  # noqa: F401

INIT_RTOL = 1e-6
CODE_RTOL = 1e-5
CODE_ATOL = 1e-5   # code units (steps)
DEQUANT_RTOL = 1e-6
GRAD_RTOL = 1e-5
HALF_TOL = 1e-5

KINDS = {  # name: (flax shape, signed)
    "conv": ((3, 3, 8, 16), True),
    "dense": ((12, 24), True),
    "bias": ((16,), True),
    "embed": ((1, 2, 4, 8), False),
}
PER_CHANNEL = ("scale", "scalebeta", "lsq", "lsqv2", "edgescale", "dq")
CASES = [(name, kind, pc) for name in sorted(ref.QUANT_MAP) for kind in KINDS
         for pc in ((False, True) if name in PER_CHANNEL else (False,))]


def _x(kind):
    shape, signed = KINDS[kind]
    r = np.random.default_rng(sorted(KINDS).index(kind))
    x = r.normal(scale=0.1, size=shape).astype(np.float32)
    return x if signed else np.abs(x) * 3.0


def _weights(shape, seed):
    r = np.random.default_rng(100 + seed)
    return (r.normal(size=shape).astype(np.float32),
            r.normal(size=shape).astype(np.float32))


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _port_qp(qp):
    return {k: torch.from_numpy(np.array(v)).requires_grad_(True)
            for k, v in qp.items()}


@pytest.mark.parametrize("name,kind,per_channel", CASES)
def test_quantizer_matches_jax(name, kind, per_channel):
    x = _x(kind)
    signed = KINDS[kind][1]
    bits = 8 if kind != "embed" else 6
    R, P = ref.get_quantizer(name), port.get_quantizer(name)

    want_qp = _np(R.init_params(jnp.asarray(x), bits, signed=signed,
                                per_channel=per_channel))
    got_qp = P.init_params(torch.from_numpy(x), bits, signed=signed,
                           per_channel=per_channel)
    assert sorted(got_qp) == sorted(want_qp)
    for k in want_qp:
        assert got_qp[k].dtype == torch.float32
        assert tuple(got_qp[k].shape) == want_qp[k].shape, k
        np.testing.assert_allclose(got_qp[k].numpy(), want_qp[k],
                                   rtol=INIT_RTOL, err_msg=k)

    # the forward, from the same (JAX) quantiser parameters
    w_code, w_quant, w_dq = map(np.asarray, R.apply(
        jnp.asarray(x), want_qp, bits, signed=signed,
        per_channel=per_channel))
    xt = torch.from_numpy(x).requires_grad_(True)
    qpt = _port_qp(want_qp)
    code, quant, dq = P.apply(xt, qpt, bits, signed=signed,
                              per_channel=per_channel)
    np.testing.assert_allclose(code.detach().numpy(), w_code,
                               rtol=CODE_RTOL, atol=CODE_ATOL)
    g_quant = quant.detach().numpy()
    differ = g_quant != w_quant
    if differ.any():
        near_half = np.abs(np.abs(w_code - np.floor(w_code)) - 0.5) < HALF_TOL
        assert np.all(near_half[differ]), "quant differs away from a half"
        assert np.all(np.abs(g_quant - w_quant)[differ] == 1)
        assert differ.sum() <= max(1, differ.size // 10 ** 4)
    same = ~differ
    np.testing.assert_allclose(dq.detach().numpy()[same], w_dq[same],
                               rtol=DEQUANT_RTOL, atol=1e-7)

    # gradients of sum(dequant * a) + 0.01 * sum(code * b): STE and
    # grad_scale, into x and every quantiser parameter
    a, b = _weights(x.shape, sorted(KINDS).index(kind))

    def f(x, qp):
        c, _, d = R.apply(x, qp, bits, signed=signed,
                          per_channel=per_channel)
        return jnp.sum(d * a) + 0.01 * jnp.sum(c * b)

    grad_qp = dict(want_qp)
    if name == "log":
        grad_qp["shift"] = np.ones_like(grad_qp["shift"])
        xt.grad = None
        qpt = _port_qp(grad_qp)
        code, _, dq = P.apply(xt, qpt, bits, signed=signed,
                              per_channel=per_channel)
    want_gx, want_gqp = jax.jit(jax.grad(f, argnums=(0, 1)))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in grad_qp.items()})
    (torch.sum(dq * torch.from_numpy(a))
     + 0.01 * torch.sum(code * torch.from_numpy(b))).backward()
    grads = [("x", xt.grad, want_gx)] + [
        (k, qpt[k].grad if qpt[k].grad is not None
         else torch.zeros_like(qpt[k]), want_gqp[k]) for k in want_qp]
    for k, got, want in grads:
        want = np.asarray(want)
        if not np.all(np.isfinite(want)):  # log / exp: a domain edge
            np.testing.assert_array_equal(np.isfinite(got.numpy()),
                                          np.isfinite(want), err_msg=k)
            fin = np.isfinite(want)
            got, want = got.numpy()[fin], want[fin]
        else:
            got = got.numpy()
        np.testing.assert_allclose(
            got, want, rtol=GRAD_RTOL,
            atol=GRAD_RTOL * (np.abs(want).max() if want.size else 0),
            err_msg=k)


@pytest.mark.parametrize("name", ["log", "exp", "multiscale"])
def test_per_channel_is_refused_where_jax_refuses_it(name):
    x = torch.from_numpy(_x("conv"))
    with pytest.raises(ValueError, match="does not support per_channel"):
        port.get_quantizer(name).init_params(x, 8, per_channel=True)
    with pytest.raises(ValueError, match="does not support per_channel"):
        ref.get_quantizer(name).init_params(jnp.asarray(x.numpy()), 8,
                                            per_channel=True)


def test_unknown_quantizer_raises_key_error():
    with pytest.raises(KeyError, match="unknown quantizer 'nope'"):
        port.get_quantizer("nope")
    assert sorted(port.QUANT_MAP) == sorted(ref.QUANT_MAP)


def test_ste_rounds_half_to_even_with_identity_gradient():
    x = torch.tensor([-1.5, -0.5, 0.5, 1.5, 2.5, 0.3], requires_grad=True)
    y = port.ste(x)
    np.testing.assert_array_equal(y.detach().numpy(),
                                  np.asarray(ref.ste(jnp.asarray(
                                      x.detach().numpy()))))
    y.sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.ones(6))
    s = torch.tensor([2.0], requires_grad=True)
    z = port.grad_scale(s, 0.25)
    z.sum().backward()
    assert float(z) == 2.0 and float(s.grad) == 0.25
