"""The nine quantisers of the CEM compression finetune (port of
boosting_nerv_tpu/ops/quantize.py).

Each quantiser is a pair of functions::

    init_params(x, bits, signed, per_channel) -> dict of float32 tensors
    apply(x, qp, bits, signed, per_channel)   -> (code, quant, dequant)

``quant = ste(code)`` rounds (half to even, as ``jnp.round``) with a
straight-through gradient, so a learned scale receives gradients through
the dequantised weights (the task loss) and through the code statistics
(the rate loss).  ``x`` is a tensor in the flax layout: per-channel
parameters run along its LAST axis (the out-channel of a flax kernel; a
1-D bias gets the global statistic broadcast per element).  The trainer
hands each quantiser the flax view of a torch parameter
(``bridge.flax_view``) so that the quantiser parameters keep the JAX
package's shapes and the codes its element order.

The JAX package's departures from the reference are kept: ``log``,
``exp`` and ``multiscale`` raise ValueError on ``per_channel``; ``log``
clamps its argument to stay finite; ``scalebeta`` and ``lsqv2`` implement
the intended per-channel init; ``multiscale``'s ``param_range`` gets no
gradient but stays a parameter of the tree (checkpoints match by leaf).
Registry names as the CLI's: lsq, lsqv2, scale, scalebeta, edgescale,
multiscale, log, exp, dq.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

QP = Dict[str, torch.Tensor]


def ste(x: torch.Tensor) -> torch.Tensor:
    """Round (half to even) with an identity gradient."""
    return x + (torch.round(x) - x).detach()


def grad_scale(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Value x, gradient scaled by ``scale``."""
    return x * scale + (x - x * scale).detach()


def _myabs(x):
    return torch.where(x == 0, x, torch.abs(x))


def _mysign(x):
    return torch.where(x == 0, torch.ones_like(x), torch.sign(x))


def _clip(x, lo, hi):
    """``jnp.clip``'s value and gradient: maximum, then minimum, each
    splitting the gradient in half at a tie (a code on a bound)."""
    return torch.minimum(torch.maximum(x, x.new_tensor(float(lo))),
                         x.new_tensor(float(hi)))


def _reject_per_channel(name: str, per_channel: bool):
    """The reference's log / exp / multiscale transforms ignore
    per_channel; raise so the flag cannot silently do nothing."""
    if per_channel:
        raise ValueError(
            f"quantizer {name!r} does not support per_channel "
            "(use lsq/lsqv2/scale/scalebeta/edgescale)")


def qrange(bits: int, signed: bool) -> Tuple[int, int]:
    if signed:
        return -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    return 0, 2 ** bits - 1


def _range_scale(x, bits, signed):
    qmin, qmax = qrange(bits, signed)
    return ((x.max() - x.min()) / (qmax - qmin)).reshape(1)


def _per_channel_reduce(x, fn):
    """``fn`` (torch.amax / torch.amin) over every axis but the last; a
    1-D tensor gets its global value per element."""
    if x.ndim > 1:
        return fn(x, dim=tuple(range(x.ndim - 1)))
    return fn(x, dim=0).expand(x.shape[0]).clone()


def _per_channel_minmax_scale(x, bits, signed):
    qmin, qmax = qrange(bits, signed)
    hi = _per_channel_reduce(x, torch.amax)
    lo = _per_channel_reduce(x, torch.amin)
    return (hi - lo) / (qmax - qmin)


def _bcast_ch(p, x):
    """A per-channel (last-axis) parameter broadcast over x's leading
    axes."""
    if p.ndim == 1 and x.ndim > 1:
        return p.reshape((1,) * (x.ndim - 1) + (-1,))
    return p


def _lsq_grad(qmax: int, numel: int) -> float:
    """LSQ's gradient scale 1 / sqrt(qmax * numel), rounded as float32."""
    return float(np.float32(1.0) / np.sqrt(np.float32(qmax * numel)))


def _const(x, value):
    return torch.tensor([value], dtype=torch.float32, device=x.device)


# --------------------------------------------------------------------- #
class _Base:
    @staticmethod
    def init_params(x, bits, signed=True, per_channel=False) -> QP:
        raise NotImplementedError

    @staticmethod
    def apply(x, qp, bits, signed=True, per_channel=False):
        raise NotImplementedError


class ScaleQ(_Base):
    """Plain learned scale, no clamp."""

    @staticmethod
    @torch.no_grad()
    def init_params(x, bits, signed=True, per_channel=False) -> QP:
        if per_channel:
            return {"scale": _per_channel_minmax_scale(x, bits, signed)}
        return {"scale": _range_scale(x, bits, signed)}

    @staticmethod
    def apply(x, qp, bits, signed=True, per_channel=False):
        scale = _bcast_ch(qp["scale"], x) if per_channel else qp["scale"]
        code = x / scale
        quant = ste(code)
        return code, quant, quant * scale


class ScaleBetaQ(_Base):
    """Learned affine scale and offset; per_channel: one of each per
    out-channel (the reference's intended per-channel init)."""

    @staticmethod
    @torch.no_grad()
    def init_params(x, bits, signed=True, per_channel=False) -> QP:
        if per_channel:
            return {"scale": _per_channel_minmax_scale(x, bits, signed),
                    "beta": _per_channel_reduce(x, torch.amin)}
        return {"scale": _range_scale(x, bits, signed),
                "beta": x.min().reshape(1)}

    @staticmethod
    def apply(x, qp, bits, signed=True, per_channel=False):
        scale, beta = qp["scale"], qp["beta"]
        if per_channel:
            scale, beta = _bcast_ch(scale, x), _bcast_ch(beta, x)
        code = (x - beta) / scale
        quant = ste(code)
        return code, quant, quant * scale + beta


class LSQ(_Base):
    """Learned step size with the 1/sqrt(qmax numel) gradient scale and
    the codes clamped to the range."""

    @staticmethod
    @torch.no_grad()
    def init_params(x, bits, signed=True, per_channel=False) -> QP:
        if per_channel:
            return {"scale": _per_channel_minmax_scale(x, bits, signed)}
        return {"scale": _range_scale(x, bits, signed)}

    @staticmethod
    def apply(x, qp, bits, signed=True, per_channel=False):
        qmin, qmax = qrange(bits, signed)
        s = grad_scale(qp["scale"], _lsq_grad(qmax, x.numel()))
        if per_channel and x.ndim > 1:
            s = _bcast_ch(s, x)
        code = _clip(x / s, qmin, qmax)
        quant = ste(code)
        return code, quant, quant * s


class LSQV2(_Base):
    """LSQ with a learned offset beta; per_channel: one scale and beta per
    out-channel."""

    @staticmethod
    @torch.no_grad()
    def init_params(x, bits, signed=True, per_channel=False) -> QP:
        return ScaleBetaQ.init_params(x, bits, signed, per_channel)

    @staticmethod
    def apply(x, qp, bits, signed=True, per_channel=False):
        qmin, qmax = qrange(bits, signed)
        g = _lsq_grad(qmax, x.numel())
        s = grad_scale(qp["scale"], g)
        b = grad_scale(qp["beta"], g)
        if per_channel:
            s, b = _bcast_ch(s, x), _bcast_ch(b, x)
        code = _clip((x - b) / s, qmin, qmax)
        quant = ste(code)
        return code, quant, quant * s + b


class EdgeScaleQ(_Base):
    """Learned dead-zone threshold and step."""

    @staticmethod
    @torch.no_grad()
    def init_params(x, bits, signed=True, per_channel=False) -> QP:
        if per_channel:
            s = _per_channel_minmax_scale(x, bits, signed)
        else:
            s = _range_scale(x, bits, signed)
        return {"scale": s, "thresold": s.clone()}

    @staticmethod
    def apply(x, qp, bits, signed=True, per_channel=False):
        th = qp["thresold"]
        sc = qp["scale"]
        if per_channel and x.ndim > 1:
            th, sc = _bcast_ch(th, x), _bcast_ch(sc, x)
        sign = torch.sign(x)
        keep = torch.abs(x) > torch.abs(th)
        sparse = x / (2 * torch.abs(th))
        reserve = sign * (0.5 + (torch.abs(x) - torch.abs(th))
                          / torch.abs(sc))
        code = torch.where(keep, reserve, sparse)
        quant = ste(code)
        csign = torch.sign(quant)
        dkeep = torch.abs(quant) > 0.5
        dsparse = quant * (2 * torch.abs(th))
        dreserve = csign * (torch.abs(th)
                            + (torch.abs(quant) - 0.5) * torch.abs(sc))
        return code, quant, torch.where(dkeep, dreserve, dsparse)


class MultiScaleQ(_Base):
    """Five-segment piecewise-linear companding; ``param_range`` is a
    constant of the init (no gradient)."""
    NUM_LIN = 5

    @staticmethod
    @torch.no_grad()
    def init_params(x, bits, signed=True, per_channel=False) -> QP:
        _reject_per_channel("multiscale", per_channel)
        n = MultiScaleQ.NUM_LIN
        scale = ((x.max() - x.min()) / 256.0).expand(n).clone()
        rng = (torch.arange(1, n, dtype=torch.float32, device=x.device)
               * (torch.abs(x).max() / n))
        return {"scale": scale, "param_range": rng}

    @staticmethod
    def apply(x, qp, bits, signed=True, per_channel=False):
        scale = qp["scale"]
        ranges = qp["param_range"].detach()
        n_ranges = ranges.shape[0]
        sign = _mysign(x)
        ax = _myabs(x)

        res = torch.zeros_like(ax)
        filled = torch.zeros_like(ax, dtype=torch.bool)
        base_last, range_last = 0.0, 0.0
        for i in range(n_ranges):
            m = (ax < ranges[i]) & ~filled
            res = torch.where(m, base_last + (ax - range_last)
                              / _myabs(scale[i]), res)
            filled = filled | m
            base_last = base_last + (ranges[i] - range_last) / _myabs(scale[i])
            range_last = ranges[i]
        res = torch.where(~filled, base_last + (ax - range_last)
                          / _myabs(scale[-1]), res)
        code = res * sign
        quant = ste(code)

        aq = _myabs(quant)
        qsign = _mysign(quant)
        res = torch.zeros_like(aq)
        filled = torch.zeros_like(aq, dtype=torch.bool)
        base_last, range_last = 0.0, 0.0
        for i in range(n_ranges):
            base_now = base_last + (ranges[i] - range_last) / scale[i]
            m = (aq < base_now) & ~filled
            res = torch.where(m, range_last + (aq - base_last) * scale[i],
                              res)
            filled = filled | m
            base_last = base_now
            range_last = ranges[i]
        res = torch.where(~filled, range_last + (aq - base_last) * scale[-1],
                          res)
        return code, quant, res * qsign


class LogQ(_Base):
    """Log companding; the argument of the log is clamped at 1e-9 (the
    reference's init takes the log of a negative number for small |x|)."""

    @staticmethod
    @torch.no_grad()
    def init_params(x, bits, signed=True, per_channel=False) -> QP:
        _reject_per_channel("log", per_channel)
        return {"scale": _const(x, 1.0 / 64), "shift": _const(x, -1.0),
                "inner_scale": (torch.abs(x).max()
                                / 1.718281828459045).reshape(1)}

    @staticmethod
    def apply(x, qp, bits, signed=True, per_channel=False):
        s, sh, inner = qp["scale"], qp["shift"], qp["inner_scale"]
        arg = torch.clamp_min(sh + _myabs(x) / inner, 1e-9)
        code = _mysign(x) * torch.log(arg) / s
        quant = ste(code)
        dequant = _mysign(quant) * (torch.exp(_myabs(quant) * s) - sh) * inner
        return code, quant, dequant


class ExpQ(_Base):
    """Exp companding."""

    @staticmethod
    @torch.no_grad()
    def init_params(x, bits, signed=True, per_channel=False) -> QP:
        _reject_per_channel("exp", per_channel)
        return {"scale": _const(x, 1.0 / 64), "shift": _const(x, -1.0),
                "inner_scale": (torch.abs(x).max()
                                / 0.69314718056).reshape(1)}

    @staticmethod
    def apply(x, qp, bits, signed=True, per_channel=False):
        s, sh, inner = qp["scale"], qp["shift"], qp["inner_scale"]
        code = _mysign(x) * (torch.exp(_myabs(x) / inner) + sh) / s
        quant = ste(code)
        dequant = _mysign(quant) * torch.log(_myabs(quant) * s - sh) * inner
        return code, quant, dequant


class DirectQuant(_Base):
    """Rounding with a straight-through gradient, no parameter."""

    @staticmethod
    def init_params(x, bits, signed=True, per_channel=False) -> QP:
        return {}

    @staticmethod
    def apply(x, qp, bits, signed=True, per_channel=False):
        quant = ste(x)
        return x, quant, quant


QUANT_MAP = {
    "edgescale": EdgeScaleQ,
    "scale": ScaleQ,
    "scalebeta": ScaleBetaQ,
    "multiscale": MultiScaleQ,
    "log": LogQ,
    "exp": ExpQ,
    "lsq": LSQ,
    "lsqv2": LSQV2,
    "dq": DirectQuant,
}


def get_quantizer(name: str):
    try:
        return QUANT_MAP[name]
    except KeyError:
        raise KeyError(f"unknown quantizer {name!r}; available "
                       f"{sorted(QUANT_MAP)}") from None
