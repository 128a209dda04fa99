"""Reconstruction losses and output squashing (port of
boosting_nerv_tpu/ops/losses.py).

The loss menu and weights of the reference ``loss_fn``.  The paper's loss
is ``Fusion10_freq``: 60 * (0.7 * L1 + 0.3 * (1 - MS-SSIM)) + the L1 of
the 2-D FFTs, over the stacked real and imaginary parts.  Tensors are NHWC
and the FFT runs over the spatial axes (1, 2).

``out_img`` is the reference's OutImg: sigmoid, tanh * 0.5 + 0.5 (the
default), or a constant bias.
"""

from __future__ import annotations

import torch

from .msssim import ms_ssim, ssim


def out_img(x: torch.Tensor, out_bias: str = "tanh") -> torch.Tensor:
    if out_bias == "sigmoid":
        return torch.reciprocal(1.0 + torch.exp(-x))
    if out_bias == "tanh":
        return torch.tanh(x) * 0.5 + 0.5
    return x + float(out_bias)


def _per_sample_mean(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(t.shape[0], -1).mean(dim=1)


def _l1(pred, target):
    return _per_sample_mean(torch.abs(pred - target))


def _l2(pred, target):
    return _per_sample_mean((pred - target) ** 2)


def _one_minus_ssim(pred, target):
    return 1.0 - ssim(pred, target, data_range=1.0, size_average=False)


def _one_minus_msssim(pred, target):
    return 1.0 - ms_ssim(pred, target, data_range=1.0, size_average=False)


def _freq_l1(pred, target):
    pf = torch.fft.fft2(pred, dim=(1, 2))
    tf = torch.fft.fft2(target, dim=(1, 2))
    diff = torch.abs(pf.real - tf.real) + torch.abs(pf.imag - tf.imag)
    # stacked real/imag doubles the element count relative to the image
    return _per_sample_mean(diff) * 0.5


# loss type -> ((weight, term), ...), summed
_MIXES = {
    "L2": ((1.0, _l2),),
    "L1": ((1.0, _l1),),
    "SSIM": ((1.0, _one_minus_ssim),),
    "Fusion1": ((0.3, _l2), (0.7, _one_minus_ssim)),
    "Fusion2": ((0.3, _l1), (0.7, _one_minus_ssim)),
    "Fusion3": ((0.5, _l2), (0.5, _one_minus_ssim)),
    "Fusion4": ((0.5, _l1), (0.5, _one_minus_ssim)),
    "Fusion5": ((0.7, _l2), (0.3, _one_minus_ssim)),
    "Fusion6": ((0.7, _l1), (0.3, _one_minus_ssim)),
    "Fusion7": ((0.7, _l2), (0.3, _l1)),
    "Fusion8": ((0.5, _l2), (0.5, _l1)),
    "Fusion9": ((0.9, _l1), (0.1, _one_minus_ssim)),
    "Fusion10": ((0.7, _l1), (0.3, _one_minus_msssim)),
    "Fusion11": ((0.9, _l1), (0.1, _one_minus_msssim)),
    "Fusion12": ((0.8, _l1), (0.2, _one_minus_msssim)),
}
# loss type -> the mix taken 60 times, plus the FFT L1
_FREQ = {"Fusion10_freq": "Fusion10", "L1_freq": "L1",
         "L1_ssim_freq": "Fusion6"}


def _mix(name, pred, target):
    terms = [w * f(pred, target) for w, f in _MIXES[name]]
    return terms[0] if len(terms) == 1 else terms[0] + terms[1]


def loss_fn(pred: torch.Tensor, target: torch.Tensor, loss_type: str = "L2",
            batch_average: bool = True) -> torch.Tensor:
    """The ``loss_type`` loss of NHWC frames: a scalar (``batch_average``)
    or one value a sample.  Raises KeyError for an unknown type."""
    target = target.detach()  # targets carry no gradient
    if loss_type in _MIXES:
        loss = _mix(loss_type, pred, target)
    elif loss_type in _FREQ:
        loss = (60.0 * _mix(_FREQ[loss_type], pred, target)
                + _freq_l1(pred, target))
    else:
        raise KeyError(f"Unknown loss type {loss_type}")
    return loss.mean() if batch_average else loss
