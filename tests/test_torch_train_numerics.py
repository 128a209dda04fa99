"""The port's training numerics against the JAX package's on the CPU:
every loss type and its gradient, SSIM / MS-SSIM (with the small-frame
guard), the metrics and the learning-rate schedules.  Inputs are drawn
with numpy from a seed and go through both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boosting_nerv_torch.ops import losses as port_losses
from boosting_nerv_torch.ops import metrics as port_metrics
from boosting_nerv_torch.ops import msssim as port_msssim
from boosting_nerv_torch.training.schedules import lr_multiplier
from boosting_nerv_tpu.ops import losses as ref_losses
from boosting_nerv_tpu.ops import metrics as ref_metrics
from boosting_nerv_tpu.ops import msssim as ref_msssim
from boosting_nerv_tpu.training import schedules as ref_schedules

MS_TYPES = ("Fusion10", "Fusion11", "Fusion12", "Fusion10_freq")
SMALL_TYPES = ("L2", "L1", "SSIM", "Fusion1", "Fusion2", "Fusion3",
               "Fusion4", "Fusion5", "Fusion6", "Fusion7", "Fusion8",
               "Fusion9", "L1_freq", "L1_ssim_freq")
MS_SHAPE = (1, 176, 176, 3)     # MS-SSIM needs min(H, W) > 160
SMALL_SHAPE = (2, 24, 40, 3)
RTOL = 1e-5                     # float32 on both sides


def _pair(shape, seed):
    r = np.random.default_rng(seed)
    target = r.uniform(size=shape).astype(np.float32)
    pred = np.clip(target + 0.1 * r.normal(size=shape), 0, 1).astype(
        np.float32)
    return pred, target


@pytest.mark.parametrize("loss_type", MS_TYPES + SMALL_TYPES)
def test_loss_fn_matches_jax(loss_type):
    pred, target = _pair(MS_SHAPE if loss_type in MS_TYPES else SMALL_SHAPE,
                         seed=len(loss_type))
    for avg in (True, False):
        want = np.asarray(ref_losses.loss_fn(jnp.asarray(pred),
                                             jnp.asarray(target), loss_type,
                                             batch_average=avg))
        got = port_losses.loss_fn(torch.from_numpy(pred),
                                  torch.from_numpy(target), loss_type,
                                  batch_average=avg).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("loss_type,shape", [("Fusion10_freq", MS_SHAPE),
                                             ("L1_freq", SMALL_SHAPE)])
def test_loss_gradient_matches_jax(loss_type, shape):
    pred, target = _pair(shape, seed=3)
    # eager, as the op-by-op reference: XLA's fusions move the jitted
    # MS-SSIM gradient by more than this tolerance
    want = np.asarray(jax.grad(lambda p: ref_losses.loss_fn(
        p, jnp.asarray(target), loss_type))(jnp.asarray(pred)))
    p = torch.from_numpy(pred).requires_grad_()
    port_losses.loss_fn(p, torch.from_numpy(target), loss_type).backward()
    # per-element gradients of an image mean: tolerance relative to the max
    np.testing.assert_allclose(p.grad.numpy(), want,
                               atol=1e-5 * np.abs(want).max(), rtol=0)


def test_unknown_loss_type_raises_key_error():
    x = torch.zeros(1, 4, 4, 3)
    with pytest.raises(KeyError):
        port_losses.loss_fn(x, x, "Fusion99")


@pytest.mark.parametrize("shape,win", [((2, 24, 40, 3), 11),
                                       ((1, 9, 15, 3), 7),
                                       ((2, 177, 181, 3), 11)])
def test_ssim_matches_jax(shape, win):
    pred, target = _pair(shape, seed=5)
    want = np.asarray(ref_msssim.ssim(jnp.asarray(pred), jnp.asarray(target),
                                      size_average=False, win_size=win))
    got = port_msssim.ssim(torch.from_numpy(pred), torch.from_numpy(target),
                           size_average=False, win_size=win).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("shape", [(1, 176, 176, 3), (2, 177, 195, 3)])
def test_ms_ssim_matches_jax(shape):  # odd sides: the padded pool
    pred, target = _pair(shape, seed=6)
    for avg in (True, False):
        want = np.asarray(ref_msssim.ms_ssim(jnp.asarray(pred),
                                             jnp.asarray(target),
                                             size_average=avg))
        got = port_msssim.ms_ssim(torch.from_numpy(pred),
                                  torch.from_numpy(target),
                                  size_average=avg).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)


def test_ms_ssim_refuses_small_frames_as_jax_does():
    x = np.zeros((1, 160, 400, 3), np.float32)
    with pytest.raises(ValueError, match="min\\(H, W\\) > 160"):
        ref_msssim.ms_ssim(jnp.asarray(x), jnp.asarray(x))
    with pytest.raises(ValueError, match="min\\(H, W\\) > 160"):
        port_msssim.ms_ssim(torch.from_numpy(x), torch.from_numpy(x))


def test_metrics_match_jax():
    pred, target = _pair(MS_SHAPE, seed=8)
    pj, tj = jnp.asarray(pred), jnp.asarray(target)
    pt, tt = torch.from_numpy(pred), torch.from_numpy(target)
    for name in ("psnr", "psnr_per_frame", "msssim_per_frame"):
        np.testing.assert_allclose(getattr(port_metrics, name)(pt, tt),
                                   getattr(ref_metrics, name)(pj, tj),
                                   rtol=RTOL, err_msg=name)
    # the 1e-9 inside the log: identical frames give 90 dB
    same = port_metrics.psnr_per_frame(tt, tt)
    np.testing.assert_allclose(same.numpy(), 90.0, rtol=1e-6)


@pytest.mark.parametrize("lr_type", ["cosine_0.1_1_0.1", "cosine_0_1_0.1",
                                     "cosine_0.2_2_0",
                                     "hybrid_0.1_1_2_0.1_0.01",
                                     "enerv_sch"])
def test_lr_multiplier_matches_jax_on_a_grid(lr_type):
    epochs, n = 7, 13
    for epoch in range(epochs):
        for i in range(n):
            kw = dict(cur_iter=i, epochs=epochs, full_data_length=n,
                      cur_epoch=epoch)
            progress = (epoch + i / n) / epochs
            assert lr_multiplier(lr_type, progress, **kw) == \
                ref_schedules.lr_multiplier(lr_type, progress, **kw)
    with pytest.raises(NotImplementedError):
        lr_multiplier("step_10", 0.5)
