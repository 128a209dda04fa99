"""The port's optimizers against the JAX trainer's ``make_optimizer`` and
``adan`` on the CPU: 5 steps of random gradients (drawn with numpy from a
seed) from the same parameters, with the learning rate set per step."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from boosting_nerv_torch.training.adan import Adan
from boosting_nerv_torch.training.trainer import make_optimizer
from boosting_nerv_tpu.training import trainer as ref_trainer
from boosting_nerv_tpu.training.adan import adan as ref_adan

SHAPES = [(3, 3, 4, 6), (6,), (5, 7)]
LRS = [1e-3, 3e-3, 2e-3, 1e-3, 5e-4]
RTOL = 1e-5   # float32 parameters after 5 updates


def _draw(seed, scale):
    r = np.random.default_rng(seed)
    params = [r.normal(size=s).astype(np.float32) for s in SHAPES]
    grads = [[(scale * r.normal(size=s)).astype(np.float32) for s in SHAPES]
             for _ in LRS]
    return params, grads


def _run_jax(opt, params, grads):
    p = [jnp.asarray(x) for x in params]
    state = opt.init(p)
    for lr, g in zip(LRS, grads):
        u, state = opt.update([jnp.asarray(x) for x in g], state, p,
                              lr=jnp.float32(lr))
        p = optax.apply_updates(p, u)
    return [np.asarray(x) for x in p]


def _run_port(make, params, grads):
    p = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in params]
    opt = make(p)
    for lr, g in zip(LRS, grads):
        for t, x in zip(p, g):
            t.grad = torch.from_numpy(x.copy())
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
    return [t.detach().numpy() for t in p]


def _close(got, want):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("optim_type", ["Adan", "adan", "ADAM", "adam"])
@pytest.mark.parametrize("clip", [0.0, 1.0])
def test_make_optimizer_matches_jax(optim_type, clip):
    # gradient norms ~ 16: the clip at 1.0 acts on every step
    params, grads = _draw(seed=len(optim_type) + int(clip), scale=1.0)
    want = _run_jax(ref_trainer.make_optimizer(optim_type, clip), params,
                    grads)
    got = _run_port(lambda p: make_optimizer(optim_type, p, clip), params,
                    grads)
    _close(got, want)


def test_clip_leaves_gradients_below_the_norm_unchanged():
    params, grads = _draw(seed=9, scale=1e-2)  # norm ~ 0.06 < 1
    want = _run_port(lambda p: make_optimizer("adan", p, 0.0), params, grads)
    got = _run_port(lambda p: make_optimizer("adan", p, 1.0), params, grads)
    _close(got, want)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError):
        make_optimizer("sgd", [torch.nn.Parameter(torch.zeros(2))])


@pytest.mark.parametrize("kw", [dict(weight_decay=0.02),
                                dict(weight_decay=0.02, no_prox=True),
                                dict(max_grad_norm=1.0)])
def test_adan_options_match_jax(kw):
    params, grads = _draw(seed=11, scale=1.0)
    opt = ref_adan(learning_rate=1.0, **kw)
    want = _run_jax(opt, params, grads)
    got = _run_port(lambda p: Adan(p, lr=1.0, **kw), params, grads)
    _close(got, want)
