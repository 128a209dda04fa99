"""Adan, adaptive Nesterov momentum (port of
boosting_nerv_tpu/training/adan.py), as a ``torch.optim.Optimizer``.

The update of the reference optimizer: betas (0.98, 0.92, 0.99), eps 1e-8,
bias corrections ``1 - b1^k``, ``1 - b2^k`` and ``sqrt(1 - b3^k)`` at step
k, the previous gradient taken equal to the current one on the first step
(a zero first difference), proximal weight decay (decoupled with
``no_prox``), and an optional clip of the global gradient norm to
``max_grad_norm`` by ``max_grad_norm / (norm + eps)``.  The learning rate
is read from ``param_groups[i]["lr"]``, which the trainer sets before each
step.
"""

from __future__ import annotations

import math
from typing import Iterable

import torch


class Adan(torch.optim.Optimizer):
    def __init__(self, params: Iterable, lr: float = 1e-3,
                 betas=(0.98, 0.92, 0.99), eps: float = 1e-8,
                 weight_decay: float = 0.0, max_grad_norm: float = 0.0,
                 no_prox: bool = False):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay,
                                      max_grad_norm=max_grad_norm,
                                      no_prox=no_prox))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Adan takes no closure")
        groups = [(g, [p for p in g["params"] if p.grad is not None])
                  for g in self.param_groups]
        clip = 1.0
        max_norm = self.defaults["max_grad_norm"]
        if max_norm > 0.0:
            grads = [p.grad for _, ps in groups for p in ps]
            gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            clip = torch.clamp(max_norm / (gnorm + self.defaults["eps"]),
                               max=1.0)
        for group, params in groups:
            b1, b2, b3 = group["betas"]
            lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
            for p in params:
                g = p.grad * clip
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_diff"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
                    st["prev_grad"] = g.clone()  # first step: zero diff
                st["step"] += 1
                k = st["step"]
                bc1 = 1.0 - b1 ** k
                bc2 = 1.0 - b2 ** k
                bc3_sqrt = math.sqrt(1.0 - b3 ** k)
                diff = g - st["prev_grad"]
                m = st["exp_avg"].mul_(b1).add_((1.0 - b1) * g)
                d = st["exp_avg_diff"].mul_(b2).add_((1.0 - b2) * diff)
                u = g + b2 * diff
                n = st["exp_avg_sq"].mul_(b3).add_((1.0 - b3) * u * u)
                denom = torch.sqrt(n) / bc3_sqrt + eps
                delta = -(lr / bc1) * m / denom - (lr * b2 / bc2) * d / denom
                if wd > 0.0:
                    if group["no_prox"]:
                        delta = delta - lr * wd * p
                    else:  # proximal: p_new = (p + delta) / (1 + lr * wd)
                        delta = (p + delta) / (1.0 + lr * wd) - p
                p.add_(delta)
                st["prev_grad"].copy_(g)
