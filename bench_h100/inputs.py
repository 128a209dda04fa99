"""What a run feeds the program and the reference, made from ``--seed``
on the device: the weights, the per-frame embeddings of a family that
takes them (its ``frame_inputs``) and the training cells' clip.  The same
seed gives the same tensors."""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from . import harness

# a distinct stream of the seed for each input
WEIGHTS, EMBEDS, CLIP = 0, 1, 2


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, stream); seeds up to
    2^63 - 1 are taken whole."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 3 + stream) % (2 ** 63 - 1))
    return g


def _fan_in(shape: Tuple[int, ...]) -> int:
    return math.prod(shape[1:]) if len(shape) > 1 else 0


def make_weights(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter of the configuration's model, float32: one uniform
    draw in [-1, 1) for all of them, each parameter's slice scaled by its
    bound (1 / sqrt(fan_in) of its layer for a conv's or a linear's weight
    and bias, 0.02 sqrt(3) for "trunc02" weights, whose std is then 0.02),
    in the order of the family's ``param_shapes``; LayerNorm 1 and 0,
    layer scale 1e-6."""
    shapes = harness.family(model["model"]).param_shapes(model)
    total = sum(math.prod(s) for s, _ in shapes.values())
    flat = torch.empty(total, device=device).uniform_(
        -1.0, 1.0, generator=generator(seed, WEIGHTS, device))
    out, at, fan = {}, 0, 0
    for name, (shape, init) in shapes.items():
        n = math.prod(shape)
        if name.endswith(".weight"):
            fan = _fan_in(shape)
        v = flat[at:at + n].view(shape)
        at += n
        if init == "fan_in":
            out[name] = v * (1.0 / math.sqrt(fan))
        elif init == "trunc02":
            out[name] = v * (0.02 * math.sqrt(3.0))
        else:
            out[name] = torch.full(shape, {"zero": 0.0, "one": 1.0,
                                           "gamma": 1e-6}[init],
                                   device=device)
    return out


def make_embeds(n: int, shape: Tuple[int, ...], seed: int, device
                ) -> torch.Tensor:
    """``n`` embeddings [n, *shape], N(0, 1): the scale of the ConvNeXt
    encoder's output, whose last op adds to a LayerNorm'd map."""
    return torch.randn((n, *shape), device=device,
                       generator=generator(seed, EMBEDS, device))


def make_clip(n: int, h: int, w: int, seed: int, device) -> torch.Tensor:
    """uint8 [n, h, w, 3]: the moving pattern of the program's
    ``synthetic_video`` (smooth gradients, a sine whose phase is drawn from
    the seed and moves with the frame, a bright square crossing the
    frame), computed on the device a frame at a time."""
    g = generator(seed, CLIP, device)
    phase = float(torch.rand((), device=device, generator=g)) * math.pi
    ys = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xs = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    base = torch.stack([ys / h + 0 * xs, xs / w + 0 * ys, (ys + xs) / (h + w)],
                       dim=-1)
    clip = torch.empty((n, h, w, 3), device=device, dtype=torch.uint8)
    for i in range(n):
        t = i / max(n - 1, 1)
        img = 0.6 * base + 0.2 * torch.sin(
            2 * math.pi * (xs / w * 3 + t) + phase)[..., None]
        cy, cx = int((h - h // 4) * t), int((w - w // 4) * (1 - t))
        img[cy:cy + h // 4, cx:cx + w // 4] += 0.3
        clip[i] = (img.clamp(0, 1) * 255).to(torch.uint8)
    return clip
