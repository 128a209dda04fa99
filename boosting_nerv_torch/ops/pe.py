"""Sinusoidal frame-index positional encoding (port of
boosting_nerv_tpu/ops/pe.py).

An embed spec ``pe_<lbase>_<levels>`` gives frequencies
``lbase**arange(levels) * lfreq`` (``lfreq`` defaults to pi); the encoding
is ``[sin(pos*f), cos(pos*f)]``, a flat ``[..., 2*levels]`` vector.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class PEConfig:
    lbase: float
    levels: int
    lfreq: float = math.pi

    @property
    def embed_length(self) -> int:
        return 2 * self.levels

    @staticmethod
    def from_string(embed: str, lfreq: str = "pi") -> "PEConfig":
        """Parse the reference CLI spelling, e.g. ``pe_1.25_80``."""
        if "pe" not in embed:
            raise ValueError(f"not a positional-encoding spec: {embed!r}")
        parts = embed.split("_")
        lbase, levels = float(parts[-2]), int(float(parts[-1]))
        freq = math.pi if lfreq == "pi" else float(lfreq)
        return PEConfig(lbase=lbase, levels=levels, lfreq=freq)


def position_encoding(pos: torch.Tensor, cfg: PEConfig) -> torch.Tensor:
    """pos: [...] positions in (0, 1] -> [..., 2*levels] float32.

    The powers are rounded from float64: the top levels feed sin with
    arguments near 1e8, where one ulp of a float32 ``pow`` changes the
    feature outright, and correctly rounded powers are what the JAX
    reference computes."""
    powers = torch.tensor([cfg.lbase ** i for i in range(cfg.levels)],
                          dtype=torch.float64, device=pos.device)
    bases = powers.to(torch.float32) * cfg.lfreq
    vals = pos[..., None].to(torch.float32) * bases
    return torch.cat([torch.sin(vals), torch.cos(vals)], dim=-1)
