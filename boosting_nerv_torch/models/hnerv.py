"""HNeRV-Boost in PyTorch (port of boosting_nerv_tpu/models/hnerv.py).

A ConvNeXt encoder maps a frame to a small per-frame embedding; the decoder
(1x1-conv stem, then sinusoidal NeRV blocks, each modulated through its
ResBlockSFT by stem_t(PE(t))) maps embedding + frame index to the frame.

Public tensors keep the JAX layout: frame [B, H, W, 3], embedding
[B, h, w, C], t [B].  Inside, the modules run NCHW.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn

from ..config import BoostConfig, decoder_stage_plan
from ..ops.losses import out_img
from ..ops.pe import PEConfig, position_encoding
from .blocks import MLP, ConvNeXtEncoder, NeRVBlock, TConv


def _encoder_dims(cfg: BoostConfig) -> Sequence[int]:
    dims = [cfg.enc_dim1] * len(cfg.enc_strds)
    dims[-1] = cfg.enc_dim2
    return dims


class HNeRVBoost(nn.Module):
    def __init__(self, cfg: BoostConfig):
        super().__init__()
        self.cfg = cfg
        self.pe = PEConfig.from_string(cfg.embed, cfg.lfreq)
        dims = _encoder_dims(cfg)
        self.encoder = ConvNeXtEncoder(3, cfg.enc_blks, cfg.enc_strds, dims)
        self.stem_t = MLP(self.pe.embed_length, (cfg.ch_t * 2, cfg.ch_t),
                          act=cfg.act)
        cond = cfg.ch_t if cfg.sft_block == "res_sft" and cfg.ch_t else 0
        self.stem = NeRVBlock(False, "conv", dims[-1], cfg.fc_dim, ks=0,
                              strd=1, norm=cfg.norm, act=cfg.act,
                              cond_ch=cond)
        plan = decoder_stage_plan(cfg, cfg.fc_dim, hnerv_style=True)
        self.blocks = nn.ModuleList(
            NeRVBlock(True, cfg.conv_type[1], s.ngf, s.new_ngf, s.ks, s.strd,
                      norm=cfg.norm, act=cfg.act, cond_ch=cond)
            for s in plan)
        self.head = TConv(plan[-1].new_ngf, 3, 3, 1, 1)

    def encode(self, img: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] frame -> [B, h, w, embed_dim] content embedding."""
        return self.encoder(img.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def time_embed(self, t: torch.Tensor) -> torch.Tensor:
        """[B] normalised frame index -> [B, ch_t] stem_t(PE(t))."""
        pe = position_encoding(t, self.pe).to(self.head.weight.dtype)
        return self.stem_t(pe)

    def decode(self, embed: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """Embedding [B, h, w, C] + index [B] -> [B, H, W, 3] frame: the
        decode path the fps clock times (encoder excluded)."""
        t_embed = self.time_embed(t)
        x = self.stem(embed.permute(0, 3, 1, 2), t_embed)
        for blk in self.blocks:
            x = blk(x, t_embed)
        return out_img(self.head(x), self.cfg.out_bias).permute(0, 2, 3, 1)

    def forward(self, img: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(img), t)


def decoder_only_params(state: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """Drop the encoder's entries from a state dict: the deployable
    decode-only artifact.  Load it with ``load_state_dict(..., strict=False)``
    into a model that only decodes."""
    return {k: v for k, v in state.items() if not k.startswith("encoder.")}
