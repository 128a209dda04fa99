"""NeRV-Boost in PyTorch (port of boosting_nerv_tpu/models/nerv.py): an
index-only INR with the TAT conditional decoder.

PE(t) -> stem MLP [2L, 256, fc_h * fc_w * fc_dim] -> the [B, fc_h, fc_w,
fc_dim] grid (NHWC, as JAX reshapes it); PE(t) -> stem_t MLP [2L, 2 ch_t,
ch_t] -> t_embed; then the NeRVBlock stack (stage 0 widens by the family's
expansion, later stages floor-divide by ``reduce``), each modulated
through its ResBlockSFT by t_embed, and a 1x1 head conv + OutImg.

t [B] -> frame [B, H, W, 3]; inside, the modules run NCHW.  With ``rows``
(the mesh's 'spatial' axis) the conv decoder runs split by rows after the
whole stem, and the frame leaves whole on every rank; without it the same
body runs unsplit.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..config import BoostConfig, model_stage_plan
from ..ops.pe import PEConfig, position_encoding
from ..parallel.spatial import WHOLE
from .blocks import MLP, NeRVBlock, TConv
from .hnerv import _decode_rows


def grid_nchw(x: torch.Tensor, fc_h: int, fc_w: int) -> torch.Tensor:
    """[B, fc_h * fc_w * C] flat features, in the JAX package's NHWC order
    (``x.reshape(B, fc_h, fc_w, C)``) -> NCHW [B, C, fc_h, fc_w]."""
    return x.reshape(x.shape[0], fc_h, fc_w, -1).permute(0, 3, 1, 2)


class NeRVBoost(nn.Module):
    def __init__(self, cfg: BoostConfig):
        super().__init__()
        self.cfg = cfg
        self.pe = PEConfig.from_string(cfg.embed, cfg.lfreq)
        L2 = self.pe.embed_length
        self.stem = MLP(L2, (256, cfg.fc_h * cfg.fc_w * cfg.fc_dim),
                        act=cfg.act)
        self.stem_t = MLP(L2, (cfg.ch_t * 2, cfg.ch_t), act=cfg.act)
        plan = model_stage_plan(cfg)
        cond = cfg.ch_t if cfg.sft_block == "res_sft" and cfg.ch_t else 0
        self.blocks = nn.ModuleList(
            NeRVBlock(True, cfg.conv_type[1], s.ngf, s.new_ngf, s.ks, s.strd,
                      norm=cfg.norm, act=cfg.act, cond_ch=cond)
            for s in plan)
        self.head = TConv(plan[-1].new_ngf, 3, 1, 1, 0)

    def forward(self, t: torch.Tensor, rows=None) -> torch.Tensor:
        """t: [B] normalised frame indices in (0, 1] -> [B, H, W, 3]."""
        cfg = self.cfg
        pe = position_encoding(t, self.pe).to(self.head.weight.dtype)
        x = grid_nchw(self.stem(pe), cfg.fc_h, cfg.fc_w)
        t_embed = self.stem_t(pe)
        rows = WHOLE if rows is None else rows
        x, split = rows.settle(x, False, "grid")
        return _decode_rows(self.blocks, self.head, cfg, x, split, rows,
                            t_embed)
