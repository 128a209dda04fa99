"""E-NeRV and E-NeRV-Boost in PyTorch (port of
boosting_nerv_tpu/models/enerv.py): an MLP-split trunk (a t-branch and an
xy-branch fused through two small transformer blocks) ahead of the conv
decoder.

- ``Attention`` (one bias-free qkv Dense split into thirds; an output
  Dense unless heads == 1 and dim_head == dim), ``FeedForward`` (Dense,
  exact GELU, Dense), ``TransformerBlock`` (both with residuals, no norm).
- ``_ENeRVTrunk``: PE(xy) of the fc_h x fc_w grid (meshgrid "ij" over
  arange(fc_h) / fc_h and arange(fc_w) / fc_w) -> stem_xy -> trans1 (one
  head) -> * stem_t(PE(t)) -> trans2 (8 heads) -> the [B, fc_h, fc_w,
  block_dim] grid (NHWC, as JAX reshapes it) -> to_conv (a Dense over the
  channels, unless block_dim == fc_dim).
- ``ENeRV``: per stage an InstanceNorm and a FiLM (gamma, beta) from a
  128-wide t-branch, then the block (stage 0 a ConvUpBlock), no TAT.
- ``ENeRVBoost``: every block (stage 0 a ConvUpBlock) modulated through
  its ResBlockSFT by t_branch(PE(t)).

t [B] -> frame [B, H, W, 3]; inside, the conv blocks run NCHW.  With
``rows`` (the mesh's 'spatial' axis) the conv decoder runs split by rows
after the whole trunk, and the frame leaves whole on every rank; without it
the same body runs unsplit.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn as nn

from ..config import BoostConfig, model_stage_plan
from ..ops.activations import get_activation
from ..ops.pe import PEConfig, position_encoding
from ..parallel.spatial import WHOLE
from .blocks import MLP, ConvUpBlock, NeRVBlock, TConv, TDense, norm_layer
from .hnerv import _decode_rows


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.qkv = TDense(dim, inner * 3, use_bias=False)
        self.out = (None if heads == 1 and dim_head == dim
                    else TDense(inner, dim))

    def forward(self, x):
        b, n, _ = x.shape
        q, k, v = (t.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)
                   for t in self.qkv(x).chunk(3, dim=-1))
        attn = torch.softmax(q @ k.transpose(-1, -2) * self.dim_head ** -0.5,
                             dim=-1)
        o = (attn @ v).transpose(1, 2).reshape(b, n, -1)
        return o if self.out is None else self.out(o)


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden_dim: int):
        super().__init__()
        self.fc1 = TDense(dim, hidden_dim)
        self.fc2 = TDense(hidden_dim, dim)
        self.act = get_activation("gelu")

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, mlp_dim: int):
        super().__init__()
        self.attn = Attention(dim, heads, dim_head)
        self.ff = FeedForward(dim, mlp_dim)

    def forward(self, x):
        x = self.attn(x) + x
        return self.ff(x) + x


class _ENeRVTrunk(nn.Module):
    """The shared E-NeRV trunk: t-branch and xy-branch fused through the
    two transformer blocks; forward(t) -> (NCHW [B, fc_dim, fc_h, fc_w],
    PE(t))."""

    def __init__(self, cfg: BoostConfig):
        super().__init__()
        self.cfg = cfg
        self.pe = PEConfig.from_string(cfg.embed, cfg.lfreq)
        L2, bd = self.pe.embed_length, cfg.block_dim
        self.stem_t = MLP(L2, (bd * 2, bd), act=cfg.act)
        self.stem_xy = MLP(2 * L2, (bd,), act=cfg.act)
        self.trans1 = TransformerBlock(bd, heads=1, dim_head=64,
                                       mlp_dim=bd // 2)
        self.trans2 = TransformerBlock(bd, heads=8, dim_head=64,
                                       mlp_dim=bd // 2)
        self.to_conv = (None if bd == cfg.fc_dim
                        else MLP(bd, (cfg.fc_dim,), act=cfg.act))
        xs = (np.arange(cfg.fc_h) / cfg.fc_h).astype(np.float32)
        ys = (np.arange(cfg.fc_w) / cfg.fc_w).astype(np.float32)
        gx, gy = np.meshgrid(xs, ys, indexing="ij")
        # float32 positions of the grid's cells, whatever the modules' dtype
        self.grid = np.stack([gx.reshape(-1), gy.reshape(-1)])

    def forward(self, t: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        dt = self.stem_xy.layers[0].weight.dtype
        pe_t = position_encoding(t, self.pe).to(dt)
        t_emb = self.stem_t(pe_t)
        grid = torch.from_numpy(self.grid).to(t.device)
        xy = torch.cat([position_encoding(grid[0], self.pe),
                        position_encoding(grid[1], self.pe)], dim=-1)
        xy = self.stem_xy(xy.to(dt))[None].expand(t.shape[0], -1, -1)
        emb = self.trans2(self.trans1(xy) * t_emb[:, None, :])
        emb = emb.reshape(t.shape[0], cfg.fc_h, cfg.fc_w, -1)
        if self.to_conv is not None:
            emb = self.to_conv(emb)
        return emb.permute(0, 3, 1, 2), pe_t


def _blocks(cfg: BoostConfig, plan, cond: int) -> nn.ModuleList:
    """Stage 0's blocks as ConvUpBlocks, the rest as NeRVBlocks."""
    blocks, idx = [], 0
    for i, n in enumerate(cfg.dec_blks[:len(cfg.dec_strds)]):
        for _ in range(n):
            s = plan[idx]
            blocks.append(
                ConvUpBlock(cfg.conv_type[1], s.ngf, s.new_ngf, s.ks, s.strd,
                            norm=cfg.norm, act=cfg.act, cond_ch=cond)
                if i == 0 else
                NeRVBlock(True, cfg.conv_type[1], s.ngf, s.new_ngf, s.ks,
                          s.strd, norm=cfg.norm, act=cfg.act, cond_ch=cond))
            idx += 1
    return nn.ModuleList(blocks)


class ENeRV(nn.Module):
    """Baseline E-NeRV (no TAT): per stage an InstanceNorm (no affine) and
    a FiLM from the 128-wide t-branch, then the block."""

    def __init__(self, cfg: BoostConfig):
        super().__init__()
        self.cfg = cfg
        self.trunk = _ENeRVTrunk(cfg)
        L2 = self.trunk.pe.embed_length
        self.t_branch = MLP(L2, (128, 128), act=cfg.act)
        plan = model_stage_plan(cfg)  # stage 0 widened by 3
        self.blocks = _blocks(cfg, plan, 0)
        self.t_layers = nn.ModuleList(MLP(128, (2 * s.ngf,), act=cfg.act)
                                      for s in plan)
        self.head = TConv(plan[-1].new_ngf, 3, 1, 1, 0)

    def forward(self, t: torch.Tensor, rows=None) -> torch.Tensor:
        x, pe_t = self.trunk(t)
        t_manip = self.t_branch(pe_t)
        rows = WHOLE if rows is None else rows
        x, split = rows.settle(x, False, "grid")
        for blk, t_layer in zip(self.blocks, self.t_layers):
            x = norm_layer("in", x, rows, split)
            gamma, beta = t_layer(t_manip).chunk(2, dim=-1)
            x, split = blk.forward_rows(
                x * gamma[:, :, None, None] + beta[:, :, None, None],
                split, rows)
        return _decode_rows([], self.head, self.cfg, x, split, rows)


class ENeRVBoost(nn.Module):
    def __init__(self, cfg: BoostConfig):
        super().__init__()
        self.cfg = cfg
        self.trunk = _ENeRVTrunk(cfg)
        L2 = self.trunk.pe.embed_length
        self.t_branch = MLP(L2, (cfg.ch_t * 2, cfg.ch_t), act=cfg.act)
        plan = model_stage_plan(cfg)
        cond = cfg.ch_t if cfg.sft_block == "res_sft" and cfg.ch_t else 0
        self.blocks = _blocks(cfg, plan, cond)
        self.head = TConv(plan[-1].new_ngf, 3, 1, 1, 0)

    def forward(self, t: torch.Tensor, rows=None) -> torch.Tensor:
        x, pe_t = self.trunk(t)
        t_manip = self.t_branch(pe_t)
        rows = WHOLE if rows is None else rows
        x, split = rows.settle(x, False, "grid")
        return _decode_rows(self.blocks, self.head, self.cfg, x, split, rows,
                            t_manip)
