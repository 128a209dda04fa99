"""HNeRV-Boost and the HNeRV baseline in PyTorch (port of
boosting_nerv_tpu/models/hnerv.py).

HNeRV-Boost: a ConvNeXt encoder maps a frame to a small per-frame
embedding; the decoder (1x1-conv stem, then sinusoidal NeRV blocks, each
modulated through its ResBlockSFT by stem_t(PE(t))) maps embedding + frame
index to the frame.

HNeRV (no TAT): the encoder (ConvNeXt, or strided NeRVBlocks of
``conv_type[0]``), or with no ``enc_strds`` the PE of the frame index as a
[B, 1, 1, 2L] embedding; a 1x1-conv stem to fc_dim fc_h fc_w channels,
rearranged into an fc_h x fc_w pixel block; plain NeRV blocks; a 3x3 head.

Public tensors keep the JAX layout: frame [B, H, W, 3], embedding
[B, h, w, C], t [B].  Inside, the modules run NCHW.

With ``rows`` (a ``parallel.spatial.Rows``: the mesh's 'spatial' axis)
``encode``, ``decode`` and ``forward`` run split by rows: the frame enters
whole and the rank takes its rows, the maps are split or whole by the
plan, and the embedding and the output frame leave whole on every rank
(``Rows.collect``).  Without it they run the same body under
``WHOLE``, which is the unsplit forward.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn as nn

from ..config import BoostConfig, model_stage_plan
from ..ops.losses import out_img
from ..ops.pe import PEConfig, position_encoding
from ..parallel.spatial import WHOLE
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
        plan = model_stage_plan(cfg)
        self.blocks = nn.ModuleList(
            NeRVBlock(True, cfg.conv_type[1], s.ngf, s.new_ngf, s.ks, s.strd,
                      norm=cfg.norm, act=cfg.act, cond_ch=cond)
            for s in plan)
        self.head = TConv(plan[-1].new_ngf, 3, 3, 1, 1)

    def encode(self, img: torch.Tensor, rows=None) -> torch.Tensor:
        """[B, H, W, 3] frame -> [B, h, w, embed_dim] content embedding."""
        return _encode_rows(self.encoder, img, rows)

    def time_embed(self, t: torch.Tensor) -> torch.Tensor:
        """[B] normalised frame index -> [B, ch_t] stem_t(PE(t))."""
        pe = position_encoding(t, self.pe).to(self.head.weight.dtype)
        return self.stem_t(pe)

    def decode(self, embed: torch.Tensor, t: torch.Tensor, rows=None
               ) -> torch.Tensor:
        """Embedding [B, h, w, C] + index [B] -> [B, H, W, 3] frame: the
        decode path the fps clock times (encoder excluded)."""
        t_embed = self.time_embed(t)
        rows = WHOLE if rows is None else rows
        x, split = rows.settle(embed.permute(0, 3, 1, 2), False, "embedding")
        x, split = self.stem.forward_rows(x, split, rows, t_embed)
        return _decode_rows(self.blocks, self.head, self.cfg, x, split, rows,
                            t_embed)

    def forward(self, img: torch.Tensor, t: torch.Tensor, rows=None
                ) -> torch.Tensor:
        return self.decode(self.encode(img, rows), t, rows)


def _encode_rows(encoder: nn.Module, img: torch.Tensor, rows
                 ) -> torch.Tensor:
    """``encoder`` (ConvNeXt, or a NeRVBlock list) of the frame ``img``
    split by rows (``rows`` None: whole); the embedding whole on every
    rank, NHWC."""
    rows = WHOLE if rows is None else rows
    x, split = rows.settle(img.permute(0, 3, 1, 2), False, "frame")
    if isinstance(encoder, nn.ModuleList):
        for blk in encoder:
            x, split = blk.forward_rows(x, split, rows)
    else:
        x, split = encoder.forward_rows(x, split, rows)
    return rows.collect(x, split, "embedding").permute(0, 2, 3, 1)


def _decode_rows(blocks, head, cfg, x, split, rows, t_embed=None
                 ) -> torch.Tensor:
    """The decoder's blocks, head and OutImg split by rows from NCHW
    ``x``; the frame whole on every rank, NHWC."""
    for blk in blocks:
        x, split = blk.forward_rows(x, split, rows, t_embed)
    x, split = rows.conv(head, x, split, "head")
    return rows.collect(out_img(x, cfg.out_bias), split,
                        "frame").permute(0, 2, 3, 1)


def decoder_only_params(state: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """Drop the encoder's entries from a state dict: the deployable
    decode-only artifact.  Load it with ``load_state_dict(..., strict=False)``
    into a model that only decodes."""
    return {k: v for k, v in state.items() if not k.startswith("encoder.")}


class HNeRV(nn.Module):
    """Baseline HNeRV (no TAT), with the encoder-less PE variant."""

    def __init__(self, cfg: BoostConfig):
        super().__init__()
        self.cfg = cfg
        ks_enc = cfg.ks_triple[0]
        self.pe = None
        if len(cfg.enc_strds):
            dims = _encoder_dims(cfg)
            if cfg.conv_type[0] == "convnext":
                self.encoder = ConvNeXtEncoder(3, cfg.enc_blks,
                                               cfg.enc_strds, dims)
            else:
                self.encoder = nn.ModuleList(
                    NeRVBlock(False, cfg.conv_type[0], i, d, ks_enc, s,
                              norm=cfg.norm, act=cfg.act)
                    for i, d, s in zip([3, *dims[:-1]], dims, cfg.enc_strds))
            hw = int(np.prod(cfg.enc_strds) // np.prod(cfg.dec_strds))
            self.fc_h = self.fc_w = hw
            embed_ch = dims[-1]
        else:
            self.pe = PEConfig.from_string(cfg.embed, cfg.lfreq)
            self.fc_h, self.fc_w = cfg.fc_h, cfg.fc_w
            self.encoder = None
            embed_ch = self.pe.embed_length
        out_f = int(cfg.fc_dim * self.fc_h * self.fc_w)
        self.stem = NeRVBlock(False, "conv", embed_ch, out_f, ks=0, strd=1,
                              norm=cfg.norm, act=cfg.act)
        plan = model_stage_plan(cfg)
        self.blocks = nn.ModuleList(
            NeRVBlock(True, cfg.conv_type[1], s.ngf, s.new_ngf, s.ks, s.strd,
                      norm=cfg.norm, act=cfg.act)
            for s in plan)
        self.head = TConv(plan[-1].new_ngf, 3, 3, 1, 1)

    def encode(self, x: torch.Tensor, rows=None) -> torch.Tensor:
        """Frame [B, H, W, 3] -> embedding [B, h, w, C]; or, encoder-less,
        the normalised index [B] -> its PE as [B, 1, 1, 2L]."""
        if self.encoder is None:
            pe = position_encoding(x, self.pe).to(self.head.weight.dtype)
            return pe[:, None, None, :]
        return _encode_rows(self.encoder, x, rows)

    def decode(self, embed: torch.Tensor, rows=None) -> torch.Tensor:
        """Embedding [B, h, w, C] -> frame [B, H, W, 3]."""
        rows = WHOLE if rows is None else rows
        x, split = rows.settle(embed.permute(0, 3, 1, 2), False, "embedding")
        x, split = self.stem.forward_rows(x, split, rows)
        if self.fc_h * self.fc_w > 1:
            x, split = rows.whole(self._fc_block, x, split, "fc_hw")
        return _decode_rows(self.blocks, self.head, self.cfg, x, split, rows)

    def _fc_block(self, x: torch.Tensor) -> torch.Tensor:
        """Channel c' fh fw + i fw + j -> pixel (i, j), c'."""
        fh, fw = self.fc_h, self.fc_w
        b, c, h, w = x.shape
        return x.reshape(b, c // (fh * fw), fh, fw, h, w).permute(
            0, 1, 4, 2, 5, 3).reshape(b, c // (fh * fw), h * fh, w * fw)

    def forward(self, x: torch.Tensor, rows=None) -> torch.Tensor:
        return self.decode(self.encode(x, rows), rows)
