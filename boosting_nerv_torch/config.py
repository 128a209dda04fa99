"""Configuration of the port (counterpart of boosting_nerv_tpu/config.py).

``BoostConfig`` carries the knobs of the reference CLI with the same names,
string encodings (``--embed pe_1.25_80``, ``--ks 0_1_5``, ``--fc_hw 9_16``,
``--enc_dim 64_16``, ``--data_split 1_1_1``, ``--crop_list 720_1280``) and
defaults as the JAX package's config: the dataset, architecture, training,
post-training quantisation, CEM compression, evaluation and misc fields,
and of the JAX package's compute knobs those that mean something on one
GPU (``train_precision``, ``micro_batch``, ``remat``) or that the port's
trainer refuses until their slice lands (``dp``, ``sp``, ``profile``,
``planar_train``).  ``decoder_stage_plan``, ``resolve_sizes`` and
``model_expansion`` are the same arithmetic as there (the reference's channel schedule and model-sizing
solver), so that one set of flags gives both packages the same model;
``tests/test_torch_config.py`` holds them to it.  The port keeps its own
copy because it must run where the JAX package is absent.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class BoostConfig:
    # dataset
    data_path: str = ""
    vid: str = "video"
    shuffle_data: bool = False
    data_split: str = "1_1_1"
    crop_list: str = "640_1280"
    resize_list: str = "-1"

    # architecture
    model: str = "HNeRV_Boost"  # NeRV_Boost | ENeRV | ENeRV_Boost | HNeRV_Boost | HNeRV
    embed: str = "pe_1.25_80"
    ks: str = "0_1_5"
    enc_blks: int = 1
    enc_strds: List[int] = field(default_factory=list)
    enc_dim: str = "64_16"
    modelsize: float = 1.5
    saturate_stages: int = -1
    lfreq: str = "pi"
    fc_dim: Optional[int] = None
    fc_hw: str = "9_16"
    reduce: float = 1.2
    lower_width: int = 32
    dec_strds: List[int] = field(default_factory=lambda: [5, 3, 2, 2, 2])
    dec_blks: List[int] = field(default_factory=lambda: [1, 1, 1, 1, 1])
    conv_type: List[str] = field(default_factory=lambda: ["convnext", "pshuffel"])
    norm: str = "none"
    act: str = "gelu"
    sft_block: str = "none"  # "res_sft" enables the TAT conditional decoder
    ch_t: int = 32
    block_dim: int = 128
    out_bias: str = "tanh"

    # training
    workers: int = 2
    batchSize: int = 1
    start_epoch: int = -1
    not_resume: bool = False
    epochs: int = 5
    lr: float = 0.001
    lr_type: str = "cosine_0.1_1_0.1"
    loss: str = "Fusion6"
    optim_type: str = "Adan"
    clip_max_norm: Optional[float] = None  # None: unset, clipping off
    inpanting: str = "none"
    interpolation: bool = False  # halves the embedding budget when sizing
    embed_inter: bool = False

    # post-training quantisation of the regression eval; the bit widths
    # and quantisers of the CEM compression finetune
    quant: bool = False  # parsed, unused by the regression trainer (as JAX)
    quant_model_bit: int = 8
    quant_bias_bit: int = 8
    quant_embed_bit: int = 6
    quant_axis: int = 0  # parsed, unused (as in the JAX package)
    per_channel_w: bool = False
    per_channel_b: bool = False
    per_channel_e: bool = False
    quantizer_w: str = "lsq"
    quantizer_b: str = "lsq"
    quantizer_e: str = "lsqv2"
    embed_entropy: bool = False  # the embedding's bits in the rate term
    target_bit: float = 5.0      # bits a parameter the rate term aims at
    lambda_rate: float = 0.2

    # evaluation
    eval_only: bool = False
    eval_freq: int = 10
    dump_images: bool = False
    dump_videos: bool = False
    eval_fps: bool = False

    # misc
    manualSeed: int = 1
    debug: bool = False
    print_freq: int = 50
    weight: str = "None"
    overwrite: bool = False
    outf: str = "unify"
    suffix: str = ""

    # compute
    dp: int = 1
    sp: int = 1
    profile: bool = False
    # "highest": float32 convolutions and matmuls with TF32 off (the
    # reference trains fp32); "high" / "default": TF32 on
    train_precision: str = "highest"
    # gradient accumulation over equal micro-batches of this many frames
    # (mean gradients); 0 = off
    micro_batch: int = 0
    remat: bool = False  # recompute the forward in the backward pass
    planar_train: int = 0

    @property
    def fc_h(self) -> int:
        return int(self.fc_hw.split("_")[0])

    @property
    def fc_w(self) -> int:
        return int(self.fc_hw.split("_")[1])

    @property
    def crop_h(self) -> int:
        return int(self.crop_list.split("_")[0])

    @property
    def crop_w(self) -> int:
        return int(self.crop_list.split("_")[1])

    @property
    def ks_triple(self) -> Tuple[int, int, int]:
        a, b, c = [int(x) for x in self.ks.split("_")]
        return a, b, c

    @property
    def enc_dim1(self) -> int:
        return int(float(self.enc_dim.split("_")[0]))

    @property
    def enc_dim2(self) -> int:
        """Embedding channel count (only valid after `resolve_sizes`)."""
        return int(float(self.enc_dim.split("_")[1]))

    @property
    def is_hnerv_family(self) -> bool:
        return "HNeRV" in self.model

    @property
    def uses_frame_input(self) -> bool:
        """True when the model consumes frames (the encoder path), as the
        reference selects its input (train_nerv_all.py:337-340); the
        index-only models take the normalised frame index."""
        return "pe" not in self.embed or "HNeRV_Boost" in self.model

    def replace(self, **kw) -> "BoostConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class StageSpec:
    """One decoder conv block: ngf -> new_ngf, kernel ks, upsample strd."""
    ngf: int
    new_ngf: int
    ks: int
    strd: int


def decoder_stage_plan(cfg: BoostConfig, fc_dim: int, expansion: float = 1.0,
                       hnerv_style: bool = False) -> List[StageSpec]:
    """Per-block channel schedule of the upsampling decoder.

    NeRV/ENeRV style: stage 0 widens by ``expansion``, later stages
    floor-divide by ``reduce`` (stride-1 stages keep width).  HNeRV style:
    every stage round-divides by ``reduce`` (or sqrt(strd) when
    reduce == -1).  A stage of ``dec_blks[i]`` blocks upsamples in its
    first block only."""
    _, ks1, ks2 = cfg.ks_triple
    plan: List[StageSpec] = []
    ngf = fc_dim
    for i, strd in enumerate(cfg.dec_strds):
        if hnerv_style:
            reduction = math.sqrt(strd) if cfg.reduce == -1 else cfg.reduce
            new_ngf = int(max(round(ngf / reduction), cfg.lower_width))
        elif i == 0:
            new_ngf = int(ngf * expansion)
        else:
            new_ngf = int(max(ngf // (1 if strd == 1 else cfg.reduce),
                              cfg.lower_width))
        for j in range(cfg.dec_blks[i]):
            plan.append(StageSpec(ngf=ngf, new_ngf=new_ngf,
                                  ks=min(ks1 + 2 * i, ks2),
                                  strd=1 if j else strd))
            ngf = new_ngf
    return plan


def resolve_sizes(cfg: BoostConfig, final_size: int, full_data_length: int
                  ) -> BoostConfig:
    """The reference sizing pass: the HNeRV embedding width (in
    ``enc_dim``) from the parameter budget ``modelsize`` (M) and the video
    (``final_size`` pixels a frame, ``full_data_length`` frames), then
    ``fc_dim`` as the root of a*fc_dim^2 + b*fc_dim + (c - decoder_size)
    unless it is set.  The result also carries ``embed_param`` (the
    embedding's parameter count, for the bits-per-pixel accounting),
    ``embed_dim``, ``fc_param``, ``final_size`` and ``full_data_length``
    as attributes, as the JAX package's does."""
    if ("pe" in cfg.embed or "le" in cfg.embed) and "HNeRV_Boost" not in cfg.model:
        embed_param = 0.0
        embed_dim = int(cfg.embed.split("_")[-1]) * 2
        fc_param = float(np.prod([int(x) for x in cfg.fc_hw.split("_")]))
        new_enc_dim = cfg.enc_dim
    else:
        total_enc_strds = float(np.prod(cfg.enc_strds))
        embed_hw = final_size / total_enc_strds ** 2
        enc_dim1, embed_ratio = [float(x) for x in cfg.enc_dim.split("_")]
        embed_dim = (int(embed_ratio * cfg.modelsize * 1e6 / full_data_length / embed_hw)
                     if embed_ratio < 1 else int(embed_ratio))
        embed_param = float(embed_dim) / total_enc_strds ** 2 * final_size * full_data_length
        if cfg.interpolation:
            embed_param = embed_param / 2
        new_enc_dim = f"{int(enc_dim1)}_{embed_dim}"
        fc_param = (np.prod(cfg.enc_strds) // np.prod(cfg.dec_strds)) ** 2 * 9

    decoder_size = cfg.modelsize * 1e6 - embed_param
    ch_reduce = 1.0 / cfg.reduce
    dec_ks1, dec_ks2 = [int(x) for x in cfg.ks.split("_")[1:]]
    n_stages = len(cfg.dec_strds)
    fix_ch_stages = n_stages if cfg.saturate_stages == -1 else cfg.saturate_stages
    a = ch_reduce * sum(
        ch_reduce ** (2 * i) * s ** 2 * min((2 * i + dec_ks1), dec_ks2) ** 2
        for i, s in enumerate(cfg.dec_strds[:fix_ch_stages]))
    b = embed_dim * fc_param
    c = cfg.lower_width ** 2 * sum(
        s ** 2 * min(2 * (fix_ch_stages + i) + dec_ks1, dec_ks2) ** 2
        for i, s in enumerate(cfg.dec_strds[fix_ch_stages:]))
    fc_dim = cfg.fc_dim
    if fc_dim is None:
        fc_dim = int(np.roots([a, b, c - decoder_size]).max())
    out = cfg.replace(fc_dim=fc_dim, enc_dim=new_enc_dim)
    out.embed_param = embed_param
    out.embed_dim = embed_dim
    out.fc_param = fc_param
    out.final_size = final_size
    out.full_data_length = full_data_length
    return out


def model_expansion(model: str) -> float:
    """Channel expansion of decoder stage 0 (train_nerv_all.py:220-227)."""
    return {"NeRV_Boost": 1, "ENeRV_Boost": 3}.get(model, 1)


def model_stage_plan(cfg: BoostConfig) -> List[StageSpec]:
    """The decoder stage plan of ``cfg.model``: HNeRV style for the HNeRV
    families, else stage 0 widened by the family's expansion (E-NeRV's 3,
    models/enerv.py)."""
    if cfg.model in ("HNeRV_Boost", "HNeRV"):
        return decoder_stage_plan(cfg, cfg.fc_dim, hnerv_style=True)
    expansion = 3 if cfg.model == "ENeRV" else model_expansion(cfg.model)
    return decoder_stage_plan(cfg, cfg.fc_dim, expansion=expansion)
