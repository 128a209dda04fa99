"""HNeRV-Boost in the plain reference (the family interface of
``models``): a frame's content embedding, conditioned on its index.

- the ConvNeXt encoder: per stage a stride x stride patchify conv (stage
  0: conv then LayerNorm; later stages: LayerNorm then conv) and ConvNeXt
  blocks (7x7 depthwise conv, LayerNorm, 4x MLP with exact GELU, layer
  scale, residual);
- the decoder stem: a 1x1 conv of the embedding, sin, a ResBlockSFT; the
  time embedding stem_t(PE(t)) conditions it and every stage;
- every stage divides the width by ``reduce`` (rounded); a 3x3 head.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from bench_h100 import inputs
from bench_h100.reference import models as ref
from bench_h100.reference.models import Macs, Params, Shapes

HEAD_K = 3
stage_layers = ref.stage_layers


def stage_plan(model: dict):
    return ref.stage_plan(model)


def _enc_dims(model: dict):
    dims = [int(model["enc_dim"].split("_")[0])] * len(model["enc_strds"])
    dims[-1] = int(model["enc_dim"].split("_")[1])
    return dims


def _embed_shape(model: dict) -> Tuple[int, int, int]:
    return (*ref.grid_hw(model), _enc_dims(model)[-1])


def param_shapes(model: dict) -> Shapes:
    """The encoder, stem_t, the stem's conv and ResBlockSFT, the stages,
    the head; the encoder's weights "trunc02", LayerNorms "one" / "zero",
    layer scales "gamma"."""
    out: Shapes = {}
    ch_t = model["ch_t"]
    levels = int(model["embed"].split("_")[-1])
    dims = _enc_dims(model)
    ins = [3, *dims[:-1]]
    for i, (ci, d, s) in enumerate(zip(ins, dims, model["enc_strds"])):
        out[f"encoder.convs.{i}.weight"] = ((d, ci, s, s), "trunc02")
        out[f"encoder.convs.{i}.bias"] = ((d,), "zero")
    for i, (ci, d) in enumerate(zip(ins, dims)):
        c = d if i == 0 else ci
        out[f"encoder.norms.{i}.weight"] = ((c,), "one")
        out[f"encoder.norms.{i}.bias"] = ((c,), "zero")
    for j, d in enumerate(d for d in dims for _ in range(model["enc_blks"])):
        n = f"encoder.blocks.{j}"
        out[n + ".gamma"] = ((d,), "gamma")
        out[n + ".dwconv.weight"] = ((d, 1, 7, 7), "trunc02")
        out[n + ".dwconv.bias"] = ((d,), "zero")
        out[n + ".norm.weight"] = ((d,), "one")
        out[n + ".norm.bias"] = ((d,), "zero")
        out[n + ".fc1.weight"] = ((4 * d, d), "trunc02")
        out[n + ".fc1.bias"] = ((4 * d,), "zero")
        out[n + ".fc2.weight"] = ((d, 4 * d), "trunc02")
        out[n + ".fc2.bias"] = ((d,), "zero")
    ref.add_linear(out, "stem_t.layers.0", 2 * levels, 2 * ch_t)
    ref.add_linear(out, "stem_t.layers.1", 2 * ch_t, ch_t)
    ref.add_conv(out, "stem.conv.conv", dims[-1], model["fc_dim"], 1)
    ref.add_rsft(out, "stem.rsft", model["fc_dim"], ch_t)
    plan = stage_plan(model)
    for i, s in enumerate(plan):
        ref.add_stage(out, i, s, ch_t)
    ref.add_conv(out, "head", plan[-1].new_ngf, 3, HEAD_K)
    return out


def frame_inputs(model: dict, n: int, seed: int, device) -> torch.Tensor:
    """The ``n`` frames' embeddings [n, fc_h, fc_w, C], from the seed."""
    return inputs.make_embeds(n, _embed_shape(model), seed, device)


def decode(embed, t, p: Params, model: dict, quant=None, calib=None):
    """Embedding [B, h, w, C] + index [B] -> [B, H, W, 3]."""
    dtype = p["head.weight"].dtype
    t_embed = ref.mlp(ref.position_encoding(t, model["embed"], dtype), p,
                      "stem_t", 2)
    x = torch.sin(ref.conv(embed.permute(0, 3, 1, 2).to(dtype), p,
                           "stem.conv.conv", 0))
    x = ref.rsft(x, p, "stem.rsft", t_embed)
    return ref.decode_stages(x, t_embed, p, stage_plan(model), quant, calib)


def _ln_channels(x, p, name):
    y = F.layer_norm(x.permute(0, 2, 3, 1), (x.shape[1],),
                     p[name + ".weight"], p[name + ".bias"], eps=1e-6)
    return y.permute(0, 3, 1, 2)


def encode(img, p: Params, model: dict):
    """ConvNeXt encoder: frame [B, H, W, 3] -> embedding [B, h, w, C]."""
    x = img.permute(0, 3, 1, 2)
    for i, s in enumerate(model["enc_strds"]):
        conv = lambda v: F.conv2d(v, p[f"encoder.convs.{i}.weight"],  # noqa
                                  p[f"encoder.convs.{i}.bias"], stride=s)
        if i == 0:
            x = _ln_channels(conv(x), p, "encoder.norms.0")
        else:
            x = conv(_ln_channels(x, p, f"encoder.norms.{i}"))
        for j in range(i * model["enc_blks"], (i + 1) * model["enc_blks"]):
            n = f"encoder.blocks.{j}"
            c = x.shape[1]
            y = F.conv2d(x, p[n + ".dwconv.weight"], p[n + ".dwconv.bias"],
                         padding=3, groups=c)
            y = F.layer_norm(y.permute(0, 2, 3, 1), (c,), p[n + ".norm.weight"],
                             p[n + ".norm.bias"], eps=1e-6)
            y = ref.lin(F.gelu(ref.lin(y, p, n + ".fc1")), p, n + ".fc2")
            x = x + (p[n + ".gamma"] * y).permute(0, 3, 1, 2)
    return x.permute(0, 2, 3, 1)


def forward(img, t, p: Params, model: dict):
    """The training forward: frame [B, H, W, 3] + index [B] ->
    reconstructed frame [B, H, W, 3]."""
    return decode(encode(img, p, model), t, p, model)


def front_layers(model: dict) -> Macs:
    """stem_t, then the stem's 1x1 conv and ResBlockSFT on the grid."""
    fh, fw, emb = _embed_shape(model)
    levels, ch_t, c = (int(model["embed"].split("_")[-1]), model["ch_t"],
                       model["fc_dim"])
    return [("stem_t", ref.mlp_macs([2 * levels, 2 * ch_t, ch_t])),
            ("stem.conv", ref.conv_macs(fh, fw, emb, c, 1)),
            *ref.rsft_layers("stem.rsft", fh, fw, c, ch_t)]


def encoder_layers(model: dict, clip: dict) -> Macs:
    """The ConvNeXt encoder on one frame of ``clip``'s size."""
    h, w, cin, out = clip["height"], clip["width"], 3, []
    for i, (d, s) in enumerate(zip(_enc_dims(model), model["enc_strds"])):
        h, w = h // s, w // s
        out.append((f"encoder.convs.{i}", ref.conv_macs(h, w, cin, d, s)))
        for _ in range(model["enc_blks"]):
            out.append((f"encoder.dwconv.{i}",
                        ref.conv_macs(h, w, d, d, 7, groups=d)))
            out.append((f"encoder.mlp.{i}", h * w * d * 4 * d * 2))
        cin = d
    return out
