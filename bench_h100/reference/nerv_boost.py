"""NeRV-Boost in the plain reference (the family interface of ``models``):
index only.

- the stem: an MLP on PE(t) [2L, 256, fc_h fc_w fc_dim], reshaped to the
  fc_h x fc_w grid (channels last); the time embedding stem_t(PE(t))
  conditions every stage;
- stage 0 keeps the width, every stride-2 stage floor-divides it by
  ``reduce``; a 1x1 head.
"""

from __future__ import annotations

from bench_h100.reference import models as ref
from bench_h100.reference.models import Macs, Params, Shapes

HEAD_K = 1
stage_layers = ref.stage_layers


def stage_plan(model: dict):
    return ref.stage_plan(model, expansion=1)


def param_shapes(model: dict) -> Shapes:
    """The stem, stem_t, the stages, the head."""
    out: Shapes = {}
    ch_t = model["ch_t"]
    levels = int(model["embed"].split("_")[-1])
    fh, fw = ref.grid_hw(model)
    ref.add_linear(out, "stem.layers.0", 2 * levels, 256)
    ref.add_linear(out, "stem.layers.1", 256, fh * fw * model["fc_dim"])
    ref.add_linear(out, "stem_t.layers.0", 2 * levels, 2 * ch_t)
    ref.add_linear(out, "stem_t.layers.1", 2 * ch_t, ch_t)
    plan = stage_plan(model)
    for i, s in enumerate(plan):
        ref.add_stage(out, i, s, ch_t)
    ref.add_conv(out, "head", plan[-1].new_ngf, 3, HEAD_K)
    return out


def frame_inputs(model: dict, n: int, seed: int, device):
    """None: the index is the only input."""
    return None


def decode(x, t, p: Params, model: dict, quant=None, calib=None):
    """Index [B] -> [B, H, W, 3]; ``x`` is None."""
    dtype = p["head.weight"].dtype
    pe = ref.position_encoding(t, model["embed"], dtype)
    fh, fw = ref.grid_hw(model)
    x = ref.mlp(pe, p, "stem", 2).reshape(t.shape[0], fh, fw, -1)
    x = x.permute(0, 3, 1, 2)
    return ref.decode_stages(x, ref.mlp(pe, p, "stem_t", 2), p,
                             stage_plan(model), quant, calib)


def front_layers(model: dict) -> Macs:
    """stem_t, then the stem MLP."""
    fh, fw = ref.grid_hw(model)
    levels, ch_t = int(model["embed"].split("_")[-1]), model["ch_t"]
    return [("stem_t", ref.mlp_macs([2 * levels, 2 * ch_t, ch_t])),
            ("stem", ref.mlp_macs([2 * levels, 256,
                                   fh * fw * model["fc_dim"]]))]
