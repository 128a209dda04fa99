"""E-NeRV-Boost in the plain reference (the family interface of
``models``): index only, through E-NeRV's trunk of two small transformer
blocks over the fc_h x fc_w grid.

With L = 2 levels of the configuration's ``embed``, d = ``block_dim``, the
grid's N = fc_h fc_w tokens numbered n = i fc_w + j, and sin the
activation of every MLP layer:

- the grid: gx_n = i / fc_h, gy_n = j / fc_w (quotients rounded once to
  float32); xy = sin(W_xy [PE(gx), PE(gy)] + b_xy), [N, d];
- the time: e = stem_t(PE(t)), an MLP [L, 2 d, d];
- Attn_h(z) = W_o concat_heads(softmax(Q K^T / 8) V), [Q K V] = z W_qkv
  (no bias), heads of 64, inner width 64 h; W_o (with bias) is absent
  where h = 1 and d = 64;
- FF(z) = W_2 gelu(W_1 z + b_1) + b_2, exact GELU, hidden width d / 2;
- Block_h(z) = z' + FF(z'), z' = z + Attn_h(z): residuals, no norm;
- the grid map: Block_8(Block_1(xy) * e), each token scaled by the frame's
  e, reshaped to [B, fc_h, fc_w, d], then to_conv, an MLP [d, fc_dim]
  (absent where d = fc_dim);
- c = t_branch(PE(t)), an MLP [L, 2 ch_t, ch_t], conditions every stage's
  ResBlockSFT;
- the blocks of stage 0 are ConvUpBlocks, which upsample first (their
  input is never wider than their output): a k x k conv (k = min(ks, 3))
  to ngf / 4 s^2 channels, PixelShuffle(s), a 3x3 conv to the stage's
  width, sin, ResBlockSFT; stage 0 triples the width, every later
  stride-2 stage floor-divides it by ``reduce``; a 1x1 head.

Departures from the paper's repository (model_enerv.py, E-NeRV-Boost's
forward): its MLP stems are 1x1-conv stacks on a 1x1 map and its grid map
is channels first, here linears and channels last, the same functions of
the same numbers; its transformer blocks' dropout is 0, so none appears
here.  The weights are the benchmark's seeded draws.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bench_h100.reference import models as ref
from bench_h100.reference.models import Macs, Params, Shapes, Stage

HEAD_K = 1
DIM_HEAD = 64
BLOCKS = (("trunk.trans1", 1), ("trunk.trans2", 8))   # (name, heads)


def stage_plan(model: dict):
    return ref.stage_plan(model, expansion=3)


def _projects(heads: int, d: int) -> bool:
    """Whether an attention of ``heads`` heads has its output linear."""
    return not (heads == 1 and DIM_HEAD == d)


def _conv_up_blocks(model: dict) -> int:
    """How many blocks lead the plan as ConvUpBlocks: stage 0's."""
    return model["dec_blks"][0]


def param_shapes(model: dict) -> Shapes:
    """The trunk (stem_t, stem_xy, the two blocks, to_conv), t_branch, the
    stages, the head."""
    out: Shapes = {}
    ch_t, d, c = model["ch_t"], model["block_dim"], model["fc_dim"]
    el = 2 * int(model["embed"].split("_")[-1])
    ref.add_linear(out, "trunk.stem_t.layers.0", el, 2 * d)
    ref.add_linear(out, "trunk.stem_t.layers.1", 2 * d, d)
    ref.add_linear(out, "trunk.stem_xy.layers.0", 2 * el, d)
    for name, heads in BLOCKS:
        inner = heads * DIM_HEAD
        ref.add_linear(out, name + ".attn.qkv", d, 3 * inner, bias=False)
        if _projects(heads, d):
            ref.add_linear(out, name + ".attn.out", inner, d)
        ref.add_linear(out, name + ".ff.fc1", d, d // 2)
        ref.add_linear(out, name + ".ff.fc2", d // 2, d)
    if d != c:
        ref.add_linear(out, "trunk.to_conv.layers.0", d, c)
    ref.add_linear(out, "t_branch.layers.0", el, 2 * ch_t)
    ref.add_linear(out, "t_branch.layers.1", 2 * ch_t, ch_t)
    plan = stage_plan(model)
    for i, s in enumerate(plan):
        if i < _conv_up_blocks(model):
            ref.add_conv(out, f"blocks.{i}.upconv.conv", s.ngf,
                         s.ngf // 4 * s.strd ** 2, min(s.ks, 3))
            ref.add_conv(out, f"blocks.{i}.conv", s.ngf // 4, s.new_ngf, 3)
            ref.add_rsft(out, f"blocks.{i}.rsft", s.new_ngf, ch_t)
        else:
            ref.add_stage(out, i, s, ch_t)
    ref.add_conv(out, "head", plan[-1].new_ngf, 3, HEAD_K)
    return out


def frame_inputs(model: dict, n: int, seed: int, device):
    """None: the index is the only input."""
    return None


def _attention(z, p: Params, name: str, heads: int):
    b, n, _ = z.shape
    q, k, v = (u.reshape(b, n, heads, DIM_HEAD).transpose(1, 2)
               for u in F.linear(z, p[name + ".qkv.weight"]).chunk(3, dim=-1))
    a = torch.softmax(q @ k.transpose(-1, -2) * DIM_HEAD ** -0.5, dim=-1)
    o = (a @ v).transpose(1, 2).reshape(b, n, heads * DIM_HEAD)
    return ref.lin(o, p, name + ".out") if _projects(heads, z.shape[-1]) else o


def _block(z, p: Params, name: str, heads: int):
    z = z + _attention(z, p, name + ".attn", heads)
    return z + ref.lin(F.gelu(ref.lin(z, p, name + ".ff.fc1")), p,
                       name + ".ff.fc2")


def grid_map(pe_t, p: Params, model: dict):
    """The trunk: the frames' PE(t) [B, L] -> NCHW [B, fc_dim, fc_h, fc_w]."""
    fh, fw = ref.grid_hw(model)
    dev, dtype = pe_t.device, pe_t.dtype
    xs = (torch.arange(fh, dtype=torch.float64, device=dev) / fh).float()
    ys = (torch.arange(fw, dtype=torch.float64, device=dev) / fw).float()
    gx = xs[:, None].expand(fh, fw).reshape(-1)
    gy = ys[None, :].expand(fh, fw).reshape(-1)
    xy = torch.cat([ref.position_encoding(gx, model["embed"], dtype),
                    ref.position_encoding(gy, model["embed"], dtype)], dim=-1)
    xy = ref.mlp(xy, p, "trunk.stem_xy", 1)[None].expand(
        pe_t.shape[0], -1, -1)
    e = ref.mlp(pe_t, p, "trunk.stem_t", 2)
    (n1, h1), (n2, h2) = BLOCKS
    z = _block(_block(xy, p, n1, h1) * e[:, None, :], p, n2, h2)
    z = z.reshape(pe_t.shape[0], fh, fw, -1)
    if model["block_dim"] != model["fc_dim"]:
        z = ref.mlp(z, p, "trunk.to_conv", 1)
    return z.permute(0, 3, 1, 2)


def _conv_up(x, p: Params, i: int, s: Stage, q: dict):
    """A ConvUpBlock's map before its activation."""
    k = min(s.ks, 3)
    y = ref.conv(x, p, f"blocks.{i}.upconv.conv", (k - 1) // 2, key="x", **q)
    if s.strd > 1:
        y = F.pixel_shuffle(y, s.strd)
    return ref.conv(y, p, f"blocks.{i}.conv", 1, key="c", **q)


def decode(x, t, p: Params, model: dict, quant=None, calib=None):
    """Index [B] -> [B, H, W, 3]; ``x`` is None."""
    pe = ref.position_encoding(t, model["embed"], p["head.weight"].dtype)
    first = _conv_up_blocks(model)

    def up(y, p_, i, s, q):
        return (_conv_up if i < first else ref.upsample)(y, p_, i, s, q)
    return ref.decode_stages(grid_map(pe, p, model),
                             ref.mlp(pe, p, "t_branch", 2), p,
                             stage_plan(model), quant, calib, up=up)


def front_layers(model: dict) -> Macs:
    """The trunk in its order (stem_t; stem_xy on every token; each
    block's qkv, Q K^T and A V over its heads, output linear and
    feed-forward; to_conv), then t_branch."""
    fh, fw = ref.grid_hw(model)
    n, d, c, ch_t = fh * fw, model["block_dim"], model["fc_dim"], \
        model["ch_t"]
    el = 2 * int(model["embed"].split("_")[-1])
    out = [("trunk.stem_t", ref.mlp_macs([el, 2 * d, d])),
           ("trunk.stem_xy", n * ref.mlp_macs([2 * el, d]))]
    for name, heads in BLOCKS:
        inner = heads * DIM_HEAD
        out += [(name + ".qkv", n * d * 3 * inner),
                (name + ".qk", heads * n * n * DIM_HEAD),
                (name + ".av", heads * n * n * DIM_HEAD)]
        if _projects(heads, d):
            out.append((name + ".out", n * inner * d))
        out.append((name + ".ff", n * ref.mlp_macs([d, d // 2, d])))
    if d != c:
        out.append(("trunk.to_conv", n * d * c))
    out.append(("t_branch", ref.mlp_macs([el, 2 * ch_t, ch_t])))
    return out


def stage_layers(model: dict, i: int, s: Stage, h: int, w: int) -> Macs:
    """A ConvUpBlock's two convs in stage 0, else the shared stage's."""
    if i >= _conv_up_blocks(model):
        return ref.stage_layers(model, i, s, h, w)
    mid = s.ngf // 4
    return [(f"blocks.{i}.upconv",
             ref.conv_macs(h, w, s.ngf, mid * s.strd ** 2, min(s.ks, 3))),
            (f"blocks.{i}.conv",
             ref.conv_macs(h * s.strd, w * s.strd, mid, s.new_ngf, 3))]

