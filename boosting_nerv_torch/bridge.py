"""Parameters between the JAX package's flax layout and the port's.

The JAX trainer saves checkpoints as a pickle of numpy trees,
``{"epoch", "params", "opt_state"?, "extra"?}``
(boosting_nerv_tpu/training/checkpoint.py), which
``training.checkpoint.load_checkpoint`` reads without jax.
``torch_state_from_flax`` maps the flax ``params`` tree of any of the five
families onto the state dict of the port's model (``models.build_model``),
and ``flax_params_from_torch_state`` is its exact inverse (the port's
checkpoints hold flax-layout params, so the JAX trainer reads them):

- conv kernels HWIO -> OIHW (no flip: both frameworks cross-correlate);
  the depthwise (7, 7, 1, C) kernel becomes (C, 1, 7, 7) by the same rule;
  a transposed conv's (k, k, in, out) kernel becomes ConvTranspose2d's
  (in, out, k, k);
- Dense kernels (in, out) -> Linear weights (out, in);
- every PixelShuffle upsampling conv's output channels (and bias) go from
  the JAX order (r1, r2, c) to torch's (c, r1, r2), and a PixelUnshuffle
  encoder conv's input channels likewise;
- every module is named explicitly, per family (``_torch_name`` /
  ``_flax_path``): inside an SFTLayer flax numbers the Dense layers by
  construction order, so TDense_0/TDense_2 are the outer scale/shift
  projections and TDense_1/TDense_3 the inner ones; E-NeRV's stage-0
  ConvUpBlock holds an UpConv_0 (``upconv``) beside its own TConv_0
  (``conv``); a transformer block's Attention_0 holds the qkv Dense
  (TDense_0) and the output one (TDense_1), its FeedForward_0 two Denses.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from .config import BoostConfig, model_stage_plan
from .ops.pixelshuffle import jax_to_torch_shuffle_perm

_SFT_DENSE = {"TDense_0": "scale_out", "TDense_1": "scale_in",
              "TDense_2": "shift_out", "TDense_3": "shift_in"}
_SFT_FLAX = {v: k for k, v in _SFT_DENSE.items()}
_CONVNEXT = {"Conv_0": "dwconv", "LayerNorm_0": "norm", "Dense_0": "fc1",
             "Dense_1": "fc2"}
_CONVNEXT_FLAX = {v: k for k, v in _CONVNEXT.items()}
_TRANSFORMER = {("Attention_0", "TDense_0"): "attn.qkv",
                ("Attention_0", "TDense_1"): "attn.out",
                ("FeedForward_0", "TDense_0"): "ff.fc1",
                ("FeedForward_0", "TDense_1"): "ff.fc2"}
_TRANSFORMER_FLAX = {v: k for k, v in _TRANSFORMER.items()}
_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "gamma": "gamma"}
_FAMILIES = ("HNeRV_Boost", "HNeRV", "NeRV_Boost", "ENeRV", "ENeRV_Boost")


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _index(name: str) -> str:
    return name.rsplit("_", 1)[1]


def _unmapped(path) -> KeyError:
    return KeyError(f"unmapped flax path {'/'.join(path)}")


def _is_convup(cfg: BoostConfig, i: int) -> bool:
    """Decoder block i is E-NeRV's stage-0 ConvUpBlock."""
    return cfg.model in ("ENeRV", "ENeRV_Boost") and i < cfg.dec_blks[0]


# ------------------------------------------------------- flax -> torch ---

def _mlp(rest, path) -> str:   # TDense_j/Dense_0
    if len(rest) != 2 or not rest[0].startswith("TDense_") or \
            rest[1] != "Dense_0":
        raise _unmapped(path)
    return f"layers.{_index(rest[0])}"


def _updown(rest, path) -> str:  # the conv of an UpConv / DownConv
    if tuple(rest) in (("TConv_0", "Conv_0"), ("TConvTranspose_0",)):
        return "conv"
    raise _unmapped(path)


def _rsft(rest, path) -> str:
    if len(rest) == 3 and rest[0].startswith("SFTLayer_") and \
            rest[1] in _SFT_DENSE and rest[2] == "Dense_0":
        return f"sft{_index(rest[0])}.{_SFT_DENSE[rest[1]]}"
    if len(rest) == 2 and rest[0].startswith("TConv_") and \
            rest[1] == "Conv_0":
        return f"conv{_index(rest[0])}"
    raise _unmapped(path)


def _block(rest, path, convup: bool) -> str:
    """A NeRVBlock (UpConv_0 / DownConv_0 -> conv) or a ConvUpBlock
    (UpConv_0 -> upconv, its own TConv_0 -> conv), with ResBlockSFT_0."""
    head, tail = rest[0], rest[1:]
    if head == "ResBlockSFT_0":
        return "rsft." + _rsft(tail, path)
    if head in ("UpConv_0", "DownConv_0"):
        return ("upconv." if convup else "conv.") + _updown(tail, path)
    if convup and tuple(rest) == ("TConv_0", "Conv_0"):
        return "conv"
    raise _unmapped(path)


def _torch_name(path: Tuple[str, ...], cfg: BoostConfig) -> str:
    """flax path (without the leaf) -> torch module path."""
    top, rest = path[0], path[1:]
    if top == "encoder":  # the ConvNeXt encoder
        if rest[0].startswith("ConvNeXtBlock_"):
            return ".".join(["encoder.blocks", _index(rest[0])]
                            + [_CONVNEXT[r] for r in rest[1:]])
        kind = {"Conv": "convs", "LayerNorm": "norms"}[rest[0].rsplit("_")[0]]
        return f"encoder.{kind}.{_index(rest[0])}"
    if top.startswith("encoder_"):  # HNeRV's NeRVBlock encoder
        return f"encoder.{_index(top)}." + _block(rest, path, False)
    if top in ("stem_t", "t_branch") or (top == "stem"
                                         and cfg.model == "NeRV_Boost"):
        return f"{top}." + _mlp(rest, path)
    if top.startswith("t_layers_"):
        return f"t_layers.{_index(top)}." + _mlp(rest, path)
    if top == "trunk":
        if rest[0] in ("stem_t", "stem_xy", "to_conv"):
            return f"trunk.{rest[0]}." + _mlp(rest[1:], path)
        if rest[0] in ("trans1", "trans2") and len(rest) == 4 and \
                tuple(rest[1:3]) in _TRANSFORMER and rest[3] == "Dense_0":
            return f"trunk.{rest[0]}.{_TRANSFORMER[tuple(rest[1:3])]}"
        raise _unmapped(path)
    if top == "head" and tuple(rest) == ("Conv_0",):
        return "head"
    if top == "stem":
        return "stem." + _block(rest, path, False)
    if top.startswith("blocks_"):
        i = int(_index(top))
        return f"blocks.{i}." + _block(rest, path, _is_convup(cfg, i))
    raise _unmapped(path)


def _upconv_block(name: str, cfg: BoostConfig) -> Optional[int]:
    """The decoder block whose UpConv's conv holds the weight or bias
    ``name`` (``blocks.i.conv.conv``, or a ConvUpBlock's
    ``blocks.i.upconv.conv``), None for any other entry."""
    m = re.fullmatch(r"blocks\.(\d+)\.(conv|upconv)\.conv\.(weight|bias)",
                     name)
    if m and (m.group(2) == "upconv") == _is_convup(cfg, int(m.group(1))):
        return int(m.group(1))
    return None


def _permutation(name: str, cfg: BoostConfig, shape) -> Tuple[int, Any]:
    """(axis, p) with ``torch = jax.take(p, axis)`` for a weight or bias
    ``name`` whose channels a PixelShuffle or PixelUnshuffle rearranges;
    (0, None) for any other entry."""
    bi = _upconv_block(name, cfg)
    if bi is not None and cfg.conv_type[1] in ("pshuffel", "pshuffel_3x3"):
        r = model_stage_plan(cfg)[bi].strd
        if r > 1:
            return 0, jax_to_torch_shuffle_perm(shape[0] // (r * r), r)
    m = re.fullmatch(r"encoder\.(\d+)\.conv\.conv\.weight", name)
    if m and cfg.conv_type[0] == "pshuffel":
        r = cfg.enc_strds[int(m.group(1))]
        if r > 1:
            return 1, jax_to_torch_shuffle_perm(shape[1] // (r * r), r)
    return 0, None


def _check_family(cfg: BoostConfig) -> None:
    if cfg.model not in _FAMILIES:
        raise KeyError(f"Unknown model {cfg.model!r}; available: "
                       f"{sorted(_FAMILIES)}")


def torch_state_from_flax(params: Mapping, cfg: BoostConfig
                          ) -> Dict[str, torch.Tensor]:
    """flax params of ``cfg.model`` (numpy or jax leaves; with or without
    the top-level ``"params"`` key) -> float32 state dict for the port's
    model of ``cfg`` (``load_state_dict``)."""
    _check_family(cfg)
    if "params" in params:
        params = params["params"]
    state: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(params):
        name = f"{_torch_name(path[:-1], cfg)}.{_LEAF[path[-1]]}"
        f = torch.from_numpy(np.array(leaf, dtype=np.float32))  # a copy
        state[name] = torch_view(name, f, cfg).contiguous()
    return state


# ------------------------------------------------------- torch -> flax ---

def _flax_block(mod, convup: bool):
    """The inverse of ``_block``: torch parts of a block -> flax path."""
    if mod[0] == "rsft":
        sub = mod[1]
        if sub.startswith("sft"):
            return ["ResBlockSFT_0", f"SFTLayer_{sub[3:]}",
                    _SFT_FLAX[mod[2]], "Dense_0"]
        return ["ResBlockSFT_0", f"TConv_{sub[4:]}", "Conv_0"]
    if convup and mod == ["conv"]:
        return ["TConv_0", "Conv_0"]
    return None  # the UpConv / DownConv, resolved by the caller


def _flax_path(name: str, cfg: BoostConfig,
               transposed: bool) -> Tuple[str, ...]:
    """torch state-dict key -> flax path (with the leaf); the inverse of
    ``_torch_name`` plus ``_LEAF``.  ``transposed``: the entry is a
    ConvTranspose2d's."""
    parts = name.split(".")
    mod, leaf = parts[:-1], parts[-1]
    top = mod[0]
    norm = False
    if top == "encoder" and mod[1] in ("blocks", "convs", "norms"):
        if mod[1] == "blocks":
            path = ["encoder", f"ConvNeXtBlock_{mod[2]}"] + [
                _CONVNEXT_FLAX[r] for r in mod[3:]]
        else:
            path = ["encoder", {"convs": "Conv", "norms": "LayerNorm"}[
                mod[1]] + f"_{mod[2]}"]
        norm = path[-1].startswith("LayerNorm_")
    elif top in ("stem_t", "t_branch") or (top == "stem"
                                           and cfg.model == "NeRV_Boost"):
        path = [top, f"TDense_{mod[2]}", "Dense_0"]
    elif top == "t_layers":
        path = [f"t_layers_{mod[1]}", f"TDense_{mod[3]}", "Dense_0"]
    elif top == "trunk":
        if mod[1] in ("stem_t", "stem_xy", "to_conv"):
            path = ["trunk", mod[1], f"TDense_{mod[3]}", "Dense_0"]
        else:
            path = ["trunk", mod[1],
                    *_TRANSFORMER_FLAX[".".join(mod[2:4])], "Dense_0"]
    elif top == "head":
        path = ["head", "Conv_0"]
    else:  # stem, blocks.i, encoder.i
        if top == "stem":
            path, rest, convup, conv = ["stem"], mod[1:], False, "DownConv_0"
        elif top == "encoder":
            path, rest, convup, conv = ([f"encoder_{mod[1]}"], mod[2:], False,
                                        "DownConv_0")
        else:
            i = int(mod[1])
            path, rest, conv = [f"blocks_{i}"], mod[2:], "UpConv_0"
            convup = _is_convup(cfg, i)
        sub = _flax_block(rest, convup)
        if sub is None:  # conv.conv or upconv.conv
            sub = [conv] + (["TConvTranspose_0"] if transposed
                            else ["TConv_0", "Conv_0"])
        path += sub
    return tuple(path) + ("scale" if norm and leaf == "weight"
                          else {"weight": "kernel", "bias": "bias",
                                "gamma": "gamma"}[leaf],)


def flax_view(name: str, t: torch.Tensor, cfg: BoostConfig) -> torch.Tensor:
    """The port's entry ``name`` (a weight or bias of the state dict) in
    its flax layout, by differentiable torch ops: the torch PixelShuffle
    channel order back to JAX's (``index_select``), then OIHW -> HWIO,
    ConvTranspose2d -> the flax (k, k, in, out), Linear -> Dense
    (``permute``).  ``torch_view`` is its inverse."""
    axis, perm = _permutation(name, cfg, t.shape)
    if perm is not None:
        t = t.index_select(axis, torch.as_tensor(np.argsort(perm),
                                                 device=t.device))
    if _flax_path(name, cfg, False)[-1] == "kernel":
        if _transposed(name, cfg):
            t = t.permute(2, 3, 0, 1)
        else:
            t = t.permute(2, 3, 1, 0) if t.ndim == 4 else t.t()
    return t


def torch_view(name: str, f: torch.Tensor, cfg: BoostConfig) -> torch.Tensor:
    """The inverse of ``flax_view``: a flax-layout tensor of the entry
    ``name`` -> the port's layout, by differentiable torch ops."""
    if _flax_path(name, cfg, False)[-1] == "kernel":
        if _transposed(name, cfg):
            f = f.permute(2, 3, 0, 1)
        else:
            f = f.permute(3, 2, 0, 1) if f.ndim == 4 else f.t()
    axis, perm = _permutation(name, cfg, f.shape)
    if perm is not None:
        f = f.index_select(axis, torch.as_tensor(perm, device=f.device))
    return f


def flax_key(name: str, cfg: BoostConfig) -> str:
    """The JAX trainers' key of the entry ``name``: its flax path under
    ``params``, joined by "/"."""
    return "/".join(("params",) + _flax_path(name, cfg, _transposed(name,
                                                                    cfg)))


def quantizable_leaves(names, cfg: BoostConfig) -> List[Tuple[str, str]]:
    """(flax key, torch name) of every state-dict entry that the CEM
    finetune quantises: a kernel or a bias outside the encoder (the JAX
    compression trainer's ``_is_quantizable``), sorted by flax key, the
    order in which the JAX trainer walks them."""
    out = []
    for name in names:
        key = flax_key(name, cfg)
        path = key.split("/")
        if not any("encoder" in p for p in path) and path[-1] in ("kernel",
                                                                 "bias"):
            out.append((key, name))
    return sorted(out)


def flax_params_from_torch_state(state: Mapping[str, torch.Tensor],
                                 cfg: BoostConfig) -> Dict[str, Any]:
    """State dict of the port's model of ``cfg`` -> the flax params tree
    ``{"params": {...}}`` in float32 numpy (``flax_view`` of each entry
    under its flax path).  ``torch_state_from_flax`` of the result gives
    ``state`` back."""
    _check_family(cfg)
    tree: Dict[str, Any] = {}
    for name, t in state.items():
        arr = flax_view(name, t.detach().to("cpu", torch.float32),
                        cfg).numpy()
        path = _flax_path(name, cfg, _transposed(name, cfg))
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(arr)
    return {"params": tree}


def _transposed(name: str, cfg: BoostConfig) -> bool:
    """The entry is the ConvTranspose2d of a decoder UpConv of kind
    ``conv``."""
    return cfg.conv_type[1] == "conv" and _upconv_block(name, cfg) is not None
