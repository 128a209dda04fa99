"""Parameters between the JAX package's flax layout and the port's.

The JAX trainer saves checkpoints as a pickle of numpy trees,
``{"epoch", "params", "opt_state"?, "extra"?}``
(boosting_nerv_tpu/training/checkpoint.py), so reading one needs no jax.
``torch_state_from_flax`` maps the flax ``params`` tree of HNeRV-Boost onto
the state dict of ``models.hnerv.HNeRVBoost``, and
``flax_params_from_torch_state`` is its exact inverse (the port's
checkpoints hold flax-layout params, so the JAX trainer reads them):

- conv kernels HWIO -> OIHW (no flip: both frameworks cross-correlate);
  the depthwise (7, 7, 1, C) kernel becomes (C, 1, 7, 7) by the same rule;
- Dense kernels (in, out) -> Linear weights (out, in);
- every upsampling conv's output channels (and bias) go from the JAX
  PixelShuffle order (r1, r2, c) to torch's (c, r1, r2);
- inside an SFTLayer flax numbers the Dense layers by construction order,
  so TDense_0/TDense_2 are the outer scale/shift projections and
  TDense_1/TDense_3 the inner ones.
"""

from __future__ import annotations

import pickle
import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from .config import BoostConfig, decoder_stage_plan
from .ops.pixelshuffle import jax_to_torch_shuffle_perm

_SFT_DENSE = {"TDense_0": "scale_out", "TDense_1": "scale_in",
              "TDense_2": "shift_out", "TDense_3": "shift_in"}
_CONVNEXT = {"Conv_0": "dwconv", "LayerNorm_0": "norm", "Dense_0": "fc1",
             "Dense_1": "fc2"}
_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "gamma": "gamma"}


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _index(name: str) -> str:
    return name.rsplit("_", 1)[1]


def _torch_name(path: Tuple[str, ...]) -> str:
    """flax path (without the leaf) -> torch module path."""
    top, rest = path[0], path[1:]
    if top == "encoder":
        out = ["encoder"]
        if rest[0].startswith("ConvNeXtBlock_"):
            out += ["blocks", _index(rest[0])] + [_CONVNEXT[r] for r in rest[1:]]
        elif rest[0].startswith("Conv_"):
            out += ["convs", _index(rest[0])]
        else:  # LayerNorm_i
            out += ["norms", _index(rest[0])]
        return ".".join(out)
    if top == "stem_t":  # MLP: TDense_i/Dense_0
        return f"stem_t.layers.{_index(rest[0])}"
    if top == "head":  # TConv: Conv_0
        return "head"
    out = [top] if top == "stem" else ["blocks", _index(top)]
    for r in rest:
        if r in ("UpConv_0", "DownConv_0"):
            out.append("conv")
        elif r == "ResBlockSFT_0":
            out.append("rsft")
        elif r.startswith("SFTLayer_"):
            out.append(f"sft{_index(r)}")
        elif r.startswith("TDense_") and out[-1].startswith("sft"):
            out.append(_SFT_DENSE[r])
        elif r.startswith("TConv_") and out[-1] == "rsft":
            out.append(f"conv{_index(r)}")
        elif r == "TConv_0":  # the conv inside UpConv / DownConv
            out.append("conv")
        elif r not in ("Conv_0", "Dense_0"):  # flax wrappers of TConv/TDense
            raise KeyError(f"unmapped flax path {'/'.join(path)}")
    return ".".join(out)


def torch_state_from_flax(params: Mapping, cfg: BoostConfig
                          ) -> Dict[str, torch.Tensor]:
    """flax HNeRV-Boost params (numpy or jax leaves; with or without the
    top-level ``"params"`` key) -> float32 state dict for
    ``HNeRVBoost(cfg).load_state_dict``."""
    if cfg.model != "HNeRV_Boost":
        raise NotImplementedError(f"the bridge covers HNeRV_Boost only, not "
                                  f"{cfg.model}")
    if "params" in params:
        params = params["params"]
    strds = [s.strd for s in decoder_stage_plan(cfg, cfg.fc_dim,
                                                hnerv_style=True)]
    state: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(params):
        arr = np.asarray(leaf, dtype=np.float32)
        name = f"{_torch_name(path[:-1])}.{_LEAF[path[-1]]}"
        if path[-1] == "kernel":
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
        r = _upconv_stride(name, strds)
        if r > 1:
            arr = arr[jax_to_torch_shuffle_perm(arr.shape[0] // (r * r), r)]
        state[name] = torch.from_numpy(np.array(arr))  # writable copy
    return state


def _upconv_stride(name: str, strds) -> int:
    """The PixelShuffle factor of an upsampling conv's weight or bias
    ``name``, 1 for any other entry."""
    m = re.fullmatch(r"blocks\.(\d+)\.conv\.conv\.(weight|bias)", name)
    return strds[int(m.group(1))] if m else 1


_FLAX_LEAF = {"weight": "kernel", "bias": "bias", "gamma": "gamma"}
_CONVNEXT_FLAX = {v: k for k, v in _CONVNEXT.items()}
_SFT_FLAX = {v: k for k, v in _SFT_DENSE.items()}


def _flax_path(name: str) -> Tuple[str, ...]:
    """torch state-dict key -> flax path (with the leaf); the inverse of
    ``_torch_name`` plus ``_LEAF``."""
    parts = name.split(".")
    mod, leaf = parts[:-1], parts[-1]
    top = mod[0]
    if top == "encoder":
        kind, i, rest = mod[1], mod[2], mod[3:]
        if kind == "blocks":
            path = ["encoder", f"ConvNeXtBlock_{i}"] + [
                _CONVNEXT_FLAX[r] for r in rest]
        else:
            path = ["encoder", {"convs": "Conv", "norms": "LayerNorm"}[kind]
                    + f"_{i}"]
        norm = (path[-1].startswith("LayerNorm_"))
    elif top == "stem_t":
        path, norm = ["stem_t", f"TDense_{mod[2]}", "Dense_0"], False
    elif top == "head":
        path, norm = ["head", "Conv_0"], False
    else:
        path = ["stem"] if top == "stem" else [f"blocks_{mod[1]}"]
        rest = mod[1:] if top == "stem" else mod[2:]
        if rest[0] == "conv":  # UpConv_0 / DownConv_0 -> TConv_0 -> Conv_0
            path += ["DownConv_0" if top == "stem" else "UpConv_0",
                     "TConv_0", "Conv_0"]
        else:  # rsft
            path.append("ResBlockSFT_0")
            sub = rest[1]
            if sub.startswith("sft"):
                path += [f"SFTLayer_{sub[3:]}", _SFT_FLAX[rest[2]],
                         "Dense_0"]
            else:
                path += [f"TConv_{sub[4:]}", "Conv_0"]
        norm = False
    return tuple(path) + ("scale" if norm and leaf == "weight"
                          else _FLAX_LEAF[leaf],)


def flax_params_from_torch_state(state: Mapping[str, torch.Tensor],
                                 cfg: BoostConfig) -> Dict[str, Any]:
    """HNeRVBoost state dict -> the flax params tree
    ``{"params": {...}}`` in float32 numpy: OIHW -> HWIO, Linear -> Dense,
    the torch PixelShuffle channel order of every upsampling conv back to
    JAX's, and the SFT Dense names.  ``torch_state_from_flax`` of the
    result gives ``state`` back."""
    if cfg.model != "HNeRV_Boost":
        raise NotImplementedError(f"the bridge covers HNeRV_Boost only, not "
                                  f"{cfg.model}")
    strds = [s.strd for s in decoder_stage_plan(cfg, cfg.fc_dim,
                                                hnerv_style=True)]
    tree: Dict[str, Any] = {}
    for name, t in state.items():
        arr = t.detach().to("cpu", torch.float32).numpy()
        r = _upconv_stride(name, strds)
        if r > 1:
            perm = jax_to_torch_shuffle_perm(arr.shape[0] // (r * r), r)
            arr = arr[np.argsort(perm)]
        path = _flax_path(name)
        if path[-1] == "kernel":
            arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(arr)
    return {"params": tree}


def load_flax_checkpoint(path: str) -> Dict[str, Any]:
    """Read a checkpoint written by the JAX trainer: a dict with "epoch",
    "params" and optionally "opt_state" and "extra", all numpy.  Unpickling
    runs code from the file, so read only checkpoints this project wrote."""
    with open(path, "rb") as f:
        return pickle.load(f)
