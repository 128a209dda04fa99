"""Checkpoints (port of boosting_nerv_tpu/training/checkpoint.py).

The same artefact as the JAX trainer's: a pickle of numpy trees
``{"epoch", "params", "opt_state"?, "extra"?}`` with ``params`` in the flax
layout (``bridge.flax_params_from_torch_state``), so the JAX trainer's
``load_checkpoint`` + ``tree_restore`` reads a checkpoint of the port, and
``restore`` reads one of the JAX trainer through
``bridge.torch_state_from_flax``.  Only numpy arrays and Python scalars go
into the pickle.  Saves are synchronous; the regression trainer resumes
the parameters only, not the optimizer state, as the reference does.

The CEM compression trainer's checkpoint (``save_cem_checkpoint``) holds
the JAX compression trainer's tree: ``params = {"model": <flax params>,
"qp": {flax key: {name: array}}, "embed_qp"?: {name: array}}`` and the
optimizer state of the port (``opt_state``, torch's state dict in numpy);
``restore_qp`` and ``restore_optimizer`` read them back (the quantiser
parameters from a checkpoint of either package; another package's
optimizer state is refused with its reason).  ``load_checkpoint`` reads
the JAX package's pickles without importing it: the classes they name
from ``boosting_nerv_tpu``, ``optax``, ``jax`` or ``flax`` (an optax
optimizer state) come back as plain tuples.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ..bridge import flax_params_from_torch_state, torch_state_from_flax
from ..config import BoostConfig


def _to_numpy(tree):
    """Tensors of a nested dict / list / tuple -> numpy arrays."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    return tree


def _write(path: str, payload: Dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


def save_checkpoint(path: str, epoch: int, model: torch.nn.Module,
                    cfg: BoostConfig,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    extra: Optional[Dict] = None) -> None:
    """Write ``model``'s parameters (flax layout) and, when given,
    ``optimizer``'s state to ``path``, atomically."""
    payload: Dict[str, Any] = {
        "epoch": int(epoch),
        "params": flax_params_from_torch_state(model.state_dict(), cfg)}
    if optimizer is not None:
        payload["opt_state"] = _to_numpy(optimizer.state_dict())
    if extra:
        payload["extra"] = extra
    _write(path, payload)


def save_cem_checkpoint(path: str, epoch: int, model: torch.nn.Module,
                        cfg: BoostConfig, qp: Mapping,
                        embed_qp: Optional[Mapping] = None,
                        optimizer: Optional[torch.optim.Optimizer] = None
                        ) -> None:
    """Write the CEM state as the JAX compression trainer does: params
    ``{"model": flax params, "qp": ..., "embed_qp": ...}`` (no
    ``embed_qp`` when there is none) and the optimizer's state."""
    params: Dict[str, Any] = {
        "model": flax_params_from_torch_state(model.state_dict(), cfg),
        "qp": _to_numpy(dict(qp))}
    if embed_qp is not None:
        params["embed_qp"] = _to_numpy(dict(embed_qp))
    payload: Dict[str, Any] = {"epoch": int(epoch), "params": params}
    if optimizer is not None:
        payload["opt_state"] = _to_numpy(optimizer.state_dict())
    _write(path, payload)


class ForeignState(tuple):
    """An object of another package's pickle (an optax state's
    NamedTuple), read as a plain tuple of its fields."""

    def __new__(cls, *args):
        return super().__new__(cls, args)


_FOREIGN = ("boosting_nerv_tpu", "optax", "jax", "jaxlib", "flax")


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] in _FOREIGN:
            return ForeignState
        return super().find_class(module, name)


def load_checkpoint(path: str) -> Dict:
    """Read a checkpoint of either package.  Unpickling runs code from the
    file, so read only checkpoints this project wrote."""
    with open(path, "rb") as f:
        return _Unpickler(f).load()


def restore(model: torch.nn.Module, ckpt: Dict, cfg: BoostConfig) -> None:
    """Load ``ckpt["params"]`` (flax layout) into ``model``: every
    parameter must be there, with its shape."""
    state = torch_state_from_flax(ckpt["params"], cfg)
    model.load_state_dict(state, strict=True)


def restore_qp(qp: Mapping, saved: Mapping) -> None:
    """Copy the saved quantiser parameters ``saved`` (numpy, as a
    checkpoint of either package holds them) into the tensors of ``qp``
    in place, key by key: the keys and shapes must be the same."""
    if set(qp) != set(saved):
        raise ValueError(f"quantiser keys differ: "
                         f"{sorted(set(qp) ^ set(saved))}")
    for k, v in qp.items():
        if isinstance(v, Mapping):
            restore_qp(v, saved[k])
        else:
            src = torch.as_tensor(np.array(saved[k]), dtype=v.dtype)  # copy
            if tuple(src.shape) != tuple(v.shape):
                raise ValueError(f"quantiser {k}: shape {tuple(src.shape)} "
                                 f"!= {tuple(v.shape)}")
            with torch.no_grad():
                v.copy_(src)


def restore_optimizer(optimizer: torch.optim.Optimizer,
                      saved) -> Optional[str]:
    """Load a saved optimizer state of the port (torch's state dict) into
    ``optimizer``; returns None when it did, or why it did not (another
    package's state, or one for other parameters), and leaves the
    optimizer as it was."""
    if not (isinstance(saved, dict) and "param_groups" in saved
            and "state" in saved):
        return "not the port's optimizer state"

    def tensors(tree):
        if isinstance(tree, dict):
            return {k: tensors(v) for k, v in tree.items()}
        if hasattr(tree, "dtype") and hasattr(tree, "shape"):
            return torch.as_tensor(tree)
        return tree

    params = [p for g in optimizer.param_groups for p in g["params"]]
    for i, st in saved["state"].items():
        for k, v in st.items():
            if (getattr(v, "ndim", 0) and not (
                    isinstance(i, int) and i < len(params)
                    and tuple(v.shape) == tuple(params[i].shape))):
                return f"state {i}/{k} of shape {tuple(v.shape)} fits no " \
                       "parameter"
    try:
        optimizer.load_state_dict({"state": tensors(saved["state"]),
                                   "param_groups": saved["param_groups"]})
    except ValueError as e:
        return str(e)
    return None
