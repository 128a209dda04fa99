"""Checkpoints (port of boosting_nerv_tpu/training/checkpoint.py).

The same artefact as the JAX trainer's: a pickle of numpy trees
``{"epoch", "params", "opt_state"?, "extra"?}`` with ``params`` in the flax
layout (``bridge.flax_params_from_torch_state``), so the JAX trainer's
``load_checkpoint`` + ``tree_restore`` reads a checkpoint of the port, and
``restore`` reads one of the JAX trainer through
``bridge.torch_state_from_flax``.  Only numpy arrays and Python scalars go
into the pickle.  Saves are synchronous; resuming restores the parameters
only, not the optimizer state, as the reference does.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional

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
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict:
    """Read a checkpoint of either package.  Unpickling runs code from the
    file, so read only checkpoints this project wrote."""
    with open(path, "rb") as f:
        return pickle.load(f)


def restore(model: torch.nn.Module, ckpt: Dict, cfg: BoostConfig) -> None:
    """Load ``ckpt["params"]`` (flax layout) into ``model``: every
    parameter must be there, with its shape."""
    state = torch_state_from_flax(ckpt["params"], cfg)
    model.load_state_dict(state, strict=True)

