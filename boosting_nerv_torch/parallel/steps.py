"""Rank workers: data-parallel steps of the two trainers from given weights
on a given global batch, for ``launch`` (what chip_smoke.py's dp phase
and the CPU tests drive; the CLIs train through ``train()`` instead), and
``run_jobs``, several of them in one launch.

Each builds its trainer on the rank's plan (``cfg.dp`` must be the plan's
dp) over the clip ``frames``, loads ``state`` (a torch state dict of numpy
arrays, or None for the seeded init or ``cfg.weight``), runs the steps on
its ``shard_batch`` slice of the global batch ``idx``, and returns host
values: the global batch's loss of each step (the mean over the ranks;
and its mean PSNR for the regression steps),
the rank's parameters after each step, each step's gradients (the
global batch's), each step's ms on the host clock (up to its loss read
back), the rank's device and its peak allocation on a card (bytes, else
None).
"""

from __future__ import annotations

import time
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from ..config import BoostConfig
from ..data.video import VideoData
from ..utils.logger import NullLogger
from .mesh import MeshPlan


def _numpy(named) -> Dict[str, np.ndarray]:
    return {n: t.detach().cpu().numpy().copy() for n, t in named}


def _load(trainer, state: Optional[Mapping[str, np.ndarray]]) -> None:
    if state is not None:
        trainer.model.load_state_dict(
            {k: torch.from_numpy(np.asarray(v)) for k, v in state.items()})


def _peak(plan: MeshPlan) -> Optional[int]:
    if plan.device.type != "cuda":
        return None
    torch.cuda.synchronize(plan.device)
    return torch.cuda.max_memory_allocated(plan.device)


def _grads(trainer) -> Dict[str, np.ndarray]:
    return _numpy((n, p.grad) for n, p in trainer.model.named_parameters()
                  if p.grad is not None)


def _state(trainer) -> Dict[str, np.ndarray]:
    return _numpy(trainer.model.state_dict().items())


def _report(plan, losses, grads, states, ms) -> Dict:
    return {"rank": plan.rank, "device": str(plan.device),
            "losses": losses, "grads": grads, "states": states, "ms": ms,
            "peak_bytes": _peak(plan)}


def train_steps(plan: MeshPlan, cfg: BoostConfig, frames: np.ndarray,
                state: Optional[Mapping[str, np.ndarray]],
                idx: Sequence[int], lr: float, steps: int = 1) -> Dict:
    """``steps`` regression steps (``RegressionTrainer.train_step_idx``)
    on the global batch ``idx``; see the module docstring."""
    from ..training.trainer import RegressionTrainer

    tr = RegressionTrainer(cfg, video=VideoData(frames), plan=plan,
                           logger=NullLogger())
    _load(tr, state)
    tr.maybe_resume()
    video = tr.video
    ids = plan.shard_batch(np.asarray(idx))
    losses, psnrs, grads, states, ms = [], [], [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss, psnr = tr.train_step_idx(ids, video.norm_idx(ids), lr)
        losses.append(float(plan.mean(loss)))
        ms.append((time.perf_counter() - t0) * 1e3)
        psnrs.append(float(plan.mean(psnr.mean())))
        grads.append(_grads(tr))
        states.append(_state(tr))
    out = _report(plan, losses, grads, states, ms)
    out["psnrs"] = psnrs
    return out


def cem_steps(plan: MeshPlan, cfg: BoostConfig, frames: np.ndarray,
              state: Optional[Mapping[str, np.ndarray]],
              idx: Sequence[int], lr: float,
              noise: Optional[Mapping[str, np.ndarray]] = None,
              steps: int = 1) -> Dict:
    """``steps`` CEM steps (``CompressionTrainer.cem_step_idx``, after
    ``maybe_resume`` and ``init_qparams``) on the global batch ``idx``,
    each fed ``noise`` (the embedding's at the global batch's shape) or
    drawn from the trainer's generator; see the module docstring, plus
    each step's bpp and the quantiser parameters after the steps and
    their gradients of the last step."""
    from ..training.compress_trainer import CompressionTrainer

    tr = CompressionTrainer(cfg, video=VideoData(frames), plan=plan,
                            logger=NullLogger())
    _load(tr, state)
    tr.maybe_resume()
    tr.init_qparams()
    if noise is not None:
        noise = {k: torch.from_numpy(np.asarray(v)).to(plan.device)
                 for k, v in noise.items()}
    video = tr.video
    ids = plan.shard_batch(np.asarray(idx))
    losses, bpps, grads, states, ms = [], [], [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss, _, bpp = tr.cem_step_idx(ids, video.norm_idx(ids), lr, noise)
        losses.append(float(plan.mean(loss)))
        ms.append((time.perf_counter() - t0) * 1e3)
        bpps.append(float(bpp))
        grads.append(_grads(tr))
        states.append(_state(tr))
    out = _report(plan, losses, grads, states, ms)
    out["bpps"] = bpps
    out["qp"] = {k: _numpy(d.items()) for k, d in tr.qparams.items()}
    out["qp_grads"] = {k: _numpy((n, v.grad) for n, v in d.items()
                                 if v.grad is not None)
                       for k, d in tr.qparams.items()}
    out["embed_qp"] = out["embed_qp_grads"] = None
    if tr.embed_qp is not None:
        out["embed_qp"] = _numpy(tr.embed_qp.items())
        out["embed_qp_grads"] = _numpy((n, v.grad)
                                       for n, v in tr.embed_qp.items()
                                       if v.grad is not None)
    return out


def run_jobs(plan: MeshPlan, jobs: Sequence) -> list:
    """Several workers in one launch, so the ranks start once: ``jobs`` a
    list of (worker, args), each run as ``worker(plan, *args)`` in turn;
    their results in order."""
    return [worker(plan, *args) for worker, args in jobs]
