"""Rank workers: steps of the two trainers over the mesh from given weights
on a given global batch, for ``launch`` (what chip_smoke.py's dp and sp
phases and the CPU tests drive; the CLIs train through ``train()``
instead), ``split_decode`` (the 'spatial' axis's decode), and
``run_jobs``, several of them in one launch.

Each step worker builds its trainer on the rank's plan (``cfg.dp`` and
``cfg.sp`` must be the plan's) over the clip ``frames``, loads ``state``
(a torch state dict of numpy arrays, or None for the seeded init or
``cfg.weight``), runs the steps on its ``shard_batch`` slice of the
global batch ``idx``, and returns host values: the global batch's loss of
each step (the mean over the ranks; and its mean PSNR for the regression
steps), the rank's parameters after each step, each step's gradients
(the global batch's), each step's ms on the host clock (up to its loss
read back), the rank's device, its peak allocation on a card (bytes, else
None), the split plan of its first forward (None at sp 1) and the rank's
kernel launches (``ops.kernels.LAUNCHES``).
"""

from __future__ import annotations

import time
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from ..config import BoostConfig
from ..data.video import VideoData
from ..ops import kernels
from ..utils.logger import NullLogger
from .mesh import MeshPlan, make_mesh_plan


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


def _report(plan, tr, losses, grads, states, ms) -> Dict:
    return {"rank": plan.rank, "device": str(plan.device),
            "losses": losses, "grads": grads, "states": states, "ms": ms,
            "peak_bytes": _peak(plan), "split_plan": tr.split_plan,
            "launches": dict(kernels.LAUNCHES)}


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
    out = _report(plan, tr, losses, grads, states, ms)
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
    out = _report(plan, tr, losses, grads, states, ms)
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
    list of (worker, args) or (worker, args, mesh), each run as
    ``worker(plan, *args)`` in turn, on ``mesh`` = (dp, sp) when given (a
    plan of that shape over the launch's ranks, its groups built anew:
    the CPU tests hold the 1 x 4 and 2 x 2 meshes in one launch of four
    ranks this way); their results in order."""
    out = []
    for worker, args, *mesh in jobs:
        p = plan
        if mesh and tuple(mesh[0]) != (plan.dp, plan.sp):
            p = make_mesh_plan(*mesh[0], devices=[plan.device] * plan.world,
                               backend=plan.backend)
        out.append(worker(p, *args))
    return out


def split_decode(plan: MeshPlan, cfg: BoostConfig,
                 state: Optional[Mapping[str, np.ndarray]],
                 t: Sequence[float], embed: Optional[np.ndarray] = None,
                 reps: int = 0) -> Dict:
    """The decode of ``cfg``'s model (``state``, or its seeded init) at
    indices ``t`` (from the embedding ``embed``, NHWC, for the HNeRV
    families) split by rows over the plan's spatial group (unsplit in a
    single process): {"frame" (the whole frames, NHWC), "split_plan"
    (None unsplit), "ms" (a decode's, the median of ``reps`` timed on the
    card's or the host's clock after the first; None at 0), "device",
    "peak_bytes", "launches"}."""
    from ..models import build_model

    model = build_model(cfg, seed=cfg.manualSeed, device=plan.device)
    if state is not None:
        model.load_state_dict({k: torch.from_numpy(np.asarray(v))
                               for k, v in state.items()})
    rows = plan.rows()
    tt = torch.as_tensor(np.asarray(t, np.float32), device=plan.device)
    e = (None if embed is None
         else torch.from_numpy(np.asarray(embed)).to(plan.device))

    def decode():
        if cfg.model == "HNeRV_Boost":
            return model.decode(e, tt, rows)
        if e is not None:
            return model.decode(e, rows)
        return model(tt, rows)

    with torch.no_grad():
        if rows is not None:
            rows.start_trace()
        frame = decode()
        split_plan = None if rows is None else rows.stop_trace()
        ms = None
        if reps:
            times = []
            for _ in range(reps):
                times.append(_clock_ms(plan, decode))
            ms = float(np.median(times))
    return {"frame": frame.cpu().numpy(), "split_plan": split_plan,
            "ms": ms, "device": str(plan.device),
            "peak_bytes": _peak(plan), "launches": dict(kernels.LAUNCHES)}


def _clock_ms(plan: MeshPlan, fn) -> float:
    """ms of ``fn()``: CUDA events on a card, else the host clock."""
    if plan.device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize(plan.device)
    return start.elapsed_time(end)
