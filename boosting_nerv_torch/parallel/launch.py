"""The process model of the mesh: one process a rank.

JAX drives every device of its mesh from one process; torch needs a
process a device.  ``launch(fn, plan_args, args)`` runs
``fn(plan, *args)`` on every rank of ``make_mesh_plan(**plan_args)``:

 - with no process group to build (dp sp 1, no backend asked for) in this
   process;
 - under torchrun (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` set) in this
   process, as its rank of the group torchrun made, which must have dp sp
   ranks;
 - otherwise in dp sp processes started in ``spawn`` mode (never ``fork``:
   a process that has imported a threaded library deadlocks when
   forked), which meet through a FileStore in a fresh temporary
   directory (so concurrent launches never share a port) and wait at
   most ``timeout`` seconds in a collective.  A CPU rank runs torch on one
   thread.  A rank that raises, or dies, makes ``launch`` raise with that
   rank's traceback; the other ranks are terminated.

It returns the ranks' results in rank order (under torchrun, this rank's
alone).  ``fn`` and ``args`` are pickled to the ranks: ``fn`` is a
module-level function of a module the ranks can import, and what it
returns travels back pickled, so it returns host values (numpy, floats),
not CUDA tensors.
"""

from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import traceback
from typing import Any, Callable, Dict, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import DEFAULT_TIMEOUT, make_mesh_plan, resolve, under_torchrun

POLL_S = 0.2  # how often the launcher looks for a dead rank
JOIN_S = 10.0  # how long a terminated rank has to exit before it is killed


def _rank_main(rank: int, world: int, store: str, fn: Callable,
               plan_args: Dict[str, Any], args: Sequence, timeout: float,
               results) -> None:
    """A spawned rank: join the group, build the plan, run ``fn``, and put
    (rank, ok, result or traceback) on ``results``."""
    try:
        devices, backend = resolve(**{k: plan_args[k] for k in
                                      ("dp", "sp", "devices", "backend")
                                      if k in plan_args})
        device = devices[rank]
        if device.type == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(device)
        dist.init_process_group(
            backend, store=dist.FileStore(store, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout))
        plan = make_mesh_plan(**plan_args)
        results.put((rank, True, fn(plan, *args)))
    except BaseException:  # reported to the launcher, which raises it
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn: Callable, plan_args: Dict[str, Any], args: Sequence = (),
           timeout: float = DEFAULT_TIMEOUT) -> List[Any]:
    """``fn(plan, *args)`` on every rank of ``make_mesh_plan(**plan_args)``
    (see the module docstring); the results in rank order."""
    dp, sp = plan_args.get("dp", 1), plan_args.get("sp", 1)
    world = dp * sp
    _, backend = resolve(**{k: plan_args[k] for k in
                            ("dp", "sp", "devices", "backend")
                            if k in plan_args})
    if backend is None:
        return [fn(make_mesh_plan(**plan_args), *args)]
    if under_torchrun():
        started = int(os.environ["WORLD_SIZE"])
        if started != world:
            raise ValueError(f"torchrun started {started} ranks, dp is {dp}"
                             f" and sp {sp}")
        return [fn(make_mesh_plan(**plan_args, timeout=timeout), *args)]

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="bnt_store_")
    store = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, store, fn, plan_args, args, timeout,
                               results))
             for r in range(world)]
    done: Dict[int, Any] = {}
    try:
        for p in procs:
            p.start()
        while len(done) < world:
            try:
                rank, ok, payload = results.get(timeout=POLL_S)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in done and p.exitcode is not None]
                if dead:  # a result it put may still be in the pipe
                    try:
                        rank, ok, payload = results.get(timeout=JOIN_S)
                    except queue.Empty:
                        raise RuntimeError(
                            f"rank {dead[0]} of {world} exited with code "
                            f"{procs[dead[0]].exitcode} and no result"
                        ) from None
                else:
                    continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n"
                                   f"{payload}")
            done[rank] = payload
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(JOIN_S)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [done[r] for r in range(world)]
