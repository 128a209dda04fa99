"""The mesh plan (port of boosting_nerv_tpu/parallel/mesh.py): its 'data'
and 'spatial' axes.

JAX runs one program over a ('data', 'spatial') mesh of devices: the frame
batch is sharded over 'data', frames and decoder maps by rows over
'spatial', the parameters are replicated, and XLA inserts the conv halos
and the gradient psum.  Torch has no SPMD, so here a rank is a process
with one device (``parallel.launch`` starts them, or torchrun); ranks
follow JAX's ``reshape(dp, sp)``: rank r = d sp + s, data index d,
spatial index s.  The batch is sliced by d (``shard_batch``), the rows by
s (``rows``, ``parallel/spatial.py``), and the gradient is averaged over
all dp sp ranks by ``DistributedDataParallel`` or by ``mean_grads``, one
flat all-reduce.  Only all-reduce and broadcast are used: gloo takes both
on CUDA tensors, so two ranks can share one card over gloo, which NCCL
refuses.

``make_mesh_plan(dp, sp, devices, backend)``:
 - dp sp = 1 (and no backend asked for) builds no process group: JAX's
   "1x1 mesh compiles to the unsharded program", so such a run is the
   code path of a single process;
 - otherwise dp sp ranks take ``cuda:0 .. cuda:dp sp - 1`` over NCCL by
   default; the devices given are used as given, over gloo when one is
   the CPU or appears twice; more ranks than devices raise ValueError, as
   JAX's does;
 - with both axes above 1, a data group a spatial index and a spatial
   group a data index are built (``dist.new_group``, in the same order on
   every rank); with one axis, its group is the world.
Inside a rank the process group must exist already (``launch`` makes it
through a FileStore) or come from torchrun's variables (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``).
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Union

import torch
import torch.distributed as dist

from .spatial import Rows, SumOverRanks

DEFAULT_TIMEOUT = 1800.0  # seconds a collective waits (torch's default)
TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK")
Devices = Optional[Sequence[Union[str, torch.device]]]


def under_torchrun() -> bool:
    """This process is a rank that torchrun (or another launcher setting
    its variables) started."""
    return all(v in os.environ for v in TORCHRUN_VARS)


def rank_devices(device: Union[str, torch.device], n: int) -> Devices:
    """The devices of ``n`` (dp sp) ranks for a trainer's ``device``:
    ``device`` itself at 1; above it the CPU for every rank, ``cuda:0 ..
    cuda:n-1`` (None, the plan's default) for "cuda", or the one device
    named with its index for every rank (over gloo)."""
    device = torch.device(device)
    if n > 1 and device.type == "cuda" and device.index is None:
        return None
    return [device] * n


def resolve(dp: int, sp: int = 1, devices: Devices = None,
            backend: Optional[str] = None):
    """(the devices of the ranks, the backend or None for no process
    group), with the plan's errors."""
    if dp < 1 or sp < 1:
        raise ValueError(f"mesh {dp}x{sp}: each axis needs at least one "
                         "rank")
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    need = dp * sp
    if need > len(devices):
        raise ValueError(f"mesh {dp}x{sp} needs {need} devices, "
                         f"have {len(devices)}")
    devices = devices[:need]
    if backend is None and need > 1:
        shared = len(set(devices)) < len(devices)
        backend = ("nccl" if all(d.type == "cuda" for d in devices)
                   and not shared else "gloo")
    return devices, backend


@dataclass
class MeshPlan:
    """One rank's view of the mesh: ``dp`` x ``sp`` ranks (``world``),
    this one ``rank`` on ``device``; ``group`` (the world) None when no
    process group was built (dp sp 1); ``data_group`` the ranks of this
    rank's spatial index (None at dp 1), ``spatial_group`` those of its
    data index (None at sp 1)."""
    dp: int
    sp: int
    rank: int
    world: int
    device: torch.device
    backend: Optional[str] = None
    group: Optional[object] = None
    data_group: Optional[object] = None
    spatial_group: Optional[object] = None

    @property
    def d(self) -> int:
        """This rank's data index."""
        return self.rank // self.sp

    @property
    def s(self) -> int:
        """This rank's spatial index."""
        return self.rank % self.sp

    @property
    def is_main(self) -> bool:
        """Rank 0: it writes the checkpoints and logs and runs the evals."""
        return self.rank == 0

    def shard_batch(self, x):
        """This rank's contiguous slice of the global batch ``x`` (its
        leading axis): the rows JAX's ``batch_sharding`` (``P("data")``)
        puts on the devices of data index ``d``.  A batch that dp does not
        divide raises ValueError."""
        n = len(x)
        if n % self.dp:
            raise ValueError(f"global batch {n} is not divisible by dp "
                             f"{self.dp}")
        size = n // self.dp
        return x[self.d * size:(self.d + 1) * size]

    def rows(self) -> Optional[Rows]:
        """The 'spatial' axis for a model's forward (``parallel.spatial``):
        None in a single process, whose forward is the unsplit one; at sp
        1 and dp > 1 the forward keeps every map whole and sums the moments
        of ``norm="bn"`` over the data group."""
        if self.group is None:
            return None
        return Rows(sp=self.sp, s=self.s, group=self.spatial_group,
                    dp=self.dp, data_group=self.data_group,
                    world_group=self.group)

    def ddp(self, module: torch.nn.Module) -> torch.nn.Module:
        """``module`` under DistributedDataParallel (its parameters
        broadcast from rank 0; gradients averaged in the backward pass,
        overlapped with it), or ``module`` itself without a group."""
        if self.group is None:
            return module
        from torch.nn.parallel import DistributedDataParallel

        ids = [self.device] if self.device.type == "cuda" else None
        return DistributedDataParallel(module, device_ids=ids,
                                       process_group=self.group)

    def replicate(self, tensors: Sequence[torch.Tensor]) -> None:
        """Rank 0's values of ``tensors`` on every rank, in place (one
        flat broadcast)."""
        if self.group is None or not tensors:
            return
        with torch.no_grad():
            flat = torch.cat([t.detach().reshape(-1) for t in tensors])
            dist.broadcast(flat, 0, group=self.group)
            for t, v in zip(tensors, flat.split([t.numel()
                                                 for t in tensors])):
                t.copy_(v.view_as(t))

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of ``x`` over the ranks (no gradient), a new tensor."""
        x = x.detach().clone()
        if self.group is not None:
            dist.all_reduce(x, group=self.group)
            x /= self.world
        return x

    def sum_over_data(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the data group, differentiable: the
        backward pass sums every rank's gradient of the sum back to each
        rank, so each rank's backward gives its share of the gradient of
        the sum of all data shards' losses.  (A value whole on every
        spatial rank: a sum over the world would count it sp times.)"""
        if self.data_group is None:
            return x
        return SumOverRanks.apply(x, self.data_group)

    def mean_grads(self, params: Sequence[torch.Tensor]) -> None:
        """Every ``.grad`` of ``params`` averaged over the ranks, in place,
        by one flat all-reduce (parameters without a gradient skipped:
        every rank runs the same step, so the same ones)."""
        if self.group is None:
            return
        grads = [p.grad for p in params if p.grad is not None]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.group)
        flat /= self.world
        for g, v in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(v.view_as(g))

    def broadcast(self, values: List[float]) -> List[float]:
        """Rank 0's ``values`` (floats) on every rank."""
        if self.group is None:
            return list(values)
        x = torch.tensor(values, dtype=torch.float64, device=self.device)
        dist.broadcast(x, 0, group=self.group)
        return x.tolist()

    def barrier(self) -> None:
        """Wait until every rank gets here (an all-reduce: NCCL's barrier
        guesses the device)."""
        if self.group is not None:
            dist.all_reduce(torch.zeros(1, device=self.device),
                            group=self.group)


def make_mesh_plan(dp: int = 1, sp: int = 1, devices: Devices = None,
                   backend: Optional[str] = None,
                   timeout: float = DEFAULT_TIMEOUT) -> MeshPlan:
    """This process's plan of a ``dp`` x ``sp`` mesh (see the module
    docstring).  ``backend`` asks for a process group even at dp sp 1 (the
    DDP path at world size 1)."""
    devices, backend = resolve(dp, sp, devices, backend)
    if backend is None:
        return MeshPlan(dp=1, sp=1, rank=0, world=1, device=devices[0])
    if not dist.is_initialized():
        if not under_torchrun():
            raise RuntimeError(
                f"mesh {dp}x{sp} over {backend} runs one process a rank: "
                "start it with boosting_nerv_torch.parallel.launch or "
                "torchrun")
        dist.init_process_group(
            backend, init_method="env://",
            timeout=datetime.timedelta(seconds=timeout))
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != dp * sp:
        raise ValueError(f"the process group has {world} ranks, the mesh "
                         f"{dp}x{sp} needs {dp * sp}")
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, the "
                         f"plan asks for {backend}")
    device = devices[rank]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    world_group = dist.group.WORLD
    data_group = world_group if sp == 1 and dp > 1 else None
    spatial_group = world_group if dp == 1 and sp > 1 else None
    if dp > 1 and sp > 1:  # every rank builds every group, in one order
        for d in range(dp):
            g = dist.new_group([d * sp + s for s in range(sp)])
            if d == rank // sp:
                spatial_group = g
        for s in range(sp):
            g = dist.new_group([d * sp + s for d in range(dp)])
            if s == rank % sp:
                data_group = g
    return MeshPlan(dp=dp, sp=sp, rank=rank, world=world, device=device,
                    backend=backend, group=world_group,
                    data_group=data_group, spatial_group=spatial_group)
