"""The port's mesh plan (``parallel/mesh.py``) against the JAX package's
(``boosting_nerv_tpu/parallel/mesh.py``) on the 8 virtual CPU devices of
tests/conftest.py, and its launcher (``parallel/launch.py``): dp 1 builds
no process group, the plan's errors, the default backends, each rank's
``shard_batch`` rows equal to the rows JAX's ``shard_batch`` puts on the
rank's device, a rank that fails fails the launch within its timeout, and
a rank that torchrun started joins its group."""

import socket
import time

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from boosting_nerv_torch.parallel import MeshPlan, launch, make_mesh_plan
from boosting_nerv_torch.parallel.mesh import resolve
from boosting_nerv_tpu.parallel.mesh import make_mesh_plan as ref_plan

TIMEOUT = 60.0  # seconds: a launch's collectives, and the failure test's


def test_dp1_builds_no_process_group():
    plan = make_mesh_plan(1, devices=["cpu"])
    assert (plan.dp, plan.sp, plan.rank, plan.world) == (1, 1, 0, 1)
    assert plan.device == torch.device("cpu") and plan.is_main
    assert plan.backend is None and plan.group is None
    assert not dist.is_initialized()
    x = torch.arange(6.0)
    model = torch.nn.Linear(2, 2)
    assert plan.ddp(model) is model
    assert torch.equal(plan.mean(x), x)
    assert plan.broadcast([1.5, 2.0]) == [1.5, 2.0]
    plan.replicate([x])
    plan.barrier()
    assert torch.equal(x, torch.arange(6.0)) and not dist.is_initialized()


def test_plan_errors():
    # the cards: none on this machine, so two ranks have no devices
    with pytest.raises(ValueError, match="mesh 2x1 needs 2 devices, have 0"):
        make_mesh_plan(2)
    with pytest.raises(ValueError, match="mesh 8x1 needs 8 devices, have 4"):
        make_mesh_plan(8, devices=["cpu"] * 4)
    # the 'spatial' axis takes dp x sp ranks
    with pytest.raises(ValueError, match="mesh 2x2 needs 4 devices, have 3"):
        make_mesh_plan(2, 2, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="each axis needs at least one"):
        make_mesh_plan(1, 0, devices=["cpu"])
    with pytest.raises(RuntimeError, match="parallel.launch or torchrun"):
        make_mesh_plan(2, devices=["cpu"] * 2)  # no group in this process
    plan = MeshPlan(dp=4, sp=1, rank=1, world=4, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="batch 6 is not divisible by dp 4"):
        plan.shard_batch(np.arange(6))


def test_default_backends():
    assert resolve(1, devices=["cpu"]) == ([torch.device("cpu")], None)
    assert resolve(2, devices=["cpu"] * 3)[1] == "gloo"
    assert resolve(2, devices=["cuda:0", "cuda:1"])[1] == "nccl"
    # two ranks on one card: gloo, since NCCL refuses them
    assert resolve(2, devices=["cuda:0", "cuda:0"])[1] == "gloo"
    assert resolve(1, devices=["cuda:0"], backend="nccl")[1] == "nccl"


def test_shard_batch_rows_match_jax_addressable_shards():
    assert len(jax.devices()) == 8
    ref = ref_plan(4, 1)
    rng = np.random.default_rng(0)
    for x in (rng.normal(size=(8, 3, 2)).astype(np.float32),
              np.arange(8, dtype=np.float32),
              rng.normal(size=(12, 5)).astype(np.float32)):
        shards = {s.device: np.asarray(s.data)
                  for s in ref.shard_batch(x).addressable_shards}
        for rank, device in enumerate(ref.mesh.devices[:, 0]):
            plan = MeshPlan(dp=4, sp=1, rank=rank, world=4,
                            device=torch.device("cpu"))
            np.testing.assert_array_equal(plan.shard_batch(x),
                                          shards[device])
            np.testing.assert_array_equal(
                plan.shard_batch(torch.from_numpy(x)).numpy(),
                shards[device])


def test_a_failing_rank_fails_the_launch_within_its_timeout():
    # rank 1's device, a card, does not exist here: it raises while rank
    # 0 waits for it to join the group
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed") as err:
        launch(MeshPlan.barrier, dict(dp=2, devices=["cpu", "cuda:0"]),
               timeout=TIMEOUT)
    assert time.perf_counter() - t0 < TIMEOUT
    assert "Traceback" in str(err.value) and "set_device" in str(err.value)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_a_torchrun_rank_joins_its_group(monkeypatch):
    for k, v in {"RANK": "0", "LOCAL_RANK": "0", "WORLD_SIZE": "2",
                 "MASTER_ADDR": "localhost",
                 "MASTER_PORT": str(_free_port())}.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="torchrun started 2 ranks, dp is "
                                         "4"):
        launch(MeshPlan.barrier, dict(dp=4, devices=["cpu"] * 4))
    monkeypatch.setenv("WORLD_SIZE", "1")
    try:
        got = launch(lambda plan, x: (plan.rank, plan.world, plan.backend,
                                      plan.shard_batch(x)),
                     dict(dp=1, devices=["cpu"], backend="gloo"),
                     args=([1, 2],), timeout=TIMEOUT)
        assert got == [(0, 1, "gloo", [1, 2])]
        assert dist.get_world_size() == 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
