"""The mesh's 'spatial' axis in the port (``parallel/spatial.py``, the split
forms of ``models/blocks.py``) on gloo CPU ranks, against the unsplit
layers in this process.

One launch of four ranks runs every case on two meshes built over them:
dp x sp = 1 x 4 and 2 x 2 (``run_jobs``' meshes).  Input [2, 4, 24, 8]:
a shard holds 6 rows at sp 4 and 12 at sp 2, so each map splits, and the
ConvNeXt encoder's second patchify gathers at sp 4 (its 12-row input has
3 rows a shard, which its stride 2 does not divide).

- The split layers (3x3 conv, ConvNeXt block with its 7x7 depthwise conv,
  ConvNeXt encoder with its patchify convs, PixelShuffle upconv,
  ResBlockSFT, 'in' and 'bn' normalisation): the output, the input's
  gradient, the SFT condition's and every weight's within 1e-5 of the
  largest value of the unsplit layer's, fp32, each rank
  back-propagating its data shard's whole output's loss and the gradients
  summed over the ranks and divided by sp (the spatial module's gradient
  rule); 'bn' takes the global batch's moments (the data group's).
- The primitives ``exchange_halo`` (2 rows; zeros past the frame's
  edges), ``gather_rows`` and ``take_rows``: each rank's output and the
  input's gradient, exactly.
- The plan's indices and groups: rank d sp + s, ``shard_batch`` by d (the
  rows JAX's ``shard_batch`` puts on the devices of data index d), the
  spatial and data groups' ranks.
"""

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from boosting_nerv_torch.parallel import MeshPlan, launch
from boosting_nerv_torch.parallel.spatial import MAX_HALO, Rows
from boosting_nerv_torch.parallel.steps import run_jobs
from boosting_nerv_tpu.parallel.mesh import make_mesh_plan as ref_plan
from torch_spatial_workers import (HALO, PRIMITIVES, plan_facts,
                                   split_layer, split_layers)

TOL = 1e-5  # of the largest value
TIMEOUT = 120.0  # seconds a rank waits in a collective
B, C, H, W = 2, 4, 24, 8
MESHES = [(1, 4), (2, 2)]
LAYERS = ["conv3x3", "dwconv7", "patchify", "pixel_shuffle", "rsft", "in",
          "bn"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def layer_case(name, rng, x, cond):
    """(the worker's case, the unsplit layer's output and gradients)."""
    m, _, unsplit = split_layer(name, C)
    xt = torch.from_numpy(x).requires_grad_(True)
    ct = torch.from_numpy(cond).requires_grad_(True)
    y = unsplit(xt, ct if name == "rsft" else None)
    gy = rng.normal(size=tuple(y.shape)).astype(np.float32)
    (y * torch.from_numpy(gy)).sum().backward()
    want = {"y": y.detach().numpy(), "gx": xt.grad.numpy(),
            "gcond": ct.grad.numpy() if name == "rsft" else None,
            "gparams": {} if m is None else
            {n: p.grad.numpy() for n, p in m.named_parameters()}}
    return (name, x, gy, cond if name == "rsft" else None), want


def primitive_case(name, sp, rng, x):
    """(the worker's case, each rank's output and the input's gradient of
    the primitive on the whole map)."""
    h = H // sp
    xt = torch.from_numpy(x).requires_grad_(True)
    if name == "exchange_halo":
        xp = F.pad(xt, (0, 0, HALO, HALO))
        outs = [xp[:, :, s * h:s * h + h + 2 * HALO] for s in range(sp)]
    elif name == "gather_rows":
        outs = [xt] * sp
    else:
        outs = [xt[:, :, s * h:(s + 1) * h] for s in range(sp)]
    gy = np.stack([rng.normal(size=tuple(o.shape)).astype(np.float32)
                   for o in outs])
    if name == "gather_rows":  # every rank's loss is the same one
        gy[:] = gy[0]
    loss = sum((o * torch.from_numpy(g)).sum() for o, g in zip(outs, gy))
    (loss / (sp if name == "gather_rows" else 1)).backward()
    return (name, x, gy, None), {"y": [o.detach().numpy() for o in outs],
                                 "gx": xt.grad.numpy()}


@pytest.fixture(scope="module")
def runs():
    """{mesh: (the cases' expected results, every rank's results)}."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, C, H, W)).astype(np.float32)
    cond = rng.normal(size=(B, C)).astype(np.float32)
    layers = [layer_case(n, rng, x, cond) for n in LAYERS]
    prims = {sp: [primitive_case(n, sp, rng, x) for n in PRIMITIVES]
             for _, sp in MESHES}
    jobs = []
    for dp, sp in MESHES:
        jobs.append((split_layers, ([c for c, _ in layers + prims[sp]],),
                     (dp, sp)))
        jobs.append((plan_facts, (), (dp, sp)))
    ranks = launch(run_jobs, dict(dp=1, sp=4, devices=["cpu"] * 4),
                   args=(jobs,), timeout=TIMEOUT)
    return {mesh: ([w for _, w in layers + prims[mesh[1]]],
                   [(r[2 * j], r[2 * j + 1]) for r in ranks])
            for j, mesh in enumerate(MESHES)}


def rel_err(got, want):
    return float(np.abs(got - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


@pytest.mark.parametrize("mesh", MESHES)
def test_split_layers_match_unsplit(runs, mesh):
    dp, sp = mesh
    wants, ranks = runs[mesh]
    for k, name in enumerate(LAYERS):
        want = wants[k]
        # the data shards' outputs, each whole on every spatial rank
        for d in range(dp):
            for s in range(sp):
                got = ranks[d * sp + s][0][k]
                err = rel_err(got["y"], want["y"][d * B // dp:
                                                  (d + 1) * B // dp])
                assert err <= TOL, (name, mesh, d, s, "y", err)
        got = ranks[0][0][k]
        pairs = [("gx", got["gx"], want["gx"])]
        if want["gcond"] is not None:
            pairs.append(("gcond", got["gcond"], want["gcond"]))
        assert sorted(got["gparams"]) == sorted(want["gparams"])
        pairs += [(n, got["gparams"][n], v)
                  for n, v in want["gparams"].items()]
        for what, a, b in pairs:
            assert rel_err(a, b) <= TOL, (name, mesh, what, rel_err(a, b))


@pytest.mark.parametrize("mesh", MESHES)
def test_primitives_exact(runs, mesh):
    dp, sp = mesh
    wants, ranks = runs[mesh]
    for k, name in enumerate(PRIMITIVES, start=len(LAYERS)):
        want = wants[k]
        for d in range(dp):
            for s in range(sp):
                got = ranks[d * sp + s][0][k]
                np.testing.assert_array_equal(
                    got["y"], want["y"][s][d * B // dp:(d + 1) * B // dp],
                    err_msg=f"{name} {mesh} rank {d * sp + s}")
        np.testing.assert_array_equal(ranks[0][0][k]["gx"], want["gx"],
                                      err_msg=f"{name} {mesh} gx")
        if name == "exchange_halo":  # the frame's edges receive zeros
            top, bottom = ranks[0][0][k]["y"], ranks[sp - 1][0][k]["y"]
            assert not top[:, :, :HALO].any()
            assert not bottom[:, :, -HALO:].any()


def test_plan_indices_groups_and_batch_rows_match_jax():
    ref = ref_plan(2, 2)
    x = np.arange(8)
    shards = {s.device: np.asarray(s.data)
              for s in ref.shard_batch(x).addressable_shards}
    for rank, device in enumerate(ref.mesh.devices.reshape(-1)):
        plan = MeshPlan(dp=2, sp=2, rank=rank, world=4,
                        device=torch.device("cpu"))
        assert (plan.d, plan.s) == divmod(rank, 2)
        np.testing.assert_array_equal(plan.shard_batch(x), shards[device])
    assert len(jax.devices()) == 8


def test_launched_meshes_build_their_groups(runs):
    for (dp, sp), (_, ranks) in runs.items():
        for rank, (_, facts) in enumerate(ranks):
            d, s = divmod(rank, sp)
            assert (facts["rank"], facts["d"], facts["s"]) == (rank, d, s)
            assert facts["rows"] == list(range(d * 8 // dp,
                                               (d + 1) * 8 // dp))
            assert facts["spatial"] == [d * sp + i for i in range(sp)]
            assert facts["data"] == (None if dp == 1 else
                                     [i * sp + s for i in range(dp)])


def test_split_rule():
    rows = Rows(sp=4, s=1)
    assert MAX_HALO == 3
    assert [h for h in (8, 12, 16, 18, 24, 36, 540, 1080)
            if rows.splits(h)] == [12, 16, 24, 36, 540, 1080]
    assert not Rows(sp=1).splits(1080)
    assert [h for h in (9, 18, 45, 135, 270) if Rows(sp=2).splits(h)] \
        == [18, 270]
