"""Rank workers of tests/test_torch_spatial_layers.py, for ``launch``
(through ``parallel.steps.run_jobs``): ``split_layers`` runs the split
layers and the primitives of the mesh's 'spatial' axis on a rank's rows,
``plan_facts`` reports a rank's plan.  Imports torch and the port only,
so that the spawned ranks start without JAX."""

from typing import Dict, Sequence

import numpy as np
import torch

from boosting_nerv_torch.parallel.mesh import MeshPlan


def plan_facts(plan: MeshPlan) -> Dict:
    """The plan's indices, its ``shard_batch`` of 8 rows and its groups'
    ranks (None for no group)."""
    def ranks(g):
        return (None if g is None else
                sorted(torch.distributed.get_process_group_ranks(g)))
    return {"rank": plan.rank, "d": plan.d, "s": plan.s,
            "rows": plan.shard_batch(np.arange(8)).tolist(),
            "data": ranks(plan.data_group),
            "spatial": ranks(plan.spatial_group)}


PRIMITIVES = ("exchange_halo", "gather_rows", "take_rows")
HALO = 2  # rows the exchange_halo case receives


def split_layer(name: str, c: int, seed: int = 0):
    """(module or None, its split forward f(rows, x, split, cond) ->
    (y, split), its unsplit forward f(x, cond)) of the layer ``name`` at
    ``c`` channels, weights drawn from ``seed``."""
    from boosting_nerv_torch.models.blocks import (ConvNeXtBlock, ConvNeXtEncoder,
                                 ResBlockSFT, TConv, UpConv, init_weights,
                                 norm_layer)

    m = {"conv3x3": lambda: TConv(c, c, 3, 1, 1),
         "dwconv7": lambda: ConvNeXtBlock(c),
         "patchify": lambda: ConvNeXtEncoder(c, 1, [2, 2], [c, c]),
         "pixel_shuffle": lambda: UpConv("pshuffel_3x3", c, c, 3, 2),
         "rsft": lambda: ResBlockSFT(c, c)}.get(name, lambda: None)()
    if m is not None:
        init_weights(m, torch.Generator().manual_seed(seed))
    if name == "conv3x3":
        return m, lambda r, x, s, _: r.conv(m, x, s), lambda x, _: m(x)
    if name == "rsft":
        return (m, lambda r, x, s, cond: m.forward_rows(x, s, r, cond),
                lambda x, cond: m(x, cond))
    if name in ("in", "bn"):
        return (None, lambda r, x, s, _: (norm_layer(name, x, r, s), s),
                lambda x, _: norm_layer(name, x))
    return m, lambda r, x, s, _: m.forward_rows(x, s, r), lambda x, _: m(x)


def split_layers(plan: MeshPlan, cases: Sequence) -> list:
    """Each (name, x, gy, cond) of ``cases`` on the plan's rows: ``x`` the
    whole input [B, C, H, W] of the global batch, ``gy`` the gradient of
    a layer's output (its whole output's, or for ``PRIMITIVES`` a rank's
    own output's, [sp, ...] by spatial rank), ``cond`` the SFT's
    condition or None.  A layer runs on the rank's data shard and rows,
    its output gathered; each rank back-propagates (output * gy).sum(),
    and the gradients of ``x``, ``cond`` and the weights are summed over
    the ranks and divided by sp (the spatial module's gradient rule; a
    primitive's by 1, its ranks' losses being the parts of one).
    Returns a dict a case: "y" (the layer's output of the data shard, or
    a primitive's own), "gx", "gcond", "gparams" (name -> array)."""
    from boosting_nerv_torch.parallel.spatial import exchange_halo, gather_rows, take_rows

    rows = plan.rows()
    dev = plan.device
    out = []
    for name, x, gy, cond in cases:
        m, split_fn, _ = split_layer(name, x.shape[1])
        if m is not None:
            m = m.to(dev)
        x = torch.from_numpy(x).to(dev).requires_grad_(True)
        cond_t = (None if cond is None else
                  torch.from_numpy(cond).to(dev).requires_grad_(True))
        gy = torch.from_numpy(gy).to(dev)
        xd = plan.shard_batch(x)
        if name in PRIMITIVES:
            gy = plan.shard_batch(gy[rows.s])
            mine = take_rows(xd, rows.sp, rows.s)
            y = {"exchange_halo": lambda: exchange_halo(
                     mine, HALO, rows.sp, rows.s, rows.group),
                 "gather_rows": lambda: gather_rows(
                     mine, rows.sp, rows.s, rows.group),
                 "take_rows": lambda: mine}[name]()
            scale = 1 if name != "gather_rows" else rows.sp
        else:
            xs, split = rows.settle(xd, False, "input")
            cd = None if cond_t is None else plan.shard_batch(cond_t)
            y, split = split_fn(rows, xs, split, cd)
            y = rows.collect(y, split, "output")
            gy = plan.shard_batch(gy)
            scale = rows.sp
        (y * gy).sum().backward()
        named = [("x", x), ("cond", cond_t)] + (
            [] if m is None else list(m.named_parameters()))
        grads = {}
        for n, v in named:
            if v is None:
                continue
            g = v.grad.clone()
            torch.distributed.all_reduce(g, group=plan.group)
            grads[n] = (g / scale).cpu().numpy()
        out.append({"y": y.detach().cpu().numpy(), "gx": grads.pop("x"),
                    "gcond": grads.pop("cond", None), "gparams": grads})
    return out
