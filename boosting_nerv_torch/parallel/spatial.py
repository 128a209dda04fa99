"""The 'spatial' axis (port of boosting_nerv_tpu/parallel/mesh.py's
'spatial' axis): frames and feature maps split by rows over the ranks of
a spatial group, with the halo exchanges written by hand.

JAX shards H over 'spatial' and XLA's SPMD partitioner writes the conv
halos.  Torch has no SPMD, so a model run with a ``Rows`` (its forward's
``rows`` argument) splits its maps itself.  Spatial rank ``s`` of ``sp``
holds rows ``[s H / sp, (s + 1) H / sp)`` of a map of height H that is
split; a map is split only where sp divides H and a shard is at least
``MAX_HALO`` rows tall (the widest halo a split layer sends: ConvNeXt's
7x7 depthwise conv), else it is whole on every spatial rank and computed
redundantly.  Both are exact, so every config runs at sp > 1; the plan
follows from the config and the frame size, and ``Rows.trace`` records
it as one forward takes it (the trainer prints it once).

The primitives use ``all_reduce`` alone (gloo takes it on CUDA tensors,
so two ranks can share one card; NCCL across cards):

- ``exchange_halo(x, rows, ...)``: ``x`` with ``rows`` rows of each
  neighbour above and below; a rank at the frame's edge receives zeros,
  the conv's zero padding.  Backward: the gradient of the received rows
  goes back to their owner and is added to its edge rows.
- ``gather_rows``: forward, the whole map on every spatial rank;
  backward, the sum of the spatial ranks' gradients, then the rank's own
  rows.
- ``take_rows``: forward, the rank's rows of a whole map; backward, those
  rows padded with zeros (``narrow``'s own backward).
- ``SumOverRanks``: the differentiable sum over a group (the spatial
  group for a split map's moments).

**Gradient rule.**  Each rank back-propagates its data shard's *whole*
loss, computed on the gathered output frame.  Through ``gather_rows``'s
backward every rank's rows receive the sum of sp equal gradients, and a
whole map reaches the loss only through ``take_rows`` (its rank's rows)
or through values each rank computes whole, so the gradients of a
spatial group sum to sp times the data shard's gradient; DDP's (or
``MeshPlan.mean_grads``') mean over all dp * sp ranks is then exactly
the dp = sp = 1 gradient.  A term that each spatial rank computes whole
from values that are whole (the CEM rate term of the weights, the
embedding's, which the encoder hands over gathered) is back-propagated
unscaled: its sp copies make the same sp times.  Normalisation moments
sum over the spatial group where the map is split and over the data
group for 'bn' (JAX's batch statistics are the global batch's); a whole
map's moments never sum over the spatial group, which would count them
sp times.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

MAX_HALO = 3  # rows: the widest halo of a split layer (a 7x7 conv's)


class SumOverRanks(torch.autograd.Function):
    """All-reduce (sum) over ``group`` whose backward all-reduces (sums)
    the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _swap_edges(shape, like, lo, hi, sp, s, group):
    """One all-reduce over the sp - 1 boundaries of a spatial group: rank
    s sends ``lo`` to rank s - 1 and ``hi`` to rank s + 1 (boundary j,
    between ranks j and j + 1, holds rank j's ``hi`` in slot 0 and rank
    j + 1's ``lo`` in slot 1).  Returns (rank s - 1's ``hi``, rank s + 1's
    ``lo``), zeros at the frame's edges."""
    buf = like.new_zeros(shape)
    if s > 0:
        buf[s - 1, 1] = lo
    if s < sp - 1:
        buf[s, 0] = hi
    dist.all_reduce(buf, group=group)
    zeros = like.new_zeros(shape[2:])
    return (buf[s - 1, 0] if s > 0 else zeros,
            buf[s, 1] if s < sp - 1 else zeros)


class _ExchangeHalo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rows, sp, s, group):
        ctx.rows, ctx.sp, ctx.s, ctx.group = rows, sp, s, group
        b, c, _, w = x.shape
        above, below = _swap_edges((sp - 1, 2, b, c, rows, w), x,
                                   x[:, :, :rows], x[:, :, -rows:], sp, s,
                                   group)
        return torch.cat([above, x, below], dim=2)

    @staticmethod
    def backward(ctx, g):
        rows, sp, s = ctx.rows, ctx.sp, ctx.s
        b, c, _, w = g.shape
        # the received rows' gradients go back to their owners: the top
        # halo's to rank s - 1's last rows, the bottom halo's to rank
        # s + 1's first rows
        from_above, from_below = _swap_edges(
            (sp - 1, 2, b, c, rows, w), g, g[:, :, :rows], g[:, :, -rows:],
            sp, s, ctx.group)
        gx = g[:, :, rows:-rows].clone()
        gx[:, :, :rows] += from_above
        gx[:, :, -rows:] += from_below
        return gx, None, None, None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sp, s, group):
        ctx.sp, ctx.s, ctx.group, ctx.h = sp, s, group, x.shape[2]
        buf = x.new_zeros((sp, *x.shape))
        buf[s] = x
        dist.all_reduce(buf, group=group)
        b, c, h, w = x.shape
        return buf.permute(1, 2, 0, 3, 4).reshape(b, c, sp * h, w)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g[:, :, ctx.s * ctx.h:(ctx.s + 1) * ctx.h], None, None, None


def exchange_halo(x: torch.Tensor, rows: int, sp: int, s: int, group
                  ) -> torch.Tensor:
    """NCHW ``x``, spatial rank ``s``'s rows of a map split over ``sp``
    ranks, with ``rows`` rows of each neighbour above and below (zeros
    past the frame's edges): [B, C, h + 2 rows, W]."""
    return _ExchangeHalo.apply(x, rows, sp, s, group)


def gather_rows(x: torch.Tensor, sp: int, s: int, group) -> torch.Tensor:
    """The whole map of which NCHW ``x`` is spatial rank ``s``'s rows."""
    return _GatherRows.apply(x, sp, s, group)


def take_rows(x: torch.Tensor, sp: int, s: int) -> torch.Tensor:
    """Spatial rank ``s``'s rows of the whole NCHW map ``x``."""
    h = x.shape[2] // sp
    return x.narrow(2, s * h, h)


class Rows:
    """One rank's view of the 'spatial' axis for a model's forward
    (``MeshPlan.rows``): spatial rank ``s`` of ``sp`` in ``group``, data
    rank of ``dp`` in ``data_group`` (None at dp 1), ``world_group`` (all
    dp * sp ranks).  Its methods take a map and whether it is split, and
    return the result and whether that is split; ``trace``, when a list,
    collects the plan as a forward takes it."""

    def __init__(self, sp: int = 1, s: int = 0, group=None, dp: int = 1,
                 data_group=None, world_group=None):
        self.sp, self.s, self.group = sp, s, group
        self.dp, self.data_group, self.world_group = dp, data_group, \
            world_group
        self.trace: Optional[List[str]] = None
        self._last_h = None

    # ------------------------------------------------------------------ #
    def splits(self, h: int) -> bool:
        """A map of full height ``h`` is split."""
        return self.sp > 1 and h % self.sp == 0 and h // self.sp >= MAX_HALO

    def full(self, x: torch.Tensor, split: bool) -> int:
        return x.shape[2] * (self.sp if split else 1)

    def start_trace(self) -> None:
        """Collect the plan of the next forward in ``trace``."""
        self.trace, self._last_h = [], None

    def stop_trace(self) -> List[str]:
        """The plan collected since ``start_trace``; collection stops."""
        trace, self.trace = self.trace or [], None
        return trace

    def note(self, what: str) -> None:
        if self.trace is not None:
            self.trace.append(what)

    def gather(self, x: torch.Tensor, split: bool) -> torch.Tensor:
        """The whole map."""
        return gather_rows(x, self.sp, self.s, self.group) if split else x

    def collect(self, x: torch.Tensor, split: bool, where: str
                ) -> torch.Tensor:
        """The whole map, leaving the split forward (the output frame,
        the encoder's embedding)."""
        if self.trace is not None:
            if split:
                self.note(f"{where} {self.full(x, split)}: gathered")
            self._last_h = None  # what enters next is noted
        return self.gather(x, split)

    def settle(self, x: torch.Tensor, split: bool, where: str
               ) -> Tuple[torch.Tensor, bool]:
        """``x`` in the plan's state for its height: this rank's rows of
        a map that ``splits``, else the whole map.  The trace notes each
        new height and each change of state."""
        h = self.full(x, split)
        want = self.splits(h)
        if want != split:
            x = (take_rows(x, self.sp, self.s) if want
                 else self.gather(x, split))
        if self.trace is not None:
            if want != split or h != self._last_h:
                self.note(f"{where} {h}: {'split' if want else 'whole'}"
                          + ("" if want == split else
                             " (rows taken)" if want else " (gathered)"))
            self._last_h = h
        return x, want

    # ------------------------------------------------------------------ #
    def conv(self, conv: torch.nn.Conv2d, x: torch.Tensor, split: bool,
             where: str = "conv") -> Tuple[torch.Tensor, bool]:
        """``conv`` of ``x``: on a split map, a stride-1 conv of odd
        kernel k and padding (k - 1) / 2 receives (k - 1) / 2 rows of
        each neighbour and pads W alone; any other conv, or one whose
        halo is taller than a shard, runs on the gathered map."""
        if not split:
            return self.settle(conv(x), False, where)
        k, p = conv.kernel_size[0], conv.padding[0]
        same = (conv.stride == (1, 1) and 2 * p == k - 1
                and conv.kernel_size == (k, k) and conv.padding == (p, p)
                and conv.dilation == (1, 1) and conv.padding_mode == "zeros")
        if not same or p > x.shape[2]:
            self.note(f"{where} {self.full(x, split)}: gathers")
            return self.settle(conv(self.gather(x, split)), False, where)
        if p:
            x = exchange_halo(x, p, self.sp, self.s, self.group)
        return F.conv2d(x, conv.weight, conv.bias, 1, (0, p), 1,
                        conv.groups), True

    def patchify(self, conv: torch.nn.Conv2d, x: torch.Tensor, split: bool,
                 where: str = "patchify") -> Tuple[torch.Tensor, bool]:
        """A kernel = stride, unpadded conv (ConvNeXt's downsamples): local
        on a split map whose shards' rows the stride divides, else on the
        gathered map."""
        r = conv.stride[0]
        if split and x.shape[2] % r:
            self.note(f"{where} {self.full(x, split)} -> "
                      f"{self.full(x, split) // r}: gathers")
            x, split = self.gather(x, split), False
        return self.settle(conv(x), split, where)

    def pixel_shuffle(self, x: torch.Tensor, r: int, split: bool,
                      where: str = "pixel_shuffle"
                      ) -> Tuple[torch.Tensor, bool]:
        """PixelShuffle(r): local on a row shard (its rows multiply by
        r)."""
        return self.settle(F.pixel_shuffle(x, r), split, where)

    def whole(self, fn, x: torch.Tensor, split: bool, where: str
              ) -> Tuple[torch.Tensor, bool]:
        """``fn`` (a layer with no split form) of the gathered map."""
        if split:
            self.note(f"{where} {self.full(x, split)}: gathers")
        return self.settle(fn(self.gather(x, split)), False, where)

    # ------------------------------------------------------------------ #
    def normalize(self, norm: str, x: torch.Tensor, split: bool
                  ) -> Optional[torch.Tensor]:
        """'in' (over H, W) or 'bn' (over B, H, W) normalisation of NCHW
        ``x``, biased variance, eps 1e-5, from the moments of the whole
        map (summed over the spatial group where it is split) and, for
        'bn', of the global batch (summed over the data group); None
        where ``x`` holds them all (``norm_layer`` normalises it)."""
        data = norm == "bn" and self.dp > 1
        if split:
            group = self.world_group if data else self.group
        else:  # a whole map: never over the spatial group
            group = self.data_group if data else None
        if group is None:
            return None
        dims = (2, 3) if norm == "in" else (0, 2, 3)
        n = (self.sp if split else 1) * (self.dp if data else 1)
        for d in dims:
            n *= x.shape[d]
        mean = SumOverRanks.apply(x.sum(dim=dims, keepdim=True), group) / n
        var = SumOverRanks.apply(((x - mean) ** 2).sum(dim=dims,
                                                       keepdim=True),
                                 group) / n
        return (x - mean) * torch.rsqrt(var + 1e-5)


# sp 1 and no groups: every method is the plain layer on the whole map, so
# a block's forward_rows under WHOLE is its unsplit forward
WHOLE = Rows()
