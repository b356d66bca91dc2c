"""The collectives of the prompt-sharded engine, the spatial encode and the
trainer's mesh step, all on `all_reduce`.

Counterparts of the JAX engine's `psum` OR, `all_gather` and masked `psum`
(`crowdsam_tpu/pipeline/engine.py`), of the gathers and halo exchanges
GSPMD inserts in the JAX package's spatially sharded encode
(`gather_bands`, `gather_halo`), and of the psums XLA inserts in the JAX
trainer's mesh step (`sum_partials`).  Only `all_reduce` is used: NCCL
serves it for several cards, and gloo serves it on CUDA tensors as well as
CPU ones (gloo has no all-gather on CUDA tensors), so the same code runs
ranks that share one card.  The gathers are sums in which exactly one rank
contributes each element and every other rank adds zero; they sum the
tensors' bytes as uint8, so every dtype (bool, int, float, bf16, -0.0 and
NaN included) arrives bit for bit.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass
class Shard:
    """One rank's place on a mesh axis: the axis's process group, this
    rank's index in it and its size M.  `calls` and `bytes` count the
    all-reduces made through it and the bytes they reduced."""
    group: object
    rank: int
    size: int
    calls: int = 0
    bytes: int = 0

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum `x` over the group in place (x contiguous)."""
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        self.calls += 1
        self.bytes += x.numel() * x.element_size()
        return x


def _sum_bytes(buf: torch.Tensor, shard: Shard) -> torch.Tensor:
    """All-reduce `buf` (contiguous; each element nonzero on at most one
    rank) as its bytes: exact for every dtype."""
    shard.all_reduce(buf.view(torch.uint8))
    return buf


def or_reduce(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    """Element-wise OR of a bool tensor over the group: the int32 sum of
    every rank's, then > 0 (the JAX engine's `psum(x.astype(int32)) > 0`)."""
    s = x.to(torch.int32).contiguous()
    return shard.all_reduce(s) > 0


def gather_rows(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    """Every rank's `x` stacked in rank order, (M, *x.shape): a zero-filled
    buffer in which each rank fills its own slot, summed over the group."""
    buf = torch.zeros((shard.size,) + tuple(x.shape), dtype=x.dtype,
                      device=x.device)
    buf[shard.rank] = x
    return _sum_bytes(buf, shard)


def gather_bands(x: torch.Tensor, bounds, shard: Shard,
                 dim: int = 1) -> torch.Tensor:
    """The whole of a tensor split along `dim` into one band a rank, rank r
    holding [bounds[r][0], bounds[r][1]) as `x`; the bands may differ in
    length.  A zero-filled buffer of the whole extent in which each rank
    fills its own band, summed over the group."""
    lo, hi = bounds[shard.rank]
    if x.shape[dim] != hi - lo:
        raise ValueError(f"rank {shard.rank}'s band [{lo}, {hi}) of "
                         f"{x.shape[dim]} rows along dim {dim}")
    shape = list(x.shape)
    shape[dim] = bounds[-1][1]
    buf = torch.zeros(shape, dtype=x.dtype, device=x.device)
    buf.narrow(dim, lo, hi - lo).copy_(x)
    return _sum_bytes(buf, shard)


def masked_psum(rows: torch.Tensor, mine: torch.Tensor,
                shard: Shard) -> torch.Tensor:
    """Rows assembled from their owners: each rank keeps the rows where
    `mine` (a bool per row, true on exactly one rank or on none) and
    zeros the rest, and the sum over the group holds every owned row as
    its owner had it (rows owned by no rank are zero)."""
    keep = mine.reshape(mine.shape + (1,) * (rows.dim() - mine.dim()))
    buf = torch.where(keep, rows, torch.zeros((), dtype=rows.dtype,
                                              device=rows.device))
    return _sum_bytes(buf.contiguous(), shard)


def gather_halo(x: torch.Tensor, bounds, need, shard: Shard,
                dim: int = 1) -> torch.Tensor:
    """This rank's band of rows along `dim` widened to the rows it needs:
    rank r holds [bounds[r][0], bounds[r][1]) as `x` and needs [need[r][0],
    need[r][1]), a range around its band.  Only the halo is reduced: a
    zero-filled buffer of the rows some rank needs and does not hold, in
    row order, each filled by the rank that holds it.  No all-reduce when
    no rank needs a row it does not hold (every rank computes the same
    halo from `bounds` and `need`)."""
    lo, hi = bounds[shard.rank]
    if x.shape[dim] != hi - lo:
        raise ValueError(f"rank {shard.rank}'s band [{lo}, {hi}) of "
                         f"{x.shape[dim]} rows along dim {dim}")
    halo = sorted({i for (a, b), (blo, bhi) in zip(need, bounds)
                   for i in range(a, b) if not blo <= i < bhi})
    if not halo:
        return x
    at = {row: j for j, row in enumerate(halo)}
    shape = list(x.shape)
    shape[dim] = len(halo)
    buf = torch.zeros(shape, dtype=x.dtype, device=x.device)
    mine = [row for row in halo if lo <= row < hi]
    if mine:
        buf.index_copy_(dim, torch.tensor([at[r] for r in mine],
                                          device=x.device),
                        x.index_select(dim, torch.tensor(
                            [r - lo for r in mine], device=x.device)))
    _sum_bytes(buf, shard)
    a, b = need[shard.rank]
    parts = []
    if a < lo:
        parts.append(buf.narrow(dim, at[a], lo - a))
    parts.append(x)
    if hi < b:
        parts.append(buf.narrow(dim, at[hi], b - hi))
    return torch.cat(parts, dim=dim) if len(parts) > 1 else x


class _SumPartials(torch.autograd.Function):
    """The sum over the group; the gradient of each rank's partial is the
    sum's gradient times the group's size M (see `sum_partials`)."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.size = shard.size
        return shard.all_reduce(x.contiguous().clone())

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.size, None


def sum_partials(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    """The sum over the group of each rank's partial `x` (each rank holds
    the partial sum of its share of a contraction), for a step whose ranks
    each scale their loss by 1/M: everything downstream of the sum is
    computed alike on the M ranks, so each counts it 1/M times, while
    each rank's partial, multiplied back by M, gets the whole gradient of
    its own share.  Summing the ranks' parameter gradients then counts
    every term once."""
    return _SumPartials.apply(x, shard)
