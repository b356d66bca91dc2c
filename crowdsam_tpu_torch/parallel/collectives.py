"""The collectives of the prompt-sharded engine and the spatial encode, all
on `all_reduce`.

Counterparts of the JAX engine's `psum` OR, `all_gather` and masked `psum`
(`crowdsam_tpu/pipeline/engine.py`), and of the gathers GSPMD inserts in
the JAX package's spatially sharded encode (`gather_bands`).  Only `all_reduce` is used: NCCL
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
