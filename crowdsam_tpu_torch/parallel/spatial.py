"""The spatial axis of the batched encode: each rank of a mesh axis computes
one band of token rows of each encoder.

Counterpart of the JAX `ShardedPipeline(..., spatial_axis=...)`, whose
encode takes its input laid out `P("data", spatial_axis)` and leaves it to
GSPMD to partition the image encoder and DINOv2 by image rows.  Here the
partition is written out.  Every rank of the axis holds the whole frame
(it normalizes, masks and resizes it as the unsharded encode does) and
computes its band of each encoder; only activations cross ranks, through
`collectives.gather_bands` and `collectives.gather_halo` on the axis's
`Shard`, which counts them:

- SAM ViT (`ImageEncoderViT.forward_band`): up to as many ranks as the
  padded grid has window rows, bands of whole window rows (64 rows pad to
  70, five 14-row windows: [0, 42) / [42, 64) at M = 2), so the window
  blocks see exactly the windows of the unsharded encode and need no
  exchange; past that, `split_rows` of the token rows (11 / 11 / 11 / 11
  / 10 / 10 at M = 6), and before each window block a rank gets the rows
  of every window its band touches from their owners (a row halo,
  `Band.windows`), the zero pad only past the grid's last row as in the
  whole encode.  Each global block gathers K and V of every band and runs
  its band's queries through K3 (a query band); the neck gathers the
  output of its 1x1 convolution and LayerNorm and runs the 3x3
  convolution and the last LayerNorm on the whole map on every rank.
- TinyViT (`TinyViT.forward_band`, `mobile_sam`): `split_rows` of the
  final grid's rows (64 at 1024), each stage's band that band at the
  stage's resolution (x4, x2, x1, x1); every 3x3 convolution past the
  patch embedding gets the rows it reads past its band (one on each side,
  one above for a stride-2 merge), every window attention the rows of the
  windows its band touches; the neck as in SAM ViT.
- DINOv2 (`DinoVisionTransformer.forward_band`): bands of patch rows (73
  rows: 37 / 36 at M = 2), the cls token with rank 0's band, so a band's
  tokens are contiguous; each block gathers K and V of every token and
  runs its band's queries through K4; the normed tokens are gathered.

Every rank thus ends with the whole features and DINOv2 tokens, the same
on each, and the rest of the pipeline runs unsharded on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from crowdsam_tpu_torch.parallel.collectives import (
    Shard,
    gather_bands,
    gather_halo,
)


@dataclasses.dataclass(frozen=True)
class Band:
    """This rank's band [lo, hi) of the rows along dim 1 of an encoder's
    activations, every rank's bounds, and the axis's `Shard`."""
    shard: Shard
    bounds: Tuple[Tuple[int, int], ...]

    @property
    def lo(self) -> int:
        return self.bounds[self.shard.rank][0]

    @property
    def hi(self) -> int:
        return self.bounds[self.shard.rank][1]

    @property
    def grid(self) -> int:
        """The whole extent: the last band's end."""
        return self.bounds[-1][1]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole extent along dim 1 from every rank's band of it."""
        return gather_bands(x, self.bounds, self.shard, dim=1)

    def widen(self, x: torch.Tensor, need) -> torch.Tensor:
        """This rank's band `x` (along dim 1) widened to need[rank], every
        rank's range of rows around its band (`gather_halo`)."""
        return gather_halo(x, self.bounds, need, self.shard, dim=1)

    def windows(self, window: int) -> Tuple[Tuple[int, int], ...]:
        """Every rank's rows of the `window`-row windows its band touches,
        cut at the grid (the windows of the grid padded past its end)."""
        return tuple((lo // window * window,
                      min(-(-hi // window) * window, self.grid))
                     for lo, hi in self.bounds)

    def scaled(self, factor: int) -> "Band":
        """The same band at `factor` times the resolution."""
        return Band(self.shard, tuple((lo * factor, hi * factor)
                                      for lo, hi in self.bounds))

    def with_cls(self, width: int) -> "Band":
        """The token band of a band of patch rows `width` patches wide,
        the cls token (token 0) going with the band that starts at row 0."""
        return Band(self.shard, tuple(
            (0 if lo == 0 else 1 + width * lo, 1 + width * hi)
            for lo, hi in self.bounds))


def split_rows(n: int, parts: int) -> Tuple[Tuple[int, int], ...]:
    """[0, n) in `parts` contiguous bands as even as can be, the first ones
    one longer.  Raises when a band would be empty."""
    if not 0 < parts <= n:
        raise ValueError(f"{n} rows do not split into {parts} bands")
    sizes = [n // parts + (i < n % parts) for i in range(parts)]
    ends = [sum(sizes[:i + 1]) for i in range(parts)]
    return tuple(zip([0] + ends[:-1], ends))


def window_bands(grid: int, window: int,
                 parts: int) -> Tuple[Tuple[int, int], ...]:
    """Bands of whole `window`-row windows of a `grid`-row grid padded to
    a multiple of the window, cut at the grid, when there are at least
    `parts` window rows; else `split_rows` of the grid's rows, which cut
    windows."""
    n_win = -(-grid // window)
    if parts > n_win:
        return split_rows(grid, parts)
    return tuple((lo * window, min(hi * window, grid))
                 for lo, hi in split_rows(n_win, parts))


def sam_band(encoder, shard: Shard) -> Band:
    """The image encoder's token-row band of this rank: SAM ViT's
    `window_bands`, TinyViT's (no `window_size`) `split_rows` of the final
    grid."""
    grid = encoder.img_size // encoder.patch_size
    window = getattr(encoder, "window_size", 0)
    return Band(shard, window_bands(grid, window, shard.size) if window
                else split_rows(grid, shard.size))


def dino_band(grid: int, shard: Shard) -> Band:
    """DINOv2's patch-row band of this rank on a `grid`-row grid."""
    return Band(shard, split_rows(grid, shard.size))
