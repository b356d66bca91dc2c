"""TinyViT-5M image encoder: the `mobile_sam` / `vit_t` arch.

Counterpart of the JAX package's `models/tiny_vit.py` (MobileSAM's TinyViT:
embed dims (64, 128, 160, 320), depths (2, 2, 6, 2), heads (2, 4, 5, 10),
windows (7, 7, 14, 7)):

- PatchEmbed: two 3x3 stride-2 convs with a GELU between (4x down);
- stage 0: MBConv blocks (1x1 expand, 3x3 depthwise, 1x1 project, GELUs,
  a GELU after the residual);
- stages 1-3: window attention with trainable bias tables over symmetric
  relative offsets, then a 3x3 depthwise local conv whose output replaces
  x, then the MLP (LayerNorm inside); PatchMerging (1x1, depthwise 3x3,
  1x1) between stages, stride 1 into the 320-wide stage so that the output
  grid stays img/16;
- SAM's neck to 256 channels.

Every Conv2d + BatchNorm pair of the reference is one biased conv (`ConvBN`,
an inference encoder): the reference's `*.c.weight` keys with the folded
bias, and a reference checkpoint's `*.bn.*` entries fold into them at load.
The attention is plain PyTorch, as in the JAX package (no Pallas kernel);
its LayerNorms run K1 on CUDA.  NHWC throughout.

`forward_band(x, band)` is one rank's share of the spatial axis
(`parallel/spatial.py`): rows of the final grid, each stage's band that
band at the stage's resolution; the patch embedding reads the rows it
needs of the whole frame, every later 3x3 convolution first brings the
input rows it reads past the band (`Conv2d.rows_read`) and every window
attention the rows of the windows its band touches from their owners
(`Band.widen`), the zero pad only past the grid's end as in the whole
map; the neck's 3x3 convolution runs on the gathered map.
"""

from __future__ import annotations

import itertools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from crowdsam_tpu_torch.models.common import (
    ChannelLayerNorm,
    Conv2d,
    LayerNorm,
    Linear,
    gelu,
)

EMBED_DIMS = (64, 128, 160, 320)
DEPTHS = (2, 2, 6, 2)
NUM_HEADS = (2, 4, 5, 10)
WINDOW_SIZES = (7, 7, 14, 7)
_STRIDE_ONE_DIMS = (320, 448, 576)   # MobileSAM: merges into these keep size


def attention_bias_idxs(h: int, w: int) -> np.ndarray:
    """(N, N) index map into the symmetric-offset bias table, offsets
    numbered in order of first appearance (the JAX package's map)."""
    points = list(itertools.product(range(h), range(w)))
    offsets, idxs = {}, []
    for p1 in points:
        for p2 in points:
            off = (abs(p1[0] - p2[0]), abs(p1[1] - p2[1]))
            if off not in offsets:
                offsets[off] = len(offsets)
            idxs.append(offsets[off])
    return np.asarray(idxs, dtype=np.int64).reshape(len(points), len(points))


def stage_windows(img_size: int, embed_dims: Sequence[int] = EMBED_DIMS,
                  window_sizes: Sequence[int] = WINDOW_SIZES) -> List[int]:
    """The window side of each stage at `img_size`: the configured window,
    cut to the stage's grid (as the JAX blocks cut it)."""
    res, out = img_size // 4, []
    for s, ws in enumerate(window_sizes):
        out.append(min(ws, res))
        if s + 1 < len(embed_dims) and \
                embed_dims[s + 1] not in _STRIDE_ONE_DIMS:
            res //= 2
    return out


class ConvBN(nn.Module):
    """The reference's Conv2d_BN with its BatchNorm folded into the conv:
    w' = w g / sqrt(var + eps), b' = beta - mean g / sqrt(var + eps)."""

    def __init__(self, cin: int, cout: int, k: int = 1, stride: int = 1,
                 groups: int = 1, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.c = Conv2d(cin, cout, k, stride=stride, padding=k // 2,
                        groups=groups, bias=True)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        bn = prefix + "bn."
        if bn + "weight" in state_dict:
            scale = state_dict.pop(bn + "weight") / torch.sqrt(
                state_dict.pop(bn + "running_var") + self.eps)
            w = state_dict[prefix + "c.weight"]
            state_dict[prefix + "c.weight"] = w * scale.reshape(-1, 1, 1, 1)
            state_dict[prefix + "c.bias"] = (
                state_dict.pop(bn + "bias")
                - state_dict.pop(bn + "running_mean") * scale)
            state_dict.pop(bn + "num_batches_tracked", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c(x)


def _halo_conv(x: torch.Tensor, band, out_band, pre, conv: ConvBN
               ) -> torch.Tensor:
    """Rows `out_band` of conv(pre(whole input)) from this rank's band `x`
    of the input (`band`): the input rows the convolution reads past the
    band brought from their owners (`Band.widen`), `pre` (row-wise) on
    them, then the convolution of those rows."""
    need = tuple(conv.c.rows_read(lo, hi, band.grid)
                 for lo, hi in out_band.bounds)
    x = pre(band.widen(x, need))
    return conv.c.forward_rows(x, need[band.shard.rank][0], band.grid,
                               out_band.lo, out_band.hi)


class PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.seq = nn.Sequential(ConvBN(3, dim // 2, 3, 2), nn.GELU(),
                                 ConvBN(dim // 2, dim, 3, 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.seq[2](gelu(self.seq[0](x)))

    def forward_rows(self, x: torch.Tensor, lo: int, hi: int
                     ) -> torch.Tensor:
        """Output rows [lo, hi) from the whole frame x: the two stride-2
        convolutions on the rows they read, no exchange."""
        c1, c2 = self.seq[0].c, self.seq[2].c
        h_mid = (x.shape[1] - 1) // 2 + 1
        a, b = c2.rows_read(lo, hi, h_mid)
        y = gelu(c1.forward_rows(x, 0, x.shape[1], a, b))
        return c2.forward_rows(y, a, h_mid, lo, hi)


class MBConv(nn.Module):
    def __init__(self, dim: int, expand_ratio: float = 4.0):
        super().__init__()
        hidden = int(dim * expand_ratio)
        self.conv1 = ConvBN(dim, hidden, 1)
        self.conv2 = ConvBN(hidden, hidden, 3, groups=hidden)
        self.conv3 = ConvBN(hidden, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = gelu(self.conv2(gelu(self.conv1(x))))
        return gelu(x + self.conv3(y))

    def forward_band(self, x: torch.Tensor, band) -> torch.Tensor:
        """The rows of `band` (a `parallel/spatial.Band`) from x, those
        rows of the input: the depthwise convolution's row on each side
        brought as rows of x (fewer channels than the expansion)."""
        y = gelu(_halo_conv(x, band, band, lambda t: gelu(self.conv1(t)),
                            self.conv2))
        return gelu(x + self.conv3(y))


class PatchMerging(nn.Module):
    def __init__(self, dim: int, out_dim: int):
        super().__init__()
        stride = 1 if out_dim in _STRIDE_ONE_DIMS else 2
        self.conv1 = ConvBN(dim, out_dim, 1)
        self.conv2 = ConvBN(out_dim, out_dim, 3, stride, groups=out_dim)
        self.conv3 = ConvBN(out_dim, out_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv3(gelu(self.conv2(gelu(self.conv1(x)))))

    def forward_band(self, x: torch.Tensor, band, out_band) -> torch.Tensor:
        """The rows of `out_band` of the merged map from x, the rows of
        `band` of the input: the rows the strided depthwise convolution
        reads past the band (one above at stride 2, one on each side at
        stride 1) brought as rows of x."""
        y = _halo_conv(x, band, out_band, lambda t: gelu(self.conv1(t)),
                       self.conv2)
        return self.conv3(gelu(y))


class TinyAttention(nn.Module):
    """Attention over the tokens of one window with a bias table over the
    symmetric offsets (key dim = value dim = dim / heads)."""

    def __init__(self, dim: int, num_heads: int, window: int):
        super().__init__()
        self.num_heads = num_heads
        self.key_dim = dim // num_heads
        self.norm = LayerNorm(dim)
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        self.attention_biases = nn.Parameter(
            torch.zeros(num_heads, window * window))
        self.register_buffer(
            "attention_bias_idxs",
            torch.from_numpy(attention_bias_idxs(window, window)),
            persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        nh, kd = self.num_heads, self.key_dim
        qkv = self.qkv(self.norm(x)).reshape(b, n, nh, 3 * kd)
        q, k, v = qkv.permute(0, 2, 1, 3).split(kd, dim=-1)
        bias = self.attention_biases[:, self.attention_bias_idxs]
        attn = (q * kd ** -0.5) @ k.transpose(-1, -2)
        attn = torch.softmax((attn + bias.to(attn.dtype)).float(), dim=-1)
        out = attn.to(v.dtype) @ v
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.norm = LayerNorm(dim)
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(self.norm(x))))


class TinyViTBlock(nn.Module):
    """Window attention -> depthwise local conv (its output replaces x) ->
    MLP, on a (B, H, W, C) grid; windows of `window` tokens a side, the
    grid zero-padded to a multiple of it."""

    def __init__(self, dim: int, num_heads: int, window: int,
                 mlp_ratio: float = 4.0, local_conv_size: int = 3):
        super().__init__()
        self.window = window
        self.attn = TinyAttention(dim, num_heads, window)
        self.local_conv = ConvBN(dim, dim, local_conv_size, groups=dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.local_conv(x + self._windows(x))
        return x + self.mlp(x)

    def _windows(self, x: torch.Tensor, top: int = 0,
                 rows: Optional[int] = None) -> torch.Tensor:
        """The attention of x's windows (x starts at a window boundary;
        zero-padded past its end and right edge), rows [top, top + rows)
        of it."""
        b, h, w, c = x.shape
        ws = self.window
        hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
        xp = F.pad(x, (0, 0, 0, wp - w, 0, hp - h))
        win = xp.reshape(b, hp // ws, ws, wp // ws, ws, c).permute(
            0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)
        y = self.attn(win).reshape(b, hp // ws, wp // ws, ws, ws, c)
        y = y.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)
        return y[:, top:top + (h if rows is None else rows), :w]

    def forward_band(self, x: torch.Tensor, band) -> torch.Tensor:
        """The rows of `band` (a `parallel/spatial.Band`) from x, those
        rows of the input: the rows of the windows the band touches
        brought from their owners (the zero pad only past the grid's
        end, as in the whole map), then the local convolution's row on
        each side of x + attention."""
        need = band.windows(self.window)
        top = band.lo - need[band.shard.rank][0]
        y = self._windows(band.widen(x, need), top, band.hi - band.lo)
        x = _halo_conv(x + y, band, band, lambda t: t, self.local_conv)
        return x + self.mlp(x)


class Layer(nn.Module):
    """One stage: its blocks, then the merge into the next stage."""

    def __init__(self, blocks: List[nn.Module], downsample=None):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x)
        return x if self.downsample is None else self.downsample(x)

    def forward_band(self, x: torch.Tensor, band, out_band) -> torch.Tensor:
        """This stage on the rows of `band`; the rows of `out_band` (the
        next stage's band) of its output."""
        for blk in self.blocks:
            x = blk.forward_band(x, band)
        return x if self.downsample is None else \
            self.downsample.forward_band(x, band, out_band)


class TinyViT(nn.Module):
    """(B, img_size, img_size, 3) normalized -> (B, img/16, img/16, 256):
    a drop-in for `ImageEncoderViT` in `Sam`."""

    patch_size = 16                      # the effective output stride

    def __init__(self, img_size: int = 1024,
                 embed_dims: Sequence[int] = EMBED_DIMS,
                 depths: Sequence[int] = DEPTHS,
                 num_heads: Sequence[int] = NUM_HEADS,
                 window_sizes: Sequence[int] = WINDOW_SIZES,
                 mlp_ratio: float = 4.0, mbconv_expand_ratio: float = 4.0,
                 local_conv_size: int = 3, out_chans: int = 256):
        super().__init__()
        self.img_size = img_size
        self.depth = sum(depths)
        self.embed_dim = embed_dims[-1]
        self.patch_embed = PatchEmbed(embed_dims[0])
        windows = stage_windows(img_size, embed_dims, window_sizes)
        # Each stage's resolution over the final grid's.
        strides = [1 if d in _STRIDE_ONE_DIMS else 2 for d in embed_dims[1:]]
        self.stage_factors = [int(np.prod(strides[s:]))
                              for s in range(len(embed_dims))]
        layers = []
        for s, dim in enumerate(embed_dims):
            if s == 0:
                blocks = [MBConv(dim, mbconv_expand_ratio)
                          for _ in range(depths[0])]
            else:
                blocks = [TinyViTBlock(dim, num_heads[s], windows[s],
                                       mlp_ratio, local_conv_size)
                          for _ in range(depths[s])]
            down = (PatchMerging(dim, embed_dims[s + 1])
                    if s + 1 < len(embed_dims) else None)
            layers.append(Layer(blocks, down))
        self.layers = nn.ModuleList(layers)
        self.neck = nn.Sequential(
            Conv2d(embed_dims[-1], out_chans, 1, bias=False),
            ChannelLayerNorm(out_chans),
            Conv2d(out_chans, out_chans, 3, padding=1, bias=False),
            ChannelLayerNorm(out_chans),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(x)
        for layer in self.layers:
            x = layer(x)
        return self.neck(x)

    def forward_band(self, x: torch.Tensor, band) -> torch.Tensor:
        """One rank's share of the spatial axis: x (B, img_size, img_size,
        3), the whole normalized frame; `band` (`parallel/spatial.Band`)
        this rank's rows of the final grid, each stage's band that band
        at the stage's resolution.  Returns the whole (B, img/16, img/16,
        256) features, the same on every rank of the axis."""
        bands = [band.scaled(f) for f in self.stage_factors] + [band]
        x = self.patch_embed.forward_rows(x, bands[0].lo, bands[0].hi)
        for s, layer in enumerate(self.layers):
            x = layer.forward_band(x, bands[s], bands[s + 1])
        x = band.gather(self.neck[1](self.neck[0](x)))
        return self.neck[3](self.neck[2](x))


def tiny_vit_shapes(img_size: int) -> Tuple[Tuple[str, Tuple[int, int]], ...]:
    """(JAX leaf path, shape) of every attention bias table at `img_size`:
    the only leaves of the TinyViT tree whose shape follows the image."""
    windows = stage_windows(img_size)
    return tuple((f"layers_{s}_blocks_{i}/attn/attention_biases",
                  (NUM_HEADS[s], windows[s] ** 2))
                 for s in range(1, len(DEPTHS)) for i in range(DEPTHS[s]))
