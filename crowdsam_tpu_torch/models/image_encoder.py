"""SAM image encoder: ViTDet-style ViT with window and global attention and
the decomposed relative-position bias.

Counterpart of the JAX package's `models/image_encoder.py` (ViT-L: embed
1024, depth 24, heads 16, window 14, global blocks (5, 11, 17, 23), neck to
256 channels).  NHWC throughout; the torch reference's state-dict keys.

Window blocks pad the normalized input to a multiple of the window BEFORE
the qkv projection, so pad tokens carry the qkv bias and take part as keys,
as in the reference.  Their attention runs through `window_attention` (K2);
global blocks through `flash_mha_decomposed_relpos` (K3).  The reference's
dense `add_decomposed_rel_pos` path is those wrappers' plain version
(`models/attention.relpos_attention_plain`).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from crowdsam_tpu_torch.models.attention import (
    flash_mha_decomposed_relpos,
    window_attention,
)
from crowdsam_tpu_torch.models.common import (
    ChannelLayerNorm,
    Conv2d,
    LayerNorm,
    Linear,
    MLPBlock,
)
from crowdsam_tpu_torch.ops.resize import linear_resize_matrix


def _rel_pos_table(rel_pos: torch.Tensor, size: int) -> torch.Tensor:
    """(L, d) table -> (size, size, d): T[i, j] = rel_pos[i - j + size - 1],
    the table linearly resized first when L != 2*size-1."""
    n = 2 * size - 1
    if rel_pos.shape[0] != n:
        m = torch.as_tensor(linear_resize_matrix(rel_pos.shape[0], n),
                            device=rel_pos.device)
        rel_pos = (m @ rel_pos.float()).to(rel_pos.dtype)
    idx = (torch.arange(size)[:, None] - torch.arange(size)[None, :]
           + (size - 1)).to(rel_pos.device)
    return rel_pos[idx]


class Attention(nn.Module):
    """Multi-head attention over a (B, H, W, C) token grid with the
    decomposed rel-pos bias; `window` > 0 selects the window form."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 input_size: Tuple[int, int] = (14, 14), window: int = 0):
        super().__init__()
        self.num_heads = num_heads
        self.window = window
        head_dim = dim // num_heads
        self.scale = head_dim ** -0.5
        self.qkv = Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1,
                                                  head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1,
                                                  head_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        ws = self.window
        if ws > 0:
            hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
            x = F.pad(x, (0, 0, 0, wp - w, 0, hp - h))
            qkv = self.qkv(x)
            out = self._attend(qkv, lambda t: window_attention(
                t, _rel_pos_table(self.rel_pos_h, ws),
                _rel_pos_table(self.rel_pos_w, ws),
                self.num_heads, self.scale, ws))
            out = out[:, :h, :w]
        else:
            qkv = self.qkv(x)
            out = self._attend(qkv, lambda t: self._global(t, h, w))
        return self.proj(out)

    @staticmethod
    def _attend(qkv, fn):
        """The kernels take bf16: on CUDA a float32 compute dtype goes
        through them in bf16 (the TPU kernels cast the same way)."""
        return fn(qkv.to(torch.bfloat16) if qkv.is_cuda else qkv).to(
            qkv.dtype)

    def _global(self, qkv: torch.Tensor, h: int, w: int) -> torch.Tensor:
        b, c = qkv.shape[0], qkv.shape[-1] // 3
        nh = self.num_heads
        qkv = qkv.reshape(b, h * w, 3, nh, c // nh).permute(2, 0, 3, 1, 4)
        out = flash_mha_decomposed_relpos(
            qkv[0], qkv[1], qkv[2], self.scale,
            _rel_pos_table(self.rel_pos_h, h),
            _rel_pos_table(self.rel_pos_w, w), (h, w))
        return out.transpose(1, 2).reshape(b, h, w, c)


class Block(nn.Module):
    """Pre-LN transformer block with window or global attention."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, window_size: int = 0,
                 input_size: Tuple[int, int] = (64, 64)):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-6)
        attn_size = (window_size, window_size) if window_size else input_size
        self.attn = Attention(dim, num_heads, qkv_bias, attn_size,
                              window=window_size)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, in_chans: int, dim: int):
        super().__init__()
        self.proj = Conv2d(in_chans, dim, patch, stride=patch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x)


class ImageEncoderViT(nn.Module):
    """(B, img_size, img_size, 3) normalized -> (B, img/16, img/16, 256)."""

    def __init__(self, img_size: int = 1024, patch_size: int = 16,
                 embed_dim: int = 1024, depth: int = 24, num_heads: int = 16,
                 mlp_ratio: float = 4.0, out_chans: int = 256,
                 qkv_bias: bool = True, window_size: int = 14,
                 global_attn_indexes: Tuple[int, ...] = (5, 11, 17, 23)):
        super().__init__()
        self.img_size = img_size
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.depth = depth
        grid = img_size // patch_size
        self.patch_embed = PatchEmbed(patch_size, 3, embed_dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid, grid, embed_dim))
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, qkv_bias,
                  window_size=0 if i in global_attn_indexes else window_size,
                  input_size=(grid, grid))
            for i in range(depth))
        self.neck = nn.Sequential(
            Conv2d(embed_dim, out_chans, 1, bias=False),
            ChannelLayerNorm(out_chans),
            Conv2d(out_chans, out_chans, 3, padding=1, bias=False),
            ChannelLayerNorm(out_chans),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(x)
        gh, gw = x.shape[1], x.shape[2]
        x = x + self.pos_embed[:, :gh, :gw].to(x.dtype)
        for blk in self.blocks:
            x = blk(x)
        return self.neck(x)
