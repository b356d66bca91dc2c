"""DINOv2 ViT (ViT-L/14 on the main path; ViT-B/14 and ViT-S/14 too).

Counterpart of the JAX package's `models/dinov2.py`: patch 14, LayerScale,
LN eps 1e-6, a cls token and no register tokens; the pretrain 37x37
positional grid is bicubic-interpolated to the call grid (73x73 for the
1022^2 input).  facebookresearch/dinov2 state-dict keys.  Attention runs
through `flash_mha` (K4) over the 1 + 73^2 = 5330 tokens.  `forward_band`
is one rank's share of the spatial axis (`parallel/spatial.py`): a band of
patch rows (the cls token with the first), K and V of every token gathered
in each block, the normed tokens gathered at the end.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from crowdsam_tpu_torch.models.attention import flash_mha
from crowdsam_tpu_torch.models.common import Conv2d, LayerNorm, Linear, gelu
from crowdsam_tpu_torch.ops.resize import resize_bicubic_torch


class DinoAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, dim * 3)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor, band=None) -> torch.Tensor:
        """x: (B, n, C) tokens; with `band` (a rank of the spatial axis)
        tokens [band.lo, band.hi), whose queries attend over every band's
        keys."""
        b, n, c = x.shape
        nh, hd = self.num_heads, c // self.num_heads
        qkv = self.qkv(x)
        q = qkv[..., :c].reshape(b, n, nh, hd).transpose(1, 2)
        kv = qkv[..., c:] if band is None else band.gather(qkv[..., c:])
        nk = kv.shape[1]
        t = kv.reshape(b, nk, 2, nh, hd).permute(2, 0, 3, 1, 4)
        out = flash_mha(q, t[0], t[1], hd ** -0.5, valid_len=nk)
        return self.proj(out.transpose(1, 2).reshape(b, n, c).to(x.dtype))


class LayerScale(nn.Module):
    def __init__(self, dim: int, init: float = 1e-5):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), init))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


class DinoMlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))


class DinoBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 ls_init: float = 1e-5):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = DinoAttention(dim, num_heads)
        self.ls1 = LayerScale(dim, ls_init)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp = DinoMlp(dim, int(dim * mlp_ratio))
        self.ls2 = LayerScale(dim, ls_init)

    def forward(self, x: torch.Tensor, band=None) -> torch.Tensor:
        x = x + self.ls1(self.attn(self.norm1(x), band))
        return x + self.ls2(self.mlp(self.norm2(x)))


class DinoPatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = Conv2d(3, dim, patch, stride=patch)


class DinoVisionTransformer(nn.Module):
    def __init__(self, patch_size: int = 14, embed_dim: int = 1024,
                 depth: int = 24, num_heads: int = 16, mlp_ratio: float = 4.0,
                 pretrain_img_size: int = 518, ls_init: float = 1e-5):
        super().__init__()
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.depth = depth
        self.n_pre = pretrain_img_size // patch_size
        self.patch_embed = DinoPatchEmbed(patch_size, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, self.n_pre * self.n_pre + 1, embed_dim))
        self.blocks = nn.ModuleList(
            DinoBlock(embed_dim, num_heads, mlp_ratio, ls_init)
            for _ in range(depth))
        self.norm = LayerNorm(embed_dim, eps=1e-6)

    def forward(self, x: torch.Tensor,
                pos_hw=None) -> Dict[str, torch.Tensor]:
        """x: (B, H, W, 3) normalized NHWC, H and W multiples of the patch.
        `pos_hw`: the (H_pos, W_pos) grid the positional embedding is
        interpolated to before its top-left (gh, gw) crop is taken (the
        rect encode: a band of the square frame keeps the square call's
        per-position embeddings); the call grid when None.
        Returns {"x_norm_clstoken": (B, C), "x_norm_patchtokens": (B, N, C)}."""
        b, h, w, _ = x.shape
        gh, gw = h // self.patch_size, w // self.patch_size
        x = self._tokens(x, self._patch_pos(pos_hw or (gh, gw))[:, :gh, :gw],
                         cls=True)
        for blk in self.blocks:
            x = blk(x)
        x = self.norm(x)
        return {"x_norm_clstoken": x[:, 0], "x_norm_patchtokens": x[:, 1:]}

    def forward_band(self, x: torch.Tensor, band) -> Dict[str, torch.Tensor]:
        """One rank's share of the spatial axis: x (B, H, W, 3), the whole
        normalized input; `band` (`parallel/spatial.Band`) this rank's patch
        rows.  Returns `forward`'s dict, whole and the same on every rank
        of the axis (the gathers are exact)."""
        p = self.patch_size
        gh, gw = x.shape[1] // p, x.shape[2] // p
        x = self._tokens(x[:, band.lo * p:band.hi * p],
                         self._patch_pos((gh, gw))[:, band.lo:band.hi],
                         cls=band.lo == 0)
        tokens = band.with_cls(gw)
        for blk in self.blocks:
            x = blk(x, tokens)
        x = tokens.gather(self.norm(x))
        return {"x_norm_clstoken": x[:, 0], "x_norm_patchtokens": x[:, 1:]}

    def _patch_pos(self, pos_hw) -> torch.Tensor:
        """The (1, H_pos, W_pos, C) positional grid, the pretrain grid
        bicubic-interpolated to `pos_hw`."""
        c = self.embed_dim
        patch_pos = self.pos_embed[:, 1:].reshape(1, self.n_pre, self.n_pre, c)
        if tuple(pos_hw) != (self.n_pre, self.n_pre):
            patch_pos = resize_bicubic_torch(patch_pos, tuple(pos_hw))
        return patch_pos

    def _tokens(self, x: torch.Tensor, pos: torch.Tensor,
                cls: bool) -> torch.Tensor:
        """The patch tokens of x (B, H, W, 3) plus `pos` (1, H/p, W/p, C),
        after the cls token when `cls`."""
        b, c = x.shape[0], self.embed_dim
        x = self.patch_embed.proj(x).reshape(b, -1, c)
        x = x + pos.reshape(1, -1, c).to(x.dtype)
        if not cls:
            return x
        cls_tok = (self.cls_token + self.pos_embed[:, :1]).expand(b, 1, c)
        return torch.cat([cls_tok.to(x.dtype), x], dim=1)


def dinov2_vitl14() -> DinoVisionTransformer:
    return DinoVisionTransformer(14, 1024, 24, 16)


def dinov2_vitb14() -> DinoVisionTransformer:
    return DinoVisionTransformer(14, 768, 12, 12)


def dinov2_vits14() -> DinoVisionTransformer:
    return DinoVisionTransformer(14, 384, 12, 6)


dino_model_registry = {
    "dinov2_vitl14": dinov2_vitl14,
    "dinov2_vitb14": dinov2_vitb14,
    "dinov2_vits14": dinov2_vits14,
}

# The width of each arch's tokens (the adapter's `dino_dim`).
DINO_DIMS = {"dinov2_vitl14": 1024, "dinov2_vitb14": 768,
             "dinov2_vits14": 384}
