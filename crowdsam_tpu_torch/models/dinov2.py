"""DINOv2 ViT (ViT-L/14 on the main path; ViT-B/14 and ViT-S/14 too).

Counterpart of the JAX package's `models/dinov2.py`: patch 14, LayerScale,
LN eps 1e-6, a cls token and no register tokens; the pretrain 37x37
positional grid is bicubic-interpolated to the call grid (73x73 for the
1022^2 input).  facebookresearch/dinov2 state-dict keys.  Attention runs
through `flash_mha` (K4) over the 1 + 73^2 = 5330 tokens.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from crowdsam_tpu_torch.models.attention import (
    flash_mha,
    require_bf16_on_cuda,
)
from crowdsam_tpu_torch.models.common import Conv2d, LayerNorm, Linear, gelu
from crowdsam_tpu_torch.ops.resize import resize_bicubic_torch


class DinoAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, dim * 3)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        nh = self.num_heads
        qkv = self.qkv(x)
        require_bf16_on_cuda(qkv, "DINOv2 attention")
        t = qkv.reshape(b, n, 3, nh, c // nh).permute(2, 0, 3, 1, 4)
        out = flash_mha(t[0], t[1], t[2], (c // nh) ** -0.5, valid_len=n)
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.ls1(self.attn(self.norm1(x)))
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
        c = self.embed_dim
        x = self.patch_embed.proj(x).reshape(b, gh * gw, c)
        cls_pos = self.pos_embed[:, :1]
        patch_pos = self.pos_embed[:, 1:].reshape(1, self.n_pre, self.n_pre, c)
        ph, pw = pos_hw if pos_hw is not None else (gh, gw)
        if (ph, pw) != (self.n_pre, self.n_pre):
            patch_pos = resize_bicubic_torch(patch_pos, (ph, pw))
        patch_pos = patch_pos[:, :gh, :gw]
        x = x + patch_pos.reshape(1, gh * gw, c).to(x.dtype)
        cls = (self.cls_token + cls_pos).expand(b, 1, c)
        x = torch.cat([cls.to(x.dtype), x], dim=1)
        for blk in self.blocks:
            x = blk(x)
        x = self.norm(x)
        return {"x_norm_clstoken": x[:, 0], "x_norm_patchtokens": x[:, 1:]}


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
