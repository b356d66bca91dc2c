"""Two-way transformer: prompt tokens <-> image cross-attention.

Counterpart of the JAX package's `models/transformer.py` (2 blocks of token
self-attention, token->image attention, MLP 2048 and image->token attention,
then a final token->image attention and LayerNorm; the attention's internal
width halved).  Plain PyTorch, batched over the prompt axis: the unfused
decode (`tpu.fused_decode false`) and the predictor's prompts run it; the
fused decode runs the same weights through kernel K5
(`models/decode_tail_kernel.py`).  LayerNorms go through K1 on CUDA.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from crowdsam_tpu_torch.models.common import LayerNorm, Linear, MLPBlock


class Attention(nn.Module):
    def __init__(self, embedding_dim: int, num_heads: int,
                 downsample_rate: int = 1):
        super().__init__()
        internal = embedding_dim // downsample_rate
        self.num_heads = num_heads
        self.q_proj = Linear(embedding_dim, internal)
        self.k_proj = Linear(embedding_dim, internal)
        self.v_proj = Linear(embedding_dim, internal)
        self.out_proj = Linear(internal, embedding_dim)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        return x.reshape(b, n, self.num_heads, c // self.num_heads).transpose(
            1, 2)

    def forward(self, q, k, v, attn_sim: Optional[torch.Tensor] = None):
        q = self._split(self.q_proj(q))
        k = self._split(self.k_proj(k))
        v = self._split(self.v_proj(v))
        attn = (q @ k.transpose(-1, -2)) / (q.shape[-1] ** 0.5)
        attn = torch.softmax(attn.float(), dim=-1)
        if attn_sim is not None:
            attn = torch.softmax(attn + attn_sim.float(), dim=-1)
        out = attn.to(v.dtype) @ v
        b, h, n, c = out.shape
        return self.out_proj(out.transpose(1, 2).reshape(b, n, h * c))


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, embedding_dim: int, num_heads: int,
                 mlp_dim: int = 2048, attention_downsample_rate: int = 2,
                 skip_first_layer_pe: bool = False):
        super().__init__()
        self.self_attn = Attention(embedding_dim, num_heads)
        self.norm1 = LayerNorm(embedding_dim)
        self.cross_attn_token_to_image = Attention(
            embedding_dim, num_heads, attention_downsample_rate)
        self.norm2 = LayerNorm(embedding_dim)
        self.mlp = MLPBlock(embedding_dim, mlp_dim, act=F.relu)
        self.norm3 = LayerNorm(embedding_dim)
        self.norm4 = LayerNorm(embedding_dim)
        self.cross_attn_image_to_token = Attention(
            embedding_dim, num_heads, attention_downsample_rate)
        self.skip_first_layer_pe = skip_first_layer_pe

    def forward(self, queries, keys, query_pe, key_pe, attn_sim=None):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)

        q = queries + query_pe
        k = keys + key_pe
        queries = queries + self.cross_attn_token_to_image(
            q, k, keys, attn_sim=attn_sim)
        queries = self.norm2(queries)

        queries = self.norm3(queries + self.mlp(queries))

        q = queries + query_pe
        k = keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    """image_embedding (B, N_img, C) with its PE, point_embedding
    (B, N_tok, C) -> (processed tokens, processed image)."""

    def __init__(self, depth: int = 2, embedding_dim: int = 256,
                 num_heads: int = 8, mlp_dim: int = 2048,
                 attention_downsample_rate: int = 2):
        super().__init__()
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(embedding_dim, num_heads, mlp_dim,
                                 attention_downsample_rate,
                                 skip_first_layer_pe=(i == 0))
            for i in range(depth))
        self.final_attn_token_to_image = Attention(
            embedding_dim, num_heads, attention_downsample_rate)
        self.norm_final_attn = LayerNorm(embedding_dim)

    def forward(self, image_embedding, image_pe, point_embedding,
                attn_sim=None):
        queries, keys = point_embedding, image_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, image_pe,
                                  attn_sim)
        q = queries + point_embedding
        k = keys + image_pe
        queries = queries + self.final_attn_token_to_image(q, k, keys)
        return self.norm_final_attn(queries), keys
