"""Mask decoder with the PWD-Net heads (the Crowd-SAM adapter).

Counterpart of the JAX package's `models/mask_decoder.py`: an iou token and
4 mask tokens, the two-way transformer, 2x2 transposed-conv upscaling
64 -> 256, 5 hypernetwork MLPs (the 5th unused, kept so the state-dict keys
match the reference checkpoint), the IoU head, and the PWD-Net heads
`dino_proj`, `parallel_iou_head` and `point_classifier`.  The projected DINO
map at 256^2 (`dino_feats_proj`) is computed once per image by the predictor
and passed in.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from crowdsam_tpu_torch.models.common import (
    ChannelLayerNorm,
    ConvTranspose2x2,
    Linear,
    MLP,
    gelu,
)
from crowdsam_tpu_torch.models.transformer import TwoWayTransformer


class MaskDecoder(nn.Module):
    def __init__(self, transformer_dim: int = 256,
                 num_multimask_outputs: int = 3, iou_head_depth: int = 3,
                 iou_head_hidden_dim: int = 256, n_class: int = 1,
                 dino_dim: int = 1024):
        super().__init__()
        d = transformer_dim
        self.transformer_dim = d
        self.n_class = n_class
        self.num_mask_tokens = num_multimask_outputs + 1
        self.iou_token = nn.Embedding(1, d)
        self.mask_tokens = nn.Embedding(self.num_mask_tokens, d)
        self.transformer = TwoWayTransformer(depth=2, embedding_dim=d,
                                             num_heads=8, mlp_dim=2048)
        self.output_upscaling = nn.Sequential(
            ConvTranspose2x2(d, d // 4),
            ChannelLayerNorm(d // 4),
            nn.GELU(),
            ConvTranspose2x2(d // 4, d // 8),
            nn.GELU(),
        )
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP(d, d, d // 8, 3) for _ in range(self.num_mask_tokens + 1))
        self.iou_prediction_head = MLP(d, iou_head_hidden_dim,
                                       self.num_mask_tokens, iou_head_depth)
        self.dino_proj = Linear(dino_dim, d)
        self.parallel_iou_head = MLP(2 * d, iou_head_hidden_dim, 1,
                                     iou_head_depth)
        self.point_classifier = MLP(d, iou_head_hidden_dim, n_class, 2)

    def project_dino(self, dino_feats: torch.Tensor) -> torch.Tensor:
        """(..., H, W, dino_dim) -> (..., H, W, transformer_dim)."""
        return self.dino_proj(dino_feats)

    def classify_points(self, feats: torch.Tensor) -> torch.Tensor:
        return self.point_classifier(feats)

    def forward(self, image_embeddings: torch.Tensor, image_pe: torch.Tensor,
                sparse_prompt_embeddings: torch.Tensor,
                dense_prompt_embeddings: torch.Tensor,
                multimask_output: bool,
                dino_feats_proj: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """image_embeddings (1, h, w, C); image_pe (h, w, C); sparse (P, N,
        C); dense (P, h, w, C); dino_feats_proj (4h, 4w, C).  Returns
        (masks (P, K, 4h, 4w), iou_pred (P, K), cls_scores (P, K, n_class))
        in float32, K = 4 with multimask_output else 1."""
        p = sparse_prompt_embeddings.shape[0]
        d = self.transformer_dim
        dtype = self.dino_proj.weight.dtype
        k_tok = self.num_mask_tokens
        out_tokens = torch.cat([self.iou_token.weight,
                                self.mask_tokens.weight], dim=0)
        tokens = torch.cat(
            [out_tokens[None].expand(p, -1, -1),
             sparse_prompt_embeddings.to(out_tokens.dtype)], dim=1)
        h, w = image_embeddings.shape[1], image_embeddings.shape[2]
        src = (image_embeddings + dense_prompt_embeddings).reshape(p, h * w, -1)
        pos_src = image_pe.reshape(1, h * w, -1).expand(p, -1, -1)
        hs, src = self.transformer(src.to(dtype), pos_src.to(dtype),
                                   tokens.to(dtype))
        iou_token_out = hs[:, 0, :]
        mask_tokens_out = hs[:, 1:1 + k_tok, :]

        up = self.output_upscaling
        y = gelu(up[1](up[0](src.reshape(p, h, w, d))))
        y = gelu(up[3](y))                                  # (P, 4h, 4w, d/8)
        hyper_in = torch.stack(
            [self.output_hypernetworks_mlps[i](mask_tokens_out[:, i, :])
             for i in range(k_tok)], dim=1)                 # (P, K, d/8)
        hh, ww = y.shape[1], y.shape[2]
        masks = (hyper_in @ y.reshape(p, hh * ww, -1).transpose(1, 2))
        masks = masks.reshape(p, k_tok, hh, ww)

        iou_pred = self.iou_prediction_head(iou_token_out)
        if dino_feats_proj is None:
            cls_scores = torch.zeros((p, k_tok, self.n_class),
                                     device=masks.device)
        else:
            weight = torch.softmax(masks.reshape(p, k_tok, hh * ww).float(),
                                   dim=-1)
            pooled = weight.to(dtype) @ dino_feats_proj.reshape(
                hh * ww, -1).to(dtype)
            cls_scores = self.point_classifier(pooled)
        fused = torch.cat([iou_token_out[:, None, :].expand(p, k_tok, d),
                           mask_tokens_out], dim=-1)
        iou_pred = iou_pred + self.parallel_iou_head(fused)[..., 0]
        sl = slice(0, None) if multimask_output else slice(0, 1)
        return (masks[:, sl].float(), iou_pred[:, sl].float(),
                cls_scores[:, sl].float())
