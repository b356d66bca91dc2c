"""HQ-SAM mask decoder with the PWD-Net heads (the `sam_hq` arch).

Counterpart of the JAX package's `models/mask_decoder_hq.py`: the SAM
tokens and an HQ output token (`hf_token`) whose hypernetwork (`hf_mlp`)
reads an HQ feature map, the upscaled embedding passed through
`embedding_maskfeature` plus the per-image fusion of the embedding
(`embedding_encoder`) and the first global block's ViT feature
(`compress_vit_feat`, `compute_hq_features`, hoisted out of the per-prompt
path by the predictor).  The PWD-Net heads pool the RAW DINO map at 256^2
under the SAM masks' softmax and project afterwards (the reverse order of
the base decoder).  Multimask output is SAM masks 1-3; single-mask output
adds the HQ mask onto mask 0.  The torch reference's state-dict keys (5
hypernetwork MLPs, the 5th unused as in the reference).

Plain PyTorch and K1 (its LayerNorms on CUDA): the HQ arch takes the
unfused decode, so the decode kernels K5 and K6 do not run here.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from crowdsam_tpu_torch.models.common import (
    ChannelLayerNorm,
    Conv2d,
    ConvTranspose2x2,
    Linear,
    MLP,
    gelu,
)
from crowdsam_tpu_torch.models.transformer import TwoWayTransformer


class MaskDecoderHQ(nn.Module):
    def __init__(self, transformer_dim: int = 256,
                 num_multimask_outputs: int = 3, iou_head_depth: int = 3,
                 iou_head_hidden_dim: int = 256, n_class: int = 1,
                 vit_dim: int = 1024, dino_dim: int = 1024):
        super().__init__()
        d = transformer_dim
        self.transformer_dim = d
        self.n_class = n_class
        self.num_sam_tokens = num_multimask_outputs + 1      # 4
        self.num_mask_tokens = self.num_sam_tokens + 1       # + the HQ token
        self.iou_token = nn.Embedding(1, d)
        self.mask_tokens = nn.Embedding(self.num_sam_tokens, d)
        self.hf_token = nn.Embedding(1, d)
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
            MLP(d, d, d // 8, 3) for _ in range(self.num_mask_tokens))
        self.hf_mlp = MLP(d, d, d // 8, 3)
        self.iou_prediction_head = MLP(d, iou_head_hidden_dim,
                                       self.num_sam_tokens, iou_head_depth)
        self.compress_vit_feat = nn.Sequential(
            ConvTranspose2x2(vit_dim, d),
            ChannelLayerNorm(d),
            nn.GELU(),
            ConvTranspose2x2(d, d // 8),
        )
        self.embedding_encoder = nn.Sequential(
            ConvTranspose2x2(d, d // 4),
            ChannelLayerNorm(d // 4),
            nn.GELU(),
            ConvTranspose2x2(d // 4, d // 8),
        )
        self.embedding_maskfeature = nn.Sequential(
            Conv2d(d // 8, d // 4, 3, padding=1),
            ChannelLayerNorm(d // 4),
            nn.GELU(),
            Conv2d(d // 4, d // 8, 3, padding=1),
        )
        self.dino_proj = Linear(dino_dim, d)
        self.parallel_iou_head = MLP(2 * d, iou_head_hidden_dim, 1,
                                     iou_head_depth)
        self.point_classifier = MLP(d, iou_head_hidden_dim, n_class, 2)

    def project_dino(self, dino_feats: torch.Tensor) -> torch.Tensor:
        """(..., dino_dim) -> (..., transformer_dim): the FG map's path."""
        return self.dino_proj(dino_feats)

    def classify_points(self, feats: torch.Tensor) -> torch.Tensor:
        return self.point_classifier(feats)

    @staticmethod
    def _stack(seq: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
        """up, LayerNorm, GELU, up (the fusion stacks)."""
        return seq[3](gelu(seq[1](seq[0](x))))

    def compute_hq_features(self, image_embeddings: torch.Tensor,
                            interm_embeddings: torch.Tensor) -> torch.Tensor:
        """The per-image HQ feature map: image_embeddings (1, h, w, C) and
        the first global block's output (1, h, w, vit_dim) -> (1, 4h, 4w,
        C/8)."""
        return (self._stack(self.embedding_encoder, image_embeddings)
                + self._stack(self.compress_vit_feat, interm_embeddings))

    def forward(self, image_embeddings: torch.Tensor, image_pe: torch.Tensor,
                sparse_prompt_embeddings: torch.Tensor,
                dense_prompt_embeddings: torch.Tensor,
                multimask_output: bool, hq_features: torch.Tensor = None,
                dino_feats_256: torch.Tensor = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """image_embeddings (1, h, w, C); image_pe (h, w, C); sparse (P, N,
        C); dense (P, h, w, C); hq_features (1, 4h, 4w, C/8); dino_feats_256
        (4h, 4w, dino_dim), the raw DINO map.  Returns (masks (P, K, 4h,
        4w), iou_pred (P, K), cls_scores (P, K, n_class)) in float32, K = 3
        with multimask_output (SAM masks 1-3) else 1."""
        p = sparse_prompt_embeddings.shape[0]
        d = self.transformer_dim
        dtype = self.dino_proj.weight.dtype
        ns = self.num_sam_tokens
        out_tokens = torch.cat([self.iou_token.weight,
                                self.mask_tokens.weight,
                                self.hf_token.weight], dim=0)
        tokens = torch.cat(
            [out_tokens[None].expand(p, -1, -1),
             sparse_prompt_embeddings.to(out_tokens.dtype)], dim=1)
        h, w = image_embeddings.shape[1], image_embeddings.shape[2]
        src = (image_embeddings + dense_prompt_embeddings).reshape(p, h * w, -1)
        pos_src = image_pe.reshape(1, h * w, -1).expand(p, -1, -1)
        hs, src = self.transformer(src.to(dtype), pos_src.to(dtype),
                                   tokens.to(dtype))
        iou_token_out = hs[:, 0, :]
        mask_tokens_out = hs[:, 1:1 + self.num_mask_tokens, :]

        up = self.output_upscaling
        up_sam = gelu(up[1](up[0](src.reshape(p, h, w, d))))
        up_sam = gelu(up[3](up_sam))                       # (P, 4h, 4w, d/8)
        mf = self._stack(self.embedding_maskfeature, up_sam)
        up_hq = mf + hq_features.to(mf.dtype)
        hyper = [self.output_hypernetworks_mlps[i](mask_tokens_out[:, i, :])
                 for i in range(ns)]
        hyper.append(self.hf_mlp(mask_tokens_out[:, ns, :]))
        hyper_in = torch.stack(hyper, dim=1)               # (P, 5, d/8)
        hh, ww = up_sam.shape[1], up_sam.shape[2]
        masks_sam = hyper_in[:, :ns] @ up_sam.reshape(p, hh * ww, -1
                                                      ).transpose(1, 2)
        masks_hq = hyper_in[:, ns:] @ up_hq.reshape(p, hh * ww, -1
                                                    ).transpose(1, 2)
        masks = torch.cat([masks_sam, masks_hq], dim=1).reshape(
            p, self.num_mask_tokens, hh, ww)

        iou_pred = self.iou_prediction_head(iou_token_out)
        weight = torch.softmax(masks_sam.float(), dim=-1)
        pooled = weight.to(dtype) @ dino_feats_256.reshape(hh * ww, -1).to(
            dtype)
        cls_scores = self.point_classifier(self.dino_proj(pooled))
        fused = torch.cat([iou_token_out[:, None, :].expand(p, ns, d),
                           mask_tokens_out[:, :ns]], dim=-1)
        iou_pred = iou_pred + self.parallel_iou_head(fused)[..., 0]
        if multimask_output:
            sl = slice(1, ns)
            out_masks = masks[:, sl]
        else:
            sl = slice(0, 1)
            out_masks = masks[:, 0:1] + masks[:, ns:]
        return (out_masks.float(), iou_pred[:, sl].float(),
                cls_scores[:, sl].float())
