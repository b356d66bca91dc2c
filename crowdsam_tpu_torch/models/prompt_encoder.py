"""Prompt encoder: random-Fourier positional encoding plus learned point,
box and mask embeddings.

Counterpart of the JAX package's `models/prompt_encoder.py`, with the torch
reference's state-dict keys (`pe_layer.positional_encoding_gaussian_matrix`,
`point_embeddings.{0..3}`, `mask_downscaling.{0,1,3,4,6}`).  The embeddings
stay float32, as in the JAX package.  NHWC at the dense outputs.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn

from crowdsam_tpu_torch.models.common import ChannelLayerNorm, Conv2d, gelu


class PositionEmbeddingRandom(nn.Module):
    def __init__(self, num_pos_feats: int = 64):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.randn(2, num_pos_feats))

    def encode(self, coords: torch.Tensor) -> torch.Tensor:
        """[0, 1]-normalized coords (..., 2) -> (..., 2*num_pos_feats)."""
        coords = 2 * coords - 1
        coords = coords @ self.positional_encoding_gaussian_matrix.float()
        coords = 2 * math.pi * coords
        return torch.cat([torch.sin(coords), torch.cos(coords)], dim=-1)


class PromptEncoder(nn.Module):
    def __init__(self, embed_dim: int = 256,
                 image_embedding_size: Tuple[int, int] = (64, 64),
                 input_image_size: Tuple[int, int] = (1024, 1024),
                 mask_in_chans: int = 16):
        super().__init__()
        self.embed_dim = embed_dim
        self.image_embedding_size = image_embedding_size
        self.input_image_size = input_image_size
        self.pe_layer = PositionEmbeddingRandom(embed_dim // 2)
        self.point_embeddings = nn.ModuleList(
            nn.Embedding(1, embed_dim) for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, embed_dim)
        self.no_mask_embed = nn.Embedding(1, embed_dim)
        self.mask_downscaling = nn.Sequential(
            Conv2d(1, mask_in_chans // 4, 2, stride=2),
            ChannelLayerNorm(mask_in_chans // 4),
            nn.GELU(),
            Conv2d(mask_in_chans // 4, mask_in_chans, 2, stride=2),
            ChannelLayerNorm(mask_in_chans),
            nn.GELU(),
            Conv2d(mask_in_chans, embed_dim, 1),
        )
        # (w, h) of the input frame, a buffer so that it moves with the
        # module: a copy to the card on every prompt batch would be a host
        # sync in the decode loop, and a tensor cached outside the module
        # would keep whatever `torch.export` traced it as (a FakeTensor).
        self.register_buffer(
            "frame_wh", torch.tensor([input_image_size[1],
                                      input_image_size[0]],
                                     dtype=torch.float32), persistent=False)

    def _device(self) -> torch.device:
        return self.no_mask_embed.weight.device

    def pe_encoding(self, coords: torch.Tensor) -> torch.Tensor:
        """[0, 1]-normalized coords (..., 2) -> (..., embed_dim): the JAX
        package's `_pe_encoding`."""
        return self.pe_layer.encode(coords)

    def get_dense_pe(self) -> torch.Tensor:
        """(h, w, embed_dim) dense grid PE."""
        h, w = self.image_embedding_size
        dev = self._device()
        y = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
        x = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        gy, gx = torch.meshgrid(y, x, indexing="ij")
        return self.pe_layer.encode(torch.stack([gx, gy], dim=-1))

    def _embed_points(self, points: torch.Tensor, labels: torch.Tensor,
                      pad: bool) -> torch.Tensor:
        """(B, N, 2), (B, N) -> (B, N[+1], embed_dim); labels 1 positive,
        0 negative, -1 not-a-point."""
        points = points.float() + 0.5
        if pad:
            b = points.shape[0]
            points = torch.cat([points, points.new_zeros(b, 1, 2)], dim=1)
            labels = torch.cat([labels, -labels.new_ones(b, 1)], dim=1)
        pe = self.pe_layer.encode(points / self.frame_wh)
        lab = labels[..., None]
        zero = pe.new_zeros(())
        pe = torch.where(lab == -1, self.not_a_point_embed.weight[0], pe)
        pe = pe + torch.where(lab == 0, self.point_embeddings[0].weight[0],
                              zero)
        pe = pe + torch.where(lab == 1, self.point_embeddings[1].weight[0],
                              zero)
        return pe

    def _embed_boxes(self, boxes: torch.Tensor) -> torch.Tensor:
        """(B, 4) xyxy -> (B, 2, embed_dim) corner embeddings."""
        coords = (boxes.float() + 0.5).reshape(-1, 2, 2) / self.frame_wh
        pe = self.pe_layer.encode(coords)
        corner = torch.stack([self.point_embeddings[2].weight[0],
                              self.point_embeddings[3].weight[0]])
        return pe + corner

    def _embed_masks(self, masks: torch.Tensor) -> torch.Tensor:
        """(B, Hm, Wm, 1) -> (B, h, w, embed_dim)."""
        m = self.mask_downscaling
        x = gelu(m[1](m[0](masks)))
        x = gelu(m[4](m[3](x)))
        return m[6](x)

    def forward(self, points: Optional[Tuple[torch.Tensor, torch.Tensor]]
                = None, boxes: Optional[torch.Tensor] = None,
                masks: Optional[torch.Tensor] = None):
        """-> (sparse (B, N, embed_dim), dense (B, h, w, embed_dim))."""
        if points is not None:
            bs = points[0].shape[0]
        elif boxes is not None:
            bs = boxes.shape[0]
        elif masks is not None:
            bs = masks.shape[0]
        else:
            bs = 1
        parts = [torch.zeros((bs, 0, self.embed_dim), device=self._device())]
        if points is not None:
            parts.append(self._embed_points(points[0], points[1],
                                            pad=boxes is None))
        if boxes is not None:
            parts.append(self._embed_boxes(boxes))
        sparse = torch.cat(parts, dim=1)
        if masks is not None:
            dense = self._embed_masks(masks)
        else:
            h, w = self.image_embedding_size
            dense = self.no_mask_embed.weight.reshape(1, 1, 1, -1).expand(
                bs, h, w, self.embed_dim)
        return sparse, dense
