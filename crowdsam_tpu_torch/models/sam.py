"""Sam: the image encoder, prompt encoder and mask decoder as one module,
plus the pixel normalization and mask post-processing.

Counterpart of the JAX package's `models/sam.py`; the state-dict prefixes
are the torch reference's (`image_encoder.`, `prompt_encoder.`,
`mask_decoder.`).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from crowdsam_tpu_torch.models.image_encoder import ImageEncoderViT
from crowdsam_tpu_torch.models.mask_decoder import MaskDecoder
from crowdsam_tpu_torch.models.prompt_encoder import PromptEncoder
from crowdsam_tpu_torch.ops.resize import resize_linear

PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)
MASK_THRESHOLD = 0.0
IMAGE_FORMAT = "RGB"


class Sam(nn.Module):
    mask_threshold = MASK_THRESHOLD
    image_format = IMAGE_FORMAT

    def __init__(self, image_encoder: ImageEncoderViT,
                 prompt_encoder: PromptEncoder, mask_decoder: MaskDecoder):
        super().__init__()
        self.image_encoder = image_encoder
        self.prompt_encoder = prompt_encoder
        self.mask_decoder = mask_decoder

    @property
    def img_size(self) -> int:
        return self.image_encoder.img_size


def preprocess(x: torch.Tensor, img_size: int = 1024) -> torch.Tensor:
    """(B, H, W, 3) pixels -> normalized, bottom-right zero-padded
    (B, img_size, img_size, 3) float32."""
    mean = torch.tensor(PIXEL_MEAN, device=x.device)
    std = torch.tensor(PIXEL_STD, device=x.device)
    x = (x.float() - mean) / std
    h, w = x.shape[1], x.shape[2]
    return F.pad(x, (0, 0, 0, img_size - w, 0, img_size - h))


def postprocess_masks(masks: torch.Tensor, input_size: Tuple[int, int],
                      original_size: Tuple[int, int],
                      img_size: int = 1024) -> torch.Tensor:
    """(..., 256, 256) logits -> (..., *original_size) logits: linear
    upscale to img_size, crop the pad, linear resize to the original."""
    x = resize_linear(masks, (img_size, img_size), axes=(-2, -1))
    x = x[..., : input_size[0], : input_size[1]]
    return resize_linear(x, tuple(original_size), axes=(-2, -1))
