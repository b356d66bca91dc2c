"""Sam: the image encoder, prompt encoder and mask decoder as one module,
plus the pixel normalization and mask post-processing.

Counterpart of the JAX package's `models/sam.py`, `forward_batched` (the
reference's list-of-records `forward`) included; the state-dict prefixes
are the torch reference's (`image_encoder.`, `prompt_encoder.`,
`mask_decoder.`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
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


@torch.no_grad()
def forward_batched(sam: Sam, batched_input, multimask_output: bool):
    """The list-of-records API of the reference's `Sam.forward`.

    Each record: 'image' (H, W, 3) already resized to the long side
    img_size, 'original_size' (h, w), and optionally 'point_coords' (B, N,
    2) with 'point_labels' (B, N), 'boxes' (B, 4), 'mask_inputs' (B, 256,
    256, 1).  Returns one {'masks', 'iou_predictions', 'low_res_logits'}
    per record, on the model's device.  `SamPredictor` is the path for
    repeated prompts on one image."""
    dev = next(sam.parameters()).device

    def arg(record, key, dtype):
        if key not in record:
            return None
        return torch.as_tensor(np.asarray(record[key]), dtype=dtype,
                               device=dev)

    outputs = []
    for record in batched_input:
        image = np.asarray(record["image"])
        x = preprocess(torch.as_tensor(image, device=dev)[None],
                       sam.img_size)
        embedding = sam.image_encoder(x)
        points = None
        if "point_coords" in record:
            points = (arg(record, "point_coords", torch.float32),
                      arg(record, "point_labels", torch.int64))
        sparse, dense = sam.prompt_encoder(
            points=points, boxes=arg(record, "boxes", torch.float32),
            masks=arg(record, "mask_inputs", torch.float32))
        low_res, iou_pred, _ = sam.mask_decoder(
            embedding, sam.prompt_encoder.get_dense_pe(), sparse, dense,
            multimask_output)
        masks = postprocess_masks(low_res, image.shape[:2],
                                  tuple(record["original_size"]),
                                  sam.img_size)
        outputs.append({"masks": masks > sam.mask_threshold,
                        "iou_predictions": iou_pred,
                        "low_res_logits": low_res})
    return outputs


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
