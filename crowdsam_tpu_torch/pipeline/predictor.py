"""SamPredictor: the dual-backbone image encode and prompt-driven decode.

Counterpart of the JAX package's `pipeline/predictor.py` for the square
encode: the image is normalized, its pad zeroed after normalization and
padded to the square SAM frame; SAM ViT encodes it; the same SAM-normalized
frame (a reference quirk) is resized linearly to 1022^2 for DINOv2; the
PWD-Net projection of the DINO tokens is resized to 256^2 once per image,
stored in bf16 as the JAX package stores it.  With the HQ decoder (the
`sam_hq` arch) the encode also keeps the first global block's output and
computes the per-image HQ feature map from it, and keeps the RAW DINO map
at 256^2 instead of its projection (the HQ decoder pools, then projects).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from crowdsam_tpu_torch.config import resolve_device
from crowdsam_tpu_torch.models.dinov2 import DinoVisionTransformer
from crowdsam_tpu_torch.models.mask_decoder_hq import MaskDecoderHQ
from crowdsam_tpu_torch.models.sam import (
    PIXEL_MEAN,
    PIXEL_STD,
    Sam,
    postprocess_masks,
)
from crowdsam_tpu_torch.ops.resize import resize_linear
from crowdsam_tpu_torch.ops.transforms import ResizeLongestSide


class SamPredictor:
    def __init__(self, sam_model: Sam,
                 dino_model: Optional[DinoVisionTransformer] = None,
                 device=None):
        """Runs on `device`: CUDA unless the caller names another; the
        models are moved there."""
        self.device = resolve_device(device)
        self.model = sam_model.to(self.device).eval()
        self.dino_model = (dino_model.to(self.device).eval()
                           if dino_model is not None else None)
        self.is_hq = isinstance(sam_model.mask_decoder, MaskDecoderHQ)
        self.transform = ResizeLongestSide(sam_model.img_size)
        self.low_res = sam_model.img_size // 4
        self.dino_grid = sam_model.img_size // 14
        self.dino_input = self.dino_grid * 14
        self.reset_image()

    # ------------------------------------------------------------- encode
    @torch.no_grad()
    def encode(self, bucket_img: torch.Tensor, input_hw) -> dict:
        """bucket_img: (1, hb, wb, 3) pixels, hb, wb <= img_size; input_hw:
        the valid (h, w).  Returns the per-image cache: features (1, g, g,
        256), dense_pe (g, g, 256), dino_feats (1, 73, 73, C) and
        dino_proj_256 (256, 256, 256) bf16; with the HQ decoder hq_features
        (1, 256, 256, 32) and dino_raw_256 (256, 256, C) bf16 in place of
        dino_proj_256."""
        s = self.model.img_size
        hb, wb = bucket_img.shape[1], bucket_img.shape[2]
        mean = torch.tensor(PIXEL_MEAN, device=self.device)
        std = torch.tensor(PIXEL_STD, device=self.device)
        x = (bucket_img.float() - mean) / std
        inside = torch.zeros((hb, wb), dtype=torch.float32, device=self.device)
        inside[: input_hw[0], : input_hw[1]] = 1.0
        x = x * inside[None, :, :, None]
        x = torch.nn.functional.pad(x, (0, 0, 0, s - wb, 0, s - hb))
        dec = self.model.mask_decoder
        out = {"dense_pe": self.model.prompt_encoder.get_dense_pe()}
        if self.is_hq:
            out["features"], interm = self.model.image_encoder(
                x, return_interm=True)
            out["hq_features"] = dec.compute_hq_features(out["features"],
                                                         interm)
        else:
            out["features"] = self.model.image_encoder(x)
        if self.dino_model is not None:
            d, g = self.dino_input, self.dino_grid
            x_dino = resize_linear(x, (d, d))
            dino = self.dino_model(x_dino)["x_norm_patchtokens"]
            dino_feats = dino.reshape(1, g, g, -1)
            out["dino_feats"] = dino_feats
            r = self.low_res
            if self.is_hq:
                out["dino_raw_256"] = resize_linear(dino_feats[0], (r, r)).to(
                    torch.bfloat16)
            else:
                proj = dec.project_dino(dino_feats)
                out["dino_proj_256"] = resize_linear(proj[0], (r, r)).to(
                    torch.bfloat16)
        return out

    def set_image(self, image: np.ndarray, image_format: str = "RGB") -> None:
        """image: HWC uint8."""
        if image_format not in ("RGB", "BGR"):
            raise ValueError(f"image_format {image_format!r}")
        if image_format != self.model.image_format:
            image = image[..., ::-1]
        original = tuple(image.shape[:2])
        self.set_image_presized(self.transform.apply_image(image))
        self.original_size = original

    def encode_bucket_hw(self, h: int, w: int) -> tuple:
        """Upload bucket of an (h, w) input: rounded up to 256 px."""
        s = self.model.img_size
        return (min(-(-h // 256) * 256, s), min(-(-w // 256) * 256, s))

    def set_image_presized(self, image: np.ndarray) -> None:
        """`image` is already resized (long side == img_size)."""
        self.original_size = tuple(image.shape[:2])
        self.input_size = tuple(image.shape[:2])
        hb, wb = self.encode_bucket_hw(*image.shape[:2])
        bucket = np.zeros((hb, wb, 3), dtype=image.dtype)
        bucket[: image.shape[0], : image.shape[1]] = image
        self._cache = self.encode(
            torch.from_numpy(bucket[None]).to(self.device), self.input_size)
        self.features = self._cache["features"]
        self.dino_feats = self._cache.get("dino_feats")
        self.is_image_set = True

    def reset_image(self) -> None:
        self.is_image_set = False
        self._cache = None
        self.features = None
        self.dino_feats = None
        self.original_size = None
        self.input_size = None

    # ------------------------------------------------------------- fg map
    @torch.no_grad()
    def predict_fg_map(self) -> torch.Tensor:
        """(1, n_class, 256, 256) float32 FG logits (256^2 whatever the
        model size, as in the JAX package)."""
        if not self.is_image_set or self.dino_feats is None:
            raise RuntimeError("set an image (with DINOv2) first")
        dec = self.model.mask_decoder
        logits = dec.classify_points(dec.project_dino(self.dino_feats))
        logits = resize_linear(logits, (256, 256))
        return logits.permute(0, 3, 1, 2)

    @torch.no_grad()
    def predict_fg_with_prototypes(self, prototypes) -> torch.Tensor:
        """(1, n_class, 256, 256) float32 FG map from class prototypes (the
        reference's multi-class variant): the cosine of the L2-normalized
        DINOv2 patch tokens against each class's mean prototype, resized
        linearly.  `prototypes`: (n_class, k, C) or (n_class, C)."""
        if not self.is_image_set or self.dino_feats is None:
            raise RuntimeError("set an image (with DINOv2) first")
        protos = torch.as_tensor(np.asarray(prototypes), device=self.device)
        if protos.ndim == 3:
            protos = protos.mean(dim=1)
        f = self.dino_feats
        f = f / torch.linalg.vector_norm(f, dim=-1, keepdim=True).clamp(
            min=1e-6)
        sim = torch.einsum("bhwc,nc->bnhw", f.float(), protos.float())
        return resize_linear(sim, (256, 256), axes=(-2, -1))

    # ------------------------------------------------------------- decode
    @torch.no_grad()
    def predict_batch(self, point_coords=None, point_labels=None, boxes=None,
                      mask_input=None, multimask_output: bool = True,
                      return_logits: bool = False,
                      return_full_masks: bool = True):
        """Prompts in the input frame: points (B, N, 2) / labels (B, N),
        boxes (B, 4), mask_input (B, 256, 256, 1).  Returns (masks at
        original_size, None without `return_full_masks`; iou_pred,
        cls_scores, low-res logits)."""
        if not self.is_image_set:
            raise RuntimeError("call set_image first")
        points = None
        if point_coords is not None:
            points = (point_coords.to(self.device),
                      point_labels.to(self.device))
        sparse, dense = self.model.prompt_encoder(
            points=points,
            boxes=boxes.to(self.device) if boxes is not None else None,
            masks=mask_input.to(self.device) if mask_input is not None
            else None)
        if self.is_hq:
            low_res, iou, cls = self.model.mask_decoder(
                self._cache["features"], self._cache["dense_pe"], sparse,
                dense, multimask_output,
                hq_features=self._cache["hq_features"],
                dino_feats_256=self._cache["dino_raw_256"])
        else:
            low_res, iou, cls = self.model.mask_decoder(
                self._cache["features"], self._cache["dense_pe"], sparse,
                dense, multimask_output,
                dino_feats_proj=self._cache.get("dino_proj_256"))
        if not return_full_masks:
            return None, iou, cls, low_res
        masks = postprocess_masks(low_res, self.input_size,
                                  self.original_size, self.model.img_size)
        if not return_logits:
            masks = masks > self.model.mask_threshold
        return masks, iou, cls, low_res

    def predict(self, point_coords: Optional[np.ndarray] = None,
                point_labels: Optional[np.ndarray] = None,
                box: Optional[np.ndarray] = None,
                mask_input: Optional[np.ndarray] = None,
                multimask_output: bool = True, return_logits: bool = False):
        """numpy single-prompt-set API -> (masks, iou, low-res, cls)."""
        coords = labels = boxes = masks_in = None
        if point_coords is not None:
            pc = self.transform.apply_coords(point_coords, self.original_size)
            coords = torch.as_tensor(pc, dtype=torch.float32)[None]
            labels = torch.as_tensor(point_labels, dtype=torch.int64)[None]
        if box is not None:
            boxes = torch.as_tensor(self.transform.apply_boxes(
                np.asarray(box).reshape(-1, 4), self.original_size),
                dtype=torch.float32)
        if mask_input is not None:
            m = torch.as_tensor(mask_input, dtype=torch.float32)
            masks_in = m.reshape(1, *m.shape[-2:], 1)
        masks, iou, cls, low_res = self.predict_batch(
            coords, labels, boxes, masks_in, multimask_output, return_logits)
        return (masks[0].cpu().numpy(), iou[0].cpu().numpy(),
                low_res[0].cpu().numpy(), cls[0].cpu().numpy())

    def get_image_embedding(self) -> torch.Tensor:
        return self._cache["features"]

    @property
    def dense_pe(self) -> torch.Tensor:
        return self._cache["dense_pe"]

    @property
    def dino_proj_256(self) -> Optional[torch.Tensor]:
        return self._cache.get("dino_proj_256")

    def decode_extras(self):
        """What the EPS engine's decode reads besides the embedding: the
        projected DINO map at 256^2, or for the HQ decoder {hq_features,
        dino_raw} (the JAX engine's dict)."""
        if self.is_hq:
            return {"hq_features": self._cache["hq_features"],
                    "dino_raw": self._cache["dino_raw_256"]}
        return self._cache.get("dino_proj_256")
