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

With `rect_encode` (`tpu.rect_encode`, a documented deviation of the JAX
package, PARITY.md #9) a non-square input is uploaded in 64 px buckets and
encoded on its valid band only: SAM on the band with the positional
embedding's matching crop, its (1, gh, gw, 256) features zero-padded back
to the square grid; DINOv2 on the square frame's linear resize cut to the
band's patch rows and columns, its positional embedding interpolated to the
square grid and cropped, its tokens zero-padded back.  The HQ decoder
refuses it with a warning and encodes square, as the JAX package does.

`trainfree_sim` is the train-free branch's foreground map: DINOv2 on the
frame stretched to its square input and ImageNet-normalized, the cosine of
its patch tokens against a reference feature.

`encode_batch` is the batched pipeline's encode (the JAX package's
`parallel/eval_shard.encode_b`): B square frames, each masked by its valid
size, through SAM and DINOv2 at once, then each image's DINO projection at
256^2 and its foreground logits.  It always encodes the square frame, as
the JAX batched path does, whatever `rect_encode` says.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from crowdsam_tpu_torch.config import resolve_device
from crowdsam_tpu_torch.models.dinov2 import DinoVisionTransformer
from crowdsam_tpu_torch.models.mask_decoder_hq import MaskDecoderHQ
from crowdsam_tpu_torch.models.sam import (
    PIXEL_MEAN,
    PIXEL_STD,
    Sam,
    postprocess_masks,
)
from crowdsam_tpu_torch.ops.resize import resize_linear, resize_linear_band
from crowdsam_tpu_torch.ops.transforms import ResizeLongestSide
from crowdsam_tpu_torch.parallel.spatial import dino_band, sam_band


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@torch.no_grad()
def imagenet_tokens(dino: DinoVisionTransformer,
                    image_sq: np.ndarray) -> torch.Tensor:
    """DINOv2's patch tokens (g, g, C) float32 of a square HWC uint8 frame
    (side g * patch), ImageNet-normalized (not SAM's normalization, which
    the encode's DINOv2 sees), on the device of `dino`."""
    dev = dino.pos_embed.device
    g = image_sq.shape[0] // dino.patch_size
    x = torch.from_numpy(np.ascontiguousarray(image_sq)).to(dev).float()
    x = (x / 255.0 - torch.tensor(IMAGENET_MEAN, device=dev)) / torch.tensor(
        IMAGENET_STD, device=dev)
    return dino(x[None])["x_norm_patchtokens"].reshape(g, g, -1).float()


def cosine_map(tokens: torch.Tensor, ref_feature: torch.Tensor
               ) -> torch.Tensor:
    """(g, g) cosine of each token (g, g, C) against `ref_feature` (C,),
    both L2-normalized with eps 1e-6."""
    f = tokens / torch.linalg.vector_norm(tokens, dim=-1,
                                          keepdim=True).clamp(min=1e-6)
    r = ref_feature.to(tokens.device).float()
    return f @ (r / torch.linalg.vector_norm(r).clamp(min=1e-6))


class SamPredictor:
    def __init__(self, sam_model: Sam,
                 dino_model: Optional[DinoVisionTransformer] = None,
                 device=None, rect_encode: bool = False, logger=None):
        """Runs on `device`: CUDA unless the caller names another; the
        models are moved there.  `rect_encode`: encode a non-square input's
        valid band only (not with the HQ decoder: a warning, then square)."""
        self.device = resolve_device(device)
        self.model = sam_model.to(self.device).eval()
        self.dino_model = (dino_model.to(self.device).eval()
                           if dino_model is not None else None)
        self.is_hq = isinstance(sam_model.mask_decoder, MaskDecoderHQ)
        if rect_encode and self.is_hq:
            (logger or logging.getLogger("crowdsam_tpu_torch")).warning(
                "tpu.rect_encode is not supported with the HQ decoder "
                "(interm-feature fusion assumes the square frame) -- "
                "falling back to square encode")
            rect_encode = False
        self.rect_encode = rect_encode
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
        dino_proj_256.  Under `rect_encode` a bucket short of the square
        frame is encoded as its band; features and DINOv2 tokens come back
        zero-padded to the square grids."""
        s = self.model.img_size
        hb, wb = bucket_img.shape[1], bucket_img.shape[2]
        mean = torch.tensor(PIXEL_MEAN, device=self.device)
        std = torch.tensor(PIXEL_STD, device=self.device)
        x = (bucket_img.float() - mean) / std
        inside = torch.zeros((hb, wb), dtype=torch.float32, device=self.device)
        inside[: input_hw[0], : input_hw[1]] = 1.0
        x = x * inside[None, :, :, None]
        rect = self.rect_encode and (hb, wb) != (s, s)
        if not rect:
            x = F.pad(x, (0, 0, 0, s - wb, 0, s - hb))
        dec = self.model.mask_decoder
        out = {"dense_pe": self.model.prompt_encoder.get_dense_pe()}
        if self.is_hq:
            out["features"], interm = self.model.image_encoder(
                x, return_interm=True)
            out["hq_features"] = dec.compute_hq_features(out["features"],
                                                         interm)
        else:
            out["features"] = self.model.image_encoder(x)
        if rect:
            g = s // self.model.image_encoder.patch_size
            f = out["features"]
            out["features"] = F.pad(f, (0, 0, 0, g - f.shape[2],
                                        0, g - f.shape[1]))
        if self.dino_model is not None:
            d, g = self.dino_input, self.dino_grid
            if rect:
                # The square frame's resize cut to the patch rows and
                # columns the band reaches (exact: the rest of the frame
                # is zero), with the square grid's positional embeddings.
                p = self.dino_model.patch_size
                gh_d = min(-(-int(np.ceil(hb * d / s)) // p), g)
                gw_d = min(-(-int(np.ceil(wb * d / s)) // p), g)
                x_dino = resize_linear_band(x, s, d, (gh_d * p, gw_d * p))
                dino = self.dino_model(x_dino, pos_hw=(g, g))[
                    "x_norm_patchtokens"].reshape(1, gh_d, gw_d, -1)
                dino_feats = F.pad(dino, (0, 0, 0, g - gw_d, 0, g - gh_d))
            else:
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

    @torch.no_grad()
    def encode_batch(self, frames: torch.Tensor, input_hw,
                     spatial=None) -> dict:
        """frames (B, S, S, 3) pixels in the square SAM frame, input_hw (B,
        2) each image's valid size.  Returns features (B, g, g, 256),
        dense_pe (g, g, 256), dino_feats (B, 73, 73, C), dino_proj_256 (B,
        256, 256, 256) bf16 and fg_logits (B, n_class, 256, 256): per image
        what `encode` and `predict_fg_map` give for it.  Not for the HQ
        decoder (the JAX batched path fails on it too).  `spatial`: the
        `Shard` of a spatial axis, whose every rank calls this on the same
        frames; each computes its band of both encoders
        (`parallel/spatial.py`) and gets the whole result."""
        if self.is_hq or self.dino_model is None:
            raise NotImplementedError(
                "encode_batch: the crowdsam, sam and mobile_sam archs only")
        s = self.model.img_size
        n = frames.shape[0]
        mean = torch.tensor(PIXEL_MEAN, device=self.device)
        std = torch.tensor(PIXEL_STD, device=self.device)
        x = (frames.float() - mean) / std
        hw = torch.as_tensor(np.asarray(input_hw).reshape(n, 2),
                             device=self.device)
        ar = torch.arange(s, device=self.device)
        inside = ((ar[None, :, None] < hw[:, 0, None, None])
                  & (ar[None, None, :] < hw[:, 1, None, None])).float()
        x = x * inside[..., None]
        dec, enc = self.model.mask_decoder, self.model.image_encoder
        d, g, r = self.dino_input, self.dino_grid, self.low_res
        x_dino = resize_linear(x, (d, d))
        out = {"dense_pe": self.model.prompt_encoder.get_dense_pe()}
        if spatial is None:
            out["features"] = enc(x)
            dino = self.dino_model(x_dino)
        else:
            out["features"] = enc.forward_band(x, sam_band(enc, spatial))
            dino = self.dino_model.forward_band(x_dino, dino_band(g, spatial))
        dino = dino["x_norm_patchtokens"]
        out["dino_feats"] = dino.reshape(n, g, g, -1)
        proj = dec.project_dino(out["dino_feats"])
        out["dino_proj_256"] = torch.stack(
            [resize_linear(proj[i], (r, r)) for i in range(n)]).to(
                torch.bfloat16)
        out["fg_logits"] = torch.cat([self._fg_logits(out["dino_feats"][i:i + 1])
                                      for i in range(n)])
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
        """Upload bucket of an (h, w) input: rounded up to 256 px, or to 64
        px (4 patch rows) under `rect_encode`, so that the band encode
        tracks the valid region."""
        s = self.model.img_size
        gran = 64 if self.rect_encode else 256
        return (min(-(-h // gran) * gran, s), min(-(-w // gran) * gran, s))

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
    def trainfree_sim(self, image_sq: np.ndarray,
                      ref_feature: torch.Tensor) -> torch.Tensor:
        """The train-free foreground map (dino_grid, dino_grid) float32 of
        `image_sq`, the frame stretched to (dino_input, dino_input) uint8:
        `cosine_map(imagenet_tokens(...), ref_feature)`."""
        if self.dino_model is None:
            raise RuntimeError("the train-free map needs DINOv2")
        return cosine_map(imagenet_tokens(self.dino_model, image_sq),
                          ref_feature)

    @torch.no_grad()
    def predict_fg_map(self) -> torch.Tensor:
        """(1, n_class, 256, 256) float32 FG logits (256^2 whatever the
        model size, as in the JAX package)."""
        if not self.is_image_set or self.dino_feats is None:
            raise RuntimeError("set an image (with DINOv2) first")
        return self._fg_logits(self.dino_feats)

    def _fg_logits(self, dino_feats: torch.Tensor) -> torch.Tensor:
        """(1, n_class, 256, 256) FG logits of one image's DINO tokens."""
        dec = self.model.mask_decoder
        logits = dec.classify_points(dec.project_dino(dino_feats))
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
