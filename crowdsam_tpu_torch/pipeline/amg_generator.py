"""SamAutomaticMaskGenerator: uniform-grid whole-image mask generation.

Counterpart of the JAX package's `pipeline/amg_generator.py` (reference
`segment_anything_cs/automatic_mask_generator.py`, upstream SAM's AMG): a
point grid per crop, decoded in batches through `SamPredictor.predict_batch`
(the unfused decode), the pred-IoU and stability filters, the within-crop
and cross-crop NMS, the small-region cleanup, and records with
segmentation / area / bbox / predicted_iou / point_coords / stability_score
/ crop_box in the output modes binary_mask, uncompressed_rle and coco_rle.

The CS decoder returns 4 masks a point under multimask_output (the
reference's `mask_slice` is `slice(0, None)`), so each point gives 4
candidates.

Where the JAX package copies every full-resolution logit mask to the host
before it filters, this version filters on the predictor's device: the
pred-IoU filter before the upscale, the stability filter, the boxes and the
crop-edge filter after it; only the survivors' RLE change positions reach
the host.  The records are the same.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from crowdsam_tpu_torch.models.common import compute_dtype, float32_entry
from crowdsam_tpu_torch.models.sam import postprocess_masks
from crowdsam_tpu_torch.ops import rle as rle_ops
from crowdsam_tpu_torch.ops.amg import (
    MaskData,
    batch_iterator,
    batched_mask_to_box,
    build_all_layer_point_grids,
    calculate_stability_score,
    generate_crop_boxes,
    uncrop_masks,
)
from crowdsam_tpu_torch.ops.boxes import (
    box_area,
    box_xyxy_to_xywh,
    is_box_near_crop_edge,
    uncrop_boxes_xyxy,
    uncrop_points,
)
from crowdsam_tpu_torch.ops.connected import remove_small_regions
from crowdsam_tpu_torch.ops.nms import nms_indices
from crowdsam_tpu_torch.pipeline.predictor import SamPredictor


def _xywh_list(boxes) -> List[List[float]]:
    return box_xyxy_to_xywh(torch.as_tensor(
        np.asarray(boxes), dtype=torch.float64)).tolist()


class SamAutomaticMaskGenerator:
    def __init__(
        self,
        model,
        points_per_side: Optional[int] = 32,
        points_per_batch: int = 64,
        pred_iou_thresh: float = 0.88,
        stability_score_thresh: float = 0.95,
        stability_score_offset: float = 1.0,
        box_nms_thresh: float = 0.7,
        crop_n_layers: int = 0,
        crop_nms_thresh: float = 0.7,
        crop_overlap_ratio: float = 512 / 1500,
        crop_n_points_downscale_factor: int = 1,
        point_grids: Optional[List[np.ndarray]] = None,
        min_mask_region_area: int = 0,
        output_mode: str = "binary_mask",
        dino_model=None,
        device=None,
    ) -> None:
        """`model`: a `Sam`; `dino_model`: an optional DINOv2, which gives
        the decoder its class head.  Runs on `device`: CUDA unless the
        caller names another.  A float32 model runs in full float32 (the
        float32 arms of K1-K3 on the card; `generate` pins TF32 off)."""
        if (points_per_side is None) == (point_grids is None):
            raise ValueError("exactly one of points_per_side or point_grids "
                             "must be provided")
        if output_mode not in ("binary_mask", "uncompressed_rle",
                               "coco_rle"):
            raise ValueError(f"output_mode {output_mode!r}")
        if points_per_side is not None:
            self.point_grids = build_all_layer_point_grids(
                points_per_side, crop_n_layers,
                crop_n_points_downscale_factor)
        else:
            self.point_grids = point_grids
        self.compute_dtype = compute_dtype(model)
        self.predictor = SamPredictor(model, dino_model, device)
        self.points_per_batch = points_per_batch
        self.pred_iou_thresh = pred_iou_thresh
        self.stability_score_thresh = stability_score_thresh
        self.stability_score_offset = stability_score_offset
        self.box_nms_thresh = box_nms_thresh
        self.crop_n_layers = crop_n_layers
        self.crop_nms_thresh = crop_nms_thresh
        self.crop_overlap_ratio = crop_overlap_ratio
        self.crop_n_points_downscale_factor = crop_n_points_downscale_factor
        self.min_mask_region_area = min_mask_region_area
        self.output_mode = output_mode

    @torch.no_grad()
    @float32_entry(lambda self: self.compute_dtype)
    def generate(self, image: np.ndarray) -> List[Dict[str, Any]]:
        """HWC uint8 image -> one record per mask."""
        mask_data = self._generate_masks(image)
        if self.min_mask_region_area > 0:
            mask_data = self.postprocess_small_regions(
                mask_data, self.min_mask_region_area,
                max(self.box_nms_thresh, self.crop_nms_thresh),
                self.predictor.device)

        if self.output_mode == "coco_rle":
            segs = [rle_ops.coco_encode_rle(r) for r in mask_data["rles"]]
        elif self.output_mode == "binary_mask":
            segs = [rle_ops.rle_to_mask(r) for r in mask_data["rles"]]
        else:
            segs = mask_data["rles"]

        bboxes = _xywh_list(mask_data["boxes"])
        crop_boxes = _xywh_list(mask_data["crop_boxes"])
        return [{
            "segmentation": segs[i],
            "area": rle_ops.area_from_rle(mask_data["rles"][i]),
            "bbox": bboxes[i],
            "predicted_iou": float(mask_data["iou_preds"][i]),
            "point_coords": [mask_data["points"][i].tolist()],
            "stability_score": float(mask_data["stability_score"][i]),
            "crop_box": crop_boxes[i],
        } for i in range(len(segs))]

    def _generate_masks(self, image: np.ndarray) -> MaskData:
        orig_size = image.shape[:2]
        crop_boxes, layer_idxs = generate_crop_boxes(
            orig_size, self.crop_n_layers, self.crop_overlap_ratio)
        data = MaskData()
        for crop_box, layer_idx in zip(crop_boxes, layer_idxs):
            data.cat(self._process_crop(image, crop_box, layer_idx,
                                        orig_size))
        if len(crop_boxes) > 1:
            scores = 1 / box_area(torch.as_tensor(data["crop_boxes"],
                                                  dtype=torch.float32))
            keep = nms_indices(
                torch.as_tensor(data["boxes"], dtype=torch.float32), scores,
                torch.zeros(len(scores), dtype=torch.int64),
                self.crop_nms_thresh)
            data.filter(keep)
        return data

    def _process_crop(self, image, crop_box, crop_layer_idx,
                      orig_size) -> MaskData:
        x0, y0, x1, y1 = crop_box
        cropped_im = image[y0:y1, x0:x1, :]
        cropped_im_size = cropped_im.shape[:2]
        self.predictor.set_image(cropped_im)
        points_scale = np.array(cropped_im_size)[None, ::-1]
        points_for_image = self.point_grids[crop_layer_idx] * points_scale
        data = MaskData()
        for (points,) in batch_iterator(self.points_per_batch,
                                        points_for_image):
            data.cat(self._process_batch(points, cropped_im_size, crop_box,
                                         orig_size))
        self.predictor.reset_image()

        boxes = torch.as_tensor(data["boxes"], dtype=torch.float32)
        keep = nms_indices(
            boxes, torch.as_tensor(data["iou_preds"], dtype=torch.float32),
            torch.zeros(len(boxes), dtype=torch.int64), self.box_nms_thresh)
        data.filter(keep)
        data["boxes"] = uncrop_boxes_xyxy(
            torch.as_tensor(data["boxes"], dtype=torch.float32),
            crop_box).numpy()
        data["points"] = uncrop_points(
            torch.as_tensor(data["points"], dtype=torch.float32),
            crop_box).numpy()
        data["crop_boxes"] = np.asarray(
            [crop_box] * len(data["rles"]), dtype=np.int64).reshape(-1, 4)
        return data

    def _process_batch(self, points, im_size, crop_box,
                       orig_size) -> MaskData:
        """One batch of points, filtered on the device; the survivors'
        fields and RLEs on the host."""
        orig_h, orig_w = orig_size
        pred = self.predictor
        dev = pred.device
        transformed = pred.transform.apply_coords(points, im_size)
        in_points = torch.as_tensor(transformed, dtype=torch.float32,
                                    device=dev)
        in_labels = torch.ones((len(points), 1), dtype=torch.int64,
                               device=dev)
        _, iou_preds, _, low_res = pred.predict_batch(
            in_points[:, None, :], in_labels, multimask_output=True,
            return_full_masks=False)
        k = low_res.shape[1]
        iou_preds = iou_preds.reshape(-1)
        low_res = low_res.reshape(-1, *low_res.shape[-2:])
        keep = torch.arange(len(iou_preds), device=dev)
        if self.pred_iou_thresh > 0.0:
            keep = torch.nonzero(iou_preds > self.pred_iou_thresh).flatten()
        masks = postprocess_masks(low_res[keep], pred.input_size,
                                  pred.original_size, pred.model.img_size)
        stability = calculate_stability_score(
            masks, pred.model.mask_threshold, self.stability_score_offset)
        if self.stability_score_thresh > 0.0:
            sel = stability >= self.stability_score_thresh
            keep, masks, stability = keep[sel], masks[sel], stability[sel]
        masks = masks > pred.model.mask_threshold
        boxes = batched_mask_to_box(masks)
        sel = ~is_box_near_crop_edge(boxes, crop_box, [0, 0, orig_w, orig_h])
        if not bool(sel.all()):
            keep, masks, stability, boxes = (
                keep[sel], masks[sel], stability[sel], boxes[sel])
        masks = uncrop_masks(masks, crop_box, orig_h, orig_w)
        rows = keep.cpu().numpy()
        return MaskData(
            iou_preds=iou_preds[keep].cpu().numpy(),
            points=np.asarray(points).repeat(k, axis=0)[rows],
            stability_score=stability.cpu().numpy(),
            boxes=boxes.cpu().numpy(),
            rles=rle_ops.mask_to_rle(masks),
        )

    @staticmethod
    def postprocess_small_regions(mask_data: MaskData, min_area: int,
                                  nms_thresh: float,
                                  device=None) -> MaskData:
        """Fill small holes and drop small islands of every mask (on
        `device`, the CPU when None), then an NMS that prefers the masks the
        cleanup left unchanged; the kept changed masks take their new RLE
        and box."""
        if len(mask_data["rles"]) == 0:
            return mask_data
        masks = torch.from_numpy(np.stack(
            [rle_ops.rle_to_mask(r) for r in mask_data["rles"]])).to(device)
        m1, ch1 = remove_small_regions(masks, min_area, "holes")
        m2, ch2 = remove_small_regions(m1, min_area, "islands")
        changed = (ch1 | ch2).cpu().numpy()
        scores = (~changed).astype(np.float32)
        boxes = batched_mask_to_box(m2)
        keep = nms_indices(boxes.float(),
                           torch.as_tensor(scores, device=boxes.device),
                           torch.zeros(len(scores), dtype=torch.int64,
                                       device=boxes.device), nms_thresh)
        mask_data["boxes"] = np.array(mask_data["boxes"])
        redo = [int(i) for i in keep if scores[i] == 0.0]
        if redo:
            idx = torch.as_tensor(redo, device=m2.device)
            new_boxes = boxes[idx].cpu().numpy()
            for j, rle in enumerate(rle_ops.mask_to_rle(m2[idx])):
                mask_data["rles"][redo[j]] = rle
                mask_data["boxes"][redo[j]] = new_boxes[j]
        mask_data.filter(keep)
        return mask_data
