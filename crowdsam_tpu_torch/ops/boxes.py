"""Box geometry on tensors (counterpart of the JAX package's `ops/boxes.py`)."""

from __future__ import annotations

from typing import Sequence

import torch


def _as_f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """(N, 4), (M, 4) xyxy -> (N, M) IoU with 1e-6 in the denominator."""
    area1, area2 = box_area(boxes1), box_area(boxes2)
    lt = torch.maximum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = torch.minimum(boxes1[:, None, 2:], boxes2[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[:, None] + area2[None, :] - inter
    return inter / (union + 1e-6)


def uncrop_boxes_xyxy(boxes: torch.Tensor, crop_box: Sequence,
                      downscale=1.0) -> torch.Tensor:
    """boxes / downscale + the crop's (x0, y0) offset."""
    crop = _as_f32(crop_box, boxes.device)
    offset = torch.stack([crop[0], crop[1], crop[0], crop[1]])
    return boxes / downscale + offset


def uncrop_points(points: torch.Tensor, crop_box: Sequence,
                  downscale=1.0) -> torch.Tensor:
    """points / downscale + the crop's (x0, y0) offset."""
    crop = _as_f32(crop_box, points.device)
    return points / downscale + crop[:2]


def box_xyxy_to_xywh(boxes: torch.Tensor) -> torch.Tensor:
    x0, y0, x1, y1 = boxes.unbind(-1)
    return torch.stack([x0, y0, x1 - x0, y1 - y0], dim=-1)


def is_box_near_crop_edge(boxes: torch.Tensor, crop_box: Sequence,
                          orig_box: Sequence, downscale=1.0,
                          atol: float = 20.0) -> torch.Tensor:
    """Near a crop edge but not near the image edge, after uncropping."""
    crop = _as_f32(crop_box, boxes.device)
    orig = _as_f32(orig_box, boxes.device)
    b = uncrop_boxes_xyxy(boxes.float(), crop, downscale)
    near_crop = torch.abs(b - crop[None, :]) <= atol
    near_image = torch.abs(b - orig[None, :]) <= atol
    return torch.any(near_crop & ~near_image, dim=1)
