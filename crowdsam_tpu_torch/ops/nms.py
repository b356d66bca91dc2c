"""Greedy box NMS as a fixed-size keep mask.

Counterpart of the JAX package's `ops/nms.py` (torchvision semantics, no
torchvision needed): boxes are visited in descending score order -- a stable
sort, so tied scores keep their index order -- and a box is dropped iff its
IoU with an earlier kept box is strictly greater than the threshold.  Entries
with valid=False are never kept and never suppress.

The order and the IoU matrix are computed on the boxes' device; the greedy
sweep, which is sequential, runs on the host over the valid prefix only.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from crowdsam_tpu_torch.ops.boxes import box_iou


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
             valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, 4), (N,) -> (N,) bool keep mask."""
    n = boxes.shape[0]
    dev = boxes.device
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=dev)
    key = torch.where(valid, scores.float(),
                      torch.tensor(float("-inf"), device=dev))
    order = torch.argsort(-key, stable=True)
    head = order[valid[order]]          # the valid entries, in sweep order
    n_valid = head.shape[0]
    over = (box_iou(boxes[head].float(), boxes[head].float())
            > iou_threshold).cpu().numpy()
    keep_sorted = np.ones(n_valid, dtype=bool)
    for i in range(1, n_valid):
        if np.any(over[i, :i] & keep_sorted[:i]):
            keep_sorted[i] = False
    keep = torch.zeros((n,), dtype=torch.bool, device=dev)
    keep[head] = torch.as_tensor(keep_sorted, device=dev)
    return keep


def batched_nms_mask(boxes: torch.Tensor, scores: torch.Tensor,
                     categories: torch.Tensor, iou_threshold: float,
                     valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Category-aware NMS through the torchvision coordinate offset."""
    if boxes.shape[0] == 0:
        return torch.zeros((0,), dtype=torch.bool, device=boxes.device)
    finite = torch.where(torch.isfinite(boxes), boxes, 0.0)
    offsets = categories.float() * (finite.max() + 1.0)
    return nms_mask(boxes + offsets[:, None], scores, iou_threshold, valid)


def nms_indices(boxes, scores, categories, iou_threshold) -> np.ndarray:
    """Kept indices in descending score order (torchvision batched_nms)."""
    keep = batched_nms_mask(boxes, scores, categories, iou_threshold)
    keep = keep.cpu().numpy()
    s = scores.cpu().numpy()
    idx = np.nonzero(keep)[0]
    return idx[np.argsort(-s[idx], kind="stable")]
