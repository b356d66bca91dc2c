"""Automatic-mask-generation math and the MaskData container.

Counterpart of the JAX package's `ops/amg.py`: stability score, mask->box,
crop boxes, and `MaskData` (row-wise filter/concat over numpy arrays,
tensors and lists).
"""

from __future__ import annotations

import math
from copy import deepcopy
from itertools import product
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

_MASKDATA_TYPES = (list, np.ndarray, torch.Tensor)


class MaskData:
    """Per-detection field store with row-wise filter/concat semantics."""

    def __init__(self, **kwargs) -> None:
        self._d: Dict[str, Any] = {}
        for k, v in kwargs.items():
            self[k] = v

    def __setitem__(self, key: str, item: Any) -> None:
        if not isinstance(item, _MASKDATA_TYPES):
            raise TypeError(f"MaskData field {key!r}: expected a list, "
                            f"numpy array or tensor, got "
                            f"{type(item).__name__}")
        self._d[key] = item

    def __delitem__(self, key: str) -> None:
        del self._d[key]

    def __getitem__(self, key: str) -> Any:
        return self._d[key]

    def __contains__(self, key: str) -> bool:
        return key in self._d

    def items(self):
        return self._d.items()

    def keys(self):
        return self._d.keys()

    def get(self, key: str, default: Any = None) -> Any:
        return self._d.get(key, default)

    def filter(self, keep) -> None:
        """Row-subset every field by a boolean mask or an index array."""
        keep = np.asarray(keep)
        for k, v in self._d.items():
            if isinstance(v, np.ndarray):
                self._d[k] = v[keep]
            elif isinstance(v, torch.Tensor):
                self._d[k] = v[torch.as_tensor(keep, device=v.device)]
            else:
                rows = np.flatnonzero(keep) if keep.dtype == np.bool_ else keep
                self._d[k] = [v[int(i)] for i in rows]

    def cat(self, other: "MaskData") -> None:
        """Row-append `other`'s fields (introducing absent keys)."""
        for k, v in other.items():
            cur = self._d.get(k)
            if cur is None:
                self._d[k] = deepcopy(v) if isinstance(v, list) else v
            elif isinstance(v, torch.Tensor):
                self._d[k] = torch.cat([cur, v], dim=0)
            elif isinstance(v, np.ndarray):
                self._d[k] = np.concatenate([cur, v], axis=0)
            else:
                self._d[k] = cur + deepcopy(v)

    def to_numpy(self) -> None:
        for k, v in self._d.items():
            if isinstance(v, torch.Tensor):
                self._d[k] = v.detach().cpu().numpy()


def calculate_stability_score(masks: torch.Tensor, mask_threshold: float,
                              threshold_offset: float) -> torch.Tensor:
    """IoU of the masks binarized at threshold +- offset, over the last two
    axes."""
    inter = (masks > (mask_threshold + threshold_offset)).sum(
        dim=(-1, -2), dtype=torch.int32)
    union = (masks > (mask_threshold - threshold_offset)).sum(
        dim=(-1, -2), dtype=torch.int32)
    return inter / union


def batched_mask_to_box(masks: torch.Tensor) -> torch.Tensor:
    """(..., H, W) bool -> (..., 4) xyxy int64 with inclusive right/bottom
    edges; [0, 0, 0, 0] for an empty mask."""
    shape = masks.shape
    h, w = shape[-2:]
    if masks.numel() == 0:
        return torch.zeros(shape[:-2] + (4,), dtype=torch.int64,
                           device=masks.device)
    flat = masks.reshape(-1, h, w)
    in_h = flat.any(dim=-1)
    hc = in_h * torch.arange(h, device=masks.device)[None, :]
    bottom = hc.max(dim=-1).values
    top = (hc + h * (~in_h)).min(dim=-1).values
    in_w = flat.any(dim=-2)
    wc = in_w * torch.arange(w, device=masks.device)[None, :]
    right = wc.max(dim=-1).values
    left = (wc + w * (~in_w)).min(dim=-1).values
    empty = (right < left) | (bottom < top)
    out = torch.stack([left, top, right, bottom], dim=-1) * (~empty)[..., None]
    return out.reshape(shape[:-2] + (4,))


def generate_crop_boxes(im_size: Tuple[int, ...], n_layers: int,
                        overlap_ratio: float
                        ) -> Tuple[List[List[int]], List[int]]:
    """Crop boxes per layer, xyxy; layer 0 is the whole image."""
    crop_boxes, layer_idxs = [], []
    im_h, im_w = int(im_size[0]), int(im_size[1])
    short_side = min(im_h, im_w)
    crop_boxes.append([0, 0, im_w, im_h])
    layer_idxs.append(0)

    def crop_len(orig_len, n_crops, overlap):
        return int(math.ceil((overlap * (n_crops - 1) + orig_len) / n_crops))

    for i_layer in range(n_layers):
        n_per_side = 2 ** (i_layer + 1)
        overlap = int(overlap_ratio * short_side * (2 / n_per_side))
        crop_w = crop_len(im_w, n_per_side, overlap)
        crop_h = crop_len(im_h, n_per_side, overlap)
        x0s = [int((crop_w - overlap) * i) for i in range(n_per_side)]
        y0s = [int((crop_h - overlap) * i) for i in range(n_per_side)]
        for x0, y0 in product(x0s, y0s):
            crop_boxes.append([x0, y0, min(x0 + crop_w, im_w),
                               min(y0 + crop_h, im_h)])
            layer_idxs.append(i_layer + 1)
    return crop_boxes, layer_idxs

