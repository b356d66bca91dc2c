"""The few-shot training sets: (RGB uint8 image, normalized xyxy boxes).

Counterpart of the JAX package's `train/dataset.py`.  `CrowdHumanDataset`
reads COCO-format annotations and JPEGs (PIL imported when an image is
read); `ArrayDataset` holds frames already in memory, for machines
without PIL (`utils/fixtures.ten_shot_arrays`).
"""

from __future__ import annotations

import json
import os
from typing import List, Sequence, Tuple

import numpy as np


def _normalized_xyxy(xywh, h: int, w: int) -> np.ndarray:
    boxes = np.asarray(xywh, dtype=np.float64).reshape(-1, 4)
    boxes = boxes / np.array([w, h, w, h])
    boxes[:, 2:] = boxes[:, :2] + boxes[:, 2:]
    return boxes


class CrowdHumanDataset:
    def __init__(self, dataset_root: str, annot_path: str,
                 img_dir: str = "Images"):
        self.dataset_root = dataset_root
        with open(annot_path) as f:
            annots = json.load(f)
        images = annots["images"]
        self.image_ids = [img["id"] for img in images]
        self.boxes = {}
        for annot in annots["annotations"]:
            self.boxes.setdefault(int(annot["image_id"]), []).append(
                annot["bbox"])
        self.image_files = [os.path.join(dataset_root, img_dir,
                                         img["file_name"]) for img in images]

    def __len__(self) -> int:
        return len(self.image_files)

    def __getitem__(self, item: int) -> Tuple[np.ndarray, np.ndarray]:
        from PIL import Image

        img = np.array(Image.open(self.image_files[item]).convert("RGB"))
        h, w = img.shape[:2]
        return img, _normalized_xyxy(self.boxes[self.image_ids[item]], h, w)


class ArrayDataset:
    """In-memory frames with their xywh pixel boxes."""

    def __init__(self, images: Sequence[np.ndarray],
                 boxes_xywh: Sequence[Sequence]):
        self.images: List[np.ndarray] = list(images)
        self.boxes = list(boxes_xywh)

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, item: int) -> Tuple[np.ndarray, np.ndarray]:
        img = self.images[item]
        return img, _normalized_xyxy(self.boxes[item], *img.shape[:2])
