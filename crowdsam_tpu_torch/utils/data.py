"""Dataset registry + image/annotation loading helpers.

Behavioural contract: reference `crowdsam/utils.py:26-30` (data_meta) and
:370-390 (load_img_and_annotation), plus the greedy box matcher used for
visualization overlays (:482-524).  Counterpart of the JAX package's
`utils/data.py`.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from crowdsam_tpu_torch.coco_names import coco_classes

data_meta = {
    "crowdhuman": ["./datasets/crowdhuman", 1, {1: "person"}],
    "occhuman": ["./datasets/OCHuman", 1, {1: "person"}],
    "coco_occ": ["./datasets/coco", 80, coco_classes],
    "coco": ["./datasets/occ_coco", 80, coco_classes],
}

_IMG_SUBDIR = {
    "crowdhuman": "Images",
    "coco": "val2017",
    "coco_occ": "occ2017",
    "occhuman": "images",
    "mineapple": "images",
}


def load_img_and_annotation(dataset_path: str, annots: dict, dataset: str, id: int = 0):
    """-> (image RGB np.uint8, gt boxes xyxy, image_id)."""
    import cv2

    img_meta = annots["images"][id]
    if dataset not in _IMG_SUBDIR:
        raise NotImplementedError(dataset)
    fname = img_meta["file_name"]
    if dataset == "coco_occ":
        fname = fname.split("/")[-1]
    img_path = os.path.join(dataset_path, _IMG_SUBDIR[dataset], fname)
    image_cv = cv2.imread(img_path)
    image_cv = cv2.cvtColor(image_cv, cv2.COLOR_BGR2RGB)
    bboxes = np.array(
        [a["bbox"] for a in annots["annotations"] if a["image_id"] == img_meta["id"]]
    )
    if len(bboxes):
        bboxes[..., 2:] += bboxes[..., :2]
    return image_cv, bboxes, img_meta["id"]


def evaluate_boxes(
    pred_boxes: np.ndarray,
    pred_scores: np.ndarray,
    gt_boxes: np.ndarray,
    iou_thresh: float,
) -> Tuple[float, float, List[int], List[int]]:
    """Greedy per-image matching -> (precision, recall, FP_list, FN_list)
    for visualization (reference `crowdsam/utils.py:482-524`)."""
    pred_boxes = np.asarray(pred_boxes, dtype=np.float64).reshape(-1, 4)
    pred_scores = np.asarray(pred_scores, dtype=np.float64).reshape(-1)
    gt_boxes = np.asarray(gt_boxes, dtype=np.float64).reshape(-1, 4)
    if len(pred_boxes) == 0:
        return 0, 0, [], []
    order = np.argsort(-pred_scores, kind="stable")
    pb = pred_boxes[order]

    def iou_mat(a, b):
        if len(a) == 0 or len(b) == 0:
            return np.zeros((len(a), len(b)))
        lt = np.maximum(a[:, None, :2], b[None, :, :2])
        rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
        wh = np.clip(rb - lt, 0, None)
        inter = wh[..., 0] * wh[..., 1]
        aa = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
        ab = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
        return inter / (aa[:, None] + ab[None, :] - inter + 1e-9)

    iou = iou_mat(pb, gt_boxes)
    matched = np.zeros(len(gt_boxes), dtype=bool)
    prec, tp, fp = [], 0, 0
    fp_list: List[int] = []
    for i in range(iou.shape[0]):
        hit = False
        for j in range(iou.shape[1]):
            if iou[i, j] > iou_thresh and not matched[j]:
                matched[j] = True
                tp += 1
                prec.append(tp / (tp + fp))
                hit = True
                break
        if not hit:
            fp += 1
            fp_list.append(int(order[i]))
    if len(gt_boxes) > 0:
        precision = sum(prec) / len(gt_boxes) if prec else 0
        recall = tp / len(gt_boxes)
    else:
        precision = recall = 0
    fn_list = np.nonzero(~matched)[0].tolist()
    return precision, recall, fp_list, fn_list
