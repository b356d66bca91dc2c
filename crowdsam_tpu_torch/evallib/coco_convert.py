"""Format converters: odgt -> COCO json, detection results -> COCO json.

Behavioural contracts: reference `tools/crowdhuman2coco.py` (odgt records to
COCO images/annotations/categories with fbox/vbox/hbox selection, ignore
passthrough, optional shuffle with seed 42) and `tools/batch_eval.py:31-58`
(`convert_to_coco`: merged per-image detection dicts -> COCO json with image
ids re-keyed to file-name stems, xyxy -> xywh in place).

This package's own copy of the JAX package's `evallib/coco_convert.py`.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List

import numpy as np


def read_odgt(path: str) -> List[dict]:
    with open(path) as f:
        lines = f.readlines()
    if len(lines) == 1:
        records = json.loads(lines[0])
        if isinstance(records, dict):
            records = [records]
    else:
        records = [json.loads(line.strip()) for line in lines]
    return records


def crowdhuman2coco(
    odgt_path: str,
    json_path: str,
    image_dir: str,
    visible: bool = False,
    full: bool = True,
    tag: str = "person",
    shuffle: bool = False,
    max_images: int = 10**9,
) -> Dict[str, Any]:
    """odgt -> COCO dict (and dump to json_path if given)."""
    import cv2

    records = read_odgt(odgt_path)
    ids = np.arange(len(records))
    if shuffle:
        np.random.seed(42)
        ids = ids[np.random.choice(len(ids), len(ids), replace=False)]

    out = {"images": [], "annotations": [], "categories": []}
    categories: Dict[str, int] = {}
    bbox_id = 1
    for image_id, item_id in enumerate(ids):
        rec = records[int(item_id)]
        file_name = rec["ID"] + ".jpg"
        im = cv2.imread(os.path.join(image_dir, file_name), 0)
        assert im is not None, f"missing image {file_name}"
        out["images"].append(
            {"file_name": file_name, "height": im.shape[0],
             "width": im.shape[1], "id": int(image_id)}
        )
        for inst in rec.get("gtboxes", []):
            cat = inst["tag"]
            if cat not in categories:
                categories[cat] = len(categories) + 1
            if not (cat == tag or tag == "both"):
                continue
            ann: Dict[str, Any] = {"category_id": categories[cat]}
            extra = inst.get("extra", {})
            if full:
                ann["bbox"] = inst["fbox"]
            if visible:
                box = inst["vbox"]
                ann["bbox"] = box[0] if isinstance(box[0], list) else box
            ann["image_id"] = int(image_id)
            ann["iscrowd"] = False
            ann["area"] = ann["bbox"][2] * ann["bbox"][3]
            ann["id"] = bbox_id
            ann["ignore"] = extra.get("ignore", 0)
            bbox_id += 1
            out["annotations"].append(ann)
        if image_id == max_images - 1:
            break
    for cat, cid in categories.items():
        out["categories"].append({"supercategory": cat, "id": cid, "name": cat})
    if json_path:
        with open(json_path, "w") as f:
            json.dump(out, f)
    return out


def convert_to_coco(det_result: List[dict], gt_js: Dict[str, Any]) -> Dict[str, Any]:
    """Merged detection dicts -> COCO-style json (reference batch_eval.py:31-58).

    Quirks preserved: gt image ids are re-keyed to file-name stems (mutating
    the passed gt dict's image items), and detections are matched to images
    positionally (k-th result dict <-> k-th gt image)."""
    id_ = 0
    annotations = []
    category_id = 1
    image_items = gt_js["images"]
    for img_item in image_items:
        img_item["id"] = img_item["file_name"][:-4]
    for k, item in enumerate(det_result):
        image_id = image_items[k]["id"] if image_items else item["image_id"]
        for score, box in zip(item["scores"], item["boxes"]):
            box = list(box)
            area = (box[3] - box[1]) * (box[2] - box[0])
            box[2] = box[2] - box[0]
            box[3] = box[3] - box[1]
            annotations.append(
                {"category_id": category_id, "bbox": box, "image_id": image_id,
                 "iscrowd": False, "area": area, "id": id_, "score": score}
            )
            id_ += 1
    return {"images": image_items, "annotations": annotations,
            "categories": gt_js.get("categories", [])}
