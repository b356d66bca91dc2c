"""Detection visualization (boxes, masks, FP/FN overlays).

Behavioural contract: reference `crowdsam/utils.py:71-102,322-368`
(visualize_result draws detections yellow, FPs red, FNs blue; masks decoded
from COCO RLEs, uncropped via rles_info).  Counterpart of the JAX package's
`utils/visualize.py`; cv2 is imported inside the functions."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from crowdsam_tpu_torch.ops.rle import coco_decode_rle


def draw_box(image, box, label=None, color=(255, 255, 0)):
    import cv2

    color = tuple(int(c) for c in color)
    if label is not None:
        cv2.putText(
            image, str(label), (int(box[0]), int(box[1])),
            cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 2,
        )
    cv2.rectangle(
        image, (int(box[0]), int(box[1])), (int(box[2]), int(box[3])), color
    )
    return image


def draw_mask(image, mask, random_color=False):
    import cv2

    mask = np.asarray(mask, dtype=np.int32)
    color = (
        np.random.random(3) * 255 if random_color else np.array([30, 144, 255])
    )
    h, w = mask.shape
    mask_image = (mask.reshape(h, w, 1) * color.reshape(1, 1, -1)).astype("uint8")
    return cv2.addWeighted(image, 1, mask_image, 0.5, 0)


def draw_point(image, point, color=(255, 0, 0)):
    import cv2

    return cv2.circle(image, (int(point[0]), int(point[1])), 2, color)


def _uncrop_mask_np(mask, crop_box, orig_h, orig_w):
    """Resize mask to the crop extent, then pad into the image frame
    (reference crowdsam/utils.py:193-203)."""
    import cv2

    x0, y0, x1, y1 = crop_box
    w, h = x1 - x0, y1 - y0
    m = cv2.resize(mask.astype(np.uint8), (w, h),
                   interpolation=cv2.INTER_NEAREST).astype(bool)
    out = np.zeros((orig_h, orig_w), dtype=bool)
    out[y0:y1, x0:x1] = m
    return out


def visualize_result(
    image,
    result: Dict,
    class_names: Dict[int, str],
    save_path: str,
    vis_masks: bool = True,
    conf_thresh: float = 0.001,
    FP_ind: Optional[List[int]] = None,
    FN_ind: Optional[List[int]] = None,
):
    import cv2

    image = np.array(image)
    image = cv2.cvtColor(image, cv2.COLOR_BGR2RGB)

    masks = None
    if vis_masks and len(result.get("rles", [])) and result["rles"][0] is not None:
        crop_box, (orig_h, orig_w) = result["rles_info"][0], result["rles_info"][1]
        masks = [
            _uncrop_mask_np(coco_decode_rle(r).astype(bool), crop_box, orig_h, orig_w)
            for r in result["rles"]
        ]

    for i in range(len(result["boxes"])):
        box = result["boxes"][i]
        score = round(float(result["scores"][i]), 3)
        class_id = int(result["categories"][i]) if "categories" in result else 0
        if score < conf_thresh:
            continue
        color = [0, 0, 255] if (FP_ind is not None and i in FP_ind) else [255, 255, 0]
        class_name = class_names.get(class_id + 1, str(class_id))
        image = draw_box(image, box, f"{class_name}:{score}", color=color)
        if masks is not None:
            image = draw_mask(image, masks[i], random_color=True)
    if FN_ind is not None and "gt_boxes" in result:
        for i in FN_ind:
            image = draw_box(image, result["gt_boxes"][i], color=[255, 0, 0])
    cv2.imwrite(save_path, image)
