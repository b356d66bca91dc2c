"""CrowdHuman evaluator: AP / Caltech log-average miss rate / Recall.

This package's own copy of the JAX package's `evallib/crowdhuman.py`,
quirks included (held equal to it by `tests/test_torch_evallib.py`).

Behavioural contract: reference `tools/crowdhuman_eval.py`:
- per-image greedy Caltech matching at IoU 0.5, score-descending, with
  ignore regions suppressing unmatched detections by IoA (:113-143);
- detections loaded from COCO-style json (boxes clipped to image bounds,
  :223-243), ground truth from COCO json (`ignore` field) or .odgt records
  (vbox when visible_flag, ignore via extra.ignore, :245-279);
- AP by trapezoidal integration over the global score-sorted PR curve
  (:503-548); MR as exp(mean(log(miss rate))) at Caltech fppi anchors
  (:452-501); `remove_empty_gt` actually drops images without detections
  (:376-378 — quirk preserved).

Pure numpy; no torch/torchvision/pycocotools dependency.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

PERSON_CLASSES = ["background", "person"]

CALTECH_REFS = {
    "CALTECH_-2": [0.0100, 0.0178, 0.03160, 0.0562, 0.1000, 0.1778, 0.3162,
                   0.5623, 1.000],
    "CALTECH_-4": [0.0001, 0.0003, 0.00100, 0.0032, 0.0100, 0.0316, 0.1000,
                   0.3162, 1.000],
}


def box_overlap(dboxes: np.ndarray, gboxes: np.ndarray, if_iou: bool) -> np.ndarray:
    """Pairwise IoU (if_iou) or IoA-over-detection matrix (reference :202-221)."""
    eps = 1e-6
    n, k = len(dboxes), len(gboxes)
    if n == 0 or k == 0:
        return np.zeros((n, k))
    iw = np.minimum(dboxes[:, None, 2], gboxes[None, :, 2]) - np.maximum(
        dboxes[:, None, 0], gboxes[None, :, 0]
    )
    ih = np.minimum(dboxes[:, None, 3], gboxes[None, :, 3]) - np.maximum(
        dboxes[:, None, 1], gboxes[None, :, 1]
    )
    inter = np.maximum(0, iw) * np.maximum(0, ih)
    darea = (dboxes[:, None, 2] - dboxes[:, None, 0]) * (
        dboxes[:, None, 3] - dboxes[:, None, 1]
    )
    if if_iou:
        garea = (gboxes[None, :, 2] - gboxes[None, :, 0]) * (
            gboxes[None, :, 3] - gboxes[None, :, 1]
        )
        return inter / (darea + garea - inter + eps)
    return inter / (darea + eps)


class ImageEval:
    """Per-image det/gt record (reference `Image`, :15-111).

    mode=0: body boxes (vbox/fbox).  mode=1: head boxes (hbox).  mode=2:
    joint body+head — gt rows are [body xyxy, head xyxy, tag] where tag=1
    iff neither box is ignored (reference :89-96), dt rows are
    [body xyxy, head xyxy, score], matched by `compare_caltech_union`.

    NOTE (documented deviation): the reference *ships* modes 1/2 broken —
    `load_gt_boxes` has the head-box rows commented out (reference
    :245-279, `head_bbox` stays an empty list, so mode 1/2 loading raises
    TypeError) and `Database.compare` never dispatches to
    `compare_caltech_union` (:436-446).  We implement the evidently
    intended semantics (the upstream CrowdHuman benchmark tool this file
    derives from): head rows loaded from `hbox` with `head_attr.ignore`,
    and mode 2 matched with the Caltech-union strategy (:145-200).
    """

    def __init__(self, mode: int = 0):
        assert mode in (0, 1, 2)
        self.mode = mode
        self.ID = None
        self.width: Optional[float] = None
        self.height: Optional[float] = None
        self.gtboxes: Optional[np.ndarray] = None  # (N, 5) xyxy + tag(1/-1)
        self.dtboxes: Optional[np.ndarray] = None  # (M, 5) xyxy + score
        self.ign_num = 0
        self.gt_num = 0

    # ---- loading ----------------------------------------------------------
    def load_cocojson_gt(self, img_item: dict, annots: List[dict]):
        self.ID = img_item["id"]
        self.width = img_item.get("width")
        self.height = img_item.get("height")
        boxes = np.array([a["bbox"] for a in annots], dtype=np.float64).reshape(-1, 4)
        if len(boxes):
            boxes[:, 2:4] += boxes[:, :2]
        if annots and "ignore" in annots[0]:
            ignore = np.array([a["ignore"] for a in annots], dtype=np.float64)
            tag = np.where(ignore == 1, -1.0, 1.0)
        else:
            tag = np.ones(len(boxes))
        self.gtboxes = np.concatenate([boxes, tag[:, None]], axis=1)
        self.gt_num = len(boxes)
        self.ign_num = int((tag == -1).sum())

    def load_cocojson_dt(self, annots: List[dict]):
        if self.mode == 1:
            # Head-box mode: silently scoring body boxes against head GT
            # would look plausible but be wrong — require the field like
            # the mode-2 branch does.
            assert annots == [] or "hbox" in annots[0], (
                "mode 1 (head-box eval) needs an 'hbox' field on each "
                "detection; refusing to fall back to the body 'bbox'")
            key = "hbox"
        else:
            key = "bbox"
        boxes = np.array([a[key] for a in annots], dtype=np.float64).reshape(-1, 4)
        if len(boxes):
            boxes[:, 2:4] += boxes[:, :2]
        if annots and "score" in annots[0]:
            scores = np.array([a["score"] for a in annots], dtype=np.float64)
        else:
            scores = np.ones(len(boxes))
        if self.mode == 2:
            # Joint rows [body4, head4, score] (reference :106-108 loads
            # body via body_key and head+score via head_key); COCO-format
            # detections carry the head box in an `hbox` field.
            assert annots == [] or "hbox" in annots[0], (
                "mode 2 needs an 'hbox' field on each detection")
            hboxes = np.array(
                [a["hbox"] for a in annots], dtype=np.float64
            ).reshape(-1, 4)
            if len(hboxes):
                hboxes[:, 2:4] += hboxes[:, :2]
            self.dtboxes = np.concatenate(
                [boxes, hboxes, scores[:, None]], axis=1)
        else:
            self.dtboxes = np.concatenate([boxes, scores[:, None]], axis=1)
        self.clip_boxes()

    def load_odgt_gt(self, record: dict, visible_flag: bool = True):
        self.ID = record["ID"]
        self.width = record.get("width")
        self.height = record.get("height")
        rows, head_rows = [], []
        for rb in record.get("gtboxes", []):
            # Body/head tags per reference :252-266: unknown class -> both
            # -1; extra.ignore -> both -1; head_attr.ignore -> head -1.
            if rb.get("tag") in PERSON_CLASSES:
                tag, head_tag = 1.0, 1.0
            else:
                tag, head_tag = -1.0, -1.0
            if rb.get("extra", {}).get("ignore", 0) != 0:
                tag = head_tag = -1.0
            if rb.get("head_attr", {}).get("ignore", 0) != 0:
                head_tag = -1.0
            box = rb["vbox"] if visible_flag else rb["fbox"]
            if isinstance(box[0], list):
                box = box[0]
            rows.append([box[0], box[1], box[0] + box[2], box[1] + box[3], tag])
            hb = rb.get("hbox", [0, 0, 0, 0])
            if isinstance(hb[0], list):
                hb = hb[0]
            head_rows.append(
                [hb[0], hb[1], hb[0] + hb[2], hb[1] + hb[3], head_tag])
        body = np.array(rows, dtype=np.float64).reshape(-1, 5)
        head = np.array(head_rows, dtype=np.float64).reshape(-1, 5)
        if self.mode == 0:
            self.gtboxes = body
        elif self.mode == 1:
            self.gtboxes = head
        else:
            # Joint tag = 1 iff neither box ignored (reference :89-96).
            joint = ((body[:, 4] != -1) & (head[:, 4] != -1)).astype(np.float64)
            self.gtboxes = np.concatenate(
                [body[:, :4], head[:, :4], joint[:, None]], axis=1)
        self.gt_num = len(rows)
        if not len(rows):
            self.ign_num = 0
        elif self.mode == 2:
            self.ign_num = int((self.gtboxes[:, 8] == 0).sum())
        else:
            self.ign_num = int((self.gtboxes[:, 4] == -1).sum())

    def clip_boxes(self):
        """Clip dt AND gt boxes to image bounds (reference clip_all_boader
        :229-243, invoked at dt-load time :417-418; in mode 2 both the body
        and head columns are clipped)."""
        if self.width is None or self.height is None:
            return

        def _clip(b, o):
            b[:, o + 0] = np.clip(b[:, o + 0], 0, self.width - 1)
            b[:, o + 1] = np.clip(b[:, o + 1], 0, self.height - 1)
            b[:, o + 2] = np.clip(b[:, o + 2], 0, self.width)
            b[:, o + 3] = np.clip(b[:, o + 3], 0, self.height)

        for b in (self.dtboxes, self.gtboxes):
            if b is None or not len(b):
                continue
            _clip(b, 0)
            if self.mode == 2:
                _clip(b, 4)

    # ---- matching ---------------------------------------------------------
    def compare_caltech(self, thres: float) -> List[Tuple[float, int]]:
        """Greedy score-descending matching; returns (score, label) pairs
        where label 1 = TP, 0 = FP (ignored detections are dropped)."""
        if self.dtboxes is None or self.gtboxes is None:
            return []
        dt = self.dtboxes[np.argsort(-self.dtboxes[:, -1], kind="stable")]
        gt = self.gtboxes[np.argsort(-self.gtboxes[:, -1], kind="stable")]
        if len(dt) == 0 or len(gt) == 0:
            return []
        pos_gt = gt[gt[:, -1] > 0]
        ign_gt = gt[gt[:, -1] <= 0]
        overlap_iou = box_overlap(dt, pos_gt, True)
        overlap_ioa = box_overlap(dt, ign_gt, False)
        ign = (
            np.any(overlap_ioa > thres, axis=1)
            if ign_gt.shape[0]
            else np.zeros(len(dt), dtype=bool)
        )
        out = []
        for i in range(len(dt)):
            if pos_gt.shape[0]:
                maxpos = int(np.argmax(overlap_iou[i]))
                if overlap_iou[i, maxpos] > thres:
                    overlap_iou[:, maxpos] = 0
                    out.append((float(dt[i, -1]), 1, self.ID))
                    continue
            if not ign[i]:
                out.append((float(dt[i, -1]), 0, self.ID))
        return out

    def compare_caltech_union(self, thres: float) -> List[Tuple[float, int]]:
        """Joint body+head greedy matching (reference :145-200): a
        detection matches a gt only when BOTH its body IoU and head IoU
        with that gt exceed `thres`; ignore-region gts (tag 0) suppress by
        body IoA; each gt matches at most one detection."""
        if self.dtboxes is None or self.gtboxes is None:
            return []
        if len(self.dtboxes) == 0:
            return []
        dt = self.dtboxes[np.argsort(-self.dtboxes[:, -1], kind="stable")]
        gt = self.gtboxes[np.argsort(-self.gtboxes[:, -1], kind="stable")]
        gt_matched = np.zeros(len(gt))
        iou_body = box_overlap(dt[:, :4], gt[:, :4], True)
        iou_head = box_overlap(dt[:, 4:8], gt[:, 4:8], True)
        ioa_body = box_overlap(dt[:, :4], gt[:, :4], False)
        out = []
        for i in range(len(dt)):
            maxpos, maxiou = -1, thres
            for j in range(len(gt)):
                if gt_matched[j] == 1:
                    continue
                if gt[j, -1] > 0:
                    if iou_body[i, j] > maxiou and iou_head[i, j] > maxiou:
                        maxiou = iou_body[i, j]
                        maxpos = j
                else:
                    # gts are tag-sorted: positives first.  Reaching an
                    # ignore row with a positive candidate ends the scan;
                    # otherwise ignore regions catch the detection by IoA.
                    if maxpos >= 0:
                        break
                    if ioa_body[i, j] > thres:
                        maxiou = ioa_body[i, j]
                        maxpos = j
            if maxpos >= 0:
                if gt[maxpos, -1] > 0:
                    gt_matched[maxpos] = 1
                    out.append((float(dt[i, -1]), 1, self.ID))
                # matched to an ignore region -> dropped entirely
            else:
                out.append((float(dt[i, -1]), 0, self.ID))
        return out


class Database:
    """Whole-dataset evaluation (reference `Database`, :360-548)."""

    def __init__(
        self,
        gt_path: str,
        dt_path: str,
        mode: int = 0,
        remove_empty_gt: bool = False,
        visible_flag: bool = False,
    ):
        assert mode in (0, 1, 2), mode
        self.mode = mode
        self.images: Dict = {}
        assert os.path.exists(gt_path), gt_path
        assert os.path.exists(dt_path), dt_path
        if ".json" in gt_path:
            assert mode == 0, (
                "modes 1/2 need head boxes; COCO-json ground truth carries "
                "body boxes only — use .odgt ground truth")
            self._load_json(gt_path, is_gt=True)
        elif ".odgt" in gt_path:
            self._load_odgt(gt_path, visible_flag=visible_flag)
        else:
            raise NotImplementedError(gt_path)
        self._load_json(dt_path, is_gt=False)

        if remove_empty_gt:
            self.images = {
                k: v for k, v in self.images.items() if v.dtboxes is not None
            }

        self.gt_num = sum(v.gt_num for v in self.images.values())
        self.ign_num = sum(v.ign_num for v in self.images.values())
        self.image_num = len(self.images)
        self.scorelist: Optional[list] = None

    def _load_json(self, path: str, is_gt: bool):
        records = json.load(open(path))
        annots = records["annotations"]
        image_ids = [it["id"] for it in records["images"]]
        assert len(image_ids) == len(set(image_ids)), "duplicate image ids"
        # annotations are contiguous per image in file order (reference :395-419)
        annot_id = 0
        for img_item in records["images"]:
            image_id = img_item["id"]
            k = 0
            while (
                annot_id + k < len(annots)
                and annots[annot_id + k]["image_id"] == image_id
            ):
                k += 1
            if is_gt:
                self.images[image_id] = ImageEval(self.mode)
                self.images[image_id].load_cocojson_gt(
                    img_item, annots[annot_id : annot_id + k]
                )
            elif image_id in self.images:
                img = self.images[image_id]
                if img.width is None:
                    img.width = img_item.get("width")
                    img.height = img_item.get("height")
                img.load_cocojson_dt(annots[annot_id : annot_id + k])
            annot_id += k

    def _load_odgt(self, path: str, visible_flag: bool):
        with open(path) as f:
            lines = f.readlines()
        if len(lines) == 1:
            records = json.loads(lines[0])
            if isinstance(records, dict):
                # A single-record one-line file; the reference's 1-line
                # branch (:427-429) assumes a list and would crash here.
                records = [records]
        else:
            records = [json.loads(line) for line in lines]
        for record in records:
            img = ImageEval(self.mode)
            img.load_odgt_gt(record, visible_flag=visible_flag)
            self.images[record["ID"]] = img

    def compare(self, thres: float = 0.5):
        scorelist = []
        for img in self.images.values():
            if self.mode == 2:
                scorelist.extend(img.compare_caltech_union(thres))
            else:
                scorelist.extend(img.compare_caltech(thres))
        scorelist.sort(key=lambda x: x[0], reverse=True)
        self.scorelist = scorelist

    def eval_AP(self):
        """-> (AP, final recall, (fppi_list, missrate_list))."""
        if self.scorelist is None:
            self.compare()
        total_gt = self.gt_num - self.ign_num
        tp = fp = 0.0
        rpX, rpY, fppi, mr = [], [], [], []
        recall = 0.0
        for score, label, _ in self.scorelist:
            if label == 1:
                tp += 1
            else:
                fp += 1
            recall = tp / total_gt if total_gt > 0 else 0.0
            precision = tp / (tp + fp)
            rpX.append(recall)
            rpY.append(precision)
            fppi.append(fp / max(self.image_num, 1))
            mr.append(1 - recall)
        ap = 0.0
        for i in range(1, len(rpX)):
            ap += (rpX[i] - rpX[i - 1]) * (rpY[i - 1] + rpY[i]) / 2
        return ap, recall, (fppi, mr)

    def eval_MR(self, ref: str = "CALTECH_-2", fppiX=None, fppiY=None):
        """Caltech log-average miss rate; returns (MR, (tp, fp))."""
        if fppiX is None or fppiY is None:
            _, _, (fppiX, fppiY) = self.eval_AP()
        anchors = CALTECH_REFS[ref]

        def find_gt(lst, target):
            for idx, item in enumerate(lst):
                if item >= target:
                    return idx
            return len(lst) - 1

        score = [fppiY[find_gt(fppiX, a)] for a in anchors if len(fppiY)]
        mr_val = float(np.exp(np.log(np.maximum(score, 1e-12)).mean())) if score else 1.0
        tp = sum(1 for s in self.scorelist if s[1] == 1)
        fp = sum(1 for s in self.scorelist if s[1] == 0)
        return mr_val, (tp, fp)


def evaluate_predictions_on_crowdhuman(
    gt_path: str,
    dt_path: str,
    mode: int = 0,
    remove_empty_gt: bool = False,
    visible_flag: bool = False,
):
    """-> (AP, MR, Recall, tp, fp) (reference :551-559)."""
    db = Database(
        gt_path, dt_path, mode=mode,
        remove_empty_gt=remove_empty_gt, visible_flag=visible_flag,
    )
    db.compare()
    ap, recall, (fppiX, fppiY) = db.eval_AP()
    mr, (tp, fp) = db.eval_MR(fppiX=fppiX, fppiY=fppiY)
    return ap, mr, recall, tp, fp
