"""The port's evaluator and converters against the JAX package's, on the
same synthetic ground truth and detections (COCO json and odgt): AP, MR,
Recall, tp and fp equal to 1e-12 (both are numpy in float64: the same
operations in the same order), the converters' JSON equal."""

import copy
import json

import cv2
import numpy as np
import pytest

from crowdsam_tpu.evallib import coco_convert as jax_convert
from crowdsam_tpu.evallib import crowdhuman as jax_eval

from crowdsam_tpu_torch.evallib import coco_convert, crowdhuman


def _synth_coco(rng, n_images=6, with_ignore=True):
    """COCO gt and detections: jittered true positives (some missed),
    false positives, and an ignore region in every third image."""
    images, gt_annots, dt_annots = [], [], []
    for img_id in range(n_images):
        images.append({"id": img_id, "width": 800, "height": 600,
                       "file_name": f"{img_id}.jpg"})
        for g in range(int(rng.integers(2, 6))):
            x, y = rng.uniform(0, 600), rng.uniform(0, 400)
            bw, bh = rng.uniform(40, 150), rng.uniform(80, 190)
            ignore = int(with_ignore and g == 0 and img_id % 3 == 0)
            gt_annots.append({"image_id": img_id, "bbox": [x, y, bw, bh],
                              "id": len(gt_annots), "category_id": 1,
                              "ignore": ignore, "area": bw * bh,
                              "iscrowd": False})
            if not ignore and rng.uniform() > 0.2:
                jx, jy = rng.uniform(-8, 8), rng.uniform(-8, 8)
                dt_annots.append({
                    "image_id": img_id, "bbox": [x + jx, y + jy, bw, bh],
                    "id": len(dt_annots), "category_id": 1,
                    "score": float(rng.uniform(0.5, 1.0)), "area": bw * bh,
                    "iscrowd": False})
        for _ in range(int(rng.integers(0, 3))):
            x, y = rng.uniform(0, 700), rng.uniform(0, 500)
            dt_annots.append({"image_id": img_id, "bbox": [x, y, 30, 40],
                              "id": len(dt_annots), "category_id": 1,
                              "score": float(rng.uniform(0.0, 0.6)),
                              "area": 1200, "iscrowd": False})
    cats = [{"id": 1, "name": "person", "supercategory": "person"}]
    return ({"images": images, "annotations": gt_annots, "categories": cats},
            {"images": images, "annotations": dt_annots, "categories": cats})


def _perfect(gt):
    dt = copy.deepcopy(gt)
    for a in dt["annotations"]:
        a["score"] = 1.0
    return dt


def _all_wrong(gt):
    dt = copy.deepcopy(gt)
    dt["annotations"] = [
        {"image_id": im["id"], "bbox": [790, 590, 5, 5], "id": i,
         "category_id": 1, "score": 0.9, "area": 25, "iscrowd": False}
        for i, im in enumerate(gt["images"])]
    return dt


def _ignore_case():
    images = [{"id": 0, "width": 100, "height": 100, "file_name": "0.jpg"}]
    gt = {"images": images, "categories": [], "annotations": [
        {"image_id": 0, "bbox": [10, 10, 30, 30], "id": 0, "category_id": 1,
         "ignore": 0, "area": 900, "iscrowd": False},
        {"image_id": 0, "bbox": [60, 60, 30, 30], "id": 1, "category_id": 1,
         "ignore": 1, "area": 900, "iscrowd": False}]}
    dt = {"images": images, "categories": [], "annotations": [
        {"image_id": 0, "bbox": [11, 11, 30, 30], "id": 0, "category_id": 1,
         "score": 0.9, "area": 900, "iscrowd": False},
        {"image_id": 0, "bbox": [62, 62, 28, 28], "id": 1, "category_id": 1,
         "score": 0.8, "area": 784, "iscrowd": False}]}
    return gt, dt


def _coco_case(name):
    rng = np.random.default_rng(7)
    if name == "synthetic":
        return _synth_coco(rng)
    if name == "perfect":
        gt, _ = _synth_coco(rng, with_ignore=False)
        return gt, _perfect(gt)
    if name == "all_wrong":
        gt, _ = _synth_coco(rng, with_ignore=False)
        return gt, _all_wrong(gt)
    if name == "ignore_region":
        return _ignore_case()
    if name == "empty_images":
        gt, dt = _synth_coco(rng, n_images=8)
        dt["images"] = dt["images"][:5]
        dt["annotations"] = [a for a in dt["annotations"]
                             if a["image_id"] < 5]
        return gt, dt
    raise KeyError(name)


def _odgt_records(rng, n_images=5):
    """odgt ground truth with body (fbox, vbox) and head (hbox) boxes,
    extra.ignore, head_attr.ignore and a non-person tag; detections carry
    `hbox` for modes 1 and 2."""
    recs, dt_images, dt_annots = [], [], []
    for i in range(n_images):
        gtboxes = []
        for g in range(int(rng.integers(2, 6))):
            x, y = rng.uniform(0, 500), rng.uniform(0, 300)
            w, h = rng.uniform(40, 120), rng.uniform(90, 200)
            vb = [x + 2, y + 3, w - 5, h - 8]
            hb = [x + w / 3, y, w / 3, h / 6]
            gtboxes.append({
                "tag": "person" if g != 3 else "mask",
                "fbox": [x, y, w, h], "vbox": vb, "hbox": hb,
                "extra": {"ignore": int(g == 2 and i % 2 == 0)},
                "head_attr": {"ignore": int(g == 1 and i % 3 == 0)}})
            if rng.uniform() > 0.25:
                j = rng.uniform(-6, 6, size=2)
                dt_annots.append({
                    "image_id": f"img{i}", "id": len(dt_annots),
                    "bbox": [vb[0] + j[0], vb[1] + j[1], vb[2], vb[3]],
                    "hbox": [hb[0] + j[0] / 2, hb[1] + j[1] / 2, hb[2],
                             hb[3]],
                    "score": float(rng.uniform(0.3, 1.0)), "category_id": 1,
                    "iscrowd": False, "area": 1})
        for _ in range(int(rng.integers(0, 3))):
            x, y = rng.uniform(0, 600), rng.uniform(0, 400)
            dt_annots.append({
                "image_id": f"img{i}", "id": len(dt_annots),
                "bbox": [x, y, 30, 60], "hbox": [x + 10, y, 10, 10],
                "score": float(rng.uniform(0.0, 0.7)), "category_id": 1,
                "iscrowd": False, "area": 1})
        recs.append({"ID": f"img{i}", "width": 640, "height": 480,
                     "gtboxes": gtboxes})
        dt_images.append({"id": f"img{i}", "width": 640, "height": 480,
                          "file_name": f"img{i}.jpg"})
    return recs, {"images": dt_images, "annotations": dt_annots,
                  "categories": []}


def _write(tmp_path, name, obj):
    p = tmp_path / name
    p.write_text(json.dumps(obj))
    return str(p)


def _assert_same_metrics(got, want):
    assert got[3] == want[3] and got[4] == want[4]
    np.testing.assert_allclose(got[:3], want[:3], rtol=0, atol=1e-12)


@pytest.mark.parametrize("remove_empty_gt", [False, True])
@pytest.mark.parametrize("case", ["synthetic", "perfect", "all_wrong",
                                  "ignore_region", "empty_images"])
def test_coco_ground_truth_matches_jax(tmp_path, case, remove_empty_gt):
    gt, dt = _coco_case(case)
    gtp, dtp = _write(tmp_path, "gt.json", gt), _write(tmp_path, "dt.json",
                                                       dt)
    kw = dict(remove_empty_gt=remove_empty_gt, visible_flag=True)
    got = crowdhuman.evaluate_predictions_on_crowdhuman(gtp, dtp, **kw)
    want = jax_eval.evaluate_predictions_on_crowdhuman(gtp, dtp, **kw)
    _assert_same_metrics(got, want)
    if case == "perfect":
        # The reference's trapezoid integration skips the first segment.
        assert got[0] == pytest.approx((got[3] - 1) / got[3])


@pytest.mark.parametrize("visible_flag", [False, True])
@pytest.mark.parametrize("remove_empty_gt", [False, True])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_odgt_ground_truth_matches_jax(tmp_path, mode, remove_empty_gt,
                                       visible_flag):
    recs, dt = _odgt_records(np.random.default_rng(11))
    gtp = tmp_path / "gt.odgt"
    gtp.write_text("\n".join(json.dumps(r) for r in recs))
    dtp = _write(tmp_path, "dt.json", dt)
    kw = dict(mode=mode, remove_empty_gt=remove_empty_gt,
              visible_flag=visible_flag)
    got = crowdhuman.evaluate_predictions_on_crowdhuman(str(gtp), dtp, **kw)
    want = jax_eval.evaluate_predictions_on_crowdhuman(str(gtp), dtp, **kw)
    _assert_same_metrics(got, want)
    db = crowdhuman.Database(str(gtp), dtp, **kw)
    jdb = jax_eval.Database(str(gtp), dtp, **kw)
    assert (db.gt_num, db.ign_num, db.image_num) == (
        jdb.gt_num, jdb.ign_num, jdb.image_num)


def test_box_overlap_matches_jax():
    rng = np.random.default_rng(3)
    a = np.sort(rng.uniform(0, 100, (7, 4)).reshape(7, 2, 2), axis=1)
    b = np.sort(rng.uniform(0, 100, (5, 4)).reshape(5, 2, 2), axis=1)
    a = a.transpose(0, 2, 1).reshape(7, 4)
    b = b.transpose(0, 2, 1).reshape(5, 4)
    for if_iou in (True, False):
        np.testing.assert_array_equal(
            crowdhuman.box_overlap(a, b, if_iou),
            jax_eval.box_overlap(a, b, if_iou))


def _odgt_dataset(tmp_path):
    recs, _ = _odgt_records(np.random.default_rng(5), n_images=4)
    img_dir = tmp_path / "Images"
    img_dir.mkdir()
    rng = np.random.default_rng(0)
    for r in recs:
        h, w = int(rng.integers(40, 90)), int(rng.integers(40, 90))
        cv2.imwrite(str(img_dir / f"{r['ID']}.jpg"),
                    np.zeros((h, w, 3), np.uint8))
    odgt = tmp_path / "ann.odgt"
    odgt.write_text("\n".join(json.dumps(r) for r in recs))
    return str(odgt), str(img_dir)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(visible=True, full=False),
    dict(tag="both", shuffle=True),
    dict(tag="mask", max_images=2),
], ids=["full", "visible", "both-shuffled", "mask-two"])
def test_crowdhuman2coco_matches_jax(tmp_path, kw):
    odgt, img_dir = _odgt_dataset(tmp_path)
    got = coco_convert.crowdhuman2coco(odgt, str(tmp_path / "a.json"),
                                       img_dir, **kw)
    want = jax_convert.crowdhuman2coco(odgt, str(tmp_path / "b.json"),
                                       img_dir, **kw)
    assert got == want
    assert (tmp_path / "a.json").read_text() == \
        (tmp_path / "b.json").read_text()
    assert coco_convert.read_odgt(odgt) == jax_convert.read_odgt(odgt)


def test_convert_to_coco_matches_jax():
    rng = np.random.default_rng(2)
    gt = {"images": [{"file_name": f"im{i}.png", "id": i, "width": 64,
                      "height": 48} for i in range(3)],
          "categories": [{"id": 1, "name": "person"}]}
    dets = [{"image_id": i, "num_gt": 2,
             "boxes": np.sort(rng.uniform(0, 60, (n, 4)), axis=1).tolist(),
             "scores": rng.uniform(0, 1, n).tolist(),
             "categories": [0] * n, "rles": [None] * n}
            for i, n in enumerate([3, 0, 2])]
    gt_a, gt_b = copy.deepcopy(gt), copy.deepcopy(gt)
    got = coco_convert.convert_to_coco(copy.deepcopy(dets), gt_a)
    want = jax_convert.convert_to_coco(copy.deepcopy(dets), gt_b)
    assert json.dumps(got) == json.dumps(want)
    assert gt_a == gt_b            # both re-key the gt image ids in place
