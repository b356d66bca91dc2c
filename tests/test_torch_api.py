"""The port's API surface against the JAX package's on the CPU: the
list-of-records `forward_batched`, the prototype FG map, the
`segment_anything_cs` names, and the numpy utilities (misc, data,
visualize, logging, COCO names).  float32 model outputs agree within 1e-5
relative to their largest value (two float32 implementations of the same
graph); the numpy utilities are copies and agree exactly."""

import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crowdsam_tpu.models.build import sam_model_registry as jax_registry
from crowdsam_tpu.models.dinov2 import dino_model_registry as jax_dinos
from crowdsam_tpu.models.sam import forward_batched as jax_forward_batched
from crowdsam_tpu.pipeline.predictor import SamPredictor as JaxPredictor

from crowdsam_tpu_torch.models.build import sam_model_registry
from crowdsam_tpu_torch.models.dinov2 import dino_model_registry
from crowdsam_tpu_torch.models.sam import forward_batched, postprocess_masks
from crowdsam_tpu_torch.pipeline.predictor import SamPredictor
from crowdsam_tpu_torch.utils import init


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this file: the test runner's workers share the
    machine's cores, and the small tensors here gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol=1e-5):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * max(np.abs(want).max(), 1e-30)


@pytest.fixture(scope="module")
def sams():
    js = jax_registry["vit_tiny"](n_class=2, dtype=jnp.float32,
                                  dino_dim=384)
    ps = sam_model_registry["vit_tiny"](n_class=2, dino_dim=384)
    missing, unexpected = ps.load_state_dict(
        init.sam_state_dict("vit_tiny", 0, None, 2, 384), strict=False)
    assert not unexpected
    return js, ps


def test_forward_batched_matches_jax(sams):
    js, ps = sams
    rng = np.random.default_rng(0)
    records = [
        {"image": rng.integers(0, 255, (192, 256, 3), dtype=np.uint8),
         "original_size": (96, 128),
         "point_coords": rng.uniform(0, 192, (3, 2, 2)).astype(np.float32),
         "point_labels": np.array([[1, 0], [1, 1], [0, 1]])},
        {"image": rng.integers(0, 255, (256, 200, 3), dtype=np.uint8),
         "original_size": (256, 200),
         "boxes": np.array([[10, 20, 120, 200], [50, 5, 190, 90]],
                           np.float32),
         "mask_inputs": rng.normal(0, 1, (2, 64, 64, 1)).astype(np.float32)},
    ]
    for multimask, recs in ((True, records), (False, records[:1])):
        want = jax_forward_batched(js, recs, multimask)
        got = forward_batched(ps, recs, multimask)
        assert len(got) == len(want) == len(recs)
        for g, w, rec in zip(got, want, recs):
            _close(g["low_res_logits"], w["low_res_logits"])
            _close(g["iou_predictions"], w["iou_predictions"])
            assert g["masks"].shape == w["masks"].shape
            # Thresholded masks: equal but at logits within 1e-5 of 0.
            diff = g["masks"].numpy() != np.asarray(w["masks"])
            logits = postprocess_masks(
                g["low_res_logits"], rec["image"].shape[:2],
                rec["original_size"], ps.img_size).numpy()
            assert (np.abs(logits[diff]) <= 1e-5).all()


def test_predict_fg_with_prototypes_matches_jax(sams):
    js, ps = sams
    dino_params = init.dino_params("dinov2_vits14", 3)
    jp = JaxPredictor(js, jax_dinos["dinov2_vits14"](), dino_params)
    dino = dino_model_registry["dinov2_vits14"]()
    dino.load_state_dict(init.dino_state_dict("dinov2_vits14", 3))
    pp = SamPredictor(ps, dino, device="cpu")
    image = np.random.default_rng(1).integers(0, 255, (192, 256, 3),
                                              dtype=np.uint8)
    jp.set_image(image)
    pp.set_image(image)
    rng = np.random.default_rng(2)
    for protos in (rng.normal(0, 1, (2, 3, 384)),
                   rng.normal(0, 1, (2, 384))):
        protos = protos.astype(np.float32)
        got = pp.predict_fg_with_prototypes(protos)
        want = jp.predict_fg_with_prototypes(protos)
        assert got.shape == (1, 2, 256, 256)
        _close(got, want)


def test_namespace_has_the_jax_names():
    import crowdsam_tpu.segment_anything_cs as jax_ns

    import crowdsam_tpu_torch.segment_anything_cs as ns

    def names(m):
        return {n for n in dir(m) if not n.startswith("_")}

    assert names(ns) == names(jax_ns)
    assert ns.SamAutomaticMaskGenerator.__module__.startswith(
        "crowdsam_tpu_torch")
    # Every arch of the JAX registry is ported; `build_sam` is ViT-H, as
    # there (not built here: a full-size model).
    assert ns.build_sam is ns.build_sam_vit_h
    assert set(ns.sam_model_registry) == set(jax_ns.sam_model_registry)


def test_misc_matches_jax():
    from crowdsam_tpu.utils import misc as jax_misc

    from crowdsam_tpu_torch.utils import misc

    rng = np.random.default_rng(0)
    boxes = np.sort(rng.uniform(0, 50, (6, 4)).reshape(6, 2, 2), axis=1)
    boxes = boxes.transpose(0, 2, 1).reshape(6, 4)
    for mode in ("big", "small"):
        assert misc.select_box(boxes, mode) == jax_misc.select_box(boxes,
                                                                   mode)
    assert misc.is_validbox([0, 0, 2, 3]) and not misc.is_validbox(
        [0, 0, 0, 3])
    res = [{"ap": float(v)} for v in rng.uniform(size=5)]
    assert misc.average_metric(res, "ap") == jax_misc.average_metric(res,
                                                                     "ap")
    mask = rng.uniform(size=(9, 11)) > 0.7
    np.testing.assert_array_equal(misc.mask2coord(mask),
                                  jax_misc.mask2coord(mask))
    xy = rng.integers(0, 20, (15, 2))
    np.testing.assert_array_equal(misc.coords2mask(xy),
                                  jax_misc.coords2mask(xy))
    pts = rng.uniform(0, 100, (40, 2))
    for got, want in zip(misc.composite_clustering(pts, [1, 3, 5]),
                         jax_misc.composite_clustering(pts, [1, 3, 5])):
        np.testing.assert_array_equal(got, want)
    assert misc.clustering_matched_points(np.zeros((0, 2)), 3).shape == (
        0, 2)


def test_data_and_names_match_jax(tmp_path):
    from crowdsam_tpu import coco_names as jax_names
    from crowdsam_tpu.utils import data as jax_data

    from crowdsam_tpu_torch import coco_names
    from crowdsam_tpu_torch.utils import data

    assert coco_names.coco_classes == jax_names.coco_classes
    assert data.data_meta == jax_data.data_meta
    (tmp_path / "Images").mkdir()
    img = np.random.default_rng(0).integers(0, 255, (30, 40, 3),
                                            dtype=np.uint8)
    cv2.imwrite(str(tmp_path / "Images" / "a.png"), img)
    annots = {"images": [{"file_name": "a.png", "id": 7}],
              "annotations": [{"image_id": 7, "bbox": [1, 2, 10, 12]},
                              {"image_id": 8, "bbox": [0, 0, 1, 1]},
                              {"image_id": 7, "bbox": [5, 5, 3, 4]}]}
    got = data.load_img_and_annotation(str(tmp_path), annots, "crowdhuman")
    want = jax_data.load_img_and_annotation(str(tmp_path), annots,
                                            "crowdhuman")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[0], img[..., ::-1])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] == 7
    rng = np.random.default_rng(1)
    gt = np.array([[0, 0, 10, 10], [20, 20, 30, 35], [50, 5, 60, 15]],
                  np.float64)
    pred = np.concatenate([gt[:2] + rng.uniform(-1, 1, (2, 4)),
                           [[80, 80, 90, 90]]])
    scores = np.array([0.9, 0.4, 0.7])
    assert data.evaluate_boxes(pred, scores, gt, 0.5) == \
        jax_data.evaluate_boxes(pred, scores, gt, 0.5)


def test_visualize_result_matches_jax(tmp_path):
    from crowdsam_tpu.utils import visualize as jax_vis

    from crowdsam_tpu_torch.ops.rle import encode_masks_coco
    from crowdsam_tpu_torch.utils import visualize

    rng = np.random.default_rng(0)
    image = rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)
    masks = np.zeros((2, 48, 64), bool)
    masks[0, 5:20, 5:30] = True
    masks[1, 25:40, 30:60] = True
    result = {"boxes": np.array([[5, 5, 29, 19], [30, 25, 59, 39]], float),
              "scores": np.array([0.9, 0.8]),
              "categories": np.array([0, 0]),
              "rles": encode_masks_coco(masks),
              "rles_info": [[0, 0, 64, 48], [48, 64]],
              "gt_boxes": np.array([[5, 5, 29, 19], [0, 0, 4, 4]], float)}
    paths = []
    for name, vis in (("port", visualize), ("jax", jax_vis)):
        np.random.seed(3)            # the masks' random colours
        paths.append(str(tmp_path / f"{name}.png"))
        vis.visualize_result(image, dict(result), {1: "person"}, paths[-1],
                             FP_ind=[1], FN_ind=[1])
    np.testing.assert_array_equal(cv2.imread(paths[0]), cv2.imread(paths[1]))


def test_setup_logger_writes_under_the_port_name(tmp_path):
    from crowdsam_tpu_torch.utils.logging import (
        LOGGER_NAME,
        get_logger,
        setup_logger,
    )

    logger = setup_logger(str(tmp_path / "log"), quiet=True)
    assert logger.name == LOGGER_NAME == "crowdsam_tpu_torch"
    logger.info("hello %s", "there")
    for h in logger.handlers:
        h.flush()
    (log,) = os.listdir(tmp_path / "log")
    assert "hello there" in (tmp_path / "log" / log).read_text()
    assert get_logger() is logger
