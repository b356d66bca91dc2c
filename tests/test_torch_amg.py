"""The port's automatic mask generator against the JAX package's on the
CPU: the tiny SAM (vit_tiny, float32) on both sides with the JAX package's
own draws (`utils/init.py`), crop_n_layers 0 and 1, the three output
modes, min_mask_region_area 0 and > 0.

Records match one to one, in order: the same count, `bbox` within 0.5 px,
`predicted_iou` and `stability_score` within 1e-4, `point_coords`,
`crop_box` equal, and the segmentations (and so `area`) equal or, by the
pipeline's rule (`tests/test_torch_pipeline.py`), differing only at pixels
whose float32 full-resolution logit lies within 1e-5 of the threshold (seen:
one pixel, at a logit of 1.4e-9).

The inputs are the same on both sides: a 192x256 frame, which the model's
resize leaves as it is; for the crops of layer 1, which are resized, the
JAX predictor is given the port's resize (PIL's BILINEAR written out in
numpy, within one grey level of PIL), so that both encode the same pixels.

The JAX generator raises on a crop or a batch without survivors (its
`mask_to_rle` and its `crop_boxes` take no empty input); at crop layer 1
the tiny random model leaves no mask in the inner crops, so there the JAX
side is given the empty results upstream SAM gives (no record for that
crop).  The port handles both cases itself."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import crowdsam_tpu.ops.rle as jax_rle
import crowdsam_tpu.ops.transforms as jax_transforms
from crowdsam_tpu.models.build import sam_model_registry as jax_registry
from crowdsam_tpu.pipeline.amg_generator import (
    SamAutomaticMaskGenerator as JaxGenerator,
)

from crowdsam_tpu_torch.models.build import sam_model_registry
from crowdsam_tpu_torch.models.sam import postprocess_masks
from crowdsam_tpu_torch.ops import amg, boxes, rle
from crowdsam_tpu_torch.ops.transforms import ResizeLongestSide
from crowdsam_tpu_torch.pipeline.amg_generator import (
    SamAutomaticMaskGenerator,
)
from crowdsam_tpu_torch.utils import init

# Random weights give logits of a few hundredths and speckled masks whose
# boxes span the crop: a stability offset of 0.001 and thresholds of that
# size keep some masks and drop others, and no box NMS (threshold 1) keeps
# every survivor of crop layer 0 (20 records); the cross-crop NMS of crop
# layer 1 keeps one.
KW = dict(points_per_side=6, points_per_batch=16, pred_iou_thresh=0.02,
          stability_score_thresh=0.35, stability_score_offset=0.001,
          box_nms_thresh=1.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this file: the test runner's workers share the
    machine's cores, and the small tensors here gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(4).integers(0, 255, (192, 256, 3),
                                             dtype=np.uint8)


@pytest.fixture(scope="module")
def sams():
    js = jax_registry["vit_tiny"](n_class=1, dtype=jnp.float32)
    ps = sam_model_registry["vit_tiny"]()
    missing, unexpected = ps.load_state_dict(
        init.sam_state_dict("vit_tiny"), strict=False)
    assert not unexpected
    assert {k.split(".layers.")[0] for k in missing} == {
        "mask_decoder.output_hypernetworks_mlps.4"}
    return js, ps


_JAX_RLE_RECORDS = {}


def _port_resize(self, image):
    return ResizeLongestSide(self.target_length).apply_image(image)


def _empty_ok_mask_to_rle(masks, _real=jax_rle.mask_to_rle):
    return [] if len(masks) == 0 else _real(masks)


@pytest.fixture(scope="module")
def jax_generator(sams):
    """One JAX generator for both crop settings, so that its compiled
    encode and decode are reused."""
    return JaxGenerator(sams[0], **KW)


@pytest.fixture(scope="module", params=[0, 1], ids=["crops0", "crops1"])
def generators(request, sams, jax_generator, image):
    """(JAX generator, port generator) at one crop_n_layers; the JAX
    side's masks (encode and decode, the costly part) are computed once
    and handed out as copies."""
    layers = request.param
    jg = jax_generator
    jg.crop_n_layers = layers
    jg.point_grids = amg.build_all_layer_point_grids(
        KW["points_per_side"], layers, 1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_transforms.ResizeLongestSide, "apply_image",
                   _port_resize)
        mp.setattr(jax_rle, "mask_to_rle", _empty_ok_mask_to_rle)
        real_crop = JaxGenerator._process_crop

        def process_crop(self, *a):
            data = real_crop(self, *a)
            if len(data["rles"]) == 0:
                data["crop_boxes"] = np.zeros((0, 4), np.int64)
            return data

        mp.setattr(JaxGenerator, "_process_crop", process_crop)
        cached = JaxGenerator._generate_masks(jg, image)
    jg._generate_masks = lambda _img: copy.deepcopy(cached)
    _JAX_RLE_RECORDS.clear()
    return jg, SamAutomaticMaskGenerator(sams[1], device="cpu", **KW,
                                         crop_n_layers=layers)


def _mask(seg, mode):
    if mode == "binary_mask":
        return np.asarray(seg)
    if mode == "uncompressed_rle":
        return rle.rle_to_mask(seg)
    return rle.coco_decode_rle(seg)


def _flips_near_threshold(pg, image, record, diff):
    """Assert that the pixels `diff` where a record's masks differ hold a
    logit within 1e-5 of the threshold: the port's full-resolution logits
    of the record's point, of the multimask output nearest its mask."""
    assert record["crop_box"] == [0.0, 0.0, image.shape[1], image.shape[0]]
    pred = pg.predictor
    pred.set_image(image)
    pt = pred.transform.apply_coords(np.asarray(record["point_coords"]),
                                     image.shape[:2])
    _, _, _, low = pred.predict_batch(
        torch.as_tensor(pt, dtype=torch.float32)[:, None],
        torch.ones((1, 1), dtype=torch.int64), return_full_masks=False)
    full = postprocess_masks(low[0], pred.input_size, pred.original_size,
                             pred.model.img_size).numpy()
    mine = _mask(record["segmentation"], pg.output_mode)
    k = int(np.argmin([((f > 0) != mine).sum() for f in full]))
    near = np.abs(full[k] - pred.model.mask_threshold) <= 1e-5
    assert near[diff].all(), "masks differ away from the threshold"


def _jax_records(jg, image, mode, min_area):
    """The JAX generator's records in `mode`: computed once per setting in
    uncompressed_rle, the other modes converted as its `generate` converts
    them (`rle_to_mask`, `coco_encode_rle`)."""
    key = min_area
    if key not in _JAX_RLE_RECORDS:
        jg.output_mode = "uncompressed_rle"
        jg.min_mask_region_area = min_area
        _JAX_RLE_RECORDS[key] = jg.generate(image)
    convert = {"uncompressed_rle": lambda r: r,
               "binary_mask": jax_rle.rle_to_mask,
               "coco_rle": jax_rle.coco_encode_rle}[mode]
    return [dict(r, segmentation=convert(r["segmentation"]))
            for r in _JAX_RLE_RECORDS[key]]


# 4 px: the cleanup's windowed path at this size (its labelling path is
# held against the JAX package in `tests/test_torch_ops.py`).
@pytest.mark.parametrize("min_area", [0, 4])
@pytest.mark.parametrize("mode", ["binary_mask", "uncompressed_rle",
                                  "coco_rle"])
def test_generate_matches_jax(generators, image, mode, min_area):
    jg, pg = generators
    pg.output_mode = mode
    pg.min_mask_region_area = min_area
    want = _jax_records(jg, image, mode, min_area)
    got = pg.generate(image)
    assert len(want) > 0
    assert len(got) == len(want)
    for a, b in zip(want, got):
        assert set(b) == set(a)
        np.testing.assert_allclose(b["bbox"], np.asarray(a["bbox"]),
                                   atol=0.5)
        assert abs(b["predicted_iou"] - a["predicted_iou"]) <= 1e-4
        assert abs(b["stability_score"] - a["stability_score"]) <= 1e-4
        assert b["point_coords"] == a["point_coords"]
        assert b["crop_box"] == [float(v) for v in a["crop_box"]]
        diff = _mask(a["segmentation"], mode) != _mask(b["segmentation"],
                                                       mode)
        if diff.any():
            _flips_near_threshold(pg, image, b, diff)
        else:
            assert b["area"] == a["area"]
    if min_area:
        # The cleanup changed some masks, or the case tests nothing.
        pg.min_mask_region_area = 0
        plain = pg.generate(image)
        assert [r["area"] for r in plain] != [r["area"] for r in got]


def test_helpers_match_jax():
    from crowdsam_tpu.ops import amg as jax_amg
    from crowdsam_tpu.ops import boxes as jax_boxes

    np.testing.assert_array_equal(amg.build_point_grid(5),
                                  jax_amg.build_point_grid(5))
    for got, want in zip(amg.build_all_layer_point_grids(8, 2, 2),
                         jax_amg.build_all_layer_point_grids(8, 2, 2)):
        np.testing.assert_array_equal(got, want)
    x = np.arange(23)
    assert [b[0].tolist() for b in amg.batch_iterator(5, x)] == [
        b[0].tolist() for b in jax_amg.batch_iterator(5, x)]
    rng = np.random.default_rng(0)
    m = rng.uniform(size=(3, 20, 30)) > 0.5
    crop = [7, 5, 37, 25]
    np.testing.assert_array_equal(
        amg.uncrop_masks(torch.from_numpy(m), crop, 40, 50).numpy(),
        np.asarray(jax_amg.uncrop_masks(jnp.asarray(m), crop, 40, 50)))
    full = [0, 0, 30, 20]
    assert amg.uncrop_masks(torch.from_numpy(m), full, 20, 30).shape == \
        m.shape
    pts = rng.uniform(0, 50, (6, 2)).astype(np.float32)
    np.testing.assert_allclose(
        boxes.uncrop_points(torch.from_numpy(pts), crop, 2.0).numpy(),
        np.asarray(jax_boxes.uncrop_points(jnp.asarray(pts), crop, 2.0)))
    bx = rng.uniform(0, 50, (6, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        boxes.box_xyxy_to_xywh(torch.from_numpy(bx)).numpy(),
        np.asarray(jax_boxes.box_xyxy_to_xywh(jnp.asarray(bx))))


def test_mask_to_rle_of_a_tensor_matches_numpy():
    """The generator's RLEs come from tensors (changes found on the
    masks' device): the same dicts as from the numpy masks, an empty batch
    included."""
    m = np.random.default_rng(1).uniform(size=(4, 9, 7)) > 0.6
    m[1] = True
    m[2] = False
    assert rle.mask_to_rle(torch.from_numpy(m)) == jax_rle.mask_to_rle(m)
    assert rle.mask_to_rle(torch.zeros((0, 9, 7), dtype=torch.bool)) == []
