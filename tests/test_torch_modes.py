"""The opt-in modes of the port's engine against the JAX package on the
CPU: `test.mask_selection` max_area / min_area, `tpu.accumulate_occupy`,
`test.fuse_simmap` and `tpu.fullres_cleanup`, each with `tpu.fused_decode`
true and false, on the tiny config of `tests/test_torch_pipeline.py` with
RLE output and the same weights and engine noise on both sides.

Tolerances, as in `tests/test_torch_pipeline.py`: the same detection count
and categories, boxes within 0.5 px, scores within 1e-4 (two float32
implementations of the same graph), RLE strings equal or their masks
differing only at pixels whose upsampled logit lies within 1e-5 of the
threshold.  The mask choice and the full-resolution survivor pass are also
held alone, on drawn logits: the choice index equal (packed and spatial
masks alike, ties to the first mask), the survivor summary and bitmap
equal."""

import contextlib
import dataclasses
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import crowdsam_tpu.pipeline.engine as jax_engine
from crowdsam_tpu.config import load_config as jax_load_config
from crowdsam_tpu.config import modify_config as jax_modify_config
from crowdsam_tpu.pipeline.crowdsam import CrowdSAM as JaxCrowdSAM
from crowdsam_tpu.utils.checkpoint import jax_tree_to_numpy
from test_torch_pipeline import (  # noqa: F401 (autouse fixture)
    TINY,
    TINY_RLES,
    _image,
    _next_noise,
    _one_torch_thread,
    _rle_flips_near_threshold,
)

from crowdsam_tpu_torch.config import load_config, modify_config
from crowdsam_tpu_torch.ops.packed import pack_spatial
from crowdsam_tpu_torch.pipeline.crowdsam import CrowdSAM
from crowdsam_tpu_torch.pipeline.engine import (
    EngineConfig,
    select_mask,
    survivor_core,
)
from crowdsam_tpu_torch.utils.weights import (
    dino_state_dict_from_jax,
    sam_state_dict_from_jax,
)

MODES = {
    "max_area": ["test.mask_selection", "max_area"],
    "min_area": ["test.mask_selection", "min_area"],
    "accumulate_occupy": ["tpu.accumulate_occupy", "true"],
    "fuse_simmap": ["test.fuse_simmap", "true"],
    "fullres_cleanup": ["tpu.fullres_cleanup", "true"],
}


@contextlib.contextmanager
def port_warnings():
    """The port logger's warnings inside the block, from a handler on the
    logger itself (the CLIs' `setup_logger` turns its propagation off)."""
    msgs = []

    class Keep(logging.Handler):
        def emit(self, record):
            msgs.append(record.getMessage())

    handler = Keep(level=logging.WARNING)
    logger = logging.getLogger("crowdsam_tpu_torch")
    logger.addHandler(handler)
    try:
        yield msgs
    finally:
        logger.removeHandler(handler)


def build_pair(opts):
    """The JAX model and the port's of the override list `opts`, the
    port's weights those of the JAX model."""
    jm = JaxCrowdSAM(jax_modify_config(jax_load_config(None), list(opts)))
    pm = CrowdSAM(modify_config(load_config(None), list(opts)), device="cpu")
    pm.sam.load_state_dict(
        sam_state_dict_from_jax(jax_tree_to_numpy(jm.sam.params)),
        strict=False)
    pm.dino.load_state_dict(
        dino_state_dict_from_jax(jax_tree_to_numpy(jm.predictor.dino_params)),
        strict=True)
    return jm, pm


def assert_same_detections(jm, pm, image):
    """One frame through both models with the JAX model's next noise:
    count, categories, boxes, scores and RLE strings.  Returns the port's
    result."""
    noise = _next_noise(jm)
    want = jm.generate(image)
    got = pm.generate(image, noise=[noise])
    assert len(got["boxes"]) == len(want["boxes"]) > 0
    np.testing.assert_array_equal(got["categories"], want["categories"])
    np.testing.assert_allclose(got["boxes"], want["boxes"], atol=0.5)
    np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-4)
    if pm.output_rles:
        _rle_flips_near_threshold(pm, got["rles"], want["rles"])
    return got


@pytest.fixture(scope="module", params=["false", "true"],
                ids=["unfused", "fused"])
def mode_pair(request):
    """The pair of one `tpu.fused_decode` setting, the occupancy filter at
    0 so that every kept mask prunes candidates (what `accumulate_occupy`
    changes); each test sets its mode on both (`set_mode`)."""
    return build_pair(list(TINY_RLES) + ["test.filter_thresh", "0.0",
                                         "tpu.fused_decode", request.param])


def set_mode(jm, pm, opts):
    """Both models' engine configs as the override list `opts` makes them:
    the port's from its constructor's wiring, the JAX model's engine and
    survivor programs rebuilt on its config's new fields."""
    cfg = modify_config(load_config(None), list(TINY_RLES) + [
        "test.filter_thresh", "0.0", "tpu.fused_decode",
        str(pm.engine_cfg.fused_decode).lower()] + list(opts))
    pm.engine_cfg = CrowdSAM(cfg, device="cpu").engine_cfg
    jm.engine_cfg = dataclasses.replace(jm.engine_cfg, **{
        f: getattr(pm.engine_cfg, f) for f in (
            "mask_selection", "accumulate_occupy", "fuse_simmap",
            "fullres_cleanup")})
    jm.engine = jax_engine.make_eps_engine(
        jm.sam.prompt_encoder, jm.sam.mask_decoder, jm.engine_cfg,
        spec_with_masks=jm.output_rles)
    jm._build_survivor_programs()


@pytest.mark.parametrize("mode", list(MODES))
def test_mode_matches_jax(mode_pair, mode):
    """Each mode alone, with the fused decode on and off."""
    jm, pm = mode_pair
    set_mode(jm, pm, MODES[mode])
    cfg = pm.engine_cfg
    assert cfg.fused_decode == jm.engine_cfg.fused_decode
    assert (cfg.mask_selection, cfg.accumulate_occupy, cfg.fuse_simmap,
            cfg.fullres_cleanup) == (
        jm.engine_cfg.mask_selection, jm.engine_cfg.accumulate_occupy,
        jm.engine_cfg.fuse_simmap, jm.engine_cfg.fullres_cleanup)
    got = assert_same_detections(jm, pm, _image(21, (200, 256, 3)))
    if mode == "fuse_simmap":      # the score is no longer the fused IoU
        summary = pm.last_engine["summary"]
        assert not torch.equal(summary[:, 1], summary[:, 2])
    if mode == "fullres_cleanup":
        assert all(isinstance(r["counts"], str) for r in got["rles"])


def test_fullres_cleanup_warns_without_rles():
    """`tpu.fullres_cleanup` with `test.output_rles false`: the warning of
    the JAX package, and the low-res cleanup (the same detections as
    without the mode)."""
    image = _image(22, (200, 256, 3))
    noise = np.random.default_rng(22).uniform(size=48 * 48).astype(
        np.float32)
    with port_warnings() as warned:
        pm = CrowdSAM(modify_config(load_config(None), list(TINY) + [
            "tpu.fullres_cleanup", "true"]), device="cpu")
    assert any("output_rles is off" in w for w in warned)
    plain = CrowdSAM(modify_config(load_config(None), list(TINY)),
                     device="cpu")
    a = pm.generate(image, noise=[noise])
    b = plain.generate(image, noise=[noise])
    np.testing.assert_array_equal(a["boxes"], b["boxes"])
    np.testing.assert_array_equal(a["scores"], b["scores"])


@pytest.mark.parametrize("selection", ["max_iou", "max_area", "min_area"])
def test_select_mask_matches_jax(selection):
    """The mask choice on drawn logits, spatial (K, 4, R, R) and packed
    (K, 4, R*R/16, 16), against the JAX `_select_mask`; prompt 0's four
    masks tie in area and IoU (all four the same), so every rule takes
    mask 0."""
    rng = np.random.default_rng(3)
    k, r = 6, 32
    logits = rng.normal(size=(k, 4, r, r)).astype(np.float32)
    logits += rng.normal(size=(k, 4, 1, 1)).astype(np.float32)
    iou = rng.uniform(size=(k, 4)).astype(np.float32)
    logits[0] = logits[0, 2]
    iou[0] = 0.5
    want = np.asarray(jax_engine._select_mask(
        jax_engine.EngineConfig(mask_selection=selection),
        jnp.asarray(logits), jnp.asarray(iou)))
    cfg = EngineConfig(mask_selection=selection)
    spatial = torch.from_numpy(logits)
    got = select_mask(cfg, spatial, torch.from_numpy(iou))
    got_packed = select_mask(cfg, pack_spatial(spatial), torch.from_numpy(iou))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got_packed.numpy(), want)
    assert want[0] == 0 and len(set(want.tolist())) > 1


@pytest.mark.parametrize("cleanup,in_hw", [(100.0, (200, 256)),
                                           (400.0, (256, 192))])
def test_fullres_survivor_core_matches_jax(cleanup, in_hw):
    """The survivor pass under `fullres_cleanup` (the cleanup on the
    upsampled 256^2 masks with the unscaled area) against the JAX
    `make_survivor_pass` of the same config on the same bf16 logits:
    summary columns 0-9 and 11 equal, n_changes equal where neither side
    overflowed (JAX off the TPU keeps 8 change rows a column, the port
    24), the bitmap equal, and the masks' holes and islands removed."""
    from scipy.ndimage import gaussian_filter

    r, s, k = 64, 256, 6
    kw = dict(img_size=s, low_res=r, min_mask_region_area=cleanup,
              fullres_cleanup=True)
    x = gaussian_filter(np.random.default_rng(k).normal(size=(k, r, r)),
                        sigma=(0, 3, 3))
    x = (x - np.median(x, axis=(1, 2), keepdims=True)) * 40
    x[-1] = -5.0                                # one empty mask
    logits = torch.tensor(x, dtype=torch.float32).bfloat16()
    want = jax_engine.make_survivor_pass(jax_engine.EngineConfig(**kw), True)(
        jnp.asarray(logits.float().numpy(), jnp.bfloat16), jnp.int32(k),
        jnp.asarray(in_hw, jnp.int32))
    got = survivor_core(EngineConfig(**kw), logits,
                        torch.tensor(in_hw, dtype=torch.int32), True)
    ws, gs = np.asarray(want["summary"]), got["summary"].numpy()
    assert ws[:, 1].sum() >= 2                  # the cleanup changed masks
    np.testing.assert_array_equal(gs[:, :10], ws[:, :10])
    np.testing.assert_array_equal(gs[:, 11], ws[:, 11])
    maxc = jax_engine.EngineConfig().max_rle_changes
    both = ~got["overflow"].numpy() & (ws[:, 10] <= maxc)
    np.testing.assert_array_equal(gs[both, 10], ws[both, 10])
    np.testing.assert_array_equal(got["packed"].numpy(),
                                  np.asarray(want["packed"]))


def test_inter_crop_nms_keeps_rles_info_per_crop(monkeypatch):
    """With crop layers and more detections than twice the crops, the
    inter-crop NMS keeps `rles_info` (two entries a crop) out of its row
    filter; the JAX package filters it by detection and raises (a fault the
    port does not copy).  Each of the five crops gives four detections far
    apart (some coincide where the crops overlap), so the NMS keeps more
    than ten."""
    from crowdsam_tpu.ops.amg import MaskData as JaxMaskData

    from crowdsam_tpu_torch.ops.amg import MaskData

    def crop_data(cls, crop_box):
        x0, y0 = crop_box[:2]
        boxes = np.asarray([[x0 + 30 * i, y0 + 30 * i, x0 + 30 * i + 10,
                             y0 + 30 * i + 10] for i in range(4)], float)
        return cls(boxes=boxes, scores=np.linspace(0.5, 0.9, 4),
                   iou_preds=np.ones(4), rles=[None] * 4,
                   rles_info=[list(crop_box), [200, 256]],
                   crop_boxes=np.asarray([crop_box] * 4))

    opts = list(TINY) + ["test.crop_n_layers", "1"]
    pm = CrowdSAM(modify_config(load_config(None), opts), device="cpu")
    pm_crops = []
    monkeypatch.setattr(pm, "_dispatch_crop", lambda image, crop_box, noise:
                        (pm_crops.append(crop_box), crop_box))
    monkeypatch.setattr(pm, "_finalize_crop",
                        lambda res, crop_box: crop_data(MaskData, crop_box))
    data = pm.generate(_image(23, (200, 256, 3)))
    assert len(data["boxes"]) > 10
    assert data["rles_info"] == [e for cb in pm_crops for e in (
        list(cb), [200, 256])]
    jm = JaxCrowdSAM(jax_modify_config(jax_load_config(None), list(opts)))
    monkeypatch.setattr(jm, "_process_crop", lambda image, crop_box:
                        crop_data(JaxMaskData, crop_box))
    with pytest.raises(IndexError):
        jm.generate(_image(23, (200, 256, 3)))
