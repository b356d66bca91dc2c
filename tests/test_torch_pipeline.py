"""The port's whole slice against the JAX package on the CPU: the tiny
CrowdSAM config (vit_tiny + dinov2_vits14, float32) with `test.output_rles`
and `tpu.fused_decode` both ways (true is the default of both), the same
weights through the weight bridge, and the engine noise JAX draws from its
key.

Tolerances: the FG map and the engine's per-row floats agree to 1e-4 (two
float32 implementations of the same graph, summed in other orders);
detections must match in count and category, boxes within 0.5 px and
scores within 1e-4; RLE strings are equal, or their masks differ only at
pixels whose float32 upsampled logit lies within 1e-5 of the threshold
(the two packages upsample in another order of operations); the survivor
pass's summary is equal."""

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import crowdsam_tpu.pipeline.engine as jax_engine
from crowdsam_tpu.config import load_config as jax_load_config
from crowdsam_tpu.config import modify_config as jax_modify_config
from crowdsam_tpu.pipeline.crowdsam import CrowdSAM as JaxCrowdSAM
from crowdsam_tpu.utils.checkpoint import jax_tree_to_numpy

from crowdsam_tpu_torch.config import load_config, modify_config
from crowdsam_tpu_torch.ops.rle import coco_decode_rle
from crowdsam_tpu_torch.pipeline.crowdsam import CrowdSAM
from crowdsam_tpu_torch.pipeline.engine import EngineConfig, survivor_core
from crowdsam_tpu_torch.utils.weights import (
    dino_state_dict_from_jax,
    sam_state_dict_from_jax,
)

TINY = [
    "model.sam_model", "vit_tiny",
    "model.dino_model", "dinov2_vits14",
    "model.sam_checkpoint", "",
    "model.dino_checkpoint", "",
    "model.sam_adapter_checkpoint", "",
    "test.max_size", "256",
    "test.grid_size", "48",
    "test.max_prompts", "64",
    "test.points_per_batch", "8",
    "test.pred_iou_thresh", "0.0",
    "test.stability_score_thresh", "0.0",
    "test.pos_sim_thresh", "0.3",
    "tpu.compute_dtype", "float32",
    "test.output_rles", "false",
]
TINY_RLES = TINY[:-2]           # test.output_rles left at its default, true
FUSED = pytest.mark.parametrize("pair", ["false", "true"], indirect=True,
                                ids=["unfused", "fused"])


@pytest.fixture(scope="module")
def pair(request):
    """The JAX model and the port's with the same weights, for one setting
    of `tpu.fused_decode` (unfused where a test does not say), or of
    (`tpu.fused_decode`, `test.output_rles`)."""
    param = getattr(request, "param", "false")
    fused, rles = param if isinstance(param, tuple) else (param, "false")
    opts = list(TINY_RLES if rles == "true" else TINY) + [
        "tpu.fused_decode", fused]
    jm = JaxCrowdSAM(jax_modify_config(jax_load_config(None), list(opts)))
    pm = CrowdSAM(modify_config(load_config(None), list(opts)), device="cpu")
    assert pm.engine_cfg.fused_decode == jm.engine_cfg.fused_decode
    # flax creates no parameters for the decoder's unused 5th hypernetwork
    # MLP, so a JAX-initialized tree lacks exactly those keys.
    missing, unexpected = pm.sam.load_state_dict(
        sam_state_dict_from_jax(jax_tree_to_numpy(jm.sam.params)),
        strict=False)
    assert not unexpected
    assert {k.split(".layers.")[0] for k in missing} == {
        "mask_decoder.output_hypernetworks_mlps.4"}
    pm.dino.load_state_dict(
        dino_state_dict_from_jax(jax_tree_to_numpy(jm.predictor.dino_params)),
        strict=True)
    return jm, pm


def _image(seed, shape):
    return np.random.default_rng(seed).integers(0, 255, shape, dtype=np.uint8)


def _next_noise(jm):
    """The vector the JAX model's next crop draws (crowdsam.py:660 split,
    engine.py:267 uniform), without advancing its key."""
    _, sub = jax.random.split(jm._key)
    n = jm.engine_cfg.grid_size ** 2
    return np.asarray(jax.random.uniform(sub, (n,)))


def _survivor_logits(pm):
    """The slab logits of the port's last detections, in output order (a
    single crop): the engine's valid rows kept by the survivor pass."""
    res = pm.last_engine
    idx = torch.nonzero(res["summary"][:, 0] > 0.5).flatten()
    in_hw = torch.tensor(pm.image.shape[:2], dtype=torch.int32)
    sp = survivor_core(pm.engine_cfg, res["logits"][idx], in_hw, True)
    return res["logits"][idx[sp["summary"][:, 0] > 0.5]]


def _rle_flips_near_threshold(pm, got, want):
    """Pixels where the masks of unequal RLE strings differ; each must have
    a float32 upsampled logit (jax.image.resize of the survivor's slab
    logits) within 1e-5 of the threshold.  Returns their count."""
    logits = None
    flips = 0
    for i, (a, b) in enumerate(zip(got, want)):
        if a == b:
            continue
        if logits is None:
            logits = _survivor_logits(pm)
        s = pm.engine_cfg.img_size
        up = np.asarray(jax.image.resize(
            jnp.asarray(logits[i].float().numpy()), (s, s), "linear",
            antialias=False))[:a["size"][0], :a["size"][1]]
        diff = coco_decode_rle(a) != coco_decode_rle(b)
        near = np.abs(up - pm.engine_cfg.mask_threshold) <= 1e-5
        assert near[diff].all(), f"detection {i}: flips away from the " \
                                 "threshold"
        flips += int(diff.sum())
    return flips


@pytest.mark.parametrize("pair", [("false", "false"), ("true", "false"),
                                  ("false", "true"), ("true", "true")],
                         indirect=True, ids=["unfused", "fused",
                                             "unfused-rles", "fused-rles"])
@pytest.mark.parametrize("seed,shape", [(1, (200, 256, 3)),
                                        (2, (256, 192, 3))])
def test_generate_matches_jax(pair, seed, shape):
    """With `test.output_rles` true the boxes of nonempty masks are the
    full-resolution ones (K7's plain version against the JAX XLA tail)."""
    jm, pm = pair
    image = _image(seed, shape)
    noise = _next_noise(jm)
    want = jm.generate(image)
    got = pm.generate(image, noise=[noise])
    assert len(got["boxes"]) == len(want["boxes"]) > 0
    np.testing.assert_allclose(got["boxes"], want["boxes"], atol=0.5)
    np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-4)
    np.testing.assert_array_equal(got["categories"], want["categories"])
    np.testing.assert_allclose(got["points"], want["points"], atol=1e-3)
    if not pm.output_rles:
        assert got["rles"] == [None] * len(got["boxes"])
        return
    assert all(isinstance(r["counts"], str) for r in got["rles"])
    assert [r["size"] for r in got["rles"]] == [list(image.shape[:2])] * len(
        got["rles"])
    flips = _rle_flips_near_threshold(pm, got["rles"], want["rles"])
    print(f"RLE pixels flipped at the threshold: {flips}")


@pytest.mark.parametrize("cleanup,in_hw", [(100.0, (200, 256)),
                                           (0.0, (256, 192)),
                                           (400.0, (256, 256))])
def test_survivor_core_with_masks_matches_jax(cleanup, in_hw):
    """The engine's survivor pass with masks against the JAX package's
    `make_survivor_pass(cfg, True)` on the same bf16 slab: summary columns
    0-5 (keep, changed, low-res boxes), 6-9 (full-res boxes) and 11
    (nonempty) equal; n_changes equal where neither side overflowed (JAX
    on the CPU keeps 8 change rows a column, K7 24)."""
    from scipy.ndimage import gaussian_filter

    r, s, k = 64, 256, 6
    kw = dict(img_size=s, low_res=r, min_mask_region_area=cleanup)
    x = gaussian_filter(np.random.default_rng(k).normal(size=(k, r, r)),
                        sigma=(0, 5, 5))
    x = (x - np.median(x, axis=(1, 2), keepdims=True)) * 40
    x[-1] = -5.0                                # one empty mask
    logits = torch.tensor(x, dtype=torch.float32).bfloat16()
    want = jax_engine.make_survivor_pass(jax_engine.EngineConfig(**kw), True)(
        jnp.asarray(logits.float().numpy(), jnp.bfloat16), jnp.int32(k),
        jnp.asarray(in_hw, jnp.int32))
    got = survivor_core(EngineConfig(**kw), logits,
                        torch.tensor(in_hw, dtype=torch.int32), True)
    ws, gs = np.asarray(want["summary"]), got["summary"].numpy()
    np.testing.assert_array_equal(gs[:, :10], ws[:, :10])
    np.testing.assert_array_equal(gs[:, 11], ws[:, 11])
    maxc = jax_engine.EngineConfig().max_rle_changes
    both = ~got["overflow"].numpy() & (ws[:, 10] <= maxc)
    assert both.sum() >= 2
    np.testing.assert_array_equal(gs[both, 10], ws[both, 10])
    assert gs[-1, 11] == 0 and (gs[-1, 6:10] == 0).all()
    np.testing.assert_array_equal(got["packed"].numpy(),
                                  np.asarray(want["packed"]))


def test_overflowing_masks_take_the_packed_bitmap():
    """A mask with a column of more changes than K7 keeps: `overflow` is
    set, n_changes is the true total, and its RLE string comes from the
    packed bitmap; every string equals the dense encoding."""
    from crowdsam_tpu_torch.ops.rle import encode_masks_coco

    r, in_hw = 64, (200, 256)
    logits = torch.full((3, r, r), -1.0)
    logits[0, ::2, 8:16] = 1.0                  # stripes: 25+ changes a column
    logits[1, 10:40, 20:30] = 1.0
    cfg = EngineConfig(img_size=4 * r, low_res=r, min_mask_region_area=0.0)
    sp = survivor_core(cfg, logits.bfloat16(),
                       torch.tensor(in_hw, dtype=torch.int32), True)
    assert sp["overflow"].tolist() == [True, False, False]
    np.testing.assert_array_equal(sp["summary"][:, 10].numpy(),
                                  sp["n_col"].sum(1).numpy())
    sel = np.arange(3)
    full = np.unpackbits(sp["packed"].numpy(), axis=-1)[
        :, :in_hw[0], :in_hw[1]].astype(bool)
    assert CrowdSAM._rles(sp, sel, *in_hw) == encode_masks_coco(full)


def test_generate_many_equals_generate():
    """Three images through `generate_many` and through `generate`, on two
    models built alike: the same noise from the same seed, the same
    detections and RLE strings item by item, and one time per image."""
    cfg = modify_config(load_config(None), list(TINY_RLES))
    images = [_image(10 + i, shape) for i, shape in enumerate(
        [(200, 256, 3), (256, 192, 3), (256, 256, 3)])]
    one = CrowdSAM(cfg, device="cpu")
    assert one.output_rles
    want = [one.generate(im) for im in images]
    times = []
    got = CrowdSAM(cfg, device="cpu").generate_many(images, times_out=times)
    assert len(got) == len(want) == len(times) == 3
    assert sum(len(w["boxes"]) for w in want) > 0
    for g, w in zip(got, want):
        assert set(g.keys()) == set(w.keys())
        np.testing.assert_array_equal(g["boxes"], w["boxes"])
        np.testing.assert_array_equal(g["scores"], w["scores"])
        assert g["rles"] == w["rles"]


@FUSED
def test_fg_map_and_pre_nms_slab_match_jax(pair, monkeypatch):
    jm, pm = pair
    image = _image(3, (200, 256, 3))
    crop_box = [0, 0, 256, 200]
    noise = _next_noise(jm)
    _, sub = jax.random.split(jm._key)

    jm.crop_image(image, crop_box)
    jm.predictor.set_image_presized(jm.image)
    fg_j = np.asarray(jm.predictor.predict_fg_map())
    sim = jm._sim_prep(jm.predictor.predict_fg_map())
    calls = []
    real_nms = jax_engine.nms_mask

    def spy(boxes, scores, thresh, valid=None):
        if not calls:  # the slab NMS; later calls run under tracing
            calls.append((np.asarray(boxes), np.asarray(scores),
                          np.asarray(valid)))
        return real_nms(boxes, scores, thresh, valid)

    monkeypatch.setattr(jax_engine, "nms_mask", spy)
    cfg = jm.engine_cfg
    r = cfg.grid_size / 256
    jm.engine.raw_fn(
        jm.sam.params, jm.predictor.get_image_embedding(),
        jm.predictor.dense_pe, jm.predictor.dino_proj_256, sim,
        jax.numpy.asarray((int(200 * r), int(256 * r)), jax.numpy.float32),
        jax.numpy.asarray((200, 256), jax.numpy.float32),
        jax.numpy.asarray(crop_box, jax.numpy.float32),
        jax.numpy.asarray((200, 256), jax.numpy.float32),
        jax.numpy.float32(1.0), sub)
    boxes_j, iou_j, valid_j = calls[0]

    pm.generate(image, noise=[noise])
    fg_p = pm.predictor.predict_fg_map().numpy()
    np.testing.assert_allclose(fg_p, fg_j, atol=1e-4, rtol=1e-4)
    slab = pm.last_engine["pre_nms"]
    np.testing.assert_array_equal(slab["valid"].numpy(), valid_j)
    assert valid_j.any()
    np.testing.assert_allclose(slab["iou"].numpy(), iou_j, atol=1e-4)
    np.testing.assert_array_equal(slab["boxes"].numpy(), boxes_j)


def test_config_defaults_equal_jax():
    """The port keeps its own copy of the config tree; one YAML file and
    one override list must mean the same to both packages."""
    opts = list(TINY) + ["test.crop_n_layers", "1"]
    assert load_config(None) == jax_load_config(None)
    assert (modify_config(load_config(None), list(opts))
            == jax_modify_config(jax_load_config(None), list(opts)))


def test_entry_point_raises_for_later_slices():
    cfg = modify_config(load_config(None), list(TINY) + [
        "tpu.fullres_cleanup", "true"])
    with pytest.raises(NotImplementedError, match="fullres_cleanup"):
        CrowdSAM(cfg, device="cpu")
    cfg = modify_config(load_config(None), list(TINY) + [
        "tpu.rect_encode", "true"])
    with pytest.raises(NotImplementedError, match="rect_encode"):
        CrowdSAM(cfg, device="cpu")


def test_fused_decode_is_the_default_and_matches_unfused():
    """`tpu.fused_decode` defaults to true, as in `configs/crowdhuman.yaml`,
    and the port's two branches give the same detections (float32: scores
    within 1e-4, boxes equal)."""
    image = _image(6, (200, 256, 3))
    noise = np.random.default_rng(6).uniform(size=48 * 48).astype(np.float32)
    out = {}
    for fused in ("true", "false"):
        pm = CrowdSAM(modify_config(load_config(None), list(TINY) + [
            "tpu.fused_decode", fused]), device="cpu")
        assert pm.engine_cfg.fused_decode == (fused == "true")
        out[fused] = pm.generate(image, noise=[noise])
    assert CrowdSAM(modify_config(load_config(None), list(TINY)),
                    device="cpu").engine_cfg.fused_decode
    assert len(out["true"]["boxes"]) == len(out["false"]["boxes"]) > 0
    np.testing.assert_array_equal(out["true"]["boxes"], out["false"]["boxes"])
    np.testing.assert_allclose(out["true"]["scores"], out["false"]["scores"],
                               atol=1e-4)


def test_generate_draws_seeded_noise():
    """Without given noise the order comes from the model's seeded
    generator: two models built alike give the same detections."""
    cfg = modify_config(load_config(None), list(TINY))
    image = _image(4, (256, 200, 3))
    a = CrowdSAM(cfg, device="cpu").generate(image)
    b = CrowdSAM(cfg, device="cpu").generate(image)
    np.testing.assert_array_equal(a["boxes"], b["boxes"])
    np.testing.assert_array_equal(a["scores"], b["scores"])
    assert torch.get_default_dtype() == torch.float32


def test_crop_loop_and_inter_crop_nms_match_jax(monkeypatch):
    """crop_n_layers 1: five crops, each through the engine with its own
    noise, then the inter-crop NMS.  Both sides resize the crops with cv2
    here, so the comparison isolates the crop loop (the port's own resize
    is held to cv2 in test_torch_ops)."""
    import crowdsam_tpu_torch.pipeline.crowdsam as port_pipeline
    from crowdsam_tpu.ops.transforms import resize_image as cv2_resize

    opts = list(TINY) + ["test.crop_n_layers", "1"]
    jm = JaxCrowdSAM(jax_modify_config(jax_load_config(None), list(opts)))
    pm = CrowdSAM(modify_config(load_config(None), list(opts)), device="cpu")
    pm.sam.load_state_dict(
        sam_state_dict_from_jax(jax_tree_to_numpy(jm.sam.params)),
        strict=False)
    pm.dino.load_state_dict(
        dino_state_dict_from_jax(jax_tree_to_numpy(jm.predictor.dino_params)))
    monkeypatch.setattr(port_pipeline, "resize_image", cv2_resize)
    image = _image(5, (200, 256, 3))
    key, noise = jm._key, []
    for _ in range(5):
        key, sub = jax.random.split(key)
        noise.append(np.asarray(jax.random.uniform(
            sub, (jm.engine_cfg.grid_size ** 2,))))
    want = jm.generate(image)
    got = pm.generate(image, noise=noise)
    assert len(got["boxes"]) == len(want["boxes"]) > 0
    np.testing.assert_allclose(got["boxes"], want["boxes"], atol=0.5)
    np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-4)


def test_torch_checkpoints_load_by_reference_keys(tmp_path):
    """A torch state dict with the reference's keys loads through the
    config's checkpoint paths (non-strictly, as the reference loads)."""
    src = CrowdSAM(modify_config(load_config(None), list(TINY)), device="cpu")
    torch.save(src.sam.state_dict(), tmp_path / "sam.pth")
    torch.save(src.dino.state_dict(), tmp_path / "dino.pth")
    opts = list(TINY) + ["environ.seed", "7",
                         "model.sam_checkpoint", str(tmp_path / "sam.pth"),
                         "model.dino_checkpoint", str(tmp_path / "dino.pth")]
    dst = CrowdSAM(modify_config(load_config(None), opts), device="cpu")
    for a, b in ((src.sam, dst.sam), (src.dino, dst.dino)):
        for k, v in a.state_dict().items():
            torch.testing.assert_close(b.state_dict()[k], v, rtol=0, atol=0)


@pytest.mark.parametrize("seed,hw", [(3, (683, 1024)), (11, (240, 320))])
def test_crowd_scene_matches_jax_fixture(seed, hw):
    """The port's copy of the bench fixture's crowd scene: the same drawn
    persons and a frame within one grey level of the JAX package's (its
    background upsample is PIL's BILINEAR written out in numpy)."""
    from crowdsam_tpu.utils.bench_fixture import crowd_scene as jax_scene

    from crowdsam_tpu_torch.utils.synthetic import crowd_scene

    want_img, want_boxes = jax_scene(seed, *hw)
    got_img, got_boxes = crowd_scene(seed, *hw)
    assert got_boxes == want_boxes and got_img.shape == want_img.shape
    diff = np.abs(got_img.astype(np.int16) - want_img.astype(np.int16))
    assert diff.max() <= 1
