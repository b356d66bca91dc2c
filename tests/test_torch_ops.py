"""The port's tensor and host ops against the JAX package's: resizes (at
the pipeline's exact shapes), transforms, boxes, AMG helpers, NMS with tied
scores, and the small-region cleanup where the hop cap binds.

Floats agree to 1e-5 (float32 matrix products in another order); masks,
boxes, keep masks and integer results agree exactly.  The host image
resizes are held to one grey level of cv2 and PIL, which they replace."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crowdsam_tpu.ops import amg as jamg
from crowdsam_tpu.ops import boxes as jboxes
from crowdsam_tpu.ops import connected as jcc
from crowdsam_tpu.ops import nms as jnms
from crowdsam_tpu.ops import resize as jresize
from crowdsam_tpu.ops import transforms as jtf

from crowdsam_tpu_torch.ops import amg, boxes, connected, nms, resize
from crowdsam_tpu_torch.ops import transforms as tf

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape,out", [
    ((1, 1024, 1024, 3), (1, 1022, 1022, 3)),     # DINO input
    ((1, 73, 73, 8), (1, 256, 256, 8)),            # FG map / DINO proj
    ((1, 2, 256, 256), (1, 2, 192, 192)),          # sim map (NCHW axes)
])
def test_linear_resize_matches_jax(shape, out):
    x = np.random.default_rng(0).normal(0, 1, shape).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), out, "linear", antialias=False)
    axes = (-3, -2) if shape[-1] in (3, 8) else (-2, -1)
    hw = tuple(out[a] for a in axes)
    got = resize.resize_linear(torch.from_numpy(x), hw, axes=axes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bicubic_matches_jax():
    x = np.random.default_rng(1).normal(0, 1, (1, 37, 37, 4)).astype(
        np.float32)
    want = jresize.resize_bicubic_torch(jnp.asarray(x), (73, 73))
    got = resize.resize_bicubic_torch(torch.from_numpy(x), (73, 73))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("hw,max_size", [((300, 200), 256),
                                         ((120, 90), 256), ((256, 64), 256)])
def test_resize_image_within_one_level_of_cv2(hw, max_size):
    img = np.random.default_rng(2).integers(0, 255, (*hw, 3), dtype=np.uint8)
    want, r_want = jtf.resize_image(img, max_size)
    got, r_got = tf.resize_image(img, max_size)
    assert got.shape == want.shape and r_got == r_want
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_resize_longest_side_matches_reference():
    img = np.random.default_rng(3).integers(0, 255, (300, 200, 3),
                                            dtype=np.uint8)
    want_t, got_t = jtf.ResizeLongestSide(128), tf.ResizeLongestSide(128)
    want, got = want_t.apply_image(img), got_t.apply_image(img)
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    coords = np.asarray([[10.0, 20.0], [199.0, 299.0]])
    np.testing.assert_allclose(got_t.apply_coords(coords, (300, 200)),
                               want_t.apply_coords(coords, (300, 200)))
    bx = np.asarray([[1.0, 2.0, 150.0, 250.0]])
    np.testing.assert_allclose(got_t.apply_boxes(bx, (300, 200)),
                               want_t.apply_boxes(bx, (300, 200)))
    assert tf.get_preprocess_shape(683, 1024, 1024) == \
        jtf.get_preprocess_shape(683, 1024, 1024)


def _random_masks(seed, n=6, h=32, w=40):
    rng = np.random.default_rng(seed)
    m = rng.random((n, h // 4, w // 4)) > 0.6
    m = np.repeat(np.repeat(m, 4, axis=1), 4, axis=2)
    m[0] = False                                    # an empty mask
    return m


def test_boxes_and_amg_match_jax():
    rng = np.random.default_rng(4)
    m = _random_masks(4)
    np.testing.assert_array_equal(
        amg.batched_mask_to_box(torch.from_numpy(m)).numpy(),
        np.asarray(jamg.batched_mask_to_box(jnp.asarray(m))))
    logits = rng.normal(0, 2, (5, 16, 16)).astype(np.float32)
    np.testing.assert_allclose(
        amg.calculate_stability_score(torch.from_numpy(logits), 0.0,
                                      1.0).numpy(),
        np.asarray(jamg.calculate_stability_score(jnp.asarray(logits), 0.0,
                                                  1.0)), **TOL)
    b1 = rng.uniform(0, 50, (7, 4)).astype(np.float32)
    b1[:, 2:] += b1[:, :2]
    np.testing.assert_allclose(
        boxes.box_iou(torch.from_numpy(b1), torch.from_numpy(b1)).numpy(),
        np.asarray(jboxes.box_iou(jnp.asarray(b1), jnp.asarray(b1))), **TOL)
    crop, orig = [10, 0, 60, 80], [0, 0, 100, 80]
    np.testing.assert_array_equal(
        boxes.is_box_near_crop_edge(torch.from_numpy(b1), crop, orig,
                                    0.5).numpy(),
        np.asarray(jboxes.is_box_near_crop_edge(jnp.asarray(b1), crop, orig,
                                                0.5)))
    for layers in (0, 1, 2):
        assert amg.generate_crop_boxes((683, 1024), layers, 0.341) == \
            jamg.generate_crop_boxes((683, 1024), layers, 0.341)


def test_mask_data_filter_and_cat():
    d = amg.MaskData(boxes=np.arange(12.0).reshape(3, 4),
                     scores=torch.tensor([0.1, 0.5, 0.9]),
                     rles=["a", "b", "c"])
    d.filter(np.asarray([True, False, True]))
    d.cat(amg.MaskData(boxes=np.zeros((1, 4)), scores=torch.tensor([0.2]),
                       rles=["d"]))
    d.to_numpy()
    assert d["rles"] == ["a", "c", "d"]
    np.testing.assert_allclose(d["scores"], [0.1, 0.9, 0.2])
    assert d["boxes"].shape == (3, 4)
    with pytest.raises(TypeError):
        d["x"] = 3


def test_nms_with_tied_scores_matches_jax():
    """Tied scores resolve by index (stable sort) on both sides; invalid
    rows never keep or suppress."""
    rng = np.random.default_rng(5)
    b = rng.uniform(0, 40, (40, 4)).astype(np.float32)
    b[:, 2:] = b[:, :2] + rng.uniform(5, 30, (40, 2))
    b[20:30] = b[0]                                   # duplicates
    scores = np.round(rng.uniform(0, 1, 40), 1).astype(np.float32)
    scores[20:30] = scores[0]                         # tied duplicates
    valid = rng.random(40) > 0.2
    for v in (None, valid):
        want = jnms.nms_mask(jnp.asarray(b), jnp.asarray(scores), 0.5,
                             None if v is None else jnp.asarray(v))
        got = nms.nms_mask(torch.from_numpy(b), torch.from_numpy(scores),
                           0.5, None if v is None else torch.from_numpy(v))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    cats = (np.arange(40) % 2).astype(np.int32)
    np.testing.assert_array_equal(
        nms.nms_indices(torch.from_numpy(b), torch.from_numpy(scores),
                        torch.from_numpy(cats), 0.5),
        jnms.nms_indices(jnp.asarray(b), jnp.asarray(scores),
                         jnp.asarray(cats), 0.5))


def _snake(h=24, w=24):
    """A long one-pixel-wide snake (diameter far above a few sweeps) plus
    small blobs and holes."""
    m = np.zeros((h, w), bool)
    for r in range(1, h - 1, 4):
        m[r, 1:w - 1] = True
        c = w - 2 if (r // 4) % 2 == 0 else 1
        m[r:r + 4, c] = True
    m[h - 2, 1:w - 1] = True
    out = np.stack([m, ~m, np.zeros_like(m)])
    out[2, 3:6, 3:6] = True
    out[2, 10:20, 10:20] = True
    out[2, 14, 14] = False
    return out


@pytest.mark.parametrize("area,max_iters", [
    (6.25, 192),     # the main path: bounded-hop window test
    (3.0, 192),
    (40.0, 1),       # global sweeps, capped after one: the cap binds
    (40.0, 2),
    (40.0, 192),     # converged
    (500.0, 1),
])
@pytest.mark.parametrize("mode", ["holes", "islands"])
def test_remove_small_regions_matches_jax(area, max_iters, mode):
    rng = np.random.default_rng(6)
    masks = np.concatenate([_snake(), rng.random((3, 24, 24)) > 0.55])
    want = jcc.remove_small_regions(jnp.asarray(masks), area, mode,
                                    max_iters=max_iters)
    got = connected.remove_small_regions(torch.from_numpy(masks), area, mode,
                                         max_iters=max_iters)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_hop_cap_binds_on_the_snake():
    """With one sweep the snake's labels have not converged: the capped
    labelling differs from the converged one, on both sides alike."""
    m = torch.from_numpy(_snake()[:1])
    capped = connected.label_components(m, max_iters=1)
    full = connected.label_components(m, max_iters=192)
    assert (capped != full).any()
    np.testing.assert_array_equal(
        capped.numpy(), np.asarray(jcc.label_components(jnp.asarray(
            m.numpy()), max_iters=1)))
