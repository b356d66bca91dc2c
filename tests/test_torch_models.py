"""The port's models and predictor against the JAX package's, on the same
weights (JAX random init -> weight bridge), in float32 on the CPU: the SAM
image encoder (vit_tiny: a grid that is not a multiple of the window, one
global block), the prompt encoder, the two-way transformer and PWD-Net mask
decoder, DINOv2 with its positional-embedding interpolation, and the
predictor's encode cache and FG map.

Tolerance 2e-3 abs for whole encoders (float32 through a dozen layers, with
the attention sums in another order), 1e-4 for single modules."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crowdsam_tpu.models.build import build_sam_vit_tiny as jax_build_tiny
from crowdsam_tpu.models.dinov2 import DinoVisionTransformer as JaxDino
from crowdsam_tpu.models.sam import postprocess_masks as jax_postprocess
from crowdsam_tpu.models.sam import preprocess as jax_preprocess
from crowdsam_tpu.pipeline.predictor import SamPredictor as JaxPredictor
from crowdsam_tpu.utils.checkpoint import jax_tree_to_numpy
from crowdsam_tpu.utils.init import fast_random_init

from crowdsam_tpu_torch.models.build import build_sam_vit_tiny
from crowdsam_tpu_torch.models.dinov2 import DinoVisionTransformer
from crowdsam_tpu_torch.models.sam import postprocess_masks, preprocess
from crowdsam_tpu_torch.pipeline.predictor import SamPredictor
from crowdsam_tpu_torch.utils.weights import (
    dino_state_dict_from_jax,
    sam_state_dict_from_jax,
)

ENCODER_TOL = dict(atol=2e-3, rtol=0)
MODULE_TOL = dict(atol=1e-4, rtol=1e-4)
DINO_KW = dict(patch_size=14, embed_dim=64, depth=2, num_heads=1)


@pytest.fixture(scope="module")
def models():
    jsam = jax_build_tiny(dtype=jnp.float32, seed=0, dino_dim=64)
    jdino = JaxDino(**DINO_KW, dtype=jnp.float32)
    dparams = fast_random_init(jdino, jnp.zeros((1, 28, 28, 3)), seed=5)
    sam = build_sam_vit_tiny(dino_dim=64)
    sam.load_state_dict(sam_state_dict_from_jax(jax_tree_to_numpy(
        jsam.params)), strict=False)
    dino = DinoVisionTransformer(**DINO_KW)
    dino.load_state_dict(dino_state_dict_from_jax(jax_tree_to_numpy(dparams)),
                         strict=True)
    return jsam, jdino, dparams, sam.eval(), dino.eval()


def _rng(seed):
    return np.random.default_rng(seed)


def test_image_encoder_matches_jax(models):
    jsam, _, _, sam, _ = models
    x = _rng(0).normal(0, 1, (1, 256, 256, 3)).astype(np.float32)
    want = jsam.image_encoder.apply({"params": jsam.params["image_encoder"]},
                                    jnp.asarray(x))
    with torch.no_grad():
        got = sam.image_encoder(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ENCODER_TOL)


def test_prompt_encoder_matches_jax(models):
    jsam, _, _, sam, _ = models
    pe_j, p = jsam.prompt_encoder, {"params": jsam.params["prompt_encoder"]}
    rng = _rng(1)
    pts = rng.uniform(0, 256, (3, 2, 2)).astype(np.float32)
    labels = np.asarray([[1, 0], [1, -1], [0, 1]], np.int32)
    boxes = rng.uniform(0, 256, (3, 4)).astype(np.float32)
    masks = rng.normal(0, 1, (3, 64, 64, 1)).astype(np.float32)
    dense_pe = pe_j.apply(p, method=pe_j.get_dense_pe)
    sparse_j, dense_j = pe_j.apply(p, points=(jnp.asarray(pts),
                                              jnp.asarray(labels)),
                                   boxes=jnp.asarray(boxes),
                                   masks=jnp.asarray(masks))
    sparse_pad_j, _ = pe_j.apply(p, points=(jnp.asarray(pts),
                                            jnp.asarray(labels)))
    with torch.no_grad():
        pe = sam.prompt_encoder
        got_pe = pe.get_dense_pe()
        tp = (torch.from_numpy(pts), torch.from_numpy(labels).long())
        sparse, dense = pe(points=tp, boxes=torch.from_numpy(boxes),
                           masks=torch.from_numpy(masks))
        sparse_pad, _ = pe(points=tp)
    np.testing.assert_allclose(got_pe.numpy(), np.asarray(dense_pe),
                               **MODULE_TOL)
    np.testing.assert_allclose(sparse.numpy(), np.asarray(sparse_j),
                               **MODULE_TOL)
    np.testing.assert_allclose(sparse_pad.numpy(), np.asarray(sparse_pad_j),
                               **MODULE_TOL)
    np.testing.assert_allclose(dense.numpy(), np.asarray(dense_j),
                               **MODULE_TOL)


def test_mask_decoder_matches_jax(models):
    """The two-way transformer, upscaling, hypernetworks, IoU head and the
    PWD-Net pooling/classifier/parallel IoU head, multimask and not."""
    jsam, _, _, sam, _ = models
    rng = _rng(2)
    feats = rng.normal(0, 1, (1, 16, 16, 256)).astype(np.float32)
    dense_pe = rng.normal(0, 1, (16, 16, 256)).astype(np.float32)
    sparse = rng.normal(0, 1, (3, 2, 256)).astype(np.float32)
    dense = rng.normal(0, 1, (3, 16, 16, 256)).astype(np.float32)
    dino = rng.normal(0, 1, (64, 64, 256)).astype(np.float32)
    for multi in (True, False):
        want = jsam.mask_decoder.apply(
            {"params": jsam.params["mask_decoder"]}, jnp.asarray(feats),
            jnp.asarray(dense_pe), jnp.asarray(sparse), jnp.asarray(dense),
            multi, dino_feats_proj=jnp.asarray(dino))
        with torch.no_grad():
            got = sam.mask_decoder(*map(torch.from_numpy, (
                feats, dense_pe, sparse, dense)), multi,
                dino_feats_proj=torch.from_numpy(dino))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       **ENCODER_TOL)


def test_two_way_transformer_matches_jax(models):
    from crowdsam_tpu.models.transformer import TwoWayTransformer

    jsam, _, _, sam, _ = models
    rng = _rng(6)
    src = rng.normal(0, 1, (2, 64, 256)).astype(np.float32)
    pe = rng.normal(0, 1, (2, 64, 256)).astype(np.float32)
    tok = rng.normal(0, 1, (2, 7, 256)).astype(np.float32)
    want = TwoWayTransformer().apply(
        {"params": jsam.params["mask_decoder"]["transformer"]},
        jnp.asarray(src), jnp.asarray(pe), jnp.asarray(tok))
    with torch.no_grad():
        got = sam.mask_decoder.transformer(*map(torch.from_numpy,
                                                (src, pe, tok)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **ENCODER_TOL)


@pytest.mark.parametrize("hw", [(98, 98), (70, 112)])
def test_dinov2_matches_jax(models, hw):
    """Call grids other than the 37x37 pretrain grid: the positional
    embedding goes through the torch-bicubic interpolation."""
    _, jdino, dparams, _, dino = models
    x = _rng(3).normal(0, 1, (1, *hw, 3)).astype(np.float32)
    want = jdino.apply({"params": dparams}, jnp.asarray(x))
    with torch.no_grad():
        got = dino(torch.from_numpy(x))
    for key in ("x_norm_patchtokens", "x_norm_clstoken"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   **ENCODER_TOL)


def test_preprocess_and_postprocess_match_jax():
    rng = _rng(4)
    img = rng.integers(0, 255, (1, 200, 256, 3)).astype(np.uint8)
    np.testing.assert_allclose(
        preprocess(torch.from_numpy(img), 256).numpy(),
        np.asarray(jax_preprocess(jnp.asarray(img), 256)), **MODULE_TOL)
    low = rng.normal(0, 1, (2, 3, 64, 64)).astype(np.float32)
    np.testing.assert_allclose(
        postprocess_masks(torch.from_numpy(low), (200, 256), (150, 192),
                          256).numpy(),
        np.asarray(jax_postprocess(jnp.asarray(low), (200, 256), (150, 192),
                                   256)), **MODULE_TOL)


def test_predictor_matches_jax(models):
    """Encode cache (features, dense PE, DINO tokens on the SAM-normalized
    frame resized to the DINO input, the projected 256^2 map in bf16), the
    FG map, and a point-prompt decode."""
    jsam, jdino, dparams, sam, dino = models
    jp = JaxPredictor(jsam, jdino, dparams)
    tp = SamPredictor(sam, dino, device="cpu")
    img = _rng(5).integers(0, 255, (200, 256, 3)).astype(np.uint8)
    jp.set_image(img)
    tp.set_image(img)
    for key in ("features", "dense_pe", "dino_feats"):
        np.testing.assert_allclose(tp._cache[key].numpy(),
                                   np.asarray(jp._cache[key]), **ENCODER_TOL)
    np.testing.assert_allclose(
        tp.dino_proj_256.float().numpy(),
        np.asarray(jp.dino_proj_256.astype(jnp.float32)), atol=2e-2)
    np.testing.assert_allclose(tp.predict_fg_map().numpy(),
                               np.asarray(jp.predict_fg_map()),
                               **ENCODER_TOL)
    pts, lab = np.asarray([[60.0, 80.0]]), np.asarray([1])
    got = tp.predict(pts, lab)
    want = jp.predict(pts, lab)
    np.testing.assert_allclose(got[1], want[1], **ENCODER_TOL)   # iou
    np.testing.assert_allclose(got[2], want[2], atol=5e-3)       # low-res
    assert jax.numpy.asarray(want[0]).shape == got[0].shape
