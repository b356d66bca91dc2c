"""The port's `tpu.rect_encode` against the JAX package's rect path on the
CPU (a documented deviation from the square encode, PARITY.md #9: the port
holds the JAX rect path, not the square one), on the tiny config of
`tests/test_torch_pipeline.py` with the same weights and engine noise.

Tolerances: features and DINOv2 tokens within 1e-4 relative L2 (float32 on
both sides, summed in other orders); detections as in
`tests/test_torch_pipeline.py` (count, boxes within 0.5 px, scores within
1e-4); a square input identical to the square path; DINOv2's positional
embedding at `pos_hw` within 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_modes import (  # noqa: F401 (autouse fixture)
    _one_torch_thread,
    build_pair,
)
from test_torch_pipeline import TINY, _image, _next_noise

from crowdsam_tpu_torch.config import load_config, modify_config
from crowdsam_tpu_torch.ops.resize import resize_linear, resize_linear_band
from crowdsam_tpu_torch.pipeline.crowdsam import CrowdSAM

RECT = list(TINY) + ["tpu.rect_encode", "true"]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.fixture(scope="module")
def rect_pair():
    jm, pm = build_pair(RECT)
    assert jm.predictor.rect_encode and pm.predictor.rect_encode
    return jm, pm


@pytest.mark.parametrize("hw", [(160, 256), (256, 160)])
def test_rect_encode_matches_jax(rect_pair, hw):
    """A 160x256 and a 256x160 frame: 64 px upload buckets, the band's
    features and DINOv2 tokens zero-padded back to the square grids, then
    the same detections as the JAX rect path."""
    jm, pm = rect_pair
    image = _image(41 + hw[0], hw + (3,))
    assert pm.predictor.encode_bucket_hw(*hw) == jm.predictor.encode_bucket_hw(
        *hw) == tuple(-(-n // 64) * 64 for n in hw)
    for m in (jm, pm):
        m.crop_image(image, [0, 0, hw[1], hw[0]])
        m.predictor.set_image_presized(m.image)
    for key in ("features", "dino_feats"):
        want = np.asarray(getattr(jm.predictor, key))
        got = getattr(pm.predictor, key).numpy()
        assert got.shape == want.shape
        assert _rel(got, want) < 1e-4, key
    # Zero beyond the band: the bucket's 192 px reach 14 of DINOv2's 18
    # patch rows (or columns) and 12 of SAM's 16.
    dino, feats = pm.predictor.dino_feats[0], pm.predictor.features[0]
    if hw[0] > hw[1]:
        dino, feats = dino.transpose(0, 1), feats.transpose(0, 1)
    assert not dino[:14].eq(0).all() and dino[14:].eq(0).all()
    assert not feats[:12].eq(0).all() and feats[12:].eq(0).all()
    noise = _next_noise(jm)
    want = jm.generate(image)
    got = pm.generate(image, noise=[noise])
    assert len(got["boxes"]) == len(want["boxes"]) > 0
    np.testing.assert_allclose(got["boxes"], want["boxes"], atol=0.5)
    np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-4)
    np.testing.assert_array_equal(got["categories"], want["categories"])


def test_rect_encode_square_input_identical():
    """With a square input the rect branch is inert: the same detections
    as the square pipeline (the port's mirror of the JAX package's
    test)."""
    image = _image(43, (256, 256, 3))
    noise = np.random.default_rng(43).uniform(size=48 * 48).astype(
        np.float32)
    a = CrowdSAM(modify_config(load_config(None), list(TINY)),
                 device="cpu").generate(image, noise=[noise])
    b = CrowdSAM(modify_config(load_config(None), list(RECT)),
                 device="cpu").generate(image, noise=[noise])
    assert len(a["boxes"]) == len(b["boxes"]) > 0
    np.testing.assert_allclose(a["boxes"], b["boxes"], atol=1e-5)
    np.testing.assert_allclose(a["scores"], b["scores"], atol=1e-6)


def test_dino_pos_hw_matches_jax():
    """DINOv2 at a rect grid with `pos_hw` (the positional embedding
    interpolated to the square grid, then cropped) against the JAX
    module, same weights."""
    from crowdsam_tpu.models.dinov2 import dino_model_registry as jax_dinos
    from crowdsam_tpu.utils.checkpoint import jax_tree_to_numpy
    from crowdsam_tpu.utils.init import fast_random_init

    from crowdsam_tpu_torch.models.dinov2 import dino_model_registry
    from crowdsam_tpu_torch.utils.weights import dino_state_dict_from_jax

    jdino = jax_dinos["dinov2_vits14"]()
    params = fast_random_init(jdino, jnp.zeros((1, 28, 28, 3), jnp.float32),
                              seed=5)
    pdino = dino_model_registry["dinov2_vits14"]()
    pdino.load_state_dict(dino_state_dict_from_jax(jax_tree_to_numpy(params)))
    x = np.random.default_rng(5).normal(size=(1, 56, 84, 3)).astype(
        np.float32)
    want = jdino.apply({"params": params}, jnp.asarray(x), pos_hw=(9, 9))
    with torch.no_grad():
        got = pdino(torch.from_numpy(x), pos_hw=(9, 9))
    np.testing.assert_allclose(got["x_norm_patchtokens"].numpy(),
                               np.asarray(want["x_norm_patchtokens"]),
                               atol=1e-5, rtol=1e-5)


def test_band_resize_equals_square_resize_cut():
    """The rect DINOv2 input: the band's cut resize equals the square
    frame's resize (zero beyond the band), cut to the band's patch rows
    and columns."""
    s, d = 64, 58
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(1, 40, 64, 3)).astype(np.float32))
    frame = torch.zeros((1, s, s, 3))
    frame[:, :40] = x
    want = resize_linear(frame, (d, d))[:, :42, :56]
    got = resize_linear_band(x, s, d, (42, 56))
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
