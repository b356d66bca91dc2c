"""The JAX package's random weights drawn by the port (`utils/init.py`)
against `crowdsam_tpu.utils.init.fast_random_init` / `init_sam_params`, and
the slice built from one config with no checkpoints in both packages.

Tolerances: the manifest and every drawn leaf are equal (the draws are
numpy's on both sides), bit for bit; `generate` of the two models on one
frame and one noise vector within the bounds of `test_torch_pipeline.py`
(the same count and categories, boxes within 0.5 px, scores within 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from crowdsam_tpu.config import load_config as jax_load_config
from crowdsam_tpu.config import modify_config as jax_modify_config
from crowdsam_tpu.models import build as jax_build
from crowdsam_tpu.models.dinov2 import dino_model_registry as jax_dinos
from crowdsam_tpu.pipeline.crowdsam import CrowdSAM as JaxCrowdSAM
from crowdsam_tpu.utils.checkpoint import jax_tree_to_numpy
from crowdsam_tpu.utils.init import fast_random_init

from crowdsam_tpu_torch.config import load_config, modify_config
from crowdsam_tpu_torch.pipeline.crowdsam import CrowdSAM
from crowdsam_tpu_torch.utils import init
from crowdsam_tpu_torch.utils.weights import (
    dino_state_dict_from_jax,
    sam_state_dict_from_jax,
)

SAM_ARCHS = ("vit_l", "vit_b", "vit_tiny")
DINO_ARCHS = ("dinov2_vitl14", "dinov2_vits14")


def _modules(arch, **kw):
    """The JAX arch's three modules, built without drawing parameters."""
    got = {}

    def grab(ie, pe, md, **_):
        got.update(ie=ie, pe=pe, md=md)
        return {}

    real = jax_build.init_sam_params
    jax_build.init_sam_params = grab
    try:
        jax_build.sam_model_registry[arch](dtype=jnp.float32, **kw)
    finally:
        jax_build.init_sam_params = real
    return got["ie"], got["pe"], got["md"]


def _eval_shapes(module, *args, **kw):
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), *args, **kw))["params"]
    return [("/".join(p), tuple(l.shape))
            for p, l in traverse_util.flatten_dict(shapes).items()]


def _sam_shapes(arch, **kw):
    ie, pe, md = _modules(arch, **kw)
    img = jnp.zeros((1, ie.img_size, ie.img_size, 3), jnp.float32)
    h = ie.img_size // ie.patch_size
    pts = (jnp.zeros((1, 1, 2), jnp.float32), jnp.ones((1, 1), jnp.int32))
    return {
        "image_encoder": _eval_shapes(ie, img),
        "prompt_encoder": _eval_shapes(
            pe, points=pts, masks=jnp.zeros((1, 4 * h, 4 * h, 1))),
        "mask_decoder": _eval_shapes(
            md, jnp.zeros((1, h, h, 256)), jnp.zeros((h, h, 256)),
            jnp.zeros((1, 2, 256)), jnp.zeros((1, h, h, 256)), True,
            dino_feats_proj=jnp.zeros((4 * h, 4 * h, 256))),
    }


@pytest.mark.parametrize("arch", SAM_ARCHS)
def test_sam_manifest_matches_eval_shape(arch):
    assert init.sam_entries(arch) == _sam_shapes(arch, n_class=1)


@pytest.mark.parametrize("arch", DINO_ARCHS)
def test_dino_manifest_matches_eval_shape(arch):
    want = _eval_shapes(jax_dinos[arch](dtype=jnp.float32),
                        jnp.zeros((1, 28, 28, 3), jnp.float32))
    got = [(p, tuple(s)) for p, s in init.manifest()["dino"][arch]]
    assert got == want


def test_config_dependent_shapes():
    """Image size (positional embedding, global rel-pos tables) and class
    count (the point classifier's last layer) away from the manifest's."""
    want = _sam_shapes("vit_tiny", n_class=3, image_size=128)
    assert init.sam_entries("vit_tiny", image_size=128, n_class=3) == want


def _leaves(tree):
    return {"/".join(k): np.asarray(v)
            for k, v in traverse_util.flatten_dict(tree).items()}


def test_sam_draws_equal_init_sam_params():
    ie, pe, md = _modules("vit_tiny", n_class=1, dino_dim=384)
    want = jax_build.init_sam_params(ie, pe, md, seed=5, dino_dim=384)
    got = init.sam_params("vit_tiny", seed=5, dino_dim=384)
    for module in ("image_encoder", "prompt_encoder", "mask_decoder"):
        a, b = _leaves(got[module]), _leaves(want[module])
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype == np.float32
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_dino_draws_equal_fast_random_init():
    module = jax_dinos["dinov2_vits14"](dtype=jnp.float32)
    want = _leaves(fast_random_init(module, jnp.zeros((1, 28, 28, 3)),
                                    seed=42))
    got = _leaves(init.dino_params("dinov2_vits14", 42))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


TINY = ["model.sam_model", "vit_tiny", "model.dino_model", "dinov2_vits14",
        "model.sam_checkpoint", "", "model.dino_checkpoint", "",
        "model.sam_adapter_checkpoint", "", "test.max_size", "256",
        "test.grid_size", "48", "test.max_prompts", "64",
        "test.points_per_batch", "8", "test.pred_iou_thresh", "0.0",
        "test.stability_score_thresh", "0.0", "test.pos_sim_thresh", "0.3",
        "tpu.compute_dtype", "float32", "test.output_rles", "false"]


@pytest.fixture(scope="module")
def pair():
    """Both packages' CrowdSAM from one config alone."""
    jm = JaxCrowdSAM(jax_modify_config(jax_load_config(None), list(TINY)))
    pm = CrowdSAM(modify_config(load_config(None), list(TINY)), device="cpu")
    return jm, pm


def test_models_from_one_config_hold_the_same_weights(pair):
    jm, pm = pair
    want = sam_state_dict_from_jax(jax_tree_to_numpy(jm.sam.params))
    got = pm.sam.state_dict()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    # The 5th hypernetwork MLP, absent from the JAX tree, is zero.
    rest = [k for k in got if k not in want]
    assert rest and all(k.startswith(
        "mask_decoder.output_hypernetworks_mlps.4.") for k in rest)
    assert all(float(got[k].abs().max()) == 0 for k in rest)
    want = dino_state_dict_from_jax(jax_tree_to_numpy(jm.predictor.dino_params))
    got = pm.dino.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_generate_from_one_config_matches(pair):
    jm, pm = pair
    image = np.random.default_rng(3).integers(0, 255, (200, 256, 3),
                                              dtype=np.uint8)
    _, sub = jax.random.split(jm._key)
    noise = np.asarray(jax.random.uniform(sub, (jm.engine_cfg.grid_size ** 2,)))
    want = jm.generate(image)
    got = pm.generate(image, noise=[noise])
    assert len(got["boxes"]) == len(want["boxes"]) > 0
    np.testing.assert_array_equal(got["categories"], want["categories"])
    np.testing.assert_allclose(got["boxes"], want["boxes"], atol=0.5)
    np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-4)


def test_checksums_of_the_tiny_draws():
    """The manifest's checksums (written with the JAX package's draws) hold
    the port's vit_tiny and dinov2_vits14 draws: elements equal, sums and
    sums of squares within 1e-9 relative (float64 sums in another order)."""
    sums = init.manifest()["checksums"]
    got = init.sam_checksums(init.sam_state_dict("vit_tiny", 0, None, 1,
                                                 384))
    dino = init.checksum(init.dino_state_dict("dinov2_vits14", 42).values())
    pairs = [(got[m], sums[f"sam/vit_tiny/0/{m}"]) for m in got]
    pairs.append((dino, sums["dino/dinov2_vits14/42"]))
    for have, want in pairs:
        assert have[0] == want[1]
        np.testing.assert_allclose(have[1:], want[2:], rtol=1e-9)
    ie, pe, md = _modules("vit_tiny", n_class=1, dino_dim=384)
    tree = jax_build.init_sam_params(ie, pe, md, seed=0, dino_dim=384)
    n, s, q = init.checksum(jax.tree_util.tree_leaves(tree["image_encoder"]))
    assert n == sums["sam/vit_tiny/0/image_encoder"][1]
    np.testing.assert_allclose([s, q], sums["sam/vit_tiny/0/image_encoder"][2:],
                               rtol=1e-9)
