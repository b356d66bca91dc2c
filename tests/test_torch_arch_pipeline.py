"""`CrowdSAM.generate` of the archs beside the main path against the JAX
package on the CPU: `sam_hq` (the HQ decoder, unfused decode), `mobile_sam`
(TinyViT at 256^2), vanilla `sam` with DINOv2 ViT-B/14, and `vit_h` at a
small width with head dim 80, each on a tiny configuration with the engine
noise the JAX model draws; and the options that still raise.

Tolerances as in `test_torch_pipeline.py`: the same detection count and
categories, boxes within 0.5 px, scores within 1e-4."""

import jax
import numpy as np
import pytest
import torch
from test_torch_pipeline import _one_torch_thread  # noqa: F401 (autouse fixture)

from crowdsam_tpu.config import load_config as jax_load_config
from crowdsam_tpu.config import modify_config as jax_modify_config
from crowdsam_tpu.models import build as jax_build
from crowdsam_tpu.pipeline.crowdsam import CrowdSAM as JaxCrowdSAM
from crowdsam_tpu.utils.checkpoint import jax_tree_to_numpy

from crowdsam_tpu_torch.config import load_config, modify_config
from crowdsam_tpu_torch.models import build
from crowdsam_tpu_torch.pipeline import crowdsam as port_crowdsam
from crowdsam_tpu_torch.pipeline.crowdsam import CrowdSAM
from crowdsam_tpu_torch.utils import init
from crowdsam_tpu_torch.utils.weights import (
    dino_state_dict_from_jax,
    sam_state_dict_from_jax,
)

TINY = ["model.sam_model", "vit_tiny", "model.dino_model", "dinov2_vits14",
        "model.sam_checkpoint", "", "model.dino_checkpoint", "",
        "model.sam_adapter_checkpoint", "", "test.max_size", "256",
        "test.grid_size", "48", "test.max_prompts", "64",
        "test.points_per_batch", "8", "test.pred_iou_thresh", "0.0",
        "test.stability_score_thresh", "0.0", "test.pos_sim_thresh", "0.3",
        "tpu.compute_dtype", "float32", "test.output_rles", "false"]
ARCHS = {
    "sam_hq": ["model.sam_arch", "sam_hq", "model.sam_model", "hqvit_tiny"],
    "mobile_sam": ["model.sam_arch", "mobile_sam", "model.sam_model",
                   "mobilevit_t", "model.image_size", "256"],
    "sam-dinov2_vitb14": ["model.sam_arch", "sam",
                          "model.dino_model", "dinov2_vitb14"],
    "vit_h": ["model.sam_model", "vit_h", "model.image_size", "256"],
}


def _vit_h_small(checkpoint=None, n_class=1, **kw):
    """The JAX package's vit_h builder at a small width: 160 wide, 2 heads
    (head dim 80), 2 blocks of which the second is global."""
    return jax_build._build_sam(160, 2, 2, (1,), n_class, checkpoint, **kw)


def _port_vit_h_small(n_class=1, **kw):
    return build._build_sam(160, 2, 2, (1,), n_class, **kw)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_generate_of_each_arch_matches_jax(arch, monkeypatch):
    """Both packages built from one config; the port takes the JAX model's
    weights through the bridge (they are its own draws already, but for
    `vit_h`, which runs here at a small width whose draws the manifest does
    not hold).  `sam_hq` decodes unfused whatever `tpu.fused_decode` says;
    `sam` loads no adapter."""
    opts = TINY + ARCHS[arch]
    if arch == "vit_h":
        monkeypatch.setitem(jax_build.sam_model_registry, "vit_h",
                            _vit_h_small)
        monkeypatch.setitem(build.sam_model_registry, "vit_h",
                            _port_vit_h_small)
    jm = JaxCrowdSAM(jax_modify_config(jax_load_config(None), list(opts)))
    want_sd = sam_state_dict_from_jax(jax_tree_to_numpy(jm.sam.params))
    if arch == "vit_h":
        monkeypatch.setattr(port_crowdsam.init, "sam_state_dict",
                            lambda *a, **k: want_sd)
    pm = CrowdSAM(modify_config(load_config(None), list(opts)),
                  device="cpu")
    got_sd = pm.sam.state_dict()
    for k, v in want_sd.items():       # the port drew the same weights
        assert torch.equal(got_sd[k], v), k
    pm.dino.load_state_dict(dino_state_dict_from_jax(
        jax_tree_to_numpy(jm.predictor.dino_params)), strict=True)
    assert pm.predictor.is_hq == jm.predictor.is_hq == (arch == "sam_hq")
    image = np.random.default_rng(1).integers(0, 255, (200, 256, 3),
                                              dtype=np.uint8)
    _, sub = jax.random.split(jm._key)
    noise = np.asarray(jax.random.uniform(sub, (jm.engine_cfg.grid_size
                                                 ** 2,)))
    want = jm.generate(image)
    got = pm.generate(image, noise=[noise])
    assert len(got["boxes"]) == len(want["boxes"]) > 0
    np.testing.assert_array_equal(got["categories"], want["categories"])
    np.testing.assert_allclose(got["boxes"], want["boxes"], atol=0.5)
    np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-4)


@pytest.mark.parametrize("opt,value,match", [
    ("tpu.mesh_model", "2", "multi-device"),
    ("test.mask_selection", "max_mask", "mask_selection"),
    ("tpu.mesh_data", "2", "multi-device"),
    ("model.sam_arch", "sam2", "not an arch"),
    ("model.sam_model", "vit_x", "not in the registry"),
])
def test_unported_options_still_raise_with_their_reasons(opt, value, match):
    cfg = modify_config(load_config(None), list(TINY) + [opt, value])
    with pytest.raises(NotImplementedError, match=match):
        CrowdSAM(cfg, device="cpu")


def test_vit_t_refuses_hq_with_the_jax_warning():
    with pytest.warns(UserWarning, match="no HQ decoder variant"):
        sam = build.build_sam_vit_t(image_size=256, hq=True)
    assert type(sam.mask_decoder).__name__ == "MaskDecoder"
    assert not init.has_hq("vit_t")
