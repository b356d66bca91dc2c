"""The port's train-free branch (`model.trainfree`) against the JAX package
on the CPU, with the JAX test's settings (`tests/test_pipeline.py`:
`test.mask_selection max_area`, `test.filter_thresh 0.99`,
`test.pos_sim_thresh 0.05`, 32 prompts) on the tiny config of
`tests/test_torch_pipeline.py`, the same weights and engine noise, and the
same reference feature drawn from a seed on both sides (the shipped
`template_features/ref_feature_new.pkl` is not in the repository).

Tolerances: the sim map within 1e-4 relative L2 (float32 on both sides);
the same detection count, boxes within 0.5 px, scores within 1e-4,
categories all 0; the stretch of the frame to DINOv2's square input equal
to PIL's BILINEAR resize."""

import json
import pickle
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_modes import (  # noqa: F401 (autouse fixture)
    _one_torch_thread,
    build_pair,
    port_warnings,
)
from test_torch_pipeline import TINY, _image, _next_noise

from crowdsam_tpu_torch.config import load_config, modify_config
from crowdsam_tpu_torch.ops.transforms import stretch_bilinear
from crowdsam_tpu_torch.pipeline.crowdsam import CrowdSAM

TRAINFREE = list(TINY) + [
    "model.trainfree", "true", "test.mask_selection", "max_area",
    "test.filter_thresh", "0.99", "test.pos_sim_thresh", "0.05",
    "test.max_prompts", "32"]


def _ref_feature(dim, seed=0):
    return np.random.default_rng(seed).normal(0, 1, (dim,)).astype(
        np.float32)


def _trainfree_pair(fused):
    jm, pm = build_pair(TRAINFREE + ["tpu.fused_decode", fused])
    ref = _ref_feature(pm.dino.embed_dim)
    jm.ref_feature = jnp.asarray(ref)
    pm.ref_feature = torch.from_numpy(ref)
    return jm, pm


@pytest.mark.parametrize("fused", ["false", "true"])
def test_trainfree_generate_matches_jax(fused):
    """The branch end to end: the engine on the DINOv2 grid (18 at
    img_size 256), the sim map of the stretched frame, then the same
    detections as the JAX package's, all of category 0."""
    jm, pm = _trainfree_pair(fused)
    assert pm.engine_cfg.grid_size == jm.engine_cfg.grid_size == 18
    image = _image(31, (160, 256, 3))
    noise = _next_noise(jm)
    want = jm.generate(image)
    got = pm.generate(image, noise=[noise])
    assert len(got["boxes"]) == len(want["boxes"]) > 0
    np.testing.assert_allclose(got["boxes"], want["boxes"], atol=0.5)
    np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-4)
    np.testing.assert_array_equal(got["categories"], want["categories"])
    assert (got["categories"] == 0).all()


def test_trainfree_sim_map_matches_jax():
    """The train-free foreground map of one stretched frame against the
    JAX `_trainfree_sim` on the same uint8 input and reference feature."""
    jm, pm = _trainfree_pair("true")
    d = pm.predictor.dino_input
    sq = stretch_bilinear(_image(32, (200, 256, 3)), (d, d))
    want = np.asarray(jm._trainfree_sim(jnp.asarray(sq), jm.ref_feature))
    got = pm.predictor.trainfree_sim(sq, pm.ref_feature).numpy()
    assert got.shape == want.shape == (18, 18)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 1e-4, rel


@pytest.mark.parametrize("hw,d", [((160, 256), 252), ((683, 1024), 1022),
                                  ((256, 200), 252), ((300, 180), 100)])
def test_stretch_equals_pil(hw, d):
    """The host stretch (PIL's 8-bit BILINEAR written out) against PIL."""
    img = _image(33, hw + (3,))
    want = np.array(Image.fromarray(img).resize((d, d), Image.BILINEAR))
    np.testing.assert_array_equal(stretch_bilinear(img, (d, d)), want)


def test_reference_feature_load(tmp_path):
    """`model.ref_feature`: a missing file gives zeros and the JAX
    package's warning; a pickle gives the mean of ref["f"] over axis 0."""
    with port_warnings() as warned:
        pm = CrowdSAM(modify_config(load_config(None), TRAINFREE + [
            "model.ref_feature", str(tmp_path / "absent.pkl")]),
            device="cpu")
    assert "trainfree ref_feature missing; using zeros" in warned
    assert torch.equal(pm.ref_feature, torch.zeros(pm.dino.embed_dim))
    f = np.random.default_rng(4).normal(size=(5, pm.dino.embed_dim))
    path = tmp_path / "ref.pkl"
    path.write_bytes(pickle.dumps({"f": f}))
    pm = CrowdSAM(modify_config(load_config(None), TRAINFREE + [
        "model.ref_feature", str(path)]), device="cpu")
    np.testing.assert_allclose(pm.ref_feature.numpy(), f.mean(axis=0),
                               rtol=1e-6)


def test_trainfree_config_through_tools_test(tmp_path, capsys):
    """`configs/crowdhuman_trainfree.yaml` as a user runs it, through
    `tools.test` on the CPU with the tiny sizes: vanilla `sam`, box-only
    output, the missing reference feature's warning (zeros: a sim map of
    zeros, so no candidate and no detection), one result per image."""
    import cv2

    from crowdsam_tpu_torch.tools import test as test_cli

    (tmp_path / "Images").mkdir()
    img = _image(34, (192, 256, 3))
    cv2.imwrite(str(tmp_path / "Images" / "f0.png"), img[..., ::-1])
    (tmp_path / "val.json").write_text(json.dumps({
        "images": [{"file_name": "f0.png", "id": 0, "height": 192,
                    "width": 256}],
        "annotations": [{"image_id": 0, "bbox": [10, 20, 40, 80], "id": 0,
                         "category_id": 1, "ignore": 0, "iscrowd": False,
                         "area": 3200}],
        "categories": [{"id": 1, "name": "person",
                        "supercategory": "person"}]}))
    out = tmp_path / "result.json"
    data = ["data.dataset_root", str(tmp_path),
            "data.json_file", str(tmp_path / "val.json"),
            "environ.output_dir", str(tmp_path / "out")]
    tiny = [t for pair in zip(TINY[0::2], TINY[1::2])
            if pair[0] != "test.output_rles" for t in pair]
    config = Path(__file__).resolve().parent.parent / "configs" / \
        "crowdhuman_trainfree.yaml"
    assert test_cli.main(["-c", str(config),
                          "-s", str(out), "--device", "cpu"]
                         + tiny + data) == 0
    assert "trainfree ref_feature missing" in capsys.readouterr().out
    results = json.loads(out.read_text())
    assert [r["image_id"] for r in results] == [0]
    assert results[0]["boxes"] == [] and results[0]["rles"] == []
