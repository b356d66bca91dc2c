"""`tpu.compute_dtype float32`: the CPU runs it (the plain path), CUDA
refuses it at construction with the reason, since the port's hand-written
kernels take bf16 operands and nothing casts for them.  The refusal is
decided before anything touches a device, so these tests need no card:
they name the device "cuda" as a string (the card's own test is in
`tests/test_torch_cuda.py`)."""

import numpy as np
import pytest
import torch
from test_torch_pipeline import TINY, _image

from crowdsam_tpu_torch.config import (
    load_config,
    modify_config,
    refuse_float32_on_cuda,
)
from crowdsam_tpu_torch.models.build import sam_model_registry
from crowdsam_tpu_torch.models.common import cast_compute_params, \
    compute_dtype
from crowdsam_tpu_torch.pipeline.amg_generator import \
    SamAutomaticMaskGenerator
from crowdsam_tpu_torch.pipeline.crowdsam import CrowdSAM

REASON = "take bf16 operands"


def test_float32_runs_on_the_cpu():
    cfg = modify_config(load_config(None), list(TINY))
    assert cfg["tpu"]["compute_dtype"] == "float32"
    pm = CrowdSAM(cfg, device="cpu")
    assert compute_dtype(pm.sam) == compute_dtype(pm.dino) == torch.float32
    data = pm.generate(_image(51, (200, 256, 3)),
                       noise=[np.random.default_rng(51).uniform(
                           size=48 * 48).astype(np.float32)])
    assert len(data["boxes"]) > 0 and np.isfinite(data["scores"]).all()


@pytest.mark.parametrize("device,dtype,refused", [
    ("cuda", torch.float32, True), ("cuda:0", torch.float32, True),
    ("cuda", torch.bfloat16, False), ("cpu", torch.float32, False),
    ("cpu", torch.bfloat16, False)])
def test_refuse_float32_on_cuda(device, dtype, refused):
    if refused:
        with pytest.raises(NotImplementedError, match=REASON) as info:
            refuse_float32_on_cuda(device, dtype, "here")
        assert "XLA" in str(info.value) and "float32 arms" in str(info.value)
    else:
        refuse_float32_on_cuda(device, dtype, "here")


def test_crowdsam_refuses_float32_on_cuda():
    """Refused in the constructor, before a model is built."""
    cfg = modify_config(load_config(None), list(TINY))
    with pytest.raises(NotImplementedError, match=f"CrowdSAM.*{REASON}"):
        CrowdSAM(cfg, device="cuda")


def test_amg_refuses_a_float32_model_on_cuda():
    sam = sam_model_registry["vit_tiny"]()
    with pytest.raises(NotImplementedError,
                       match=f"SamAutomaticMaskGenerator.*{REASON}"):
        SamAutomaticMaskGenerator(sam, device="cuda")
    cast_compute_params(sam, torch.bfloat16)
    assert compute_dtype(sam) == torch.bfloat16
    SamAutomaticMaskGenerator(sam, device="cpu")


def test_trainer_feature_cache_refuses_float32_on_cuda():
    """`AdapterTrainer.cache_features` on a float32 model whose device is
    CUDA refuses before it encodes anything."""
    from crowdsam_tpu_torch.pipeline.predictor import SamPredictor
    from crowdsam_tpu_torch.train.trainer import AdapterTrainer

    cfg = modify_config(load_config(None), list(TINY))
    pm = CrowdSAM(cfg, device="cpu")
    trainer = AdapterTrainer(cfg, SamPredictor(pm.sam, pm.dino, "cpu"))
    trainer.device = torch.device("cuda")
    with pytest.raises(NotImplementedError,
                       match=f"cache_features.*{REASON}"):
        trainer.cache_features([])
