"""`tpu.compute_dtype float32`: the CPU runs it (the plain path); CUDA runs
it through the float32 arms of the kernels (K1-K4 in the encoders, K5 and
K6 in the fused decode), with either decode.  Construction on "cuda"
reaches the model build for every decode, where these tests stop it:
they need no card and name the device "cuda" as a string (the card's own
tests are in `tests/test_torch_cuda.py`).

The TF32 guard (`models/common.exact_float32`): with TF32 switched on by
the caller, what `F.conv2d` and `F.linear` see inside a float32 forward
is off, and the caller's settings are back afterwards."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_pipeline import TINY, _image

from crowdsam_tpu_torch.config import load_config, modify_config
from crowdsam_tpu_torch.models.build import sam_model_registry
from crowdsam_tpu_torch.models.common import (
    cast_compute_params,
    compute_dtype,
)
from crowdsam_tpu_torch.pipeline.crowdsam import CrowdSAM


def test_float32_runs_on_the_cpu():
    cfg = modify_config(load_config(None), list(TINY))
    assert cfg["tpu"]["compute_dtype"] == "float32"
    pm = CrowdSAM(cfg, device="cpu")
    assert compute_dtype(pm.sam) == compute_dtype(pm.dino) == torch.float32
    data = pm.generate(_image(51, (200, 256, 3)),
                       noise=[np.random.default_rng(51).uniform(
                           size=48 * 48).astype(np.float32)])
    assert len(data["boxes"]) > 0 and np.isfinite(data["scores"]).all()


def _tiny(*extra):
    return modify_config(load_config(None), list(TINY) + list(extra))


@pytest.mark.parametrize("extra", [
    ("tpu.fused_decode", "true"),
    ("tpu.fused_decode", "false"),
    ("tpu.fused_decode", "true", "model.sam_arch", "sam_hq",
     "model.sam_model", "vit_tiny")], ids=["fused", "unfused", "sam_hq"])
def test_crowdsam_float32_on_cuda_reaches_build_models(extra, monkeypatch):
    """Float32 on "cuda" with the fused decode (K5 and K6 have float32
    arms), the unfused decode and the HQ decoder: the constructor goes on
    to build the models, stopped here before they would move to a card."""
    import crowdsam_tpu_torch.pipeline.crowdsam as crowdsam_mod

    def stop(*a, **kw):
        raise RuntimeError("build_models reached")

    monkeypatch.setattr(crowdsam_mod, "build_models", stop)
    with pytest.raises(RuntimeError, match="build_models reached"):
        CrowdSAM(_tiny(*extra), device="cuda")


def _record_flags(monkeypatch):
    """Patch F.conv2d and F.linear to record (cuDNN TF32, float32 matmul
    precision) at each call."""
    seen = {"conv2d": [], "linear": []}
    for name in seen:
        real = getattr(F, name)

        def rec(*a, real=real, name=name, **kw):
            seen[name].append((torch.backends.cudnn.allow_tf32,
                               torch.get_float32_matmul_precision()))
            return real(*a, **kw)
        monkeypatch.setattr(F, name, rec)
    return seen


@pytest.fixture
def tf32_on():
    """The caller's TF32 on (cuDNN and matmul "high"), restored after."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    yield
    torch.backends.cudnn.allow_tf32 = saved[0]
    torch.set_float32_matmul_precision(saved[1])


@pytest.mark.parametrize("dtype,inside", [
    (torch.float32, (False, "highest")), (torch.bfloat16, (True, "high"))],
    ids=["float32", "bfloat16"])
def test_tf32_guard_in_float32_layers(dtype, inside, tf32_on, monkeypatch):
    """A float32 encoder's convolutions and products see TF32 off whatever
    the caller set; a bf16 one's see the caller's settings (the guard
    changes nothing there).  The caller's flags are back afterwards."""
    sam = cast_compute_params(sam_model_registry["vit_tiny"](), dtype)
    seen = _record_flags(monkeypatch)
    with torch.no_grad():
        sam.image_encoder(torch.zeros((1, 256, 256, 3)))
    assert seen["conv2d"] and seen["linear"]
    assert set(seen["conv2d"]) == set(seen["linear"]) == {inside}
    assert (torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision()) == (True, "high")


def test_tf32_guard_at_the_float32_entry_points(tf32_on, monkeypatch):
    """`CrowdSAM.generate` of a float32 model runs its crop (encode,
    engine, decode, upsampling) with TF32 off, and gives the caller's
    settings back."""
    import crowdsam_tpu_torch.pipeline.crowdsam as crowdsam_mod

    pm = CrowdSAM(_tiny("tpu.fused_decode", "false"), device="cpu")
    seen = []
    real = crowdsam_mod.CrowdSAM._dispatch_crop

    def rec(self, *a, **kw):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.get_float32_matmul_precision()))
        return real(self, *a, **kw)

    monkeypatch.setattr(crowdsam_mod.CrowdSAM, "_dispatch_crop", rec)
    pm.generate(_image(52, (200, 256, 3)))
    assert seen == [(False, "highest")]
    assert (torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision()) == (True, "high")
