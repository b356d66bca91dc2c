"""`tpu.compute_dtype float32`: the CPU runs it (the plain path); CUDA runs
it through the float32 arms of K1-K4 with the unfused decode and refuses
it at construction where the fused decode would launch K5 or K6, whose
float32 arms are the next slice.  The refusal is decided before anything
touches a device, so these tests need no card: they name the device "cuda"
as a string (the card's own tests are in `tests/test_torch_cuda.py`).

The TF32 guard (`models/common.exact_float32`): with TF32 switched on by
the caller, what `F.conv2d` and `F.linear` see inside a float32 forward
is off, and the caller's settings are back afterwards."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_pipeline import TINY, _image

from crowdsam_tpu_torch.config import (
    load_config,
    modify_config,
    refuse_float32_on_cuda,
)
from crowdsam_tpu_torch.models.build import sam_model_registry
from crowdsam_tpu_torch.models.common import (
    cast_compute_params,
    compute_dtype,
)
from crowdsam_tpu_torch.parallel.eval_shard import ShardedPipeline
from crowdsam_tpu_torch.pipeline.crowdsam import CrowdSAM

REASON = "K5 and K6 take bf16 operands"


def test_float32_runs_on_the_cpu():
    cfg = modify_config(load_config(None), list(TINY))
    assert cfg["tpu"]["compute_dtype"] == "float32"
    pm = CrowdSAM(cfg, device="cpu")
    assert compute_dtype(pm.sam) == compute_dtype(pm.dino) == torch.float32
    data = pm.generate(_image(51, (200, 256, 3)),
                       noise=[np.random.default_rng(51).uniform(
                           size=48 * 48).astype(np.float32)])
    assert len(data["boxes"]) > 0 and np.isfinite(data["scores"]).all()


@pytest.mark.parametrize("device,dtype,fused,refused", [
    ("cuda", torch.float32, True, True),
    ("cuda:0", torch.float32, True, True),
    ("cuda", torch.float32, False, False),
    ("cuda:0", torch.float32, False, False),
    ("cuda", torch.bfloat16, True, False),
    ("cuda", torch.bfloat16, False, False),
    ("cpu", torch.float32, True, False),
    ("cpu", torch.float32, False, False),
    ("cpu", torch.bfloat16, True, False)])
def test_refuse_float32_on_cuda(device, dtype, fused, refused):
    """Refused only for float32 on CUDA where the decode fuses; the message
    names the float32 arms of K5/K6 as the next slice and the way out."""
    if refused:
        with pytest.raises(NotImplementedError, match=REASON) as info:
            refuse_float32_on_cuda(device, dtype, fused, "here")
        msg = str(info.value)
        assert "float32 arms" in msg and "next slice" in msg
        assert "tpu.fused_decode false" in msg
    else:
        refuse_float32_on_cuda(device, dtype, fused, "here")


def _tiny(*extra):
    return modify_config(load_config(None), list(TINY) + list(extra))


def test_crowdsam_refuses_float32_on_cuda():
    """Refused in the constructor, before a model is built: float32 with
    the fused decode (the default) on CUDA."""
    with pytest.raises(NotImplementedError, match=f"CrowdSAM.*{REASON}"):
        CrowdSAM(_tiny("tpu.fused_decode", "true"), device="cuda")


@pytest.mark.parametrize("extra", [
    ("tpu.fused_decode", "false"),
    ("tpu.fused_decode", "true", "model.sam_arch", "sam_hq",
     "model.sam_model", "vit_tiny")], ids=["unfused", "sam_hq"])
def test_crowdsam_float32_on_cuda_passes_the_refusal(extra, monkeypatch):
    """The unfused decode and the HQ decoder (which never fuses) pass the
    refusal: the constructor goes on to build the models, stopped here
    before they would move to a card."""
    import crowdsam_tpu_torch.pipeline.crowdsam as crowdsam_mod

    def stop(*a, **kw):
        raise RuntimeError("build_models reached")

    monkeypatch.setattr(crowdsam_mod, "build_models", stop)
    with pytest.raises(RuntimeError, match="build_models reached"):
        CrowdSAM(_tiny(*extra), device="cuda")


def test_sharded_pipeline_refuses_float32_fused_on_cuda():
    """`ShardedPipeline` makes the same check at construction: a float32
    model whose device is CUDA and whose decode fuses is refused; with the
    unfused decode it is taken."""
    pm = CrowdSAM(_tiny("tpu.fused_decode", "true"), device="cpu")
    ShardedPipeline(pm, batch=2)
    pm.device = torch.device("cuda")
    with pytest.raises(NotImplementedError,
                       match=f"ShardedPipeline.*{REASON}"):
        ShardedPipeline(pm, batch=2)
    pm.engine_cfg = dataclasses.replace(pm.engine_cfg, fused_decode=False)
    ShardedPipeline(pm, batch=2)


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
