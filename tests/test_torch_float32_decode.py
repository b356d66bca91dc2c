"""The fused decode in float32 on its kernel route (K5 and K6), on the CPU:
the plain versions that the float32 arms (`csrc/decode_tail_f32.cu`,
`csrc/mask_head_f32.cu`) compute on the card.

- `twoway_tail_plain` in float32 over B = 2 images against one call per
  image, at T = 2 and T = 8: the same operands, so 1e-6 covers only the
  host's own summation order.
- The plain versions evaluated in float64 (the card's yardstick for the
  float32 arms) against float32: within 1e-5 of the output's largest
  magnitude, float32's rounding of a few dozen dependent stages.  At bf16
  they give today's values bit for bit (a seeded pin: sha256 of the
  outputs' bytes, one torch thread).
- `CrowdSAM.generate` and `ShardedPipeline.generate_batch` (B = 2) in
  float32 on the tiny config with the kernel route forced on the CPU,
  against the JAX package's float32 `generate` on the same noise: boxes
  within 0.5 px, scores within 1e-4, as `tests/test_torch_pipeline.py`
  holds the fused decode.
- The two arms' sources: their products in 3xTF32 on wgmma (TF32
  products, operands split by `cvt.rna.tf32.f32`), no bf16, no library
  include.
"""

import functools
import hashlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_pipeline import _image, _next_noise, _one_torch_thread, pair

from crowdsam_tpu_torch.models import decode_tail_kernel as dtk
from crowdsam_tpu_torch.models import fused_decode as fd
from crowdsam_tpu_torch.models import mask_head_kernel as mhk
from crowdsam_tpu_torch.models.build import sam_model_registry
from crowdsam_tpu_torch.parallel.eval_shard import ShardedPipeline
from crowdsam_tpu_torch.pipeline import engine

assert _one_torch_thread and pair        # fixtures used by this module

CSRC = Path(dtk.__file__).resolve().parent.parent / "csrc"


def _decoder(dtype=torch.float32):
    """The vit_tiny mask decoder with seeded numpy weights (LayerNorm
    scales around 1), in `dtype`."""
    sam = sam_model_registry["vit_tiny"](n_class=1, dino_dim=1024)
    rng = np.random.default_rng(21)
    with torch.no_grad():
        for name, p in sorted(sam.named_parameters()):
            x = rng.normal(0, 0.05, tuple(p.shape))
            if "norm" in name and name.endswith("weight"):
                x += 1.0
            p.copy_(torch.from_numpy(x.astype(np.float32)))
    dec = sam.mask_decoder.to(dtype)
    return dec, sam.prompt_encoder.no_mask_embed.weight.to(dtype)


def _operands(dtype, n_img=1, p=3, t=7, hw=8, seed=3):
    """K5's operands (`precompute_decode_shared` on the kernel route) for
    `n_img` seeded images of hw x hw rows, p prompts of t tokens, and each
    prompt's image (None for one image)."""
    dec, no_mask = _decoder(dtype)
    rng = np.random.default_rng(seed)
    emb = torch.from_numpy(rng.normal(0, 1, (n_img, hw, hw, 256)).astype(
        np.float32))
    pe = torch.from_numpy(rng.normal(0, 1, (hw, hw, 256)).astype(np.float32))
    tokens = torch.from_numpy(rng.normal(0, 1, (p, t, 256)).astype(
        np.float32)).to(dtype)
    with torch.no_grad():
        shared = fd.precompute_decode_shared(
            dec, no_mask, emb if n_img > 1 else emb[0], pe, kernel_route=True)
    img = None if n_img == 1 else torch.arange(p, dtype=torch.int32) % n_img
    return dec, shared, tokens, img


def _tail_args(shared, tokens):
    return (shared["keys0"], shared["q1i_flat"], shared["k1_flat"],
            shared["v1_flat"], tokens, shared["tail"])


@pytest.mark.parametrize("t", [2, 8])
def test_twoway_tail_plain_over_two_images_f32(t):
    """Each prompt over B = 2 images (interleaved) against one call per
    image on that image's rows."""
    _, shared, tokens, img = _operands(torch.float32, n_img=2, p=5, t=t)
    args = _tail_args(shared, tokens)
    with torch.no_grad():
        keys2, tok = dtk.twoway_tail_plain(*args, img=img)
        assert keys2.dtype == tok.dtype == torch.float32
        for i in range(2):
            rows = torch.nonzero(img == i).flatten()
            want = dtk.twoway_tail_plain(*(x[i] for x in args[:4]),
                                         tokens[rows], shared["tail"])
            np.testing.assert_allclose(keys2[rows].numpy(), want[0].numpy(),
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(tok[rows].numpy(), want[1].numpy(),
                                       rtol=1e-6, atol=1e-6)


def _mask_head_operands(dtype, keys2_f32, p=3, seed=4):
    dec, _ = _decoder(dtype)
    rng = np.random.default_rng(seed)
    hyper = torch.from_numpy(rng.normal(0, 3, (p, 4, 32)).astype(np.float32))
    return (keys2_f32.to(dtype), hyper.to(dtype),
            mhk.build_mask_head_weights(dec, dtype))


def _as64(x):
    if isinstance(x, dict):
        return {k: v.double() for k, v in x.items()}
    return x.double()


def _close_to(got, want):
    want = want.double()
    err = float((got.double() - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), err


def test_plain_versions_in_float64_agree_with_float32():
    """K5's and K6's plain versions follow their input's dtype: float64
    operands give float64 arithmetic (the card's yardstick), within 1e-5
    of float32's."""
    _, shared, tokens, _ = _operands(torch.float32)
    args = _tail_args(shared, tokens)
    with torch.no_grad():
        got = dtk.twoway_tail_plain(*args)
        want = dtk.twoway_tail_plain(*(x.double() for x in args[:5]),
                                     _as64(args[5]))
        assert want[0].dtype == want[1].dtype == torch.float64
        for g, w in zip(got, want):
            _close_to(g, w)
        keys2, hyper, weights = _mask_head_operands(torch.float32, got[0])
        got = mhk.mask_head_plain(keys2, hyper, weights, emit_exp=True)
        want = mhk.mask_head_plain(keys2.double(), hyper.double(),
                                   _as64(weights), emit_exp=True)
    assert all(w.dtype == torch.float64 for w in want)
    for g, w in zip(got, want):
        _close_to(g, w)
    # The float64 evaluation is not float32's: it differs from it.
    assert not torch.equal(got[0].double(), want[0])


def _digest(*tensors):
    h = hashlib.sha256()
    for x in tensors:
        h.update(x.contiguous().view(torch.int16).numpy().tobytes())
    return h.hexdigest()[:16]


# sha256 (16 hex digits) of the plain versions' bf16 outputs on the seeded
# operands below, as the plain versions computed them before they followed
# their input's dtype.
BF16_PINS = {"twoway_tail": "d3e5670c66d5d5ee", "mask_head": "46554134ac2b12f8"}


@pytest.mark.parametrize("kernel", ["twoway_tail", "mask_head"])
def test_plain_versions_at_bf16_keep_their_values(kernel):
    _, shared, tokens, _ = _operands(torch.bfloat16)
    with torch.no_grad():
        out = dtk.twoway_tail_plain(*_tail_args(shared, tokens))
        if kernel == "mask_head":
            keys2, hyper, weights = _mask_head_operands(torch.bfloat16,
                                                        out[0].float())
            out = mhk.mask_head_plain(keys2, hyper, weights, emit_exp=True)
            out = (out[0], out[1], out[2].to(torch.bfloat16))
    assert all(x.dtype == torch.bfloat16 for x in out)
    assert _digest(*out) == BF16_PINS[kernel]


def _kernel_route(monkeypatch):
    """Force the engine's fused decode onto the kernel route on the CPU
    (the wrappers of K5 and K6, so their plain versions) and count the
    plain versions' calls."""
    calls = {"twoway_tail": 0, "mask_head": 0}

    def counted(name, fn):
        def run(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return run

    monkeypatch.setattr(engine, "precompute_decode_shared", functools.partial(
        fd.precompute_decode_shared, kernel_route=True))
    monkeypatch.setattr(dtk, "twoway_tail_plain",
                        counted("twoway_tail", dtk.twoway_tail_plain))
    monkeypatch.setattr(mhk, "mask_head_plain",
                        counted("mask_head", mhk.mask_head_plain))
    return calls


def _close_to_jax(got, want):
    assert len(got["boxes"]) == len(want["boxes"]) > 0
    np.testing.assert_allclose(got["boxes"], want["boxes"], atol=0.5)
    np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-4)
    np.testing.assert_array_equal(got["categories"], want["categories"])


@pytest.mark.parametrize("pair", ["true"], indirect=True, ids=["fused"])
def test_generate_on_the_kernel_route_matches_jax_f32(pair, monkeypatch):
    jm, pm = pair
    calls = _kernel_route(monkeypatch)
    image = _image(61, (200, 256, 3))
    noise = _next_noise(jm)
    want = jm.generate(image)
    got = pm.generate(image, noise=[noise])
    assert calls["twoway_tail"] > 0 and calls["mask_head"] > 0
    _close_to_jax(got, want)


@pytest.mark.parametrize("pair", ["true"], indirect=True, ids=["fused"])
def test_generate_batch_on_the_kernel_route_matches_jax_f32(pair,
                                                             monkeypatch):
    """B = 2 images in one lockstep decode: K5 over two images (an image
    index a prompt), against the JAX package's `generate` of each."""
    jm, pm = pair
    calls = _kernel_route(monkeypatch)
    images = [_image(62, (200, 256, 3)), _image(63, (256, 192, 3))]
    noises, wants = [], []
    for img in images:
        noises.append(_next_noise(jm))
        wants.append(jm.generate(img))
    got = ShardedPipeline(pm, batch=2).generate_batch(images, noise=noises)
    assert calls["twoway_tail"] > 0 and calls["mask_head"] > 0
    for g, w in zip(got, wants):
        _close_to_jax(g, w)


@pytest.mark.parametrize("source,entries", [
    ("decode_tail_f32.cu", ("twoway_tail_f32_forward",
                            "twoway_tail_f32_occupancy",
                            "twoway_tail_f32_scratch_bytes")),
    ("mask_head_f32.cu", ("mask_head_f32_forward",
                          "mask_head_f32_occupancy"))])
def test_float32_decode_arms_source_is_3xtf32_on_wgmma_without_bf16(
        source, entries):
    """The float32 arms of K5 and K6 and their shared header compute their
    products in 3xTF32 on the tensor cores: TF32 wgmma with the operands
    split by `cvt.rna.tf32.f32`, no FFMA tile product left; no bf16 or half
    type or conversion, no library include; their C entry points are
    there."""
    text = (CSRC / source).read_text()
    header = (CSRC / "tf32x3.cuh").read_text()
    code = "\n".join(ln for ln in (text + "\n" + header).splitlines()
                     if not ln.lstrip().startswith("//"))
    for banned in ("bf16", "bfloat16", "half", "__nv_", "mma.sync",
                   "cublas", "cutlass", "cudnn", "cute", "tile_product"):
        assert banned not in code.lower(), banned
    assert "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32" in code
    assert "cvt.rna.tf32.f32" in code
    assert "product<" in text
    includes = [ln for ln in (text + "\n" + header).splitlines()
                if ln.startswith("#include")]
    assert sorted(set(includes)) == ['#include "tf32x3.cuh"',
                                     "#include <cuda_runtime.h>",
                                     "#include <math.h>",
                                     "#include <stdint.h>"]
    for entry in entries:
        assert re.search(rf'extern "C" (int|long long) {entry}\(', code), entry
    assert not (CSRC / "f32_tile.cuh").exists()
