"""The port's fused decode (`models/fused_decode.py`) and the plain versions
of its two kernels against the JAX package, on the CPU, with the vit_tiny
decoder (M = 256 image rows), the same weights through the weight bridge and
inputs from a numpy seed.

Tolerances:
- float32, port against the JAX XLA path: 2e-4, the tolerance the JAX
  package holds its own fused path to (two float32 graphs summed in other
  orders);
- bf16, kernel arithmetic against the Pallas kernels in interpret mode and
  against the module-level body: the JAX package's own bound for its tail
  kernel against its XLA path, |err| / max(|y|, 1) with a median below 0.02
  and a maximum below 0.12 (masks, image tensor) or 0.06 (iou, class,
  tokens).  Both sides round to bf16 after every stage, at slightly
  different places, and one bf16 ulp is 2^-8 of the value.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crowdsam_tpu.models import decode_tail_kernel as jax_tail
from crowdsam_tpu.models import fused_decode as jax_fused
from crowdsam_tpu.models import mask_head_kernel as jax_head
from crowdsam_tpu.models.build import sam_model_registry as jax_registry
from crowdsam_tpu.ops.packed import pack_spatial as jax_pack_spatial
from crowdsam_tpu.utils.checkpoint import jax_tree_to_numpy

from crowdsam_tpu_torch.models import decode_tail_kernel, mask_head_kernel
from crowdsam_tpu_torch.models.build import init_random_, sam_model_registry
from crowdsam_tpu_torch.models.common import cast_compute_params
from crowdsam_tpu_torch.models.fused_decode import (
    _pooled_from_exp,
    fused_decode,
    precompute_decode_shared,
)
from crowdsam_tpu_torch.ops.packed import pack_spatial, unpack_spatial
from crowdsam_tpu_torch.pipeline.engine import EngineConfig, run_eps_engine
from crowdsam_tpu_torch.utils.weights import sam_state_dict_from_jax

F32_TOL = dict(rtol=2e-4, atol=2e-4)
H = 16                      # vit_tiny: 256 / 16
BF = torch.bfloat16


def _pair(dtype_j, n_class):
    jsam = jax_registry["vit_tiny"](n_class=n_class, dtype=dtype_j)
    sam = sam_model_registry["vit_tiny"](n_class=n_class, dino_dim=1024)
    sam.load_state_dict(sam_state_dict_from_jax(jax_tree_to_numpy(
        jsam.params)), strict=False)
    return jsam, sam.eval()


def _bf(x):
    return jnp.asarray(x).astype(jnp.bfloat16)


def _tbf(x):
    return torch.from_numpy(x).to(BF)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.float().numpy()


def _assert_bf16_close(got, want, max_tol, name):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, name
    err = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
    assert np.median(err) < 0.02, (name, float(np.median(err)))
    assert err.max() < max_tol, (name, float(err.max()))


# ---------------------------------------------------------------- float32

@pytest.fixture(scope="module")
def f32_setup():
    jsam, sam = _pair(jnp.float32, 3)
    rng = np.random.default_rng(7)
    feats = rng.normal(0, 1, (1, H, H, 256)).astype(np.float32)
    pe = np.array(jsam.prompt_encoder.apply(
        {"params": jsam.params["prompt_encoder"]},
        method=jsam.prompt_encoder.get_dense_pe))
    sparse = rng.normal(0, 1, (5, 2, 256)).astype(np.float32)
    dino = rng.normal(0, 1, (4 * H, 4 * H, 256)).astype(np.float32)
    return jsam, sam, feats, pe, sparse, dino


_JAX_F32 = {}


def _jax_f32_decode(f32_setup, multimask, packed):
    """The JAX package's float32 fused decode of `f32_setup` (its XLA path:
    its kernels are off for float32) and the port's DINO map in the same
    layout, computed once a (multimask, packed)."""
    key = (multimask, packed)
    if key not in _JAX_F32:
        jsam, _, feats, pe, sparse, dino = f32_setup
        dec_j = jsam.params["mask_decoder"]
        shared_j = jax_fused.precompute_decode_shared(
            dec_j, jsam.params["prompt_encoder"]["no_mask_embed"],
            jnp.asarray(feats), jnp.asarray(pe), num_heads=8,
            dtype=jnp.float32)
        dino_j = jnp.asarray(dino)
        dino_t = torch.from_numpy(dino)
        if packed:
            dino_j = jax_pack_spatial(jnp.moveaxis(dino_j, -1, 0)).reshape(
                256, -1).T
            dino_t = pack_spatial(dino_t.movedim(-1, 0)).reshape(256, -1).T
            np.testing.assert_array_equal(dino_t.numpy(), np.asarray(dino_j))
        want = jax_fused.fused_decode(
            dec_j, shared_j, jnp.asarray(sparse), multimask,
            dino_feats_proj=dino_j, num_heads=8, dtype=jnp.float32,
            n_class=3, packed_masks=packed)
        _JAX_F32[key] = [np.asarray(w) for w in want], dino_t
    return _JAX_F32[key]


@pytest.mark.parametrize("multimask", [True, False])
@pytest.mark.parametrize("packed", [False, True])
def test_fused_decode_matches_jax_f32(f32_setup, multimask, packed):
    _, sam, feats, pe, sparse, _ = f32_setup
    want, dino_t = _jax_f32_decode(f32_setup, multimask, packed)
    shared = precompute_decode_shared(
        sam.mask_decoder, sam.prompt_encoder.no_mask_embed.weight,
        torch.from_numpy(feats), torch.from_numpy(pe))
    assert "tail" not in shared                 # CPU: the module-level body
    got = fused_decode(sam.mask_decoder, shared, torch.from_numpy(sparse),
                       multimask, dino_feats_proj=dino_t,
                       packed_masks=packed)
    k = 4 if multimask else 1
    assert got[0].shape == ((5, k, H * H, 16) if packed
                            else (5, k, 4 * H, 4 * H))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32_TOL)


@pytest.mark.parametrize("multimask", [True, False])
@pytest.mark.parametrize("packed", [False, True])
def test_kernel_route_matches_jax_and_the_body_f32(f32_setup, multimask,
                                                   packed, monkeypatch):
    """The kernel route in float32 (`kernel_route=True` on the CPU: K5's and
    K6's wrappers, so the plain versions that their float32 arms compute on
    the card) against the JAX package's float32 XLA fused decode and
    against the module-level body; packed masks go through K6, spatial
    ones through the module-level head."""
    _, sam, feats, pe, sparse, _ = f32_setup
    want, dino_t = _jax_f32_decode(f32_setup, multimask, packed)
    calls = {"tail": 0, "head": 0}

    def counted(key, fn):
        def run(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return run

    monkeypatch.setattr(decode_tail_kernel, "twoway_tail_plain", counted(
        "tail", decode_tail_kernel.twoway_tail_plain))
    monkeypatch.setattr(mask_head_kernel, "mask_head_plain", counted(
        "head", mask_head_kernel.mask_head_plain))
    t = torch.from_numpy
    dec, no_mask = sam.mask_decoder, sam.prompt_encoder.no_mask_embed.weight
    outs = []
    for route in (True, False):
        shared = precompute_decode_shared(dec, no_mask, t(feats), t(pe),
                                          kernel_route=route)
        assert ("tail" in shared) == route
        outs.append(fused_decode(dec, shared, t(sparse), multimask,
                                 dino_feats_proj=dino_t, packed_masks=packed))
    assert calls == {"tail": 1, "head": int(packed)}
    got, body = outs
    assert shared["keys0"].dtype == torch.float32
    for g, w, b in zip(got, want, body):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, **F32_TOL)
        np.testing.assert_allclose(g.numpy(), b.numpy(), **F32_TOL)


def test_fused_decode_matches_the_module_and_packed_unpacks_f32(f32_setup):
    """Against the port's own `MaskDecoder.forward`, and the packed masks
    against the spatial ones through `unpack_spatial`: a wrong sub-pixel
    order would still give plausible masks."""
    _, sam, feats, pe, sparse, dino = f32_setup
    dec = sam.mask_decoder
    no_mask = sam.prompt_encoder.no_mask_embed.weight
    t = torch.from_numpy
    dense = no_mask.reshape(1, 1, 1, -1).expand(5, H, H, 256)
    with torch.no_grad():
        want = dec(t(feats), t(pe), t(sparse), dense, True,
                   dino_feats_proj=t(dino))
    shared = precompute_decode_shared(dec, no_mask, t(feats), t(pe))
    spatial = fused_decode(dec, shared, t(sparse), True,
                           dino_feats_proj=t(dino))
    dino_pk = pack_spatial(t(dino).movedim(-1, 0)).reshape(256, -1).T
    for route in (False, True):             # packed plain, packed through K6
        sh = precompute_decode_shared(dec, no_mask, t(feats), t(pe),
                                      kernel_route=route)
        pk = fused_decode(dec, sh, t(sparse), True, dino_feats_proj=dino_pk,
                          packed_masks=True)
        np.testing.assert_allclose(unpack_spatial(pk[0], H, H).numpy(),
                                   spatial[0].numpy(), **F32_TOL)
        for g, w in zip(pk[1:], spatial[1:]):
            np.testing.assert_allclose(g.numpy(), w.numpy(), **F32_TOL)
    for g, w in zip(spatial, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **F32_TOL)


# ------------------------------------------------------------------- bf16

@pytest.fixture(scope="module")
def bf16_setup():
    jsam, sam = _pair(jnp.bfloat16, 1)
    cast_compute_params(sam, BF)
    rng = np.random.default_rng(11)
    feats = rng.normal(0, 1, (1, H, H, 256)).astype(np.float32)
    pe = rng.normal(0, 1, (H, H, 256)).astype(np.float32)
    sparse = rng.normal(0, 1, (3, 2, 256)).astype(np.float32)
    dino = rng.normal(0, 1, (H * H * 16, 256)).astype(np.float32)
    return jsam, sam, feats, pe, sparse, dino


def _jax_tail_inputs(jsam, feats, pe, sparse, monkeypatch):
    monkeypatch.setenv("CROWDSAM_FORCE_TAIL_KERNEL", "1")
    dec_j = jsam.params["mask_decoder"]
    shared = jax_fused.precompute_decode_shared(
        dec_j, jsam.params["prompt_encoder"]["no_mask_embed"], _bf(feats),
        jnp.asarray(pe), num_heads=8, dtype=jnp.bfloat16)
    assert "tail" in shared
    out_tok = jnp.concatenate([dec_j["iou_token"], dec_j["mask_tokens"]], 0)
    tokens = jnp.concatenate(
        [jnp.broadcast_to(out_tok[None], (sparse.shape[0],) + out_tok.shape),
         _bf(sparse).astype(out_tok.dtype)], axis=1).astype(jnp.bfloat16)
    return shared, tokens


def test_twoway_tail_plain_matches_pallas_interpret(bf16_setup, monkeypatch):
    jsam, sam, feats, pe, sparse, _ = bf16_setup
    shared_j, tokens_j = _jax_tail_inputs(jsam, feats, pe, sparse,
                                          monkeypatch)
    keys2_j, tok_j = jax_tail.twoway_tail_pallas(
        shared_j["keys0"], shared_j["q1i_flat"], shared_j["k1_flat"],
        shared_j["v1_flat"], tokens_j, shared_j["tail"], num_heads=8,
        interpret=True)
    shared = precompute_decode_shared(
        sam.mask_decoder, sam.prompt_encoder.no_mask_embed.weight,
        _tbf(feats), torch.from_numpy(pe), kernel_route=True)
    assert set(shared["tail"]) == set(decode_tail_kernel.PARAM_NAMES)
    # The shared operands themselves (one dense stage each).
    for name in ("keys0", "q1i_flat", "k1_flat", "v1_flat"):
        _assert_bf16_close(shared[name], shared_j[name], 0.06, name)
    tokens = torch.from_numpy(_np(tokens_j).copy()).to(BF)
    before = decode_tail_kernel.twoway_tail.launches
    keys2, tok = decode_tail_kernel.twoway_tail(
        shared["keys0"], shared["q1i_flat"], shared["k1_flat"],
        shared["v1_flat"], tokens, shared["tail"])
    assert decode_tail_kernel.twoway_tail.launches == before  # CPU: plain
    assert keys2.dtype == BF and keys2.shape == (3, H * H, 256)
    assert tok.shape == (3, 7, 256)
    _assert_bf16_close(keys2, keys2_j, 0.12, "keys2")
    _assert_bf16_close(tok, tok_j, 0.06, "tokens")


@pytest.mark.parametrize("packed", [True, False])
def test_kernel_route_matches_module_body_and_jax_bf16(bf16_setup, packed,
                                                       monkeypatch):
    """`fused_decode` through the wrappers' plain versions (K5, and K6 when
    packed) against the module-level body, and both against the JAX XLA
    path."""
    jsam, sam, feats, pe, sparse, dino = bf16_setup
    dec = sam.mask_decoder
    no_mask = sam.prompt_encoder.no_mask_embed.weight
    dino_t = _tbf(dino) if packed else _tbf(dino).reshape(4 * H, 4 * H, 256)
    outs = {}
    for route in (False, True):
        shared = precompute_decode_shared(dec, no_mask, _tbf(feats),
                                          torch.from_numpy(pe),
                                          kernel_route=route)
        outs[route] = fused_decode(dec, shared, _tbf(sparse), True,
                                   dino_feats_proj=dino_t,
                                   packed_masks=packed)
    monkeypatch.delenv("CROWDSAM_FORCE_TAIL_KERNEL", raising=False)
    dec_j = jsam.params["mask_decoder"]
    shared_j = jax_fused.precompute_decode_shared(
        dec_j, jsam.params["prompt_encoder"]["no_mask_embed"], _bf(feats),
        jnp.asarray(pe), num_heads=8, dtype=jnp.bfloat16)
    assert "tail" not in shared_j
    dino_j = _bf(dino) if packed else _bf(dino).reshape(4 * H, 4 * H, 256)
    want = jax_fused.fused_decode(
        dec_j, shared_j, _bf(sparse), True, dino_feats_proj=dino_j,
        num_heads=8, dtype=jnp.bfloat16, n_class=1, packed_masks=packed)
    for i, (name, tol) in enumerate((("masks", 0.12), ("iou", 0.06),
                                     ("cls", 0.06))):
        _assert_bf16_close(outs[True][i], outs[False][i], tol, name)
        _assert_bf16_close(outs[True][i], want[i], tol, name + " vs jax")
        _assert_bf16_close(outs[False][i], want[i], tol, name + " body/jax")


@pytest.mark.parametrize("emit_exp", [False, True])
def test_mask_head_plain_matches_pallas_interpret(bf16_setup, emit_exp):
    jsam, sam, *_ = bf16_setup
    rng = np.random.default_rng(13)
    keys2 = rng.normal(0, 1, (3, H * H, 256)).astype(np.float32)
    hyper = rng.normal(0, 0.5, (3, 4, 32)).astype(np.float32)
    w_j = jax_head.build_mask_head_weights(jsam.params["mask_decoder"],
                                           jnp.bfloat16)
    want = jax_head.mask_head_pallas(_bf(keys2), _bf(hyper), w_j, num_masks=4,
                                     tile_m=128, interpret=True,
                                     emit_exp=emit_exp)
    w = mask_head_kernel.build_mask_head_weights(sam.mask_decoder, BF)
    got = mask_head_kernel.mask_head_plain(_tbf(keys2), _tbf(hyper), w,
                                           emit_exp=emit_exp, tile_m=128)
    if not emit_exp:
        assert got.dtype == BF
        _assert_bf16_close(got, want, 0.12, "masks")
        return
    masks_j, e_j, mx_j = want
    e_j = jnp.transpose(e_j.reshape(3, H * H, 4, 16), (0, 2, 1, 3))
    assert got[2].shape == (3, 2) and got[2].dtype == torch.float32
    _assert_bf16_close(got[0], masks_j, 0.12, "masks")
    _assert_bf16_close(got[2], mx_j, 0.12, "tile maxes")
    # e = exp(mask - max) in (0, 1]: a mask off by d moves e by ~d e.
    _assert_bf16_close(got[1], e_j, 0.12, "e")


@pytest.mark.parametrize("tile_m", [64, 128, 256])
def test_pooled_from_exp_matches_softmax_pooling(tile_m):
    """The tilewise combination is the softmax pooling, for any number of
    tiles (float32: 1e-5)."""
    rng = np.random.default_rng(17)
    sam = sam_model_registry["vit_tiny"](n_class=1)
    init_random_(sam, torch.Generator().manual_seed(3))
    w = mask_head_kernel.build_mask_head_weights(sam.mask_decoder,
                                                 torch.float32)
    keys2 = torch.from_numpy(rng.normal(0, 1, (2, 256, 256)).astype(
        np.float32))
    hyper = torch.from_numpy(rng.normal(0, 2, (2, 4, 32)).astype(np.float32))
    dino = torch.from_numpy(rng.normal(0, 1, (256 * 16, 24)).astype(
        np.float32))
    masks, e, mx = mask_head_kernel.mask_head_plain(keys2, hyper, w, True,
                                                    tile_m=tile_m)
    assert mx.shape == (2, 256 // tile_m)
    got = _pooled_from_exp(e, mx, dino, torch.float32)
    want = torch.softmax(masks.reshape(2, 4, -1), dim=-1) @ dino
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_wrappers_keep_the_jax_parameter_order():
    """The kernel indexes its parameters by position: the port's list is the
    JAX kernel's, name for name."""
    assert decode_tail_kernel.PARAM_NAMES == jax_tail._PARAM_NAMES


# ----------------------------------------------------------------- engine

def test_engine_fused_matches_unfused():
    """The port's mirror of the JAX package's
    `test_engine_fused_vs_module_path`: same consumed count, valid flags and
    masks from both branches of the loop (float32)."""
    sam = sam_model_registry["vit_tiny"](n_class=1)
    init_random_(sam, torch.Generator().manual_seed(0))
    sam.eval()
    rng = np.random.default_rng(3)
    size = sam.img_size
    cfg = EngineConfig(
        grid_size=24, points_per_batch=8, max_prompts=32, n_class=1,
        img_size=size, low_res=size // 4, pos_sim_thresh=0.3,
        pred_iou_thresh=0.0, stability_score_thresh=0.0,
        min_mask_region_area=0.0, max_keep=32)
    r = cfg.low_res
    args = dict(
        features=torch.from_numpy(rng.normal(0, 1, (1, H, H, 256)).astype(
            np.float32)),
        dense_pe=sam.prompt_encoder.get_dense_pe(),
        dino_feats_proj=torch.from_numpy(rng.normal(0, 1, (r, r, 256)).astype(
            np.float32)),
        sim_map=torch.from_numpy(rng.uniform(0, 1, (24, 24)).astype(
            np.float32)),
        feat_hw=(24, 18), input_hw=(size, size * 3 // 4),
        crop_box=[0, 0, size * 3 // 4, size],
        orig_hw=(size, size * 3 // 4), downscale=1.0,
        noise=torch.from_numpy(rng.uniform(0, 1, 24 * 24).astype(
            np.float32)))
    assert cfg.fused_decode                     # the default, as in JAX
    fused = run_eps_engine(sam, cfg, **args)
    plain = run_eps_engine(
        sam, dataclasses.replace(cfg, fused_decode=False), **args)
    assert fused["num_consumed"] == plain["num_consumed"] > 0
    for k in ("valid", "boxes"):
        np.testing.assert_array_equal(fused["pre_nms"][k].numpy(),
                                      plain["pre_nms"][k].numpy())
    assert fused["pre_nms"]["valid"].any()
    np.testing.assert_allclose(fused["summary"].numpy(),
                               plain["summary"].numpy(), rtol=1e-3, atol=1e-3)
    assert fused["logits"].shape == plain["logits"].shape == (32, r, r)
    np.testing.assert_array_equal((fused["logits"].float() > 0).numpy(),
                                  (plain["logits"].float() > 0).numpy())
