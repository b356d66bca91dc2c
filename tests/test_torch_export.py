"""The serving export (`crowdsam_tpu_torch/utils/export.py`) on the CPU, in
float32, against the JAX package's `utils/export.py` on the same weights.

- `export_decoder` on `vit_tiny` (the contract of `tests/test_export.py`):
  the loaded program equals the port's eager module bit for bit, and the
  JAX package's `build_decoder_fn` and its loaded StableHLO within atol
  1e-5, rtol 1e-4.
- the serving head at full decoder size (256 wide, a 64x64 embedding,
  img_size 1024) against the JAX `build_serving_fn` in the four
  parametrizations of `tests/test_export_serving.py`, with that test's own
  tolerances: masks atol 5e-3 / rtol 1e-3, the rest 1e-3, areas equal or
  apart only by pixels at a threshold tie.  The JAX functions run under
  `jit`: a compile each costs less than JAX's first op-by-op run.
- the round trip of `export_serving`, a model exported before any eager
  call, `opcheck` of the K1 ops, K1's node count in the graph (10 for the
  decoder, 12 for the serving head) and the entry points' refusal to run
  with no device and no card.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crowdsam_tpu.models.build import build_sam_vit_tiny as jax_build_tiny
from crowdsam_tpu.models.mask_decoder import MaskDecoder as JaxMaskDecoder
from crowdsam_tpu.models.prompt_encoder import (
    PromptEncoder as JaxPromptEncoder,
)
from crowdsam_tpu.utils import export as jexport
from crowdsam_tpu.utils.checkpoint import (
    convert_mask_decoder,
    convert_prompt_encoder,
    jax_tree_to_numpy,
)

from crowdsam_tpu_torch.models.build import build_sam_vit_tiny, init_random_
from crowdsam_tpu_torch.models.mask_decoder import MaskDecoder
from crowdsam_tpu_torch.models.prompt_encoder import PromptEncoder
from crowdsam_tpu_torch.ops import layernorm as ln
from crowdsam_tpu_torch.utils import export
from crowdsam_tpu_torch.utils.weights import sam_state_dict_from_jax

JAX_TOL = dict(atol=1e-5, rtol=1e-4)
ORIG_HW = (600, 800)


def _k1_nodes(module) -> int:
    return sum(1 for n in module.graph.nodes if n.target is ln.LAYER_NORM)


@pytest.fixture(scope="module")
def tiny():
    jsam = jax_build_tiny(n_class=1, dtype=jnp.float32)
    sam = build_sam_vit_tiny()
    sam.load_state_dict(sam_state_dict_from_jax(jax_tree_to_numpy(
        jsam.params)), strict=False)
    return jsam, sam.eval()


def _decoder_inputs(img_size, batch, seed):
    h, r = img_size // 16, img_size // 4
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 0.5, (1, h, h, 256)).astype(np.float32),
            rng.normal(0, 0.5, (r, r, 256)).astype(np.float32),
            rng.uniform(0, img_size, (batch, 1, 2)).astype(np.float32),
            np.ones((batch, 1), np.int32))


@pytest.fixture(scope="module")
def decoder_export(tiny, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("decoder") / "decoder.pt2")
    return path, export.export_decoder(tiny[1], path, batch=4, device="cpu")


def test_export_decoder_matches_eager_and_jax(tiny, decoder_export,
                                              tmp_path):
    jsam, sam = tiny
    path, blob = decoder_export
    assert len(blob) > 1000 and open(path, "rb").read() == blob
    args = _decoder_inputs(sam.img_size, 4, 0)
    run = export.load_exported(path)
    with torch.no_grad():
        got = run(*map(torch.from_numpy, args))
        eager = export.build_decoder_fn(sam)(*map(torch.from_numpy, args))
    for g, e in zip(got, eager):
        assert torch.equal(g, e)
    jargs = [jnp.asarray(a) for a in args]
    want = jax.jit(jexport.build_decoder_fn(jsam))(jsam.params, *jargs)
    jblob = jexport.export_decoder(jsam, str(tmp_path / "j.stablehlo"),
                                   batch=4)
    want_loaded = jexport.load_exported(jblob)(jsam.params, *jargs)
    for g, w, wl in zip(got, want, want_loaded):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **JAX_TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(wl), **JAX_TOL)


def test_export_before_any_eager_call_leaves_the_model_usable():
    """Export traces with FakeTensors: a model exported before its first
    eager call must keep no traced tensor (the prompt encoder's frame size
    is a buffer), so the eager call after it returns real tensors equal to
    the program's."""
    sam = init_random_(build_sam_vit_tiny(dino_dim=64),
                       torch.Generator().manual_seed(3)).eval()
    blob = export.export_decoder(sam, "", batch=2, device="cpu")
    args = [torch.from_numpy(a) for a in _decoder_inputs(sam.img_size, 2, 4)]
    with torch.no_grad():
        eager = export.build_decoder_fn(sam)(*args)
        got = export.load_exported(blob)(*args)
    for g, e in zip(got, eager):
        assert type(e) is torch.Tensor and torch.isfinite(e).all()
        assert torch.equal(g, e)


def _full_size():
    """The port's prompt encoder and PWD-Net decoder at full decoder size,
    drawn as `tests/test_export_serving.py` draws the reference's (prompt
    encoder at its default init, decoder weights N(0, 0.05), vectors N(0,
    0.02)), and the same weights as JAX params through the JAX package's
    converters."""
    with torch.random.fork_rng():
        torch.manual_seed(11)
        pe = PromptEncoder(256, (64, 64), (1024, 1024), 16).eval()
        dec = MaskDecoder(256, n_class=1).eval()
        with torch.no_grad():
            for p in dec.parameters():
                p.normal_(0, 0.05 if p.ndim > 1 else 0.02)
            for m in (dec.output_upscaling[0], dec.output_upscaling[3]):
                # A reference checkpoint's (out,) bias, tiled per sub-pixel.
                m.bias.copy_(m.bias[:m.out_channels].repeat(4))
    pe_sd = {k: v.numpy() for k, v in pe.state_dict().items()}
    dec_sd = {k: v.numpy() for k, v in dec.state_dict().items()}
    for i in (0, 3):
        key = f"output_upscaling.{i}.bias"
        dec_sd[key] = dec_sd[key][:dec_sd[key].shape[0] // 4]
    params = {"prompt_encoder": convert_prompt_encoder(pe_sd),
              "mask_decoder": convert_mask_decoder(dec_sd)}
    jsam = SimpleNamespace(
        img_size=1024, mask_threshold=0.0, params=params,
        prompt_encoder=JaxPromptEncoder(
            embed_dim=256, image_embedding_size=(64, 64),
            input_image_size=(1024, 1024), mask_in_chans=16,
            dtype=jnp.float32),
        mask_decoder=JaxMaskDecoder(transformer_dim=256, n_class=1,
                                    dtype=jnp.float32))
    sam = SimpleNamespace(img_size=1024, mask_threshold=0.0,
                          prompt_encoder=pe, mask_decoder=dec)
    return jsam, sam


@pytest.fixture(scope="module")
def full_size():
    return _full_size()


def _serving_inputs(seed, batch=2, num_points=3):
    """Labels cover positive and negative points, box corners and
    padding."""
    rng = np.random.default_rng(seed)
    embed = rng.normal(0, 0.5, (1, 64, 64, 256)).astype(np.float32)
    coords = rng.uniform(0, 1024, (batch, num_points, 2)).astype(np.float32)
    labels = np.array([[1, 2, 3], [1, 0, -1]],
                      np.float32)[:batch, :num_points]
    mask_in = rng.normal(0, 1.0, (batch, 256, 256, 1)).astype(np.float32)
    return embed, coords, labels, mask_in


def _run_port(fn, inputs, has_mask):
    with torch.no_grad():
        out = fn(*map(torch.from_numpy, inputs),
                 torch.tensor(has_mask, dtype=torch.float32))
    return [o.numpy() for o in out]


def _run_jax(fn, params, inputs, has_mask):
    out = fn(params, *map(jnp.asarray, inputs),
             jnp.asarray(has_mask, jnp.float32))
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize(
    "single,stab,extra,has_mask,orig_hw",
    [(True, False, False, 0.0, ORIG_HW),
     (False, False, False, 1.0, ORIG_HW),
     (True, True, False, 0.0, ORIG_HW),
     (False, False, True, 1.0, ORIG_HW),
     (False, False, True, 1.0, None)])
def test_serving_matches_jax(full_size, single, stab, extra, has_mask,
                             orig_hw):
    jsam, sam = full_size
    kw = dict(return_single_mask=single, use_stability_score=stab,
              return_extra_metrics=extra, orig_im_size=orig_hw)
    inputs = _serving_inputs(7)
    got = _run_port(export.build_serving_fn(sam, **kw), inputs, has_mask)
    want = _run_jax(jax.jit(jexport.build_serving_fn(jsam, **kw)),
                    jsam.params, inputs, has_mask)
    names = (["masks", "scores", "stability", "areas", "low_res"] if extra
             else ["masks", "scores", "low_res"])
    assert len(got) == len(want) == len(names)
    out = dict(zip(names, zip(got, want)))
    for name, (g, w) in out.items():
        assert g.shape == w.shape and g.dtype == w.dtype, (name, g.dtype,
                                                          w.dtype)
        if name == "areas":
            # A pixel may fall on either side of the threshold only where
            # the mask logit sits within the masks' tolerance of it.
            gm, wm = out["masks"]
            np.testing.assert_array_equal(g, (gm > 0).sum((-1, -2)))
            np.testing.assert_array_equal(w, (wm > 0).sum((-1, -2)))
            flips = (gm > 0) != (wm > 0)
            assert np.abs(wm[flips]).max(initial=0.0) <= 5e-3
        elif name == "masks":
            np.testing.assert_allclose(g, w, atol=5e-3, rtol=1e-3)
        else:
            np.testing.assert_allclose(g, w, atol=1e-3, rtol=1e-3)


@pytest.fixture(scope="module")
def serving_blob(full_size, tmp_path_factory):
    _, sam = full_size
    path = str(tmp_path_factory.mktemp("serving") / "serving.pt2")
    blob = export.export_serving(sam, path, batch=2, num_points=3,
                                 return_single_mask=True,
                                 orig_im_size=ORIG_HW, device="cpu")
    return path, blob


def test_serving_export_roundtrip(full_size, serving_blob):
    _, sam = full_size
    path, blob = serving_blob
    assert len(blob) > 1000
    inputs = _serving_inputs(9)
    a = _run_port(export.load_exported(path), inputs, 1.0)
    b = _run_port(export.build_serving_fn(sam, True, orig_im_size=ORIG_HW),
                  inputs, 1.0)
    assert a[0].shape == (2, 1) + ORIG_HW
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("op", ["layer_norm", "layer_norm_stats"])
def test_k1_ops_pass_opcheck(op):
    """The schema, the fake version, the CPU version (the plain LayerNorm)
    and, for `layer_norm_stats`, its autograd registration."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(0.3, 1.5, (2, 7, 48)).astype(np.float32))
    w = torch.from_numpy(rng.normal(1.0, 0.1, 48).astype(np.float32))
    b = torch.from_numpy(rng.normal(0.0, 0.1, 48).astype(np.float32))
    target = getattr(torch.ops.crowdsam_tpu_torch, op).default
    if op == "layer_norm_stats":
        x, w, b = (t.requires_grad_() for t in (x, w, b))
    results = torch.library.opcheck(target, (x, w, b, 1e-5))
    assert set(results.values()) == {"SUCCESS"}, results
    y = target(x, w, b, 1e-5)
    y = y[0] if op == "layer_norm_stats" else y
    torch.testing.assert_close(y, ln.layer_norm_plain(x, w, b, 1e-5),
                               rtol=0, atol=0)


@pytest.mark.parametrize("which", ["decoder", "serving"])
def test_graph_holds_one_k1_node_per_layer_norm(decoder_export,
                                                serving_blob, which):
    """9 LayerNorms in the two-way transformer and the upscaling's channel
    LayerNorm; the serving head adds the mask downscaling's two (widths 4
    and 16)."""
    blob, want = ((decoder_export[1], 10) if which == "decoder"
                  else (serving_blob[1], 12))
    run = export.load_exported(blob)
    assert _k1_nodes(run) == want
    assert not any("layer_norm_stats" in str(n.target)
                   for n in run.graph.nodes)


def test_export_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch,
                                                            tiny):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sam = tiny[1]
    with pytest.raises(RuntimeError, match="CUDA"):
        export.export_decoder(sam, "")
    with pytest.raises(RuntimeError, match="CUDA"):
        export.export_serving(sam)
