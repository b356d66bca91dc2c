"""The numerics of the float32 decode arms, 3xTF32 on wgmma: K5 f32
(`csrc/decode_tail_f32.cu`) and K6 f32 (`csrc/mask_head_f32.cu`), written
out in PyTorch by `decode_tail_kernel.twoway_tail_tf32x3_model` and
`mask_head_kernel.mask_head_tf32x3_model` on the product model
`tf32x3.mm` (TF32 rounding on the float32 bits, lo.hi + hi.lo + hi.hi a
stage of 32 inputs, lo.lo dropped).

- At T = 2 and 8 on one image and at T = 7 over two images (vit_tiny's
  decoder with seeded weights, 8x8 image rows), each model's max and mean
  absolute error from a float64 evaluation of the plain version is within
  the bound chip_smoke.py holds the kernels to (`_f64_held`): at most 2x
  the plain float32 version's, floor 1e-7 of max |out|.
- Each fault of the design (`TWOWAY_FAULTS`, `MASK_HEAD_FAULTS`: lo.hi
  dropped, a stage's lo from the next stage, A's lo not split again at a
  k-step, a prompt's folded values from the next prompt, K6's second
  weight's inputs out of the accumulators' order) breaks that bound
  8-fold.
- On the fused decode's kernel route, the two models in place of the plain
  versions agree with the JAX package's float32 fused decode (its XLA
  path) within 1e-5 relative plus 1e-5 of each output's largest magnitude.
- `tf32x3.pack` lays a weight out as the kernels' stages (128-byte swizzle,
  hi then lo, the inputs in `KEY_ORDER` where asked)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_float32_decode import (
    _as64,
    _mask_head_operands,
    _operands,
    _tail_args,
)
from test_torch_fused_decode import H, _pair

from crowdsam_tpu.models import fused_decode as jax_fused
from crowdsam_tpu_torch.models import decode_tail_kernel as dtk
from crowdsam_tpu_torch.models import fused_decode as fd
from crowdsam_tpu_torch.models import mask_head_kernel as mhk
from crowdsam_tpu_torch.models import tf32x3

CASES = {"T2": (1, 2), "T8": (1, 8), "two images, T7": (2, 7)}


def _errs(x, want):
    d = (x.double() - want).abs()
    return float(d.max()), float(d.mean())


def _over(got, plain, want):
    """The largest of max and mean |got - want| over the bound: 2x the
    plain float32 version's, floor 1e-7 max |want|."""
    want = want.double()
    g, p = _errs(got, want), _errs(plain, want)
    floor = 1e-7 * float(want.abs().max())
    return max(g[0] / max(2 * p[0], floor), g[1] / max(2 * p[1], floor))


_TAIL = {}


def _tail(case):
    """K5's operands of `case`, the plain version in float32 and in
    float64."""
    if case not in _TAIL:
        n_img, t = CASES[case]
        _, shared, tokens, img = _operands(torch.float32, n_img=n_img, p=5,
                                           t=t)
        args = _tail_args(shared, tokens)
        with torch.no_grad():
            plain = dtk.twoway_tail_plain(*args, img=img)
            want = dtk.twoway_tail_plain(*(x.double() for x in args[:5]),
                                         _as64(args[5]), img=img)
        _TAIL[case] = args, img, plain, want
    return _TAIL[case]


def _head(case):
    """K6's operands on `case`'s plain keys2, the plain version in float32
    and in float64 (`emit_exp`)."""
    args, _, plain, _ = _tail(case)
    keys2, hyper, weights = _mask_head_operands(torch.float32, plain[0],
                                                p=5)
    with torch.no_grad():
        got = mhk.mask_head_plain(keys2, hyper, weights, emit_exp=True)
        want = mhk.mask_head_plain(keys2.double(), hyper.double(),
                                   _as64(weights), emit_exp=True)
    return (keys2, hyper, weights), got, want


@pytest.mark.parametrize("case", list(CASES))
def test_twoway_tail_model_within_the_bound(case):
    args, img, plain, want = _tail(case)
    with torch.no_grad():
        got = dtk.twoway_tail_tf32x3_model(*args, img=img)
    for g, p, w in zip(got, plain, want):
        assert g.dtype == torch.float32
        assert _over(g, p, w) <= 1.0


@pytest.mark.parametrize("fault", dtk.TWOWAY_FAULTS)
def test_twoway_tail_faults_break_the_bound(fault):
    args, img, plain, want = _tail("T8")
    with torch.no_grad():
        got = dtk.twoway_tail_tf32x3_model(*args, img=img, fault=fault)
    assert max(_over(g, p, w) for g, p, w in zip(got, plain, want)) > 8.0


@pytest.mark.parametrize("case", list(CASES))
def test_mask_head_model_within_the_bound(case):
    ops, plain, want = _head(case)
    with torch.no_grad():
        got = mhk.mask_head_tf32x3_model(*ops, emit_exp=True)
    for g, p, w in zip(got, plain, want):
        assert _over(g, p, w) <= 1.0


@pytest.mark.parametrize("fault", mhk.MASK_HEAD_FAULTS)
def test_mask_head_faults_break_the_bound(fault):
    ops, plain, want = _head("T8")
    with torch.no_grad():
        got = mhk.mask_head_tf32x3_model(*ops, emit_exp=True, fault=fault)
    assert max(_over(g, p, w) for g, p, w in zip(got, plain, want)) > 8.0


def test_models_on_the_kernel_route_agree_with_jax_f32(monkeypatch):
    """fused_decode on the kernel route (packed masks, multimask) with the
    two models in place of the plain versions, against the JAX package's
    float32 fused decode on the same weights and inputs."""
    jsam, sam = _pair(jnp.float32, 3)
    rng = np.random.default_rng(7)
    feats = rng.normal(0, 1, (1, H, H, 256)).astype(np.float32)
    pe = np.array(jsam.prompt_encoder.apply(
        {"params": jsam.params["prompt_encoder"]},
        method=jsam.prompt_encoder.get_dense_pe))
    sparse = rng.normal(0, 1, (5, 2, 256)).astype(np.float32)
    dino = rng.normal(0, 1, (H * H * 16, 256)).astype(np.float32)
    dec_j = jsam.params["mask_decoder"]
    shared_j = jax_fused.precompute_decode_shared(
        dec_j, jsam.params["prompt_encoder"]["no_mask_embed"],
        jnp.asarray(feats), jnp.asarray(pe), num_heads=8, dtype=jnp.float32)
    hw = shared_j.pop("hw")           # static: outside the traced tree
    want = jax.jit(lambda d, sh, sp, dn: jax_fused.fused_decode(
        d, dict(sh, hw=hw), sp, True, dino_feats_proj=dn, num_heads=8,
        dtype=jnp.float32, n_class=3, packed_masks=True))(
            dec_j, shared_j, jnp.asarray(sparse), jnp.asarray(dino))
    calls = {"tail": 0, "head": 0}

    def tail(*a, **kw):         # the wrapper passes img 8th
        calls["tail"] += 1
        return dtk.twoway_tail_tf32x3_model(
            *a[:6], img=a[7] if len(a) > 7 else kw.get("img"))

    def head(*a, **kw):
        calls["head"] += 1
        return mhk.mask_head_tf32x3_model(*a, **kw)

    monkeypatch.setattr(dtk, "twoway_tail_plain", tail)
    monkeypatch.setattr(mhk, "mask_head_plain", head)
    dec, no_mask = sam.mask_decoder, sam.prompt_encoder.no_mask_embed.weight
    with torch.no_grad():
        shared = fd.precompute_decode_shared(
            dec, no_mask, torch.from_numpy(feats), torch.from_numpy(pe),
            kernel_route=True)
        got = fd.fused_decode(dec, shared, torch.from_numpy(sparse), True,
                              dino_feats_proj=torch.from_numpy(dino),
                              packed_masks=True)
    assert calls == {"tail": 1, "head": 1}
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(w).max()))


def test_pack_lays_out_the_kernels_stages():
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.normal(0, 1, (256, 72)).astype(np.float32))
    out = tf32x3.pack(w)
    assert out.dtype == torch.uint8
    assert out.numel() == 2 * 3 * tf32x3.STAGE_BYTES     # 2 chunks x 3
    stages = out.view(torch.float32).view(2, 3, 2, 128, 8, 4)
    hi, lo = tf32x3.split(torch.nn.functional.pad(w, (0, 24)))
    for ch, ks, r, c in ((0, 0, 0, 0), (1, 2, 77, 5), (0, 1, 13, 7)):
        pos = c ^ (r % 8)
        cols = slice(32 * ks + 4 * c, 32 * ks + 4 * c + 4)
        assert torch.equal(stages[ch, ks, 0, r, pos], hi[128 * ch + r, cols])
        assert torch.equal(stages[ch, ks, 1, r, pos], lo[128 * ch + r, cols])
    assert float((hi + lo - torch.nn.functional.pad(w, (0, 24))).abs().max()
                 ) <= 2.0 ** -22 * float(w.abs().max())
    # KEY_ORDER: position c of an 8-input group holds input KEY_ORDER[c].
    keyed = tf32x3.pack(w, key_order=True).view(torch.float32).view(
        2, 3, 2, 128, 8, 4)
    row = keyed[0, 0, 0, 3]                       # row 3: chunk c at c ^ 3
    first = torch.cat([row[0 ^ 3], row[1 ^ 3]])   # inputs 0..7, in order
    assert torch.equal(first, hi[3, list(tf32x3.KEY_ORDER)])
    # The cache gives one packing a tensor and packs a weight written again.
    a = tf32x3.packed(w)
    assert tf32x3.packed(w) is a
    w.add_(1.0)
    assert tf32x3.packed(w) is not a
