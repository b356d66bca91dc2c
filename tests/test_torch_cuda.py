"""Kernels against their plain versions on the GPU (small shapes, bf16).

Marked `cuda`: they skip where no CUDA device is present, and run on the
card with `python -m pytest tests/test_torch_cuda.py --noconftest` (that
machine has no JAX, which `tests/conftest.py` imports).  `chip_smoke.py`
holds the same kernels at the main path's shapes.  Tolerances in bf16 are
atol + 2^-7 |y|: the last term is one bf16 ulp of the output (both sides
round to bf16), atol is each kernel's own (as in `chip_smoke.py`): 1e-2
for LayerNorm outputs of rms ~1, and for attention ~10% of the output's
rms or less (bf16 probabilities into PV, bf16 rel-pos terms).  float32
LayerNorm: 1e-5.  The two decode kernels (two-way transformer, mask head) round at the
same points as their plain versions: 2e-2 on LayerNorm outputs of rms ~1,
3% of the masks' rms on the masks.  The survivor kernel (K7) and its plain
version round the same float32 operations: its outputs are bit for bit
equal.  K1's backward: dx within 1e-2 + 2^-7 |dx| in bf16 (1e-5 in
float32), dw and db within 1e-4 of their largest value (float32 sums over
rows in another order), and bit for bit equal from call to call.  The
2-step full-decoder training on the card only has to move every trainable
leaf, leave the others as they were and stay finite."""

import numpy as np
import pytest
import torch

from crowdsam_tpu_torch.models import (
    attention,
    decode_tail_kernel,
    mask_head_kernel,
)
from crowdsam_tpu_torch.models.build import init_random_, sam_model_registry
from crowdsam_tpu_torch.models.common import cast_compute_params
from crowdsam_tpu_torch.models.fused_decode import precompute_decode_shared
from crowdsam_tpu_torch.models.image_encoder import _rel_pos_table
from crowdsam_tpu_torch.ops import survivor_kernel
from crowdsam_tpu_torch.ops.layernorm import layer_norm, layer_norm_plain

pytestmark = pytest.mark.cuda


@pytest.fixture()
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # The kernels without a backward refuse inputs that require grad with
    # grad mode on (module weights among them): the tests run as serving
    # does, under no_grad; a test of a gradient turns it back on.
    with torch.no_grad():
        yield torch.Generator(device="cuda").manual_seed(0)


def _close(got, want, atol, rtol=2.0 ** -7):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= atol + rtol * want.abs()).all()


@pytest.mark.parametrize("n,d", [(1, 64), (37, 256), (1000, 1024)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_kernel(gen, n, d, dtype):
    x = torch.randn((n, d), generator=gen, device="cuda").to(dtype)
    w = 1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
    b = 0.1 * torch.randn(d, generator=gen, device="cuda")
    before = layer_norm.launches
    got = layer_norm(x, w, b, 1e-5)
    assert layer_norm.launches == before + 1
    if dtype == torch.bfloat16:
        _close(got, layer_norm_plain(x, w, b, 1e-5), 1e-2)
    else:
        _close(got, layer_norm_plain(x, w, b, 1e-5), 1e-5, 1e-5)


def _tables(gen, h, w, hd=64):
    """Distinct gathered rel-pos tables (h, h, hd) and (w, w, hd)."""
    rh = _rel_pos_table(0.1 * torch.randn((2 * h - 1, hd), generator=gen,
                                          device="cuda"), h)
    rw = _rel_pos_table(0.1 * torch.randn((2 * w - 1, hd), generator=gen,
                                          device="cuda"), w)
    return rh, rw


@pytest.mark.parametrize("b,grid,ws,heads", [
    (1, 28, 14, 2), (1, 70, 14, 16), (2, 28, 14, 3), (1, 24, 8, 2),
    (1, 32, 16, 2), (1, 15, 5, 2), (1, 40, 20, 2), (1, 64, 64, 1)])
def test_window_attention_kernel(gen, b, grid, ws, heads):
    """K2 (TMA + wgmma, fh/fw formed in the kernel) against its plain
    version: the main path's 70x70 grid of 14x14 windows with 16 heads,
    two images, windows of one key tile (8x8, 5x5) and of exactly two
    (16x16); windows past two tiles (20x20, 64x64) through K3's kernel;
    distinct tables, so swapped ones would show.  atol 8% of the output's
    rms (bf16 probabilities into PV, bf16 fh/fw)."""
    hd = 64
    qkv = torch.randn((b, grid, grid, 3 * heads * hd), generator=gen,
                      device="cuda").bfloat16()
    rh, rw = _tables(gen, ws, ws)
    before = attention.window_attention.launches
    got = attention.window_attention(qkv, rh, rw, heads, hd ** -0.5, ws)
    assert attention.window_attention.launches == before + 1
    want = attention.window_attention_plain(qkv, rh, rw, heads, hd ** -0.5,
                                            ws)
    rms = float(want.float().square().mean().sqrt())
    _close(got, want, 0.08 * rms)
    assert torch.equal(
        attention.window_attention(qkv, rh, rw, heads, hd ** -0.5, ws), got)


@pytest.mark.parametrize("hw", [(64, 64), (20, 24), (20, 20), (17, 64),
                                (64, 20), (1, 64), (7, 9)])
def test_relpos_kernel(gen, hw):
    """K3 (TMA + wgmma) against its plain version on strided views of one
    qkv buffer, distinct rel_h/rel_w tables: the main path's 64x64 grid and
    one 64 wide with a half tile at the end (the bias in registers), grids
    whose h is not w and the 20x20 grid (the bias folded into the product,
    one or two 64-dim slabs).  atol 12% of the output's rms."""
    h, w = hw
    heads, hd, s = 2, 64, h * w
    qkv = torch.randn((1, s, 3 * heads * hd), generator=gen,
                      device="cuda").bfloat16()
    q, k, v = qkv.reshape(1, s, 3, heads, hd).permute(2, 0, 3, 1, 4)
    rh, rw = _tables(gen, h, w)
    before = attention.flash_mha_decomposed_relpos.launches
    got = attention.flash_mha_decomposed_relpos(q, k, v, 0.125, rh, rw, hw)
    assert attention.flash_mha_decomposed_relpos.launches == before + 1
    want = attention.relpos_attention_plain(q, k, v, 0.125, rh, rw, hw)
    rms = float(want.float().square().mean().sqrt())
    _close(got, want, 0.12 * rms)
    swapped = attention.relpos_attention_plain(q, k, v, 0.125, rw, rh, hw) \
        if h == w else None
    if swapped is not None:       # the tables matter at this tolerance
        err = (swapped.float() - want.float()).abs()
        assert (err > 0.12 * rms + 2.0 ** -7 * want.float().abs()).any()
    again = attention.flash_mha_decomposed_relpos(q, k, v, 0.125, rh, rw, hw)
    assert torch.equal(again, got)


@pytest.mark.parametrize("valid", [None, 300])
def test_flash_kernels(gen, valid):
    g, heads, hd = 20, 2, 64
    qkv = torch.randn((1, g * g, 3 * heads * hd), generator=gen,
                      device="cuda").bfloat16()
    q, k, v = qkv.reshape(1, g * g, 3, heads, hd).permute(2, 0, 3, 1, 4)
    got = attention.flash_mha(q, k, v, 0.125, valid_len=valid)
    want = attention.flash_mha_plain(q, k, v, 0.125, valid)
    rows = valid or g * g
    _close(got[:, :, :rows], want[:, :, :rows], 6e-3)    # rms ~0.09
    rh, rw = _tables(gen, g, g)
    got = attention.flash_mha_decomposed_relpos(q, k, v, 0.125, rh, rw,
                                                (g, g))
    want = attention.relpos_attention_plain(q, k, v, 0.125, rh, rw, (g, g))
    _close(got, want, 1e-2)


@pytest.mark.parametrize("layout", ["contiguous", "strided"])
@pytest.mark.parametrize("short", [False, True])
@pytest.mark.parametrize("s", [64, 130, 1000])
def test_flash_mha_sm90_kernel(gen, s, short, layout):
    """K4 (TMA + wgmma) at batch 2: one key tile, a ragged second tile, and
    eight tiles; keys from valid_len on masked; contiguous (B, H, S, 64)
    operands and strided views of one qkv buffer (the latter bit for bit
    equal to the kernel on contiguous copies).  atol 7% of the output's
    rms (bf16 probabilities into PV)."""
    b, heads, hd = 2, 3, 64
    if layout == "strided":
        qkv = torch.randn((b, s, 3 * heads * hd), generator=gen,
                          device="cuda").bfloat16()
        q, k, v = qkv.reshape(b, s, 3, heads, hd).permute(2, 0, 3, 1, 4)
    else:
        q, k, v = (torch.randn((b, heads, s, hd), generator=gen,
                               device="cuda").bfloat16() for _ in range(3))
    valid = s - 37 if short else None
    before = attention.flash_mha.launches
    got = attention.flash_mha(q, k, v, 0.125, valid_len=valid)
    assert attention.flash_mha.launches == before + 1
    assert got.shape == (b, heads, s, hd) and got.stride(2) == heads * hd
    want = attention.flash_mha_plain(q, k, v, 0.125, valid)
    rms = float(want.float().square().mean().sqrt())
    _close(got, want, 0.07 * rms)
    again = attention.flash_mha(q, k, v, 0.125, valid_len=valid)
    assert torch.equal(again, got)
    if layout == "strided":
        dense = attention.flash_mha(q.contiguous(), k.contiguous(),
                                    v.contiguous(), 0.125, valid_len=valid)
        assert torch.equal(dense, got)


def test_kernels_refuse_what_they_do_not_take(gen):
    x = torch.randn((1, 2, 16, 32), device="cuda").bfloat16()
    with pytest.raises(ValueError, match="head dim"):
        attention.flash_mha(x, x, x, 0.125)
    with pytest.raises(TypeError):
        attention.flash_mha(*(torch.randn((1, 2, 16, 64), device="cuda"),) * 3,
                            0.125)
    odd = torch.randn((1, 16, 2 * 1028), device="cuda").bfloat16()
    odd = odd.as_strided((1, 2, 16, 64), (16 * 2 * 1028, 64, 2 * 1028 - 4, 1))
    with pytest.raises(ValueError, match="multiples of 16"):
        attention.flash_mha(odd, odd, odd, 0.125)
    qkv = torch.randn((1, 65, 65, 3 * 128), device="cuda").bfloat16()
    t65 = torch.zeros((65, 65, 64), device="cuda")
    with pytest.raises(ValueError, match="windows up to"):   # 65 x 65 keys
        attention.window_attention(qkv, t65, t65, 2, 0.125, 65)
    with pytest.raises(ValueError, match="unsupported shape"):  # dim 32
        attention.flash_mha_decomposed_relpos(x, x, x, 0.125, t65[:4, :4],
                                              t65[:4, :4], (4, 4))
    w = torch.ones(1536, device="cuda")
    with pytest.raises(ValueError, match="width"):
        layer_norm(torch.randn((5, 1536), device="cuda"), w, w, 1e-5)


def _decoder_operands(gen, image_size, p, t, point_tokens=False):
    """A vit_tiny SAM (the full-width decoder) at `image_size`, bf16, seeded:
    the shared tensors of its decode, (P, T, 256) tokens and hypernetwork
    vectors.  The tokens are normal draws, or with `point_tokens` what the
    main path feeds K5: the output tokens and a seeded point prompt's two
    sparse embeddings (T = 7), as `chip_smoke.py` builds them."""
    sam = sam_model_registry["vit_tiny"](image_size=image_size).cuda()
    init_random_(sam, torch.Generator(device="cuda").manual_seed(0))
    cast_compute_params(sam, torch.bfloat16)
    g = image_size // 16
    feats = torch.randn((1, g, g, 256), generator=gen,
                        device="cuda").bfloat16()
    with torch.no_grad():
        shared = precompute_decode_shared(
            sam.mask_decoder, sam.prompt_encoder.no_mask_embed.weight, feats,
            sam.prompt_encoder.get_dense_pe())
    if point_tokens:
        coords = torch.rand((p, 1, 2), generator=gen,
                            device="cuda") * image_size
        labels = torch.ones((p, 1), dtype=torch.int64, device="cuda")
        dec = sam.mask_decoder
        with torch.no_grad():
            sparse, _ = sam.prompt_encoder(points=(coords, labels))
            out_tok = torch.cat([dec.iou_token.weight,
                                 dec.mask_tokens.weight], dim=0)
            tokens = torch.cat([out_tok[None].expand(p, -1, -1),
                                sparse.to(out_tok.dtype)], dim=1)
        tokens = tokens.bfloat16().contiguous()
        assert tokens.shape == (p, t, 256)
    else:
        tokens = torch.randn((p, t, 256), generator=gen,
                             device="cuda").bfloat16()
    hyper = torch.randn((p, 4, 32), generator=gen, device="cuda").bfloat16()
    return shared, tokens, hyper


def _tail_args(shared, tokens):
    return (shared["keys0"], shared["q1i_flat"], shared["k1_flat"],
            shared["v1_flat"], tokens, shared["tail"])


@pytest.mark.parametrize("image_size,p,t,point_tokens", [
    (256, 3, 7, False), (256, 5, 6, False), (1024, 8, 7, False),
    (1024, 4, 6, False),
    # The batched token side: one prompt, 33 prompts (P * 8 rows not a
    # multiple of the 64-row tile), 5 and 8 tokens, the small config's
    # 32 x 7 at M = 256, and the main path's 32 x 7 at M = 4096 on the
    # main path's tokens and on normal draws (ROADMAP fault F3, where a
    # bf16 token state had put one element 1.11x over the bound).
    (256, 1, 7, False), (256, 33, 7, False), (256, 4, 5, False),
    (256, 4, 8, False), (256, 32, 7, False), (1024, 32, 7, True),
    (1024, 32, 7, False)])
def test_twoway_tail_kernel(gen, image_size, p, t, point_tokens):
    """K5 at M = 256 and 4096 image rows, 1 to 33 prompts, 5 to 8 tokens
    (the decoder's MLP width, 2048, is the small config's and the main
    path's)."""
    shared, tokens, _ = _decoder_operands(gen, image_size, p, t,
                                          point_tokens)
    args = _tail_args(shared, tokens)
    before = decode_tail_kernel.twoway_tail.launches
    keys2, tok = decode_tail_kernel.twoway_tail(*args)
    assert decode_tail_kernel.twoway_tail.launches == before + 1
    want_keys2, want_tok = decode_tail_kernel.twoway_tail_plain(*args)
    assert keys2.shape == (p, (image_size // 16) ** 2, 256)
    assert tok.shape == (p, t, 256)
    _close(keys2, want_keys2, 2e-2)
    _close(tok, want_tok, 2e-2)
    again = decode_tail_kernel.twoway_tail(*args)
    assert torch.equal(again[0], keys2) and torch.equal(again[1], tok)


@pytest.mark.parametrize("image_size,p", [
    (256, 3), (1024, 8),
    # The persistent grid (min(tiles, SMs) blocks of two warpgroups): 4,
    # 64 and 128 tiles (fewer than 132 SMs), 132 (one a block), 2048 (the
    # main path's, not a multiple of 132).
    (256, 1), (1024, 1), (256, 32), (256, 33), (1024, 32)])
@pytest.mark.parametrize("emit_exp", [False, True])
def test_mask_head_kernel(gen, image_size, p, emit_exp):
    """K6 at M = 256 and 4096 image rows, 1 to 33 prompts, with and without
    the exp terms."""
    shared, tokens, hyper = _decoder_operands(gen, image_size, p, 7)
    keys2, _ = decode_tail_kernel.twoway_tail_plain(*_tail_args(shared,
                                                                tokens))
    w = shared["mask_head"]
    before = mask_head_kernel.mask_head.launches
    got = mask_head_kernel.mask_head(keys2, hyper, w, emit_exp=emit_exp)
    assert mask_head_kernel.mask_head.launches == before + 1
    want = mask_head_kernel.mask_head_plain(keys2, hyper, w,
                                            emit_exp=emit_exp)
    masks, want_masks = (got[0], want[0]) if emit_exp else (got, want)
    m = (image_size // 16) ** 2
    assert masks.shape == (p, 4, m, 16) and masks.dtype == torch.bfloat16
    atol = 0.03 * float(want_masks.float().square().mean().sqrt())
    _close(masks, want_masks, atol)
    if emit_exp:
        assert got[2].shape == (p, m // mask_head_kernel.ROW_TILE)
        _close(got[1], want[1], 2e-2)
        _close(got[2], want[2], atol)


def test_decode_kernels_refuse_what_they_do_not_take(gen):
    shared, tokens, hyper = _decoder_operands(gen, 256, 3, 7)
    args = _tail_args(shared, tokens)
    keys2, _ = decode_tail_kernel.twoway_tail_plain(*args)
    w = shared["mask_head"]
    with pytest.raises(TypeError):                      # float32 input
        decode_tail_kernel.twoway_tail(args[0].float(), *args[1:])
    with pytest.raises(TypeError):
        mask_head_kernel.mask_head(keys2.float(), hyper, w)
    with pytest.raises(ValueError, match="contiguous"):  # strided input
        decode_tail_kernel.twoway_tail(
            *args[:4], tokens.transpose(0, 1).contiguous().transpose(0, 1),
            args[5])
    with pytest.raises(ValueError, match="contiguous"):
        mask_head_kernel.mask_head(
            keys2.transpose(1, 2).contiguous().transpose(1, 2), hyper, w)
    with pytest.raises(ValueError, match="multiple"):   # M % 64 != 0
        short = dict(shared["tail"])
        for name in ("kpe2", "qpe2i", "kpef"):
            short[name] = short[name][:200].contiguous()
        decode_tail_kernel.twoway_tail(
            *(x[:200].contiguous() for x in args[:4]), tokens, short)
    with pytest.raises(ValueError, match="multiple"):
        mask_head_kernel.mask_head(keys2[:, :200].contiguous(), hyper, w)
    with pytest.raises(ValueError, match="tokens"):     # T > 8
        decode_tail_kernel.twoway_tail(
            *args[:4], torch.cat([tokens, tokens], dim=1), args[5])
    with pytest.raises(ValueError, match="MLP width"):  # not 2048
        narrow = dict(shared["tail"])
        for name in ("mlp1_w", "mlp1l0_w"):
            narrow[name] = narrow[name][:1024].contiguous()
        for name in ("mlp1_b", "mlp1l0_b"):
            narrow[name] = narrow[name][:1024].contiguous()
        for name in ("mlp2_w", "mlp2l0_w"):
            narrow[name] = narrow[name][:, :1024].contiguous()
        decode_tail_kernel.twoway_tail(*args[:5], narrow)


def _survivor_operands(gen, k, r, dtype=torch.bfloat16):
    """Seeded logits (k, r, r), sparse edits and per-mask in_hw."""
    s = 4 * r
    x = (torch.randn((k, r, r), generator=gen, device="cuda") * 4).to(dtype)
    e = torch.randint(-1, 2, (k, r, r), generator=gen, device="cuda")
    keep = torch.rand((k, r, r), generator=gen, device="cuda") < 0.05
    edit = torch.where(keep, e, torch.zeros_like(e)).to(torch.int8)
    hw = torch.randint(s // 2, s + 1, (k, 2), generator=gen,
                       device="cuda").int()
    return x, edit, hw


@pytest.mark.parametrize("r", [64, 256])
@pytest.mark.parametrize("k", [1, 7, 32])
def test_survivor_kernel(gen, r, k):
    """K7 at R = 64 and 256, bf16 logits, per-mask in_hw: every output
    equal to the plain version's."""
    x, edit, hw = _survivor_operands(gen, k, r)
    before = survivor_kernel.survivor_rle.launches
    got = survivor_kernel.survivor_rle(x, edit, hw)
    assert survivor_kernel.survivor_rle.launches == before + 1
    want = survivor_kernel.survivor_rle_plain(x, edit, hw)
    for key in ("packed", "cand", "n_col", "summary"):
        assert got[key].dtype == want[key].dtype
        assert torch.equal(got[key], want[key]), key
    again = survivor_kernel.survivor_rle(x, edit, hw)
    assert all(torch.equal(again[key], got[key]) for key in got)


@pytest.mark.parametrize("k", [1, 32, 320])
def test_survivor_kernel_ragged_bands(gen, k):
    """K7 at the loaded pass's k = 1, k = 32 and the survivor slab's 320,
    R = 256, float32 and bf16 logits, with in_h and in_w off the band grid
    (S / 8 = 128 rows) and off multiples of 8, and one mask cut inside its
    first band: every output equal to the plain version's."""
    s = 1024
    x, edit, _ = _survivor_operands(gen, k, 256)
    hw = torch.tensor([[s - 37 - 131 * (i % 7), s - 5 - 97 * (i % 9)]
                       for i in range(k)], dtype=torch.int32, device="cuda")
    hw[0] = torch.tensor([77, 300])
    for logits in (x, x.float()):
        got = survivor_kernel.survivor_rle(logits, edit, hw)
        want = survivor_kernel.survivor_rle_plain(logits, edit, hw)
        for key in ("packed", "cand", "n_col", "summary"):
            assert torch.equal(got[key], want[key]), key


def test_survivor_kernel_refuses_what_it_does_not_take(gen):
    x, edit, hw = _survivor_operands(gen, 2, 64)
    with pytest.raises(TypeError):                      # float16 logits
        survivor_kernel.survivor_rle(x.half(), edit, hw)
    with pytest.raises(TypeError):                      # int32 edits
        survivor_kernel.survivor_rle(x, edit.int(), hw)
    with pytest.raises(TypeError):                      # int64 in_hw
        survivor_kernel.survivor_rle(x, edit, hw.long())
    with pytest.raises(ValueError, match="contiguous"):
        survivor_kernel.survivor_rle(x.transpose(1, 2), edit, hw)
    with pytest.raises(ValueError, match="shape"):      # R not a multiple
        survivor_kernel.survivor_rle(x[:, :48, :48].contiguous(),
                                     edit[:, :48, :48].contiguous(), hw)
    with pytest.raises(ValueError, match="on cpu"):     # in_hw on the host
        survivor_kernel.survivor_rle(x, edit, hw.cpu())


def test_survivor_kernel_clamps_in_hw_as_the_plain_version(gen):
    """in_hw outside [1, S] (0, negative, above S) is clamped in the kernel
    as in the plain version: equal outputs, no read past the staged strip."""
    x, edit, _ = _survivor_operands(gen, 3, 64)
    hw = torch.tensor([[0, 300], [-4, 0], [257, 1]], dtype=torch.int32,
                      device="cuda")
    got = survivor_kernel.survivor_rle(x, edit, hw)
    want = survivor_kernel.survivor_rle_plain(x, edit, hw)
    for key in ("packed", "cand", "n_col", "summary"):
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("n,d", [(1001, 64), (333, 256), (77, 1024),
                                 (7, 100)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_backward_kernel(gen, n, d, dtype):
    """K1 forward with statistics and K1's backward against autograd of
    the plain version, at ragged row counts; then the autograd path of
    `layer_norm` (forward and backward through the kernels)."""
    from crowdsam_tpu_torch.ops import layernorm as ln

    x = torch.randn((n, d), generator=gen, device="cuda").to(dtype)
    w = 1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
    b = 0.1 * torch.randn(d, generator=gen, device="cuda")
    dy = torch.randn((n, d), generator=gen, device="cuda").to(dtype)
    y, mean, rstd = ln._forward(x, w, b, 1e-5, stats=True)
    assert torch.equal(y, layer_norm(x, w, b, 1e-5))
    before = ln.layer_norm_backward.launches
    dx, dw, db = ln.layer_norm_backward(dy, x, w, mean, rstd)
    assert ln.layer_norm_backward.launches == before + 1
    want = ln.layer_norm_grads_plain(dy, x, w, b, 1e-5)
    _close(dx, want[0], 1e-2 if dtype == torch.bfloat16 else 1e-5,
           2.0 ** -7 if dtype == torch.bfloat16 else 0.0)
    for got, ref in ((dw, want[1]), (db, want[2])):
        _close(got, ref, 1e-4 * float(ref.abs().max()), 0.0)
    again = ln.layer_norm_backward(dy, x, w, mean, rstd)
    assert all(torch.equal(a, c) for a, c in zip(again, (dx, dw, db)))
    with torch.enable_grad():
        xr = x.clone().requires_grad_()
        wr = w.clone().requires_grad_()
        br = b.clone().requires_grad_()
        fwd, bwd = layer_norm.launches, ln.layer_norm_backward.launches
        layer_norm(xr, wr, br, 1e-5).backward(dy)
        assert layer_norm.launches == fwd + 1
        assert ln.layer_norm_backward.launches == bwd + 1
    assert torch.equal(xr.grad, dx) and torch.equal(wr.grad, dw)
    assert torch.equal(br.grad, db)


def test_full_decoder_training_steps_on_the_card(gen):
    """Two full-decoder steps of the port's trainer on a small config in
    bf16 (SAM ViT-B at 256^2 and DINOv2 ViT-S/14: head dim 64, which the
    attention kernels take): K1 forward and backward launch, every
    trainable leaf moves, the unused 5th hypernetwork MLP does not."""
    from crowdsam_tpu_torch.config import load_config, modify_config
    from crowdsam_tpu_torch.ops import layernorm as ln
    from crowdsam_tpu_torch.ops.transforms import ResizeLongestSide
    from crowdsam_tpu_torch.pipeline.crowdsam import CrowdSAM
    from crowdsam_tpu_torch.train.dataset import ArrayDataset
    from crowdsam_tpu_torch.train.trainer import AdapterTrainer
    from crowdsam_tpu_torch.utils.fixtures import ten_shot_arrays

    cfg = modify_config(load_config(None), [
        "model.sam_model", "vit_b", "model.image_size", "256",
        "model.dino_model", "dinov2_vits14",
        "model.sam_checkpoint", "", "model.dino_checkpoint", "",
        "model.sam_adapter_checkpoint", "", "train.n_shot", "2",
        "train.steps", "2", "train.samples_per_batch", "4",
        "train.lr", "1e-3", "train.full_decoder", "True"])
    model = CrowdSAM(cfg, device="cuda")
    imgs, boxes = ten_shot_arrays(0, n_images=2)
    data = ArrayDataset([ResizeLongestSide(256).apply_image(i)
                         for i in imgs], boxes)
    trainer = AdapterTrainer(cfg, model.predictor)
    before = {k: v.clone() for k, v in
              model.sam.mask_decoder.state_dict().items()}
    fwd, bwd = layer_norm.launches, ln.layer_norm_backward.launches
    history = []
    params = trainer.train(data, on_step=lambda step, ls: history.append(
        {k: float(v) for k, v in ls.items()}))
    # Ten LayerNorms a step: norm1-norm4 of both blocks, the final one and
    # the upscaling's.
    assert ln.layer_norm_backward.launches - bwd == 2 * 10
    assert layer_norm.launches > fwd
    assert len(history) == 2
    assert all(np.isfinite(v) for h in history for v in h.values())
    after = model.sam.mask_decoder.state_dict()
    for k, v in before.items():
        if k in params:
            assert torch.isfinite(params[k]).all()
            assert not torch.equal(after[k], v), k
        else:
            assert k.startswith("output_hypernetworks_mlps.4.")
            assert torch.equal(after[k], v), k
