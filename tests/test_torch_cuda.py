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


# K1's arms: widths 4 and 100 (bf16) take the scalar arm, 16-256 the row
# groups of 2-32 lanes, 1024 and 1280 one warp a row; row counts below one
# block, ragged against a chunk (128 rows at width 64) and against a row
# group (4 rows a warp at width 64, 16 at width 16 bf16).
@pytest.mark.parametrize("n,d", [(1, 64), (37, 256), (1000, 1024),
                                 (1000, 1280), (1000, 4), (1000, 16),
                                 (5, 16), (33, 4), (3, 72), (1001, 72),
                                 (777, 100), (70001, 64), (9999, 256),
                                 (130, 1024), (2, 1280)])
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


@pytest.mark.parametrize("d", [64, 256, 1024])
def test_layer_norm_kernel_unaligned_rows(gen, d):
    """x and y 2 bytes off a 16-byte boundary: the scalar arm takes them
    (the vector arm's bulk copies need 16-byte aligned rows); forward with
    statistics and backward against the plain version."""
    from crowdsam_tpu_torch.ops import layernorm as ln

    n = 301
    buf = torch.randn(n * d + 1, generator=gen, device="cuda").to(
        torch.bfloat16)
    x = buf[1:].view(n, d)
    w = 1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
    b = 0.1 * torch.randn(d, generator=gen, device="cuda")
    dy = torch.randn(n * d + 1, generator=gen, device="cuda").to(
        torch.bfloat16)[1:].view(n, d)
    y, mean, rstd = ln._forward(x, w, b, 1e-5, stats=True)
    _close(y, layer_norm_plain(x, w, b, 1e-5), 1e-2)
    dx, dw, db = ln.layer_norm_backward(dy, x, w, mean, rstd)
    want = ln.layer_norm_grads_plain(dy, x, w, b, 1e-5)
    _close(dx, want[0], 1e-2)
    for got, ref in ((dw, want[1]), (db, want[2])):
        _close(got, ref, 1e-4 * float(ref.abs().max()), 0.0)


@pytest.mark.parametrize("backward", [False, True])
def test_layer_norm_plan_matches_the_source(gen, backward):
    """The source's `ln_plan` lays the rows out as the Python description
    (`forward_plan`, `backward_plan`) says, at every arm's widths."""
    import ctypes

    from crowdsam_tpu_torch.kernels import _build
    from crowdsam_tpu_torch.ops import layernorm as ln

    fn = _build.function("layernorm", "ln_plan",
                         (ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p))
    for dtype in (torch.bfloat16, torch.float32):
        for d in (4, 8, 16, 32, 64, 72, 100, 128, 256, 512, 1024, 1280):
            if backward and d > ln.MAX_BWD_WIDTH:
                continue
            for rows in (1, 33, 420, 4096, 5330, 524288, 983040):
                out = (ctypes.c_longlong * 11)()
                _build.check(fn(int(backward), rows, d, ln._DTYPES[dtype],
                                ctypes.cast(out, ctypes.c_void_p)), "ln_plan")
                got = list(out)
                sms, occ = got[9], got[8]
                want = (ln.backward_plan(rows, d, dtype, sms) if backward
                        else ln.forward_plan(rows, d, dtype, sms, occ))
                arm = want["arm"] or (0, 0)
                assert got[:2] == list(arm), (d, dtype, rows, got, want)
                assert got[3:6] == [want["rows_per_group"],
                                    want["chunk_rows"], want["grid"]]
                assert got[6] == (want["rows_per_block"] if backward
                                  else want["chunks"])
                assert got[10] == int(want["direct"])
                if backward:
                    assert got[5] == ln.backward_blocks(rows, sms)


def _tables(gen, h, w, hd=64):
    """Distinct gathered rel-pos tables (h, h, hd) and (w, w, hd)."""
    rh = _rel_pos_table(0.1 * torch.randn((2 * h - 1, hd), generator=gen,
                                          device="cuda"), h)
    rw = _rel_pos_table(0.1 * torch.randn((2 * w - 1, hd), generator=gen,
                                          device="cuda"), w)
    return rh, rw


@pytest.mark.parametrize("b,grid,ws,heads", [
    (1, 28, 14, 2), (1, 70, 14, 16), (2, 28, 14, 3), (1, 24, 8, 2),
    (1, 32, 16, 2), (1, 15, 5, 2), (1, 40, 20, 2), (1, 64, 64, 1),
    (1, (56, 70), 14, 16), (1, (70, 56), 14, 16)])
def test_window_attention_kernel(gen, b, grid, ws, heads):
    """K2 (TMA + wgmma, fh/fw formed in the kernel) against its plain
    version: the main path's 70x70 grid of 14x14 windows with 16 heads,
    two images, windows of one key tile (8x8, 5x5) and of exactly two
    (16x16); windows past two tiles (20x20, 64x64) through K3's kernel;
    the rect encode's padded bands of 4x5 and 5x4 windows; distinct
    tables, so swapped ones would show.  atol 8% of the output's rms (bf16
    probabilities into PV, bf16 fh/fw)."""
    hd = 64
    gh, gw = grid if isinstance(grid, tuple) else (grid, grid)
    qkv = torch.randn((b, gh, gw, 3 * heads * hd), generator=gen,
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
                                (64, 20), (1, 64), (7, 9), (44, 64),
                                (48, 64), (64, 48), (64, 44)])
def test_relpos_kernel(gen, hw):
    """K3 (TMA + wgmma) against its plain version on strided views of one
    qkv buffer, distinct rel_h/rel_w tables: the main path's 64x64 grid and
    one 64 wide with a half tile at the end (the bias in registers), grids
    64 tall (64x20, the rect encode's 64x48 of a 1024x768 frame and 64x44:
    the bias in registers on the exchanged grid, read column by column),
    grids under 64 both ways (the bias folded into the product, one or two
    64-dim slabs); the rect encode's 44x64 and 48x64 (registers).  atol 12%
    of the output's rms."""
    h, w = hw
    heads, hd, s = 2, 64, h * w
    qkv = torch.randn((1, s, 3 * heads * hd), generator=gen,
                      device="cuda").bfloat16()
    q, k, v = qkv.reshape(1, s, 3, heads, hd).permute(2, 0, 3, 1, 4)
    rh, rw = _tables(gen, h, w)
    k3 = attention.flash_mha_decomposed_relpos
    form = attention.relpos_form(h, w, s)
    before, by_form = k3.launches, k3.launches_by_form[form]
    got = attention.flash_mha_decomposed_relpos(q, k, v, 0.125, rh, rw, hw)
    assert k3.launches == before + 1
    assert k3.launches_by_form[form] == by_form + 1
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


@pytest.mark.parametrize("b,grid,ws,heads", [
    (1, 28, 14, 2), (1, 70, 14, 16), (2, 28, 14, 3), (2, 70, 14, 16),
    (1, 32, 16, 2), (1, 24, 8, 2), (1, 15, 5, 2), (1, 40, 20, 2)])
def test_window_attention_kernel_head_dim_80(gen, b, grid, ws, heads):
    """K2 at SAM ViT-H's head dim 80 (dims 64-79 as a second slab in the
    kernel, its own layout of two blocks an SM): the main path's 70x70 grid
    with 16 heads at one and two images, windows of one and of two key
    tiles (5x5 and 8x8 ones smaller than a batch of seven table tiles), and
    20x20 windows through K3's kernel; atol 8% of the output's rms, as at
    64."""
    hd = 80
    qkv = torch.randn((b, grid, grid, 3 * heads * hd), generator=gen,
                      device="cuda").bfloat16()
    rh, rw = _tables(gen, ws, ws, hd)
    before = attention.window_attention.launches
    got = attention.window_attention(qkv, rh, rw, heads, hd ** -0.5, ws)
    assert attention.window_attention.launches == before + 1
    want = attention.window_attention_plain(qkv, rh, rw, heads, hd ** -0.5,
                                            ws)
    rms = float(want.float().square().mean().sqrt())
    _close(got, want, 0.08 * rms)


@pytest.mark.parametrize("hw", [(64, 64), (20, 24), (17, 64), (7, 9),
                                (64, 48), (64, 44), (64, 45)])
def test_relpos_kernel_head_dim_80(gen, hw):
    """K3 at head dim 80 on strided views of one qkv buffer: SAM ViT-H's
    64x64 grid (the bias in registers, a block of two consumers two grid
    rows; 17 rows leave the last block one), grids 64 tall (on the
    exchanged grid, a block two grid columns; 45 wide leaves the last block
    one) and other grids (the bias folded); atol 12% of the output's rms,
    as at 64."""
    h, w = hw
    heads, hd, s = 2, 80, h * w
    qkv = torch.randn((1, s, 3 * heads * hd), generator=gen,
                      device="cuda").bfloat16()
    q, k, v = qkv.reshape(1, s, 3, heads, hd).permute(2, 0, 3, 1, 4)
    rh, rw = _tables(gen, h, w, hd)
    got = attention.flash_mha_decomposed_relpos(q, k, v, hd ** -0.5, rh, rw,
                                                hw)
    want = attention.relpos_attention_plain(q, k, v, hd ** -0.5, rh, rw, hw)
    rms = float(want.float().square().mean().sqrt())
    _close(got, want, 0.12 * rms)
    # the 16-dim slab matters at this tolerance: without it (q.k over dims
    # 0-63 only) the plain version breaks the bound
    q0 = q.clone()
    q0[..., 64:] = 0
    drop = attention.relpos_attention_plain(q0, k, v, hd ** -0.5, rh, rw, hw)
    err = (drop.float() - want.float()).abs()
    assert (err > 0.12 * rms + 2.0 ** -7 * want.float().abs()).any()


@pytest.mark.parametrize("hw,hd,parts", [((64, 64), 64, 2), ((64, 64), 80, 4),
                                         ((16, 16), 64, 2), ((20, 24), 64, 2),
                                         ((64, 64), 80, ((0, 21), (21, 42),
                                                         (42, 64)))])
def test_relpos_kernel_query_bands(gen, hw, hd, parts):
    """K3 on query bands, a rank's of the spatial axis: window-aligned grid
    rows (`parts` ranks' `window_bands`, or the bands given) against every
    key of the grid (64 wide: the bias in registers, Rh from the band's
    first row on; else folded, fh/fw cut to the band), each band against
    the plain version's band; atol 12% of the output's rms, as for the
    whole grid.  At head dim 80 also bands of an odd row count (the last
    block of two consumers holds one row) and from an odd row, through
    `relpos_global_launch` in the form the grid takes."""
    from crowdsam_tpu_torch.parallel.spatial import window_bands

    h, w = hw
    heads, s = 2, h * w
    qkv = torch.randn((1, s, 3 * heads * hd), generator=gen,
                      device="cuda").bfloat16()
    q, k, v = qkv.reshape(1, s, 3, heads, hd).permute(2, 0, 3, 1, 4)
    rh, rw = _tables(gen, h, w, hd)
    scale = hd ** -0.5
    want = attention.relpos_attention_plain(q, k, v, scale, rh, rw, hw)
    rms = float(want.float().square().mean().sqrt())
    given = not isinstance(parts, int)
    bands = parts if given else window_bands(h, 14 if h > 16 else 8, parts)
    for lo, hi in bands:
        rows = slice(lo * w, hi * w)
        if given:
            form = attention.relpos_form(h, w, (hi - lo) * w, lo)
            got = attention.relpos_global_launch(q[:, :, rows], k, v, scale,
                                                 rh, rw, hw, form, lo)
        else:
            got = attention.flash_mha_decomposed_relpos(
                q[:, :, rows], k, v, scale, rh, rw, hw, lo)
        assert got.shape == (1, heads, (hi - lo) * w, hd)
        band = attention.relpos_attention_plain(q[:, :, rows], k, v, scale,
                                                rh, rw, hw, lo)
        _close(got, band, 0.12 * rms)
        _close(got, want[:, :, rows], 0.12 * rms)


@pytest.mark.parametrize("bounds", [((0, 163), (163, 325)),
                                    ((0, 64), (64, 300), (300, 325))])
def test_flash_mha_sm90_query_bands(gen, bounds):
    """K4 with fewer queries than keys (a rank's token band of DINOv2):
    each band of 325 tokens against every key, against the plain version;
    atol 7% of the output's rms."""
    b, heads, hd, s = 2, 3, 64, 325
    qkv = torch.randn((b, s, 3 * heads * hd), generator=gen,
                      device="cuda").bfloat16()
    q, k, v = qkv.reshape(b, s, 3, heads, hd).permute(2, 0, 3, 1, 4)
    want = attention.flash_mha_plain(q, k, v, 0.125)
    rms = float(want.float().square().mean().sqrt())
    for lo, hi in bounds:
        got = attention.flash_mha(q[:, :, lo:hi], k, v, 0.125)
        assert got.shape == (b, heads, hi - lo, hd)
        _close(got, want[:, :, lo:hi], 0.07 * rms)


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
    t65 = torch.zeros((65, 65, 64), device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        attention.flash_mha(x, x, x, 0.125)
    # float16 has no arm (bf16 goes to the kernels, float32 to their
    # float32 arms); a float32 head dim outside (64, 80) is refused too.
    with pytest.raises(TypeError):
        attention.flash_mha(*(torch.randn((1, 2, 16, 64), device="cuda")
                              .half(),) * 3, 0.125)
    with pytest.raises(ValueError, match="head dim"):
        attention.flash_mha(*(x.float(),) * 3, 0.125)
    with pytest.raises(ValueError, match="head dims"):
        attention.flash_mha_decomposed_relpos(*(x.float(),) * 3, 0.125,
                                              t65[:4, :4, :32],
                                              t65[:4, :4, :32], (4, 4))
    odd = torch.randn((1, 16, 2 * 1028), device="cuda").bfloat16()
    odd = odd.as_strided((1, 2, 16, 64), (16 * 2 * 1028, 64, 2 * 1028 - 4, 1))
    with pytest.raises(ValueError, match="multiples of 16"):
        attention.flash_mha(odd, odd, odd, 0.125)
    qkv = torch.randn((1, 65, 65, 3 * 128), device="cuda").bfloat16()
    with pytest.raises(ValueError, match="windows up to"):   # 65 x 65 keys
        attention.window_attention(qkv, t65, t65, 2, 0.125, 65)
    with pytest.raises(ValueError, match="unsupported shape"):  # dim 32
        attention.flash_mha_decomposed_relpos(x, x, x, 0.125, t65[:4, :4],
                                              t65[:4, :4], (4, 4))
    w = torch.ones(1536, device="cuda")
    with pytest.raises(ValueError, match="width"):
        layer_norm(torch.randn((5, 1536), device="cuda"), w, w, 1e-5)


def _decoder_operands(gen, image_size, p, t, point_tokens=False,
                      dtype=torch.bfloat16, n_img=1):
    """A vit_tiny SAM (the full-width decoder) at `image_size` in `dtype`,
    seeded: the shared tensors of its decode over `n_img` images, (P, T,
    256) tokens and hypernetwork vectors.  The tokens are normal draws, or
    with `point_tokens` what the main path feeds K5: the output tokens and
    a seeded point prompt's two sparse embeddings (T = 7), as
    `chip_smoke.py` builds them."""
    sam = sam_model_registry["vit_tiny"](image_size=image_size).cuda()
    init_random_(sam, torch.Generator(device="cuda").manual_seed(0))
    cast_compute_params(sam, dtype)
    g = image_size // 16
    feats = torch.randn((n_img, g, g, 256), generator=gen,
                        device="cuda").to(dtype)
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
        tokens = tokens.to(dtype).contiguous()
        assert tokens.shape == (p, t, 256)
    else:
        tokens = torch.randn((p, t, 256), generator=gen,
                             device="cuda").to(dtype)
    hyper = torch.randn((p, 4, 32), generator=gen, device="cuda").to(dtype)
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
    with pytest.raises(TypeError):      # float32 keys, bf16 the others
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
                                 (7, 100), (1, 4), (33, 16), (4097, 72),
                                 (5, 256), (20000, 64), (1500, 1024),
                                 (100003, 64)])
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


SMALL = ["model.sam_model", "vit_b", "model.image_size", "256",
         "model.dino_model", "dinov2_vits14", "model.sam_checkpoint", "",
         "model.dino_checkpoint", "", "model.sam_adapter_checkpoint", "",
         "test.max_size", "256", "test.grid_size", "48",
         "test.max_prompts", "64", "test.pred_iou_thresh", "0.0",
         "test.stability_score_thresh", "0.0"]


def _record_masks_fit(records, hw):
    from crowdsam_tpu_torch.ops.rle import coco_decode_rle

    for r in records:
        m = coco_decode_rle(r["segmentation"])
        assert m.shape == hw and int(m.sum()) == r["area"]
        if r["area"]:
            ys, xs = np.nonzero(m)
            x, y, w, h = r["bbox"]
            assert xs.min() >= x and xs.max() <= x + w
            assert ys.min() >= y and ys.max() <= y + h


def _f32_case(gen, arm, shape):
    """The float32 arm's preparation (`attention.*_f32_attention`) of one
    case on the card: K2 (grid, heads, hd) on a padded grid of 14x14
    windows, K3 (grid, hd, rows) over a 64-wide table pair resized to the
    grid, K4 (s, band) at 16 heads of 64."""
    if arm == "K2":
        (gh, gw), heads, hd = shape
        qkv = torch.randn((1, gh, gw, 3 * heads * hd), generator=gen,
                          device="cuda")
        tabs = [_rel_pos_table(0.1 * torch.randn(
            (27, hd), generator=gen, device="cuda"), 14) for _ in range(2)]
        return (attention.window_f32_attention(qkv, *tabs, heads,
                                               hd ** -0.5, 14),
                lambda: attention.window_attention(qkv, *tabs, heads,
                                                   hd ** -0.5, 14))
    if arm == "K3":
        (hh, ww), hd, (lo, hi) = shape
        qkv = torch.randn((1, hh * ww, 3, 16, hd), generator=gen,
                          device="cuda")
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        q = q[:, :, lo * ww:hi * ww]
        rh = _rel_pos_table(0.1 * torch.randn((127, hd), generator=gen,
                                              device="cuda"), hh)
        rw = _rel_pos_table(0.1 * torch.randn((127, hd), generator=gen,
                                              device="cuda"), ww)
        return (attention.relpos_f32_attention(q, k, v, hd ** -0.5, rh, rw,
                                               (hh, ww), lo),
                lambda: attention.flash_mha_decomposed_relpos(
                    q, k, v, hd ** -0.5, rh, rw, (hh, ww), lo))
    s, (lo, hi) = shape
    qkv = torch.randn((1, s, 3, 16, 64), generator=gen, device="cuda")
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    q = q[:, :, lo:hi]
    return (attention.flash_f32_attention(q, k, v, 0.125, s),
            lambda: attention.flash_mha(q, k, v, 0.125, valid_len=s))


def _as64(a):
    """The same preparation with every tensor in float64."""
    f = {k: (getattr(a, k).double() if getattr(a, k) is not None else None)
         for k in ("q", "k", "v", "fh", "fw")}
    return attention.F32Attention(f["q"], f["k"], f["v"], a.scale, a.valid,
                                  f["fh"], f["fw"], a.grid)


@pytest.mark.parametrize("arm,shape", [
    ("K2", ((70, 70), 16, 64)), ("K2", ((70, 70), 16, 80)),
    ("K2", ((28, 70), 16, 64)),
    ("K3", ((64, 64), 64, (0, 64))), ("K3", ((64, 48), 64, (0, 64))),
    ("K3", ((44, 64), 64, (0, 44))), ("K3", ((64, 64), 80, (0, 64))),
    ("K3", ((64, 64), 64, (42, 64))),
    ("K4", (5330, (0, 5330))), ("K4", (4096, (0, 4096))),
    ("K4", (5330, (2628, 5330))), ("K4", (1000, (0, 1000)))],
    ids=["K2-25x16x196x64", "K2-25x16x196x80", "K2-halo-10x16x196x64",
         "K3-64x64", "K3-64x48", "K3-44x64", "K3-64x64-hd80",
         "K3-band-42-64", "K4-5330", "K4-4096", "K4-band-2702-of-5330",
         "K4-1000"])
def test_float32_arm_against_float64(gen, arm, shape):
    """Each float32 arm through its wrapper on float32 CUDA tensors, against
    a float64 evaluation of the same function on the card: its max and
    mean absolute error at most 2x the plain float32 version's (TF32 off),
    with a floor of 1e-7 of max |out|; one launch of the arm, counted as
    float32."""
    a, call = _f32_case(gen, arm, shape)
    wrapper = {"K2": attention.window_attention,
               "K3": attention.flash_mha_decomposed_relpos,
               "K4": attention.flash_mha}[arm]
    before = wrapper.launches_by_dtype["float32"]
    got = call()
    torch.cuda.synchronize()
    assert wrapper.launches_by_dtype["float32"] == before + 1
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    want = attention.f32_attention_plain(_as64(a))
    plain = attention.f32_attention_plain(a)
    if arm == "K2":
        (gh, gw), _, _ = shape
        want, plain = (attention.window_f32_output(x, 14, gh, gw)
                       for x in (want, plain))
    floor = 1e-7 * float(want.abs().max())
    for stat in (torch.amax, torch.mean):
        err = float(stat((got.double() - want).abs()))
        ref = float(stat((plain.double() - want).abs()))
        assert err <= max(2 * ref, floor), (stat.__name__, err, ref)


def test_float32_unfused_generate_on_the_card(gen):
    """The small config in float32 with `tpu.fused_decode false` runs on
    the card through the float32 arms of K1-K4 (K5, K6 not launched) and
    gives the detections of the CPU's plain path: equal counts, boxes
    within 0.5 px, scores within 1e-4."""
    from crowdsam_tpu_torch.config import load_config, modify_config
    from crowdsam_tpu_torch.pipeline.crowdsam import CrowdSAM
    from crowdsam_tpu_torch.utils.synthetic import crowd_scene

    cfg = modify_config(load_config(None), list(SMALL) + [
        "tpu.compute_dtype", "float32", "tpu.fused_decode", "false"])
    img = crowd_scene(3, 171, 256, people=(3, 6))[0]
    noise = [np.random.default_rng(3).uniform(size=48 * 48).astype(
        np.float32)]
    kernels = {"window_attention": attention.window_attention,
               "flash_mha_decomposed_relpos":
                   attention.flash_mha_decomposed_relpos,
               "flash_mha": attention.flash_mha}
    before = {k: fn.launches_by_dtype["float32"] for k, fn in kernels.items()}
    ln0 = layer_norm.launches
    k56 = (decode_tail_kernel.twoway_tail.launches,
           mask_head_kernel.mask_head.launches)
    card = CrowdSAM(cfg, device="cuda").generate(img, noise=noise)
    for k, fn in kernels.items():
        assert fn.launches_by_dtype["float32"] > before[k], k
    assert layer_norm.launches > ln0
    assert (decode_tail_kernel.twoway_tail.launches,
            mask_head_kernel.mask_head.launches) == k56
    cpu = CrowdSAM(cfg, device="cpu").generate(img, noise=noise)
    assert len(card["boxes"]) == len(cpu["boxes"]) > 0
    np.testing.assert_allclose(np.asarray(card["boxes"], np.float64),
                               np.asarray(cpu["boxes"], np.float64),
                               atol=0.5)
    np.testing.assert_allclose(card["scores"], cpu["scores"], atol=1e-4)


def test_float32_fused_generate_on_the_card(gen):
    """The small config in float32 with the fused decode runs on the card:
    K5 and K6 gain float32 launches (their float32 arms), and it gives the
    detections of the CPU's plain path: equal counts, boxes within 0.5 px,
    scores within 1e-4."""
    from crowdsam_tpu_torch.config import load_config, modify_config
    from crowdsam_tpu_torch.pipeline.crowdsam import CrowdSAM
    from crowdsam_tpu_torch.utils.synthetic import crowd_scene

    cfg = modify_config(load_config(None), list(SMALL) + [
        "tpu.compute_dtype", "float32", "tpu.fused_decode", "true"])
    img = crowd_scene(3, 171, 256, people=(3, 6))[0]
    noise = [np.random.default_rng(3).uniform(size=48 * 48).astype(
        np.float32)]
    kernels = (decode_tail_kernel.twoway_tail, mask_head_kernel.mask_head)
    before = [fn.launches_by_dtype["float32"] for fn in kernels]
    card = CrowdSAM(cfg, device="cuda").generate(img, noise=noise)
    assert all(fn.launches_by_dtype["float32"] > n
               for fn, n in zip(kernels, before))
    cpu = CrowdSAM(cfg, device="cpu").generate(img, noise=noise)
    assert len(card["boxes"]) == len(cpu["boxes"]) > 0
    np.testing.assert_allclose(np.asarray(card["boxes"], np.float64),
                               np.asarray(cpu["boxes"], np.float64),
                               atol=0.5)
    np.testing.assert_allclose(card["scores"], cpu["scores"], atol=1e-4)


def _held_to_float64(got, plain, want):
    """A float32 arm's output within 2x the plain float32 version's error
    from float64 (max and mean), with a floor of 1e-7 of max |out|."""
    want = want.double()
    floor = 1e-7 * float(want.abs().max())
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    for stat in (torch.amax, torch.mean):
        err = float(stat((got.double() - want).abs()))
        ref = float(stat((plain.double() - want).abs()))
        assert err <= max(2 * ref, floor), (stat.__name__, err, ref)


def _f64(params):
    return {k: v.double() for k, v in params.items()}


@pytest.mark.parametrize("image_size,p,t,n_img", [
    (1024, 32, 7, 1), (256, 32, 7, 1), (1024, 32, 7, 2), (1024, 16, 7, 1),
    (1024, 32, 8, 1), (256, 33, 5, 1), (256, 3, 2, 2)],
    ids=["main-path", "small", "two-images", "prompt-shard", "T8",
         "33-prompts", "T2-two-images"])
def test_twoway_tail_float32_arm_against_float64(gen, image_size, p, t,
                                                 n_img):
    """K5's float32 arm on float32 operands: one launch counted as float32,
    keys2 and the tokens held to a float64 evaluation of the plain version
    (`_held_to_float64`), two calls bit for bit."""
    shared, tokens, _ = _decoder_operands(gen, image_size, p, t,
                                          dtype=torch.float32, n_img=n_img)
    args = _tail_args(shared, tokens)
    img = None if n_img == 1 else (torch.arange(
        p, device="cuda") % n_img).to(torch.int32)
    before = decode_tail_kernel.twoway_tail.launches_by_dtype["float32"]
    got = decode_tail_kernel.twoway_tail(*args, img=img)
    torch.cuda.synchronize()
    assert decode_tail_kernel.twoway_tail.launches_by_dtype["float32"] == \
        before + 1
    plain = decode_tail_kernel.twoway_tail_plain(*args, img=img)
    want = decode_tail_kernel.twoway_tail_plain(
        *(x.double() for x in args[:5]), _f64(args[5]), img=img)
    for g, q, w in zip(got, plain, want):
        _held_to_float64(g, q, w)
    again = decode_tail_kernel.twoway_tail(*args, img=img)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


@pytest.mark.parametrize("image_size,p,emit_exp", [
    (1024, 32, True), (1024, 32, False), (256, 32, True), (1024, 16, True),
    (256, 1, True)])
def test_mask_head_float32_arm_against_float64(gen, image_size, p,
                                               emit_exp):
    """K6's float32 arm on float32 operands: one launch counted as float32,
    masks (and e, mx) held to a float64 evaluation of the plain version."""
    shared, tokens, hyper = _decoder_operands(gen, image_size, p, 7,
                                              dtype=torch.float32)
    keys2, _ = decode_tail_kernel.twoway_tail_plain(*_tail_args(shared,
                                                                tokens))
    hyper = hyper * 64.0          # mask logits of a trained decoder's spread
    w = shared["mask_head"]
    before = mask_head_kernel.mask_head.launches_by_dtype["float32"]
    got = mask_head_kernel.mask_head(keys2, hyper, w, emit_exp=emit_exp)
    torch.cuda.synchronize()
    assert mask_head_kernel.mask_head.launches_by_dtype["float32"] == \
        before + 1
    plain = mask_head_kernel.mask_head_plain(keys2, hyper, w, emit_exp)
    want = mask_head_kernel.mask_head_plain(keys2.double(), hyper.double(),
                                            _f64(w), emit_exp)
    if not emit_exp:
        got, plain, want = (got,), (plain,), (want,)
    assert got[0].shape == (p, 4, (image_size // 16) ** 2, 16)
    for g, q, x in zip(got, plain, want):
        _held_to_float64(g, q, x)


def test_amg_on_the_small_config(gen):
    """The automatic mask generator on the card (bf16, K1-K3 in the SAM
    encoder) against the plain float32 path on the CPU, same weights:
    records whose masks fit their boxes, and the CPU's record boxes
    matched at IoU >= 0.9."""
    from crowdsam_tpu_torch.config import load_config, modify_config
    from crowdsam_tpu_torch.pipeline.amg_generator import (
        SamAutomaticMaskGenerator,
    )
    from crowdsam_tpu_torch.pipeline.crowdsam import build_models
    from crowdsam_tpu_torch.utils.synthetic import crowd_scene

    cfg = modify_config(load_config(None), list(SMALL))
    sam, _ = build_models(cfg, "cuda")
    cpu_sam, _ = build_models(
        modify_config(cfg, ["tpu.compute_dtype", "float32"]), "cpu")
    img = crowd_scene(3, 171, 256, people=(3, 6))[0]
    kw = dict(points_per_side=16, points_per_batch=64, pred_iou_thresh=0.0,
              stability_score_thresh=0.0, min_mask_region_area=20,
              output_mode="coco_rle")
    before = {k: getattr(attention, k).launches for k in
              ("window_attention", "flash_mha_decomposed_relpos")}
    ln0 = layer_norm.launches
    on_card = SamAutomaticMaskGenerator(sam, device="cuda",
                                        **kw).generate(img)
    assert layer_norm.launches > ln0
    for k, v in before.items():
        assert getattr(attention, k).launches > v, k
    on_cpu = SamAutomaticMaskGenerator(cpu_sam, device="cpu",
                                       **kw).generate(img)
    assert on_card and on_cpu
    _record_masks_fit(on_card, img.shape[:2])
    card = np.asarray([r["bbox"] for r in on_card], np.float64)
    for r in on_cpu:
        b = np.asarray(r["bbox"], np.float64)
        lt = np.maximum(card[:, :2], b[:2])
        rb = np.minimum(card[:, :2] + card[:, 2:], b[:2] + b[2:])
        inter = np.prod(np.clip(rb - lt, 0, None), axis=1)
        iou = inter / (card[:, 2] * card[:, 3] + b[2] * b[3] - inter)
        assert iou.max() >= 0.9


def test_tools_test_cli_on_the_small_config(gen, tmp_path):
    """`tools.test` in-process on the card (no --device) on two seeded
    frames: every kernel of the fused path launches, the result dicts
    have the JAX CLI's keys and the scores of `generate_many` with the
    same noise, and `tools.crowdhuman_eval` scores them."""
    import json

    import cv2

    from crowdsam_tpu_torch.tools import crowdhuman_eval
    from crowdsam_tpu_torch.tools import test as test_cli
    from crowdsam_tpu_torch.utils.synthetic import crowd_scene

    (tmp_path / "Images").mkdir()
    images, annots, odgt, frames = [], [], [], []
    for i in range(2):
        img, boxes = crowd_scene(10 + i, 171, 256, people=(3, 6))
        frames.append(img)
        cv2.imwrite(str(tmp_path / "Images" / f"s{i}.png"), img[..., ::-1])
        images.append({"file_name": f"s{i}.png", "id": i, "height": 171,
                       "width": 256})
        for b in boxes:
            annots.append({"image_id": i, "bbox": list(b), "ignore": 0,
                           "id": len(annots), "category_id": 1})
        odgt.append({"ID": f"s{i}", "gtboxes": [
            {"tag": "person", "fbox": list(b), "vbox": list(b)}
            for b in boxes]})
    (tmp_path / "val.json").write_text(json.dumps(
        {"images": images, "annotations": annots, "categories": []}))
    (tmp_path / "val.odgt").write_text("\n".join(map(json.dumps, odgt)))
    data = ["data.dataset_root", str(tmp_path),
            "data.json_file", str(tmp_path / "val.json"),
            "environ.output_dir", str(tmp_path / "out")]
    captured = []

    class Capturing(test_cli.CrowdSAM):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            captured.append(self)

    counts = {k: getattr(m, k).launches for m, k in (
        (attention, "window_attention"),
        (attention, "flash_mha_decomposed_relpos"), (attention, "flash_mha"),
        (decode_tail_kernel, "twoway_tail"), (mask_head_kernel, "mask_head"))}
    ln0 = layer_norm.launches
    out = tmp_path / "result.json"
    old = test_cli.CrowdSAM
    test_cli.CrowdSAM = Capturing
    try:
        assert test_cli.main(["-c", "", "-s", str(out)] + SMALL + data) == 0
    finally:
        test_cli.CrowdSAM = old
    assert layer_norm.launches > ln0
    for (k, v), m in zip(counts.items(), (attention, attention, attention,
                                          decode_tail_kernel,
                                          mask_head_kernel)):
        assert getattr(m, k).launches > v, k
    results = json.loads(out.read_text())
    assert [r["image_id"] for r in results] == [0, 1]
    for r in results:
        assert set(r) == {"image_id", "num_gt", "boxes", "scores",
                          "categories", "rles"}
    model = captured[0]
    model.generator.manual_seed(int(model.config["environ"]["seed"]))
    many = model.generate_many(frames)
    for m, r in zip(many, results):
        assert np.asarray(m["scores"]).tolist() == r["scores"]
        assert m["rles"] == r["rles"]
    from crowdsam_tpu_torch.evallib.coco_convert import convert_to_coco

    det = tmp_path / "det.json"
    det.write_text(json.dumps(convert_to_coco(
        results, json.loads((tmp_path / "val.json").read_text()))))
    assert crowdhuman_eval.main(["-d", str(det), "-g",
                                 str(tmp_path / "val.odgt"), "-f", "-v",
                                 "-o", str(tmp_path / "rec.txt")]) == 0
    assert (tmp_path / "rec.txt").read_text().startswith("AP: ")


@pytest.mark.parametrize("image_size,b,per_image", [
    (256, 3, 5), (256, 4, 32), (1024, 2, 32),
    # one prompt an image: every pair of prompts that a block of row
    # phase 0 serves straddles two images
    (256, 4, 1)])
def test_twoway_tail_kernel_image_axis(gen, image_size, b, per_image):
    """K5 with B images' operands stacked and an image index a prompt,
    against its plain version; one call whatever B; a prompt given its
    neighbour's image must change its rows."""
    sam = sam_model_registry["vit_tiny"](image_size=image_size).cuda()
    init_random_(sam, torch.Generator(device="cuda").manual_seed(0))
    cast_compute_params(sam, torch.bfloat16)
    g = image_size // 16
    feats = torch.randn((b, g, g, 256), generator=gen,
                        device="cuda").bfloat16()
    shared = precompute_decode_shared(
        sam.mask_decoder, sam.prompt_encoder.no_mask_embed.weight, feats,
        sam.prompt_encoder.get_dense_pe())
    assert shared["keys0"].shape == (b, g * g, 256)
    p = b * per_image
    tokens = torch.randn((p, 7, 256), generator=gen,
                         device="cuda").bfloat16()
    img = torch.arange(b, dtype=torch.int32,
                       device="cuda").repeat_interleave(per_image)
    args = _tail_args(shared, tokens)
    before = decode_tail_kernel.twoway_tail.launches
    keys2, tok = decode_tail_kernel.twoway_tail(*args, img=img)
    assert decode_tail_kernel.twoway_tail.launches == before + 1
    want_keys2, want_tok = decode_tail_kernel.twoway_tail_plain(*args,
                                                                img=img)
    _close(keys2, want_keys2, 2e-2)
    _close(tok, want_tok, 2e-2)
    other = decode_tail_kernel.twoway_tail(*args, img=(img + 1) % b)
    assert not torch.equal(other[0], keys2)


def test_generate_batch_on_the_small_config(gen):
    """`ShardedPipeline.generate_batch` on the card against
    `generate_many` on the same generator seed: B = 1 equal bit for bit,
    B = 2 the same detection counts, boxes within 0.5 px and scores within
    1e-4; K5 and K6 once a lockstep iteration, K7 once a chunk with
    survivors."""
    from crowdsam_tpu_torch.config import load_config, modify_config
    from crowdsam_tpu_torch.parallel.eval_shard import ShardedPipeline
    from crowdsam_tpu_torch.pipeline.crowdsam import CrowdSAM
    from crowdsam_tpu_torch.utils.synthetic import crowd_scene

    model = CrowdSAM(modify_config(load_config(None), list(SMALL)),
                     device="cuda")
    frames = [crowd_scene(20 + i, 171, 256, people=(3, 6))[0]
              for i in range(3)]
    model.generator.manual_seed(3)
    want = model.generate_many(frames)
    assert sum(len(w["boxes"]) for w in want) > 0
    for b in (1, 2):
        model.generator.manual_seed(3)
        pipe = ShardedPipeline(model, batch=b)
        k5 = decode_tail_kernel.twoway_tail.launches
        k6 = mask_head_kernel.mask_head.launches
        got = pipe.generate_batch(frames)
        iters = pipe.last_engine[0]["loop"]["iterations"]
        assert decode_tail_kernel.twoway_tail.launches > k5
        assert mask_head_kernel.mask_head.launches > k6
        if b == 2:           # the last chunk: one image
            assert decode_tail_kernel.twoway_tail.launches - k5 >= iters
        for g, w in zip(got, want):
            assert len(g["boxes"]) == len(w["boxes"])
            if b == 1:
                np.testing.assert_array_equal(g["boxes"], w["boxes"])
                np.testing.assert_array_equal(g["scores"], w["scores"])
                assert g["rles"] == w["rles"]
            else:
                np.testing.assert_allclose(g["boxes"], w["boxes"], atol=0.5)
                np.testing.assert_allclose(g["scores"], w["scores"],
                                           atol=1e-4)


@pytest.mark.parametrize("layout", ["prompts 16", "prompts 8",
                                    "4 images x 8 prompts"])
def test_decode_kernels_at_prompt_shard_counts(gen, layout):
    """K5 and K6 at the prompt counts a rank of the prompt axis gives them
    at M = 2 and 4 (32 / M prompts of one image, 8 prompts of each of a
    composed rank's 4 images), at the main path's 4096 image rows."""
    if layout.startswith("prompts"):
        p = int(layout.split()[1])
        shared, tokens, hyper = _decoder_operands(gen, 1024, p, 7, True)
        img = None
    else:
        b, per = 4, 8
        sam = sam_model_registry["vit_tiny"](image_size=1024).cuda()
        init_random_(sam, torch.Generator(device="cuda").manual_seed(0))
        cast_compute_params(sam, torch.bfloat16)
        feats = torch.randn((b, 64, 64, 256), generator=gen,
                            device="cuda").bfloat16()
        shared = precompute_decode_shared(
            sam.mask_decoder, sam.prompt_encoder.no_mask_embed.weight,
            feats, sam.prompt_encoder.get_dense_pe())
        tokens = torch.randn((b * per, 7, 256), generator=gen,
                             device="cuda").bfloat16()
        hyper = torch.randn((b * per, 4, 32), generator=gen,
                            device="cuda").bfloat16()
        img = torch.arange(b, dtype=torch.int32,
                           device="cuda").repeat_interleave(per)
    args = _tail_args(shared, tokens)
    keys2, tok = decode_tail_kernel.twoway_tail(*args, img=img)
    want_keys2, want_tok = decode_tail_kernel.twoway_tail_plain(*args,
                                                                img=img)
    _close(keys2, want_keys2, 2e-2)
    _close(tok, want_tok, 2e-2)
    w = shared["mask_head"]
    got = mask_head_kernel.mask_head(want_keys2, hyper, w, emit_exp=True)
    want = mask_head_kernel.mask_head_plain(want_keys2, hyper, w,
                                            emit_exp=True)
    atol = 0.03 * float(want[0].float().square().mean().sqrt())
    _close(got[0], want[0], atol)
    _close(got[1], want[1], 2e-2)
    _close(got[2], want[2], atol)


@pytest.mark.parametrize("mesh_shape,prompt_axis,spatial_axis", [
    ((1, 2), None, None), ((2, 1), None, None), ((2, 2), "model", None),
    ((1, 2), None, "model"), ((2, 2), "model", "model")],
    ids=["prompt_shard", "data_shard", "composed", "spatial",
         "spatial_composed"])
def test_multi_device_on_the_small_config(gen, tmp_path, mesh_shape,
                                          prompt_axis, spatial_axis):
    """Gloo ranks sharing the card (NCCL refuses two ranks on one device):
    the prompt-sharded `generate`, the data axis, the composed layout and
    the spatial axis (alone, and with the data and prompt axes) of
    `ShardedPipeline` (three images at batch 2: a partial chunk) against
    the single process on the same noise: the same detection counts, boxes
    within 0.5 px, scores within 1e-4; every rank the same results, and K5
    and K6 launched on every rank that ran an image.  A rank of the spatial
    axis runs its encode's products on a band's rows, where cuBLAS may
    round otherwise than on the whole grid's: there scores within 1e-4 +
    one bf16 ulp, and a box whose RLE string differs (a threshold tie)
    within 4 px (a cell of the 4x upsampled logit grid)."""
    from torch_ranks import card_rank

    from crowdsam_tpu_torch.config import load_config, modify_config
    from crowdsam_tpu_torch.parallel.eval_shard import ShardedPipeline
    from crowdsam_tpu_torch.parallel.launch import run_ranks
    from crowdsam_tpu_torch.pipeline.crowdsam import CrowdSAM
    from crowdsam_tpu_torch.utils.synthetic import crowd_scene

    model = CrowdSAM(modify_config(load_config(None), list(SMALL)),
                     device="cuda")
    frames = [crowd_scene(20 + i, 171, 256, people=(3, 6))[0]
              for i in range(3)]
    ng = torch.Generator().manual_seed(4)
    noises = [torch.rand(48 * 48, generator=ng) for _ in frames]
    if prompt_axis is None and spatial_axis is None and mesh_shape[0] == 1:
        want = [model.generate(f, noise=[n]) for f, n in zip(frames, noises)]
    else:
        want = ShardedPipeline(model, batch=2).generate_batch(frames,
                                                              noise=noises)
    assert sum(len(w["boxes"]) for w in want) > 0
    world = mesh_shape[0] * mesh_shape[1]
    ranks = run_ranks(card_rank, world, (SMALL, frames, noises, mesh_shape,
                                         prompt_axis, spatial_axis),
                      join_timeout_s=300.0, threads=None,
                      workdir=str(tmp_path))
    for got, k5, k6 in ranks:
        assert k5 > 0 and k6 > 0
        for g, w, r0 in zip(got, want, ranks[0][0]):
            assert len(g["boxes"]) == len(w["boxes"])
            if spatial_axis:
                tie = np.array([a != b for a, b in zip(g["rles"],
                                                       w["rles"])])
                db = np.abs(g["boxes"] - w["boxes"]).max(axis=1, initial=0)
                assert (db <= np.where(tie, 4.0, 0.5)).all()
                np.testing.assert_allclose(g["scores"], w["scores"],
                                           atol=1e-4, rtol=2.0 ** -7)
            else:
                np.testing.assert_allclose(g["boxes"], w["boxes"], atol=0.5)
                np.testing.assert_allclose(g["scores"], w["scores"],
                                           atol=1e-4)
            np.testing.assert_array_equal(g["boxes"], r0["boxes"])
            assert g["rles"] == r0["rles"]


@pytest.mark.parametrize("which", ["decoder", "serving"])
def test_export_on_the_card(gen, which):
    """`export_decoder` / `export_serving` of a small model (vit_tiny, bf16)
    on the card: the loaded program equals the eager module bit for bit and
    launches K1 once a LayerNorm on the path (10; the serving head 12, the
    mask downscaling's widths 4 and 16 among them)."""
    from crowdsam_tpu_torch.ops import layernorm as ln
    from crowdsam_tpu_torch.utils import export

    sam = cast_compute_params(init_random_(
        sam_model_registry["vit_tiny"](dino_dim=64).cuda(),
        torch.Generator(device="cuda").manual_seed(1)),
        torch.bfloat16).eval()
    h, r = sam.img_size // 16, sam.img_size // 4
    feats = torch.randn((1, h, h, 256), generator=gen,
                        device="cuda").bfloat16()
    coords = torch.rand((4, 2, 2), generator=gen, device="cuda") * 256
    if which == "decoder":
        run = export.load_exported(export.export_decoder(sam, "", batch=4,
                                                         num_points=2))
        eager = export.build_decoder_fn(sam)
        dino = torch.randn((r, r, 256), generator=gen,
                           device="cuda").bfloat16()
        args = (feats, dino, coords,
                torch.ones((4, 2), dtype=torch.int32, device="cuda"))
        want = 10
    else:
        kw = dict(return_single_mask=True, orig_im_size=(171, 256))
        run = export.load_exported(export.export_serving(
            sam, batch=4, num_points=2, **kw))
        eager = export.build_serving_fn(sam, **kw)
        args = (feats, coords,
                torch.tensor([[1.0, 0.0]] * 4, device="cuda"),
                torch.randn((4, r, r, 1), generator=gen, device="cuda"),
                torch.ones((), device="cuda"))
        want = 12
    nodes = sum(1 for n in run.graph.nodes if n.target is ln.LAYER_NORM)
    before = layer_norm.launches
    widths = dict(layer_norm.launches_by_width)
    got = run(*args)
    assert nodes == layer_norm.launches - before == want
    if which == "serving":
        for d in (4, 16):
            assert layer_norm.launches_by_width[d] == widths.get(d, 0) + 1
    for g, e in zip(got, eager(*args)):
        assert g.is_cuda and torch.equal(g, e)
