"""K2, K3, K4: the plain versions of the port's attention wrappers (what a
CPU tensor runs) against the JAX package's Pallas kernels in interpret mode
and its dense rel-pos path, in float32.

Tolerance 1e-4 abs / 1e-4 rel: float32 softmax attention on both sides;
the TPU kernels fold the rel-pos bias into a widened head, the port adds
it to the logits, so sums run in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from crowdsam_tpu.models import attention as jattn
from crowdsam_tpu.models import image_encoder as jenc

from crowdsam_tpu_torch.models import attention
from crowdsam_tpu_torch.models import image_encoder as enc

TOL = dict(atol=1e-4, rtol=1e-4)


def _normal(rng, shape, scale=1.0):
    return rng.normal(0, scale, shape).astype(np.float32)


@pytest.mark.parametrize("grid,ws,heads,hd", [(16, 7, 2, 8), (12, 4, 3, 8),
                                              (70, 14, 2, 64),
                                              (28, 14, 2, 80)])
def test_window_attention_matches_pallas(grid, ws, heads, hd):
    """A grid that is not a multiple of the window: the block pads the
    normalized input before qkv, so pad tokens carry the qkv bias; the
    main path's 70x70 grid of 14x14 windows at head dim 64; and SAM
    ViT-H's head dim 80 on 14x14 windows."""
    rng = np.random.default_rng(0)
    dim = heads * hd
    x = _normal(rng, (1, grid, grid, dim))
    wqkv, bqkv = _normal(rng, (dim, 3 * dim), 0.1), _normal(rng, (3 * dim,),
                                                            0.5)
    rel_h, rel_w = _normal(rng, (2 * ws - 1, hd), 0.5), _normal(
        rng, (2 * ws - 1, hd), 0.5)
    hp = -(-grid // ws) * ws
    x_pad = np.pad(x, ((0, 0), (0, hp - grid), (0, hp - grid), (0, 0)))
    qkv = x_pad @ wqkv + bqkv
    rh = jenc._rel_pos_table(jnp.asarray(rel_h), ws)
    rw = jenc._rel_pos_table(jnp.asarray(rel_w), ws)
    want = jattn.window_attention_pallas(
        jnp.asarray(qkv), rh, rw, num_heads=heads, scale=hd ** -0.5,
        window=ws, interpret=True)
    got = attention.window_attention(
        torch.from_numpy(qkv), torch.tensor(np.asarray(rh)),
        torch.tensor(np.asarray(rw)), heads, hd ** -0.5, ws)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _global_inputs(g, heads=2, hd=16, seed=1):
    rng = np.random.default_rng(seed)
    q, k, v = (_normal(rng, (1, heads, g * g, hd)) for _ in range(3))
    rel_h, rel_w = _normal(rng, (2 * g - 1, hd), 0.3), _normal(
        rng, (2 * g - 1, hd), 0.3)
    return q, k, v, rel_h, rel_w


def test_global_relpos_matches_pallas_flash():
    g, hd = 16, 16
    q, k, v, rel_h, rel_w = _global_inputs(g, hd=hd)
    rh = jenc._rel_pos_table(jnp.asarray(rel_h), g)
    rw = jenc._rel_pos_table(jnp.asarray(rel_w), g)
    with pltpu.force_tpu_interpret_mode():
        want = jattn.flash_mha_decomposed_relpos(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), hd ** -0.5,
            rh, rw, (g, g))
    got = attention.flash_mha_decomposed_relpos(
        *map(torch.from_numpy, (q, k, v)), hd ** -0.5,
        torch.tensor(np.asarray(rh)), torch.tensor(np.asarray(rw)), (g, g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_global_relpos_head_dim_80_matches_pallas_flash():
    """SAM ViT-H's head dim 80 through the global rel-pos path: the Pallas
    flash kernel on augmented heads of 80 + 2 g dims, the port's plain
    version at the same tolerance as at 16."""
    g, hd = 16, 80
    q, k, v, rel_h, rel_w = _global_inputs(g, hd=hd, seed=6)
    rh = jenc._rel_pos_table(jnp.asarray(rel_h), g)
    rw = jenc._rel_pos_table(jnp.asarray(rel_w), g)
    with pltpu.force_tpu_interpret_mode():
        want = jattn.flash_mha_decomposed_relpos(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), hd ** -0.5,
            rh, rw, (g, g))
    got = attention.flash_mha_decomposed_relpos(
        *map(torch.from_numpy, (q, k, v)), hd ** -0.5,
        torch.tensor(np.asarray(rh)), torch.tensor(np.asarray(rw)), (g, g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_global_relpos_matches_dense_path():
    g, heads, hd = 8, 2, 16
    q, k, v, rel_h, rel_w = _global_inputs(g, heads, hd, seed=2)
    scale = hd ** -0.5
    qb, kb, vb = (a.reshape(heads, g * g, hd) for a in (q, k, v))
    logits = jnp.einsum("bqc,bkc->bqk", qb * scale, kb)
    logits = jenc.add_decomposed_rel_pos(logits, jnp.asarray(qb),
                                         jnp.asarray(rel_h),
                                         jnp.asarray(rel_w), (g, g))
    want = jnp.einsum("bqk,bkc->bqc", jax.nn.softmax(logits, -1), vb)
    got = attention.flash_mha_decomposed_relpos(
        *map(torch.from_numpy, (q, k, v)), scale,
        enc._rel_pos_table(torch.from_numpy(rel_h), g),
        enc._rel_pos_table(torch.from_numpy(rel_w), g), (g, g))
    np.testing.assert_allclose(got.numpy()[0], np.asarray(want), **TOL)


@pytest.mark.parametrize("valid", [200, 256])
def test_flash_mha_matches_pallas(valid):
    rng = np.random.default_rng(3)
    q, k, v = (_normal(rng, (1, 2, 256, 64)) for _ in range(3))
    with pltpu.force_tpu_interpret_mode():
        want = jattn.flash_mha(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), sm_scale=0.125,
                               valid_len=valid)
    got = attention.flash_mha(*map(torch.from_numpy, (q, k, v)), 0.125,
                              valid_len=valid)
    # Rows at or beyond valid_len are padding: JAX's segment ids attend them
    # to the pad keys, the port to the valid keys; neither is ever read.
    np.testing.assert_allclose(got.numpy()[:, :, :valid],
                               np.asarray(want)[:, :, :valid], **TOL)


def test_rel_pos_table_resizes_like_jax():
    rng = np.random.default_rng(4)
    table = _normal(rng, (27, 8))
    want = jenc._rel_pos_table(jnp.asarray(table), 9)
    got = enc._rel_pos_table(torch.from_numpy(table), 9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_wrappers_reject_unsupported_devices():
    x = torch.zeros(1, 2, 4, 64, device="meta")
    with pytest.raises(ValueError, match="device"):
        attention.flash_mha(x, x, x, 0.125)


def test_flash_mha_strided_qkv_matches_pallas():
    """K4's operands as the DINOv2 block hands them over: strided q/k/v
    views of one (B, S, 3, H, D) qkv buffer, at a ragged length (1 + 9^2
    tokens: the Pallas path pads to 128, the port's kernel masks its last
    key tile)."""
    rng = np.random.default_rng(5)
    b, s, heads, hd = 2, 1 + 9 * 9, 2, 64
    qkv = _normal(rng, (b, s, 3 * heads * hd))
    t = torch.from_numpy(qkv).reshape(b, s, 3, heads, hd).permute(2, 0, 3, 1,
                                                                   4)
    assert t[0].stride() == (s * 3 * heads * hd, hd, 3 * heads * hd, 1)
    jt = jnp.asarray(qkv).reshape(b, s, 3, heads, hd).transpose(2, 0, 3, 1, 4)
    with pltpu.force_tpu_interpret_mode():
        want = jattn.flash_mha(jt[0], jt[1], jt[2], sm_scale=hd ** -0.5,
                               valid_len=s)
    got = attention.flash_mha(t[0], t[1], t[2], hd ** -0.5, valid_len=s)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_tma_layout_of_dinov2_views():
    """The tensor maps of the main path's q/k/v: dims {64, H, S, B}, byte
    strides {hs, ld, bs} x 2, a box of 64 dims x 128 tokens (64 for q);
    k and v start 2048 and 4096 bytes into the qkv buffer, 16-byte
    aligned."""
    s, heads, hd = 1 + 73 * 73, 16, 64
    qkv = torch.empty((1, s, 3 * heads * hd), dtype=torch.bfloat16)
    views = qkv.reshape(1, s, 3, heads, hd).permute(2, 0, 3, 1, 4)
    for i, t in enumerate(views):
        rows = attention.TMA_Q_ROWS if i == 0 else attention.TMA_KV_ROWS
        lay = attention.tma_layout(t, rows=rows)
        assert lay.dims == (64, heads, s, 1)
        assert lay.strides == (128, 3 * heads * hd * 2, s * 3 * heads * hd * 2)
        assert lay.box == (64, 1, rows, 1)
        assert lay.pos == (1, 2, 3)
        assert t.data_ptr() - qkv.data_ptr() == 2048 * i
        assert len(lay.row()) == 14


@pytest.mark.parametrize("g", [64, 14])
def test_tma_layout_of_vit_h_views(g):
    """K3's q/k/v at SAM ViT-H's head dim 80, read in place from one qkv
    buffer (a global block's 64x64 grid; K2's wrapper hands windows past
    16x16 to K3 the same way): dims {80, H, S, B}, strides {160, ld, bs},
    a box of 64 dims (the kernel adds the box of dims 64-79); K4's layout
    (head dim 64 only) refuses them."""
    s, heads, hd = g * g, 16, 80
    qkv = torch.empty((1, s, 3 * heads * hd), dtype=torch.bfloat16)
    views = qkv.reshape(1, s, 3, heads, hd).permute(2, 0, 3, 1, 4)
    for i, t in enumerate(views):
        rows = attention.TMA_Q_ROWS if i == 0 else attention.TMA_KV_ROWS
        lay = attention.tma_layout(t, rows=rows,
                                   head_dims=attention.RELPOS_HEAD_DIMS)
        assert lay.dims == (80, heads, s, 1)
        assert lay.strides == (160, 3 * heads * hd * 2,
                               s * 3 * heads * hd * 2)
        assert lay.box == (64, 1, rows, 1)
        assert lay.pos == (1, 2, 3)
        assert (t.data_ptr() - qkv.data_ptr()) % 16 == 0
    with pytest.raises(ValueError, match="head dim"):
        attention.tma_layout(views[0])


def test_tma_layout_orders_dims_by_stride():
    """A contiguous (B, H, S, 64) operand: the token axis is the map's dim 1,
    the head dim 2, the batch dim 3; the box spans the token dim."""
    b, heads, s = 2, 3, 130
    lay = attention.tma_layout(torch.empty((b, heads, s, 64),
                                           dtype=torch.bfloat16))
    assert lay.dims == (64, s, heads, b)
    assert lay.strides == (128, s * 128, heads * s * 128)
    assert lay.pos == (2, 1, 3)
    assert lay.box == (64, attention.TMA_KV_ROWS, 1, 1)


def _odd_views():
    buf = torch.empty(16 * 64 * 1028 + 64, dtype=torch.bfloat16)
    return {
        # token stride 1028 elements = 2056 bytes, not a multiple of 16
        "stride": (ValueError, "multiples of 16",
                   buf.as_strided((1, 16, 64, 64), (64 * 1028, 64, 1028, 1))),
        "head dim": (ValueError, "head dim",
                     torch.empty((1, 2, 64, 32), dtype=torch.bfloat16)),
        "base": (ValueError, "16-byte aligned",
                 buf[1:1 + 2 * 64 * 64].reshape(1, 2, 64, 64)),
        "dtype": (TypeError, "bfloat16", torch.empty((1, 2, 64, 64))),
    }


@pytest.mark.parametrize("case", ["stride", "head dim", "base", "dtype"])
def test_tma_layout_refuses_what_tma_does_not_take(case):
    err, match, t = _odd_views()[case]
    with pytest.raises(err, match=match):
        attention.tma_layout(t)
