"""The float32 arms of K2, K3 and K4 (`csrc/attention_f32.cu`): each arm's
host-side preparation (`window_f32_attention`, `relpos_f32_attention`,
`flash_f32_attention`), composed with the arms' plain function
(`f32_attention_plain`), against the JAX package's dense float32 path on
the CPU (where `flash_enabled` is False, so the JAX package runs as it
does for `tpu.compute_dtype float32`): window attention on a padded grid
and on a halo band's windows, global attention on square and rect grids
and on a query band, at head dims 64 and 80; DINOv2's attention with
`valid_len` < S and on a query band.  The card runs the kernel on the same
preparation (`tests/test_torch_cuda.py`, `chip_smoke.py`).

Tolerance 1e-5 relative, plus 1e-5 of the output's largest magnitude:
float32 on both sides, summed in other orders."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crowdsam_tpu.models import image_encoder as jenc

from crowdsam_tpu_torch.models import attention
from crowdsam_tpu_torch.models import image_encoder as enc


def _normal(rng, shape, scale=1.0):
    return rng.normal(0, scale, shape).astype(np.float32)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def _dense_relpos(q, k, v, rel_h, rel_w, hw, scale):
    """The JAX float32 path of a SAM attention block (`Attention.__call__`
    without flash): q*scale . k, `add_decomposed_rel_pos`, softmax, PV;
    q, k, v (B*, S, D), rel_* the block's (2h-1, D) / (2w-1, D)."""
    logits = jnp.einsum("bqc,bkc->bqk", jnp.asarray(q) * scale,
                        jnp.asarray(k))
    logits = jenc.add_decomposed_rel_pos(logits, jnp.asarray(q),
                                         jnp.asarray(rel_h),
                                         jnp.asarray(rel_w), hw)
    probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    return jnp.einsum("bqk,bkc->bqc", probs, jnp.asarray(v))


@pytest.mark.parametrize("grid,heads,hd", [
    ((28, 28), 2, 64), ((28, 28), 2, 80), ((14, 42), 2, 64)],
    ids=["28x28-hd64", "28x28-hd80", "halo-14x42"])
def test_window_f32_matches_jax_dense(grid, heads, hd):
    """K2's preparation (window partition, fh/fw) + the plain function
    against the JAX dense window path (its `window_partition`, the dense
    attention of each window, `window_unpartition`).  14x42: a halo band's
    windows, one window row of a wider grid (`Band.windows`)."""
    rng = np.random.default_rng(hd + grid[1])
    ws, dim = 14, heads * hd
    gh, gw = grid
    qkv = _normal(rng, (1, gh, gw, 3 * dim))
    rel_h, rel_w = (_normal(rng, (2 * ws - 1, hd), 0.3) for _ in range(2))
    scale = hd ** -0.5
    windows, _ = jenc.window_partition(jnp.asarray(qkv), ws)
    win = windows.reshape(-1, ws * ws, 3, heads, hd).transpose(2, 0, 3, 1, 4)
    nw = win.shape[1]
    q, k, v = (win[i].reshape(nw * heads, ws * ws, hd) for i in range(3))
    out = _dense_relpos(q, k, v, rel_h, rel_w, (ws, ws), scale)
    out = out.reshape(nw, heads, ws, ws, hd).transpose(0, 2, 3, 1, 4)
    want = jenc.window_unpartition(out.reshape(nw, ws, ws, dim), ws,
                                   (gh, gw), (gh, gw))
    a = attention.window_f32_attention(
        torch.from_numpy(qkv), enc._rel_pos_table(torch.from_numpy(rel_h), ws),
        enc._rel_pos_table(torch.from_numpy(rel_w), ws), heads, scale, ws)
    assert a.valid == ws * ws and a.grid == (ws, ws)
    assert a.fh.is_contiguous() and a.fw.is_contiguous()
    got = attention.window_f32_output(attention.f32_attention_plain(a), ws,
                                      gh, gw)
    _close(got.numpy(), want)


@pytest.mark.parametrize("hw,hd,band", [
    ((16, 16), 64, None), ((16, 16), 80, None), ((12, 16), 64, None),
    ((16, 12), 80, None), ((16, 16), 64, (10, 16))],
    ids=["16x16-hd64", "16x16-hd80", "rect-12x16", "rect-16x12-hd80",
         "band-rows-10-16"])
def test_relpos_f32_matches_jax_dense(hw, hd, band):
    """K3's preparation (fh/fw of the queries' rows, the key grid) + the
    plain function against the JAX dense global path; a query band (grid
    rows [lo, hi), as a rank of the spatial axis holds them) against the
    same rows of the whole dense result."""
    rng = np.random.default_rng(hd + hw[0])
    h, w = hw
    heads, s = 2, h * w
    q, k, v = (_normal(rng, (1, heads, s, hd)) for _ in range(3))
    rel_h = _normal(rng, (2 * h - 1, hd), 0.3)
    rel_w = _normal(rng, (2 * w - 1, hd), 0.3)
    scale = hd ** -0.5
    want = _dense_relpos(*(x.reshape(heads, s, hd) for x in (q, k, v)),
                         rel_h, rel_w, hw, scale)
    lo, hi = band or (0, h)
    qt = torch.from_numpy(q)[:, :, lo * w:hi * w]
    a = attention.relpos_f32_attention(
        qt, torch.from_numpy(k), torch.from_numpy(v), scale,
        enc._rel_pos_table(torch.from_numpy(rel_h), h),
        enc._rel_pos_table(torch.from_numpy(rel_w), w), hw, lo)
    assert a.valid == s and a.grid == hw
    assert a.fh.shape == (1, heads, (hi - lo) * w, h)
    got = attention.f32_attention_plain(a)
    _close(got.numpy()[0], np.asarray(want)[:, lo * w:hi * w])


@pytest.mark.parametrize("s,valid,band", [
    (200, 170, None), (200, 200, (60, 130))],
    ids=["valid-170-of-200", "band-60-130"])
def test_flash_f32_matches_jax_dense(s, valid, band):
    """K4's preparation + the plain function against the JAX dense DINOv2
    path (`DinoAttention` without flash: (q.k) scale, softmax, PV) over
    the first `valid` keys, which is what masking the keys past
    `valid_len` computes; a query band against the same rows."""
    rng = np.random.default_rng(s + valid)
    heads, hd = 2, 64
    q, k, v = (_normal(rng, (1, heads, s, hd)) for _ in range(3))
    scale = hd ** -0.5
    logits = jnp.einsum("bhqc,bhkc->bhqk", jnp.asarray(q),
                        jnp.asarray(k[:, :, :valid])) * scale
    want = jnp.einsum("bhqk,bhkc->bhqc", jax.nn.softmax(logits, axis=-1),
                      jnp.asarray(v[:, :, :valid]))
    lo, hi = band or (0, s)
    a = attention.flash_f32_attention(
        torch.from_numpy(q)[:, :, lo:hi], torch.from_numpy(k),
        torch.from_numpy(v), scale, valid)
    assert a.fh is None and a.valid == valid
    got = attention.f32_attention_plain(a)
    _close(got.numpy(), np.asarray(want)[:, :, lo:hi])


def test_float32_arms_source_is_ffma_without_tensor_cores_or_bf16():
    """`csrc/attention_f32.cu` (named for the FFMA arm it was first) now
    computes in 3xTF32 on the tensor cores: wgmma's TF32 products on
    operands split by `cvt.rna.tf32.f32`, the softmax's exponentials by
    ex2; no other product type (no bf16, half or mma.sync), no library
    include beyond the shared Hopper helpers, no switch to another body;
    its two C entry points are there."""
    from pathlib import Path

    text = (Path(attention.__file__).resolve().parent.parent / "csrc"
            / "attention_f32.cu").read_text()
    code = "\n".join(ln for ln in text.splitlines()
                     if not ln.lstrip().startswith("//"))
    for banned in ("mma.sync", "bf16", "bfloat16", "half", "cublas",
                   "cutlass", "cudnn", "getenv", "#if"):
        assert banned not in code.lower(), banned
    includes = [ln for ln in text.splitlines() if ln.startswith("#include")]
    assert includes == ['#include "sm90.cuh"']
    for entry in ("attention_f32_forward", "attention_f32_occupancy"):
        assert f'extern "C" int {entry}(' in code
    for shape in ("m64n64k8", "m64n80k8"):
        assert f"wgmma.mma_async.sync.aligned.{shape}.f32.tf32.tf32" in code
    assert "cvt.rna.tf32.f32" in code and "ex2(" in code
