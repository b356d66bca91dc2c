"""K3's forms (`models/attention.relpos_form`) on the CPU: the form each
grid takes, the columns form's exchange of rows and columns in plain
PyTorch against the port's plain version and the JAX package's Pallas
flash kernel (interpret mode), and the folded 64-wide term as the kernel
reads it through the strides the wrapper hands over.

Tolerance 1e-4 abs / 1e-4 rel, float32 on both sides, as in
`test_torch_attention.py`: the exchange reorders the keys of every
softmax, so its sums run in another order; the JAX kernel folds the bias
into a widened head."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from crowdsam_tpu.models import attention as jattn
from crowdsam_tpu.models import image_encoder as jenc

from crowdsam_tpu_torch.models import attention

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("h,w,sq,row0,form", [
    (64, 64, 64 * 64, 0, "grid64"),     # SAM's grid, the main path
    (44, 64, 44 * 64, 0, "grid64"),     # a landscape frame's rect grid
    (64, 64, 22 * 64, 42, "grid64"),    # a band of SAM's grid
    (64, 48, 64 * 48, 0, "columns"),    # a portrait frame's rect grid
    (64, 44, 64 * 44, 0, "columns"),
    (64, 48, 22 * 48, 42, "fold"),      # a band of a grid 64 tall
    (16, 16, 16 * 16, 0, "fold"),       # under 64 both ways
    (20, 24, 20 * 24, 0, "fold"),
])
def test_relpos_form_picker(h, w, sq, row0, form):
    assert attention.relpos_form(h, w, sq, row0) == form


def _inputs(hw, heads, hd, seed):
    rng = np.random.default_rng(seed)
    h, w = hw
    q, k, v = (rng.normal(0, 1, (1, heads, h * w, hd)).astype(np.float32)
               for _ in range(3))
    rel_h = rng.normal(0, 0.3, (2 * h - 1, hd)).astype(np.float32)
    rel_w = rng.normal(0, 0.3, (2 * w - 1, hd)).astype(np.float32)
    rh = jenc._rel_pos_table(jnp.asarray(rel_h), h)
    rw = jenc._rel_pos_table(jnp.asarray(rel_w), w)
    return q, k, v, rh, rw


@pytest.mark.parametrize("hd", [64, 80])
@pytest.mark.parametrize("hw", [(64, 48), (64, 44)])
def test_columns_form_matches_plain_and_pallas(hw, hd):
    """The columns form in plain PyTorch (q, k, v in column order, Rh and Rw
    exchanged, attention on the w x 64 grid, the output back in grid order)
    on a portrait frame's rect grids at head dims 64 and 80: equal to the
    plain version and to the JAX `flash_mha_decomposed_relpos`."""
    q, k, v, rh, rw = _inputs(hw, 2, hd, seed=hw[1] + hd)
    scale = hd ** -0.5
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    trh, trw = torch.tensor(np.asarray(rh)), torch.tensor(np.asarray(rw))
    got = attention.relpos_attention_columns(tq, tk, tv, scale, trh, trw, hw)
    plain = attention.relpos_attention_plain(tq, tk, tv, scale, trh, trw, hw)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    with pltpu.force_tpu_interpret_mode():
        want = jattn.flash_mha_decomposed_relpos(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, rh, rw,
            hw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_to_columns_is_the_grid_exchange():
    """Token (r, c) of an h x w grid lands at c h + r, and the exchange of
    the exchanged grid gives the grid back."""
    h, w = 3, 5
    x = torch.arange(h * w, dtype=torch.float32).reshape(1, h * w, 1)
    cols = attention.to_columns(x, (h, w))
    for r in range(h):
        for c in range(w):
            assert cols[0, c * h + r, 0] == r * w + c
    assert torch.equal(attention.to_columns(cols, (w, h)), x)


@pytest.mark.parametrize("form,hw,hd,row0,hq", [
    ("grid64", (20, 64), 64, 0, 20), ("grid64", (20, 64), 80, 6, 8),
    ("columns", (64, 20), 64, 0, 64), ("columns", (64, 20), 80, 0, 64),
    ("grid64", (21, 64), 80, 7, 9), ("columns", (64, 21), 80, 0, 64)])
def test_kernel_terms_as_the_kernel_reads_them(form, hw, hd, row0, hq):
    """The folded 64-wide term read as GRID64's kernel reads it: block x's
    query i, 64 values from x fw_strides[2] + bh fw_strides[1] + i
    fw_strides[0].  grid64 (block x is grid row row0 + x, query i its
    column): q.Rw[col(q)], the kernel's own term from Rh; columns (block x
    is grid column x, query i its row): q.Rh[row(q)], the kernel's own term
    from Rw.  At head dim 80 (the grid's rows or columns an odd count in the
    last two cases, as a block of two consumers reads them) the term is the
    float32 product, also from bf16 operands, which the kernel divides by
    the scale and rounds to bf16 once: within one bf16 rounding of the
    float32 term divided by the scale."""
    h, w = hw
    b, heads, scale = 2, 3, hd ** -0.5
    gen = torch.Generator().manual_seed(hd + row0)
    q = torch.randn((b, heads, hq * w, hd), generator=gen)
    rh = torch.randn((h, h, hd), generator=gen)
    rw = torch.randn((w, w, hd), generator=gen)
    blocks, rows = (hq, w) if form == "grid64" else (w, hq)
    dtypes = (torch.float32,) if hd == attention.HEAD_DIM else (
        torch.float32, torch.bfloat16)
    for dtype in dtypes:
        qd, rhd, rwd = (t.to(dtype) for t in (q, rh, rw))
        fh, fw, strides, table = attention._kernel_terms(qd, rhd, rwd, scale,
                                                         hw, form, row0)
        assert fh is None
        assert table is (rhd if form == "grid64" else rwd)
        assert fw.dtype == (dtype if hd == attention.HEAD_DIM
                            else torch.float32)
        want_h, want_w = attention._rel_bias_terms(
            qd.float(), rhd.float(), rwd.float(), hw, row0)
        want = (want_w if form == "grid64" else want_h).reshape(
            b * heads, hq, w, 64)
        flat = fw.reshape(-1)
        for bh in range(b * heads):
            for x in range(blocks):
                base = x * strides[2] + bh * strides[1]
                got = torch.stack([flat[base + i * strides[0]:][:64]
                                   for i in range(rows)])
                ref = want[bh, x] if form == "grid64" else want[bh, :, x]
                torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
                if hd != attention.HEAD_DIM:
                    # QA as the kernel forms it: x (1 / scale), one rounding
                    qa = (got * (1.0 / scale)).to(torch.bfloat16).float()
                    once = (ref / scale).to(torch.bfloat16).float()
                    torch.testing.assert_close(qa, once, rtol=2.0 ** -7,
                                               atol=1e-6)
