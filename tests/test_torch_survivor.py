"""The survivor kernel's plain version (`crowdsam_tpu_torch/ops/
survivor_kernel.survivor_rle_plain`, which K7's wrapper takes on the CPU)
against the JAX package's Pallas `survivor_rle_pallas` in interpret mode,
as `tests/test_survivor_kernel.py` runs it.  Bit for bit: packed bits,
per-column counts, every candidate slot (empty ones hold S - 1 on both
sides) and the summary."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crowdsam_tpu.ops.survivor_kernel import survivor_rle_pallas

from crowdsam_tpu_torch.ops.rle import (
    encode_changes_coco,
    encode_masks_coco,
    svals_from_cand,
    unpack_cand10,
)
from crowdsam_tpu_torch.ops.survivor_kernel import (
    BANDS,
    COL_SLOTS,
    survivor_rle,
    survivor_rle_plain,
)

_spec = importlib.util.spec_from_file_location(
    "_jax_survivor_tests",
    Path(__file__).resolve().parent / "test_survivor_kernel.py")
_jax_tests = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_jax_tests)
_blob_logits = _jax_tests._blob_logits      # +-8 blobs with speckles


def _both(logits, edit, in_hw, thresh=0.0):
    want = survivor_rle_pallas(jnp.asarray(logits), jnp.asarray(edit),
                               jnp.asarray(in_hw, jnp.int32), thresh=thresh,
                               interpret=True)
    got = survivor_rle(torch.as_tensor(np.asarray(logits)),
                       torch.as_tensor(np.asarray(edit)), in_hw, thresh)
    return ({k: v.numpy() for k, v in got.items()},
            {k: np.asarray(v) for k, v in want.items()})


def _assert_equal(got, want):
    for key in ("packed", "cand", "n_col", "summary"):
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("in_hw", [(256, 256), (172, 256), (256, 200)])
def test_plain_matches_pallas_on_blobs(in_hw):
    logits, edit = _blob_logits(np.random.default_rng(0), 3, 64)
    got, want = _both(logits, edit, in_hw)
    _assert_equal(got, want)
    assert got["summary"][:, 4].all()                 # every blob nonempty


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_on_noisy_logits(dtype):
    """Gaussian logits with per-mask in_hw and random edits, float32 and
    bf16: the rounding of both passes, not only exact +-8 sums."""
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(4, 64, 64)) * 3).astype(np.float32)
    edit = (rng.integers(-1, 2, x.shape)
            * (rng.uniform(size=x.shape) < 0.05)).astype(np.int8)
    hw = np.asarray([[256, 256], [200, 230], [1, 256], [256, 1]], np.int32)
    want = survivor_rle_pallas(
        jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(edit),
        jnp.asarray(hw), thresh=0.25, interpret=True)
    got = survivor_rle_plain(torch.tensor(x).to(getattr(torch, dtype)),
                             torch.tensor(edit), torch.tensor(hw), 0.25)
    _assert_equal({k: v.numpy() for k, v in got.items()},
                  {k: np.asarray(v) for k, v in want.items()})
    assert got["summary"][:, 6].any()          # noise overflows some column


def test_empty_and_full_masks():
    r = 64
    logits = np.stack([np.full((r, r), -8.0, np.float32),
                       np.full((r, r), 8.0, np.float32),
                       np.full((r, r), 8.0, np.float32)])
    edit = np.zeros((3, r, r), np.int8)
    edit[2] = -1                                # an invalid slot: all off
    got, want = _both(logits, edit, (200, 256))
    _assert_equal(got, want)
    np.testing.assert_array_equal(got["summary"][0], [0] * 8)
    np.testing.assert_array_equal(got["summary"][2], [0] * 8)
    # The full mask: one change, at Fortran position 0; box of the crop.
    np.testing.assert_array_equal(got["summary"][1],
                                  [0, 0, 255, 199, 1, 1, 0, 0])
    assert got["n_col"][1, 0] == 1 and got["n_col"][1, 1:].sum() == 0


def test_column_link_at_the_bottom_edge():
    """A bar that runs down to row in_h - 1: row 0 of each next column
    compares with that last pixel (the Fortran column link).  So the bar's
    first column changes once (at its top), every further bar column twice
    (at row 0, from 1 to 0, and at its top), and the column after the bar
    once, at row 0.  Without the link they would change once, once and
    never."""
    r, in_h = 64, 172
    logits = np.full((1, r, r), -8.0, np.float32)
    logits[0, 20:, 10:14] = 8.0                # rows 80.. down to the edge
    got, want = _both(logits, np.zeros((1, r, r), np.int8), (in_h, 256))
    _assert_equal(got, want)
    cand = unpack_cand10(got["cand"][0])
    n_col = got["n_col"][0]
    cols = np.nonzero(n_col)[0]
    first, after = cols[0], cols[-1]
    full = np.unpackbits(got["packed"][0], axis=-1)[:in_h, :256]
    assert full[in_h - 1, first:after].all() and not full[:, after].any()
    assert n_col[first] == 1 and cand[0, first] > 0
    assert (n_col[first + 1:after] == 2).all()
    assert (cand[0, first + 1:after] == 0).all()
    assert (cand[1, first + 1:after] > 0).all()
    assert n_col[after] == 1 and cand[0, after] == 0
    assert n_col.sum() == got["summary"][0, 5] == 2 * (after - first)


def test_overflowing_column():
    """Alternating stripes: every column of the band changes more than
    COL_SLOTS times; the first COL_SLOTS rows are kept, overflow is 1."""
    r = 64
    logits = -np.ones((2, r, r), np.float32)
    logits[0, ::2, 8:16] = 1.0
    got, want = _both(logits, np.zeros((2, r, r), np.int8), (256, 256))
    _assert_equal(got, want)
    assert got["summary"][0, 6] == 1 and got["summary"][1, 6] == 0
    assert got["n_col"][0].max() > COL_SLOTS


@pytest.mark.parametrize("in_hw", [(172, 256), (256, 200)])
def test_rle_from_change_rows_equals_dense_encoding(in_hw):
    """The host RLE path: `svals_from_cand` over the kernel's change rows,
    then `encode_changes_coco`, equals `encode_masks_coco` of the packed
    bitmap, for every mask that does not overflow."""
    logits, edit = _blob_logits(np.random.default_rng(2), 4, 64)
    out = survivor_rle(torch.tensor(logits), torch.tensor(edit), in_hw)
    in_h, in_w = in_hw
    cand = unpack_cand10(out["cand"].numpy())
    full = np.unpackbits(out["packed"].numpy(), axis=-1)[:, :in_h, :in_w]
    for i in range(4):
        assert out["summary"][i, 6] == 0
        svals = svals_from_cand(cand[i], out["n_col"][i].numpy(), in_h)
        assert len(svals) == out["summary"][i, 5]
        assert (encode_changes_coco(svals, in_h * in_w, in_hw)
                == encode_masks_coco(full[i])[0])


def test_in_hw_outside_the_frame_is_clamped():
    """in_hw is clamped to [1, S], as the kernel clamps it."""
    logits, edit = _blob_logits(np.random.default_rng(3), 2, 64)
    args = (torch.tensor(logits), torch.tensor(edit))
    got = survivor_rle_plain(*args, torch.tensor([[0, 300], [-5, 0]],
                                                 dtype=torch.int32))
    want = survivor_rle_plain(*args, torch.tensor([[1, 256], [1, 1]],
                                                  dtype=torch.int32))
    for key in ("packed", "cand", "n_col", "summary"):
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)


def test_wrapper_refuses_other_devices():
    x = torch.zeros((1, 64, 64), device="meta")
    with pytest.raises(ValueError, match="device"):
        survivor_rle(x, x.to(torch.int8), (256, 256))


# ---------------------------------------------------------------------------
# The band merge of the CUDA kernel, as a numpy model
# ---------------------------------------------------------------------------

def _band_merge_model(full, in_hw, bands):
    """K7's band decomposition in numpy, from the dense (S, S) bitmap of one
    mask: each column is cut into `bands` row bands; a band keeps its change
    count and first COL_SLOTS change rows (changes inside the band only),
    its first and last set rows, and its first and last pixel.  Merged in
    band order: a change counts at each band boundary where the last pixel
    of band b - 1 differs from the first pixel of band b (band 0's first
    pixel against the column link, pixel (in_h - 1, x - 1)); the change
    rows are the bands' lists, each boundary change before its band's,
    concatenated and cut at COL_SLOTS.  Returns n_col (S,), the change rows
    (COL_SLOTS, S) with empty slots S - 1, per-column first and last set
    rows, and the overflow flag."""
    s = full.shape[0]
    in_h, in_w = (min(max(v, 1), s) for v in in_hw)
    rows_b = s // bands
    n_col = np.zeros(s, np.int64)
    slots = np.full((COL_SLOTS, s), s - 1, np.int64)
    y_lo = np.full(s, s)
    y_hi = np.full(s, -1)
    for x in range(in_w):
        col = full[:in_h, x].astype(np.int64)
        link = int(full[in_h - 1, x - 1]) if x > 0 else 0
        merged, prev_last = [], link
        for b in range(bands):
            y0, y1 = b * rows_b, min((b + 1) * rows_b, in_h)
            if y0 >= y1:
                break
            band = col[y0:y1]
            inner = y0 + 1 + np.nonzero(band[1:] != band[:-1])[0]
            boundary = [y0] if band[0] != prev_last else []
            merged += boundary + list(inner)
            set_rows = y0 + np.nonzero(band)[0]
            if len(set_rows):
                y_lo[x] = min(y_lo[x], set_rows[0])
                y_hi[x] = max(y_hi[x], set_rows[-1])
            prev_last = band[-1]
        n_col[x] = len(merged)
        first = merged[:COL_SLOTS]
        slots[:len(first), x] = first
    return n_col, slots, y_lo, y_hi, bool((n_col > COL_SLOTS).any())


def _painted(r, cells, base=-8.0):
    """(1, r, r) logits of `base` with edits forcing the (row, col) low-res
    `cells` on: 4x4 output blocks, so edges fall on chosen output rows."""
    logits = np.full((1, r, r), base, np.float32)
    edit = np.zeros((1, r, r), np.int8)
    for rows, cols in cells:
        edit[0, rows, cols] = 1
    return logits, edit


def _merge_case(name):
    r = 64                                   # S = 256: bands of 32 rows
    rng = np.random.default_rng(4)
    if name == "change at a band boundary":  # edges at rows 32, 64, 160
        return _painted(r, [(slice(8, 16), slice(5, 40)),
                            (slice(40, 48), slice(20, 30))]) + ((256, 256),)
    if name == "more than 24 changes over several bands":
        return _painted(r, [(slice(0, r, 2), slice(10, 20))]) + ((256, 256),)
    if name == "ragged in_h":                # 203: not a multiple of 32 or 8
        logits, edit = _blob_logits(rng, 1, r)
        return logits, edit, (203, 241)
    if name == "column link":                # a bar down to row in_h - 1
        logits = np.full((1, r, r), -8.0, np.float32)
        logits[0, 13:, 10:14] = 8.0
        return logits, np.zeros((1, r, r), np.int8), (172, 256)
    if name == "empty mask":
        return (np.full((1, r, r), -8.0, np.float32),
                np.zeros((1, r, r), np.int8), (200, 256))
    if name == "full mask":
        return (np.full((1, r, r), 8.0, np.float32),
                np.zeros((1, r, r), np.int8), (200, 256))
    logits = (rng.normal(size=(1, r, r)) * 3).astype(np.float32)
    return logits, np.zeros((1, r, r), np.int8), (229, 250)   # noise


@pytest.mark.parametrize("name", [
    "change at a band boundary", "more than 24 changes over several bands",
    "ragged in_h", "column link", "empty mask", "full mask", "noise"])
def test_band_merge_model_matches_plain(name):
    """The kernel's merge rule (`_band_merge_model`, bands of S / BANDS
    rows) gives the plain version's per-column counts, change rows, box and
    overflow flag at the edges the rule must get right."""
    logits, edit, in_hw = _merge_case(name)
    out = survivor_rle_plain(torch.tensor(logits), torch.tensor(edit),
                             in_hw)
    full = np.unpackbits(out["packed"][0].numpy(), axis=-1).astype(bool)
    n_col, slots, y_lo, y_hi, overflow = _band_merge_model(full, in_hw,
                                                           BANDS)
    np.testing.assert_array_equal(n_col, out["n_col"][0].numpy())
    np.testing.assert_array_equal(slots, unpack_cand10(out["cand"][0].numpy()))
    summary = out["summary"][0].numpy()
    assert overflow == bool(summary[6])
    assert n_col.sum() == summary[5]
    if summary[4]:
        assert (y_lo.min(), y_hi.max()) == (summary[1], summary[3])
    else:
        assert y_hi.max() == -1
    s = full.shape[0]
    rows_b = s // BANDS
    on_boundary = int(((slots % rows_b == 0) & (slots > 0)
                       & (slots < s - 1)).sum())
    if name == "change at a band boundary":
        assert on_boundary > 0
    if name == "more than 24 changes over several bands":
        assert overflow and (slots[COL_SLOTS - 1] < s - 1).any()
