"""The port's host RLE (`crowdsam_tpu_torch/ops/rle.py` and the C++ codec
`csrc/rle_codec.cpp`, built by g++) against the JAX package's
`crowdsam_tpu/ops/rle.py` on seeded masks.  Every comparison is exact:
the same counts lists, the same COCO strings, the same decoded masks."""

import numpy as np
import pytest
from scipy.ndimage import gaussian_filter

from crowdsam_tpu.ops import rle as jax_rle

from crowdsam_tpu_torch.ops import rle


def _masks(seed, b=6, h=37, w=23):
    """Blobby seeded masks, then a leading one-run (pixel 0 set), an empty
    mask and a full mask."""
    x = np.random.default_rng(seed).uniform(size=(b, h, w))
    sm = np.stack([gaussian_filter(m, 3) for m in x])
    masks = sm > np.median(sm)
    masks[0, 0, 0] = True
    masks[1] = False
    masks[2] = True
    return masks


@pytest.mark.parametrize("seed,hw", [(0, (37, 23)), (1, (64, 48)),
                                     (2, (1, 9))])
def test_uncompressed_rle_matches_jax(seed, hw):
    masks = _masks(seed, h=hw[0], w=hw[1])
    got, want = rle.mask_to_rle(masks), jax_rle.mask_to_rle(masks)
    assert got == want
    for m, r in zip(masks, got):
        np.testing.assert_array_equal(rle.rle_to_mask(r),
                                      jax_rle.rle_to_mask(r))
        np.testing.assert_array_equal(rle.rle_to_mask(r), m)
        assert rle.area_from_rle(r) == jax_rle.area_from_rle(r) == m.sum()
    assert got[0]["counts"][0] == 0           # leading one-run
    assert got[1]["counts"] == [hw[0] * hw[1]]
    assert got[2]["counts"] == [0, hw[0] * hw[1]]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coco_strings_match_jax(seed):
    masks = _masks(seed)
    for r in rle.mask_to_rle(masks):
        enc = rle.coco_encode_rle(r)
        assert enc == jax_rle.coco_encode_rle(r)
        assert rle._decompress_counts_py(enc["counts"]) == r["counts"]
        assert (jax_rle._decompress_counts_py(enc["counts"])
                == rle._decompress_counts_py(enc["counts"]))
    got = rle.encode_masks_coco(masks)
    assert got == jax_rle.encode_masks_coco(masks)
    for m, enc in zip(masks, got):
        np.testing.assert_array_equal(rle.coco_decode_rle(enc), m)
        np.testing.assert_array_equal(jax_rle.coco_decode_rle(enc), m)


def test_cpp_codec_against_its_python_version():
    """The C++ codec's encoder, decoder and area against the plain Python
    codec on the same masks, and a mask given as 2-D."""
    masks = _masks(3, b=8, h=50, w=31)
    fast = rle.encode_masks_coco(masks)
    slow = [rle.coco_encode_rle(r) for r in rle.mask_to_rle(masks)]
    assert fast == slow
    assert rle.encode_masks_coco(masks[4]) == fast[4:5]
    assert rle.encode_masks_coco(masks[:0]) == []
    area = rle.codec("rle_area")
    for m, enc in zip(masks, fast):
        raw = enc["counts"].encode()
        assert area(raw, len(raw)) == m.sum()
        counts = rle._decompress_counts_py(enc["counts"])
        np.testing.assert_array_equal(
            rle.coco_decode_rle(enc),
            rle.rle_to_mask({"size": enc["size"], "counts": counts}))


def test_codec_raises_on_a_malformed_string():
    with pytest.raises(ValueError, match="malformed"):
        rle.coco_decode_rle({"size": [4, 4], "counts": "3"})  # 3 of 16 px


@pytest.mark.parametrize("seed,hw", [(4, (172, 256)), (5, (256, 200))])
def test_changes_encoding_equals_dense_encoding(seed, hw):
    """`encode_changes_coco(svals_from_cand(...))` equals
    `encode_masks_coco` of the dense mask; the change rows come from the
    Fortran scan the survivor kernel does (`unpack_cand10` of its packed
    words)."""
    h, w = hw
    x = gaussian_filter(np.random.default_rng(seed).normal(size=(3, h, w)), 6,
                        axes=(1, 2))
    masks = x > 0
    masks[1] = False
    masks[2, :, 5] = True                      # a column down to row h - 1
    for m in masks:
        flat = m.flatten(order="F").astype(np.int8)
        chg = np.nonzero(np.diff(np.concatenate([[0], flat])))[0]
        n_col = np.bincount(chg // h, minlength=w)
        assert n_col.max() <= 24
        rows = np.full((24, w), 1023, np.int64)
        for c in range(w):
            rows[:n_col[c], c] = chg[chg // h == c] % h
        words = (rows[0::3] << 20) | (rows[1::3] << 10) | rows[2::3]
        cand = rle.unpack_cand10(words.astype(np.int32))
        np.testing.assert_array_equal(cand, rows)
        np.testing.assert_array_equal(cand,
                                      jax_rle.unpack_cand10(words.astype(
                                          np.int32)))
        svals = rle.svals_from_cand(cand, n_col, h)
        np.testing.assert_array_equal(svals, chg)
        np.testing.assert_array_equal(
            svals, jax_rle.svals_from_cand(cand, n_col, h))
        got = rle.encode_changes_coco(svals, h * w, (h, w))
        assert got == rle.encode_masks_coco(m)[0]
        assert got == jax_rle.encode_changes_coco(svals, h * w, (h, w))
