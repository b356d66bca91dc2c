"""Host-side image resizes and coordinate transforms (numpy).

Counterpart of the JAX package's `ops/transforms.py`, which resizes with cv2
(`resize_image`) and PIL (`ResizeLongestSide.apply_image`).  Neither library
is a dependency here, so both resizes are written out in numpy:

- `resize_image`: cv2 INTER_LINEAR on uint8 -- half-pixel source positions
  clamped at the edges, 11-bit fixed-point weights, and the rounding of
  cv2's vectorized vertical pass.  Within one grey level of cv2.
- `ResizeLongestSide.apply_image`: PIL BILINEAR -- a triangle filter whose
  support widens with the downscale factor, in PIL's 8-bit fixed point
  (`stretch_bilinear`, which also serves the train-free branch's stretch
  of the frame to DINOv2's square input, the aspect not kept, and the
  synthetic crowd scenes' backgrounds).  Equal to PIL.

When the target size equals the input size both return the input, as cv2
and PIL do (the CrowdSAM path at max_size 1024 on a 1024-long image).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np

_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS


def get_preprocess_shape(oldh: int, oldw: int,
                         long_side_length: int) -> Tuple[int, int]:
    """(newh, neww) with the long side scaled to `long_side_length`
    (round half up)."""
    scale = long_side_length * 1.0 / max(oldh, oldw)
    return int(oldh * scale + 0.5), int(oldw * scale + 0.5)


def resize_image_shape(h: int, w: int, max_size: int) -> Tuple[int, int, float]:
    """(new_h, new_w, r) with r = min(max_size/w, max_size/h), truncated."""
    r = min(max_size / w, max_size / h)
    return int(r * h), int(r * w), r


def _cv2_linear_taps(n_in: int, n_out: int):
    """Source index and fixed-point weights of cv2's INTER_LINEAR."""
    scale = n_in / n_out
    f = (np.arange(n_out) + 0.5) * scale - 0.5
    s = np.floor(f).astype(np.int64)
    frac = f - s
    low = s < 0
    frac[low], s[low] = 0.0, 0
    high = s >= n_in - 1
    frac[high], s[high] = 0.0, n_in - 1
    w1 = np.round(frac.astype(np.float32) * _COEF_SCALE).astype(np.int64)
    w0 = _COEF_SCALE - w1
    return s, np.minimum(s + 1, n_in - 1), w0, w1


def resize_image(image: np.ndarray, max_size: int) -> Tuple[np.ndarray, float]:
    """HWC uint8 -> (resized image, r) as the JAX package's cv2 resize."""
    h, w = image.shape[:2]
    nh, nw, r = resize_image_shape(h, w, max_size)
    if (nh, nw) == (h, w):
        return image.copy(), r
    x = image.astype(np.int64)
    sx0, sx1, a0, a1 = _cv2_linear_taps(w, nw)
    rows = x[:, sx0] * a0[None, :, None] + x[:, sx1] * a1[None, :, None]
    sy0, sy1, b0, b1 = _cv2_linear_taps(h, nh)
    top = (rows[sy0] >> 4) * b0[:, None, None] >> 16
    bot = (rows[sy1] >> 4) * b1[:, None, None] >> 16
    out = (top + bot + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8), r


_PIL_PRECISION_BITS = 22        # PIL's 8-bit resample: 32 - 8 - 2


@lru_cache(maxsize=32)
def _pil_int_coeffs(n_in: int, n_out: int):
    """PIL's BILINEAR taps of one axis as its 8-bit resample fixes them:
    (first source index (n_out,), int coefficients (n_out, taps)), the
    float weights normalized per output, then scaled by 2^22 and rounded
    half away from zero (Resample.c `precompute_coeffs`,
    `normalize_coeffs_8bpc`)."""
    scale = n_in / n_out
    support = max(scale, 1.0)
    taps = int(np.ceil(support)) * 2 + 1
    first = np.zeros(n_out, np.int64)
    coef = np.zeros((n_out, taps), np.int64)
    for i in range(n_out):
        center = (i + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), n_in)
        j = np.arange(lo, hi)
        w = np.maximum(0.0, 1.0 - np.abs((j - center + 0.5) / support))
        if w.sum() != 0.0:
            w = w / w.sum()
        first[i] = lo
        coef[i, :hi - lo] = np.where(
            w < 0, np.trunc(-0.5 + w * (1 << _PIL_PRECISION_BITS)),
            np.trunc(0.5 + w * (1 << _PIL_PRECISION_BITS))).astype(np.int64)
    return first, coef


def _pil_pass(x: np.ndarray, n_out: int, axis: int) -> np.ndarray:
    """One PIL 8-bit resample pass of uint8 `x` along `axis` (0 rows, 1
    columns): the fixed-point sum with a half added, shifted and clipped."""
    first, coef = _pil_int_coeffs(x.shape[axis], n_out)
    # The sums stay below 2^31: the weights are >= 0 and add up to ~2^22.
    xs = np.moveaxis(x, axis, 0).astype(np.int32)
    coef = coef.astype(np.int32)
    acc = np.full((n_out,) + xs.shape[1:], 1 << (_PIL_PRECISION_BITS - 1),
                  np.int32)
    n_in = xs.shape[0]
    for t in range(coef.shape[1]):
        idx = np.minimum(first + t, n_in - 1)
        acc += coef[:, t].reshape((-1,) + (1,) * (xs.ndim - 1)) * xs[idx]
    out = np.clip(acc >> _PIL_PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def stretch_bilinear(image: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """HWC uint8 -> (out_h, out_w) HWC uint8, PIL's
    `Image.resize((out_w, out_h), BILINEAR)`: the horizontal pass first,
    rounded to uint8, then the vertical one, each in PIL's fixed point; the
    input itself when the size is unchanged."""
    th, tw = out_hw
    h, w = image.shape[:2]
    if (th, tw) == (h, w):
        return image
    out = image
    if tw != w:
        out = _pil_pass(out, tw, 1)
    if th != h:
        out = _pil_pass(out, th, 0)
    return out


class ResizeLongestSide:
    """Long-side resize of images, coordinates and boxes."""

    def __init__(self, target_length: int) -> None:
        self.target_length = target_length

    def apply_image(self, image: np.ndarray) -> np.ndarray:
        """HWC uint8 -> HWC uint8 with the long side == target_length."""
        return stretch_bilinear(image, get_preprocess_shape(
            image.shape[0], image.shape[1], self.target_length))

    def apply_coords(self, coords: np.ndarray,
                     original_size: Tuple[int, ...]) -> np.ndarray:
        old_h, old_w = original_size
        new_h, new_w = get_preprocess_shape(old_h, old_w, self.target_length)
        coords = np.asarray(coords, dtype=np.float64).copy()
        coords[..., 0] = coords[..., 0] * (new_w / old_w)
        coords[..., 1] = coords[..., 1] * (new_h / old_h)
        return coords

    def apply_boxes(self, boxes: np.ndarray,
                    original_size: Tuple[int, ...]) -> np.ndarray:
        return self.apply_coords(np.asarray(boxes).reshape(-1, 2, 2),
                                 original_size).reshape(-1, 4)
