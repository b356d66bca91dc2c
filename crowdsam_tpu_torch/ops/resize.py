"""Separable resizes with the JAX package's semantics, as matrix products.

- `linear_resize_matrix` is the weight matrix that `jax.image.resize(...,
  "linear", antialias=False)` applies along one axis: a triangle kernel at
  half-pixel centres, weights renormalized where the kernel leaves the input,
  and zero rows for samples outside it.  For an upscale this is the clamped
  bilinear of torch's `align_corners=False`; the tests hold it against
  `jax.image.resize` at 1024->1022, 73->256 and 256->192.
- `cubic_resize_matrix` is torch's bicubic (a = -0.75, half-pixel, border
  replication), which DINOv2 uses for its positional embedding.

The matrices are built once per size pair in numpy (the linear one in
float32, step by step as JAX builds it; the cubic one in float64) and
applied in float32.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence

import numpy as np
import torch


@lru_cache(maxsize=64)
def linear_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) float32 matrix of jax.image.resize "linear",
    computed in float32 step by step as JAX computes it (its sample
    positions carry float32 rounding that shows at 1024 -> 1022)."""
    f = np.float32
    inv_scale = f(1.0) / f(out_size / in_size)
    sample = (np.arange(out_size, dtype=f) + f(0.5)) * inv_scale - f(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f)[:, None])
    weights = np.maximum(f(0.0), f(1.0) - x)                 # (in, out)
    total = weights.sum(axis=0, keepdims=True, dtype=f)
    weights = np.where(np.abs(total) > 1000.0 * np.finfo(f).eps,
                       weights / np.where(total != 0, total, f(1.0)), f(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    weights = np.where(inside[None, :], weights, f(0.0))
    return np.ascontiguousarray(weights.T).astype(f)


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    x = np.abs(x)
    out = np.zeros_like(x)
    m1 = x <= 1
    out[m1] = ((a + 2) * x[m1] - (a + 3)) * x[m1] * x[m1] + 1
    m2 = (x > 1) & (x < 2)
    out[m2] = (((x[m2] - 5) * x[m2] + 8) * x[m2] - 4) * a
    return out


@lru_cache(maxsize=64)
def cubic_resize_matrix(in_size: int, out_size: int,
                        a: float = -0.75) -> np.ndarray:
    """(out_size, in_size) float32 matrix of torch bicubic
    (align_corners=False, antialias=False, border replication)."""
    scale = in_size / out_size
    coords = (np.arange(out_size) + 0.5) * scale - 0.5
    base = np.floor(coords).astype(np.int64)
    frac = coords - base
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for tap in range(-1, 3):
        idx = np.clip(base + tap, 0, in_size - 1)
        np.add.at(mat, (np.arange(out_size), idx), _cubic_kernel(tap - frac, a))
    return mat.astype(np.float32)


def _apply(x: torch.Tensor, mats: Sequence[np.ndarray],
           axes: Sequence[int]) -> torch.Tensor:
    y = x.float()
    for mat, axis in zip(mats, axes):
        m = torch.as_tensor(mat, device=x.device)
        y = torch.movedim(torch.tensordot(m, torch.movedim(y, axis, 0),
                                          dims=1), 0, axis)
    return y


def resize_linear(x: torch.Tensor, out_hw, axes=(-3, -2)) -> torch.Tensor:
    """Linear resize of the two `axes` (NHWC spatial by default) to out_hw,
    in float32 (jax.image.resize "linear", antialias=False)."""
    mats, use = [], []
    for axis, n_out in zip(axes, out_hw):
        n_in = x.shape[axis]
        if n_in != n_out:
            mats.append(linear_resize_matrix(n_in, int(n_out)))
            use.append(axis)
    return _apply(x, mats, use)


def resize_bicubic_torch(x: torch.Tensor, out_hw) -> torch.Tensor:
    """(..., H, W, C) -> (..., out_h, out_w, C) torch-bicubic, float32."""
    h, w = x.shape[-3], x.shape[-2]
    return _apply(x, [cubic_resize_matrix(h, out_hw[0]),
                      cubic_resize_matrix(w, out_hw[1])], [-3, -2])


def resize_linear_band(x: torch.Tensor, frame: int, out: int, out_hw,
                       axes=(-3, -2)) -> torch.Tensor:
    """The top-left `out_hw` block of the linear resize (frame -> out on
    both axes) of a frame x frame image whose top-left band is `x` and
    which is zero beyond it: `linear_resize_matrix(frame, out)` cut to
    `out_hw` rows and to x's extent of columns, on each axis.  Exact, since
    the columns cut away multiply zeros."""
    mats = [linear_resize_matrix(frame, out)[:n, :x.shape[a]]
            for a, n in zip(axes, out_hw)]
    return _apply(x, mats, axes)
