"""The survivor mask tail as one kernel (K7): `csrc/survivor.cu`, its
wrapper `survivor_rle` and its plain PyTorch version `survivor_rle_plain`.

Replaces the JAX package's Pallas `survivor_rle_pallas`
(crowdsam_tpu/ops/survivor_kernel.py:231).  Per post-NMS survivor, at image
resolution S = 4R: the bilinear 4x upsample of the (R, R) logits
(`jax.image.resize` "linear" weights, horizontal pass first), the threshold,
the low-res cleanup edits by nearest expansion (+1 forces a pixel on, -1
off), the crop to the valid (in_h, in_w) region, the bit-packed bitmap, the
box, and the Fortran-order change rows of every column: the first
`COL_SLOTS` rows where a pixel differs from its predecessor (row 0 compares
with pixel (in_h - 1, x - 1), the previous column's last valid one), packed
three 10-bit rows a word, and the per-column counts.  The host turns them
into COCO RLE strings (`ops/rle.svals_from_cand`, `encode_changes_coco`).

Numerics, the same in the kernel and the plain version: every bilinear
weight is k/8; each pass is a product, a product and a sum, each rounded to
float32 (no fused multiply-add), so the two agree bit for bit on any input.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Dict

import numpy as np
import torch

from crowdsam_tpu_torch.kernels import _build
from crowdsam_tpu_torch.ops.resize import linear_resize_matrix

COL_SLOTS = 24                  # change rows kept per column
CAND_WORDS = COL_SLOTS // 3     # three 10-bit rows per int32 word
STRIP = 32                      # output columns per kernel block
BANDS = 8                       # row bands per kernel block (S / 8 rows)
RES_MULTIPLE = 32               # R a multiple of 32: the contract's shapes
MAX_RES = 256                   # R <= 256: S <= 1024 fits 10 bits

_ARGTYPES = ((ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_float, ctypes.c_int, ctypes.c_int)
             + (ctypes.c_void_p,) * 6)


@lru_cache(maxsize=8)
def _taps(r: int):
    """The two taps of every output index of the 4x linear resize R -> S:
    (lo, hi, w_lo, w_hi), from `linear_resize_matrix`.  Where the resize
    clamps at an edge the row has one weight, 1, and w_hi is 0."""
    m = linear_resize_matrix(r, 4 * r)                  # (S, R)
    nz = m != 0
    lo = nz.argmax(axis=1)
    hi = r - 1 - nz[:, ::-1].argmax(axis=1)
    rows = np.arange(4 * r)
    w_hi = np.where(hi > lo, m[rows, hi], 0.0).astype(np.float32)
    return lo, hi, m[rows, lo], w_hi


def _as_hw(in_hw, k: int, device) -> torch.Tensor:
    hw = torch.as_tensor(in_hw, dtype=torch.int32, device=device)
    if hw.dim() == 1:
        hw = hw[None].expand(k, 2)
    return hw.contiguous()


def _column_link(full: torch.Tensor, hw: torch.Tensor) -> torch.Tensor:
    """(K, S) bool: what row 0 of each column compares with, the previous
    column's pixel at row in_h - 1 (0 for column 0)."""
    k, _, s = full.shape
    last = full.gather(1, (hw[:, 0] - 1)[:, None, None].expand(k, 1, s))[:, 0]
    link = torch.zeros_like(last)
    link[:, 1:] = last[:, :-1]
    return link


def upsample_plain(logits: torch.Tensor) -> torch.Tensor:
    """(K, R, R) -> (K, 4R, 4R) float32: the horizontal pass, then the
    vertical one, each w_lo * a + w_hi * b rounded after every operation."""
    r = logits.shape[-1]
    dev = logits.device
    lo, hi, wa, wb = (torch.as_tensor(a, device=dev) for a in _taps(r))
    x = logits.float()
    h = x[:, :, lo] * wa + x[:, :, hi] * wb              # (K, R, S)
    return h[:, lo, :] * wa[:, None] + h[:, hi, :] * wb[:, None]


def survivor_rle_plain(logits: torch.Tensor, edit: torch.Tensor, in_hw,
                       thresh: float = 0.0) -> Dict[str, torch.Tensor]:
    """Plain version of `survivor_rle` (same contract), step by step on
    (K, S, S) tensors."""
    k, r, _ = logits.shape
    s = 4 * r
    dev = logits.device
    hw = _as_hw(in_hw, k, dev).long().clamp(1, s)
    full = upsample_plain(logits) > thresh
    ed = edit.repeat_interleave(4, dim=1).repeat_interleave(4, dim=2)
    full = torch.where(ed > 0, True, torch.where(ed < 0, False, full))
    ys = torch.arange(s, device=dev)
    full &= ((ys[None, :, None] < hw[:, 0, None, None])
             & (ys[None, None, :] < hw[:, 1, None, None]))
    return mask_tail(full, hw)


def mask_tail(full: torch.Tensor, hw: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The outputs of `survivor_rle` from finished (K, S, S) bool masks,
    zero outside the valid region hw (K, 2): the packed bitmap, the box,
    the Fortran-order change rows and their counts, the summary.  Plain
    PyTorch ops: the second half of K7's plain version, and the tail of the
    full-resolution cleanup (`pipeline/engine.py`), where K7 does not run."""
    k, _, s = full.shape
    dev = full.device
    hw = hw.long()
    ys = torch.arange(s, device=dev)
    inside = ((ys[None, :, None] < hw[:, 0, None, None])
              & (ys[None, None, :] < hw[:, 1, None, None]))

    bitw = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32,
                        device=dev)
    packed = (full.reshape(k, s, s // 8, 8).int() * bitw).sum(-1).to(
        torch.uint8)

    col_any, row_any = full.any(dim=1), full.any(dim=2)  # (K, S) each
    nonempty = col_any.any(dim=1)
    big = torch.tensor(s, device=dev)
    x0 = torch.where(col_any, ys, big).amin(1)
    x1 = torch.where(col_any, ys, -1).amax(1)
    y0 = torch.where(row_any, ys, big).amin(1)
    y1 = torch.where(row_any, ys, -1).amax(1)
    box = torch.stack([x0, y0, x1, y1], 1) * nonempty[:, None]

    # Fortran-order change map: row y > 0 compares with row y - 1; row 0
    # with the previous column's pixel at row in_h - 1.
    prev = torch.empty_like(full)
    prev[:, 1:] = full[:, :-1]
    prev[:, 0] = _column_link(full, hw)
    change = inside & (full != prev)
    n_col = change.sum(1)
    rank = change.int().cumsum(1)
    kk, yy, xx = torch.nonzero(change & (rank <= COL_SLOTS), as_tuple=True)
    rows = torch.full((k, COL_SLOTS, s), s - 1, dtype=torch.int32, device=dev)
    rows[kk, rank[kk, yy, xx] - 1, xx] = yy.int()
    rows = rows.reshape(k, CAND_WORDS, 3, s)
    cand = (rows[:, :, 0] << 20) | (rows[:, :, 1] << 10) | rows[:, :, 2]

    summary = torch.stack([
        *box.unbind(1), nonempty.long(), n_col.sum(1),
        (n_col.amax(1) > COL_SLOTS).long(), torch.zeros_like(x0)], 1)
    return {"packed": packed, "cand": cand, "n_col": n_col.int(),
            "summary": summary.int()}


def survivor_rle(logits: torch.Tensor, edit: torch.Tensor, in_hw,
                 thresh: float = 0.0) -> Dict[str, torch.Tensor]:
    """The survivor mask tail (K7).

    logits (K, R, R) bf16 or float32; edit (K, R, R) int8 in {-1, 0, +1};
    in_hw (2,) or per-mask (K, 2) int32, the valid region; the pipeline
    passes 1 <= in_h, in_w <= S, and other values are clamped to [1, S].
    Returns, with S = 4R:
      packed  (K, S, S/8) uint8: the mask bits, row-major, MSB first;
      cand    (K, 8, S) int32: the first 24 change rows of each column,
              three 10-bit rows a word (`ops/rle.unpack_cand10`), empty
              slots S - 1;
      n_col   (K, S) int32: changes per column;
      summary (K, 8) int32: [x0, y0, x1, y1, nonempty, total changes,
              overflow (a column above 24), 0], the box [0, 0, 0, 0] when
              empty.

    CPU: the plain version.  CUDA: the kernel (K >= 1, R a multiple of 32
    and at most 256), or an error."""
    _build.refuse_grad("survivor_rle", logits, edit)
    if logits.device.type == "cpu":
        return survivor_rle_plain(logits, edit, in_hw, thresh)
    if logits.device.type != "cuda":
        raise ValueError(f"survivor_rle: unsupported device {logits.device}")
    dev = logits.device
    if logits.dim() != 3 or logits.shape[1] != logits.shape[2]:
        raise ValueError(f"survivor_rle: logits must be (K, R, R), got "
                         f"{tuple(logits.shape)}")
    k, r, _ = logits.shape
    if k == 0 or r % RES_MULTIPLE or r > MAX_RES:
        raise ValueError(
            f"survivor_rle: unsupported shape {tuple(logits.shape)} (K >= 1, "
            f"R a multiple of {RES_MULTIPLE}, at most {MAX_RES})")
    if logits.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"survivor_rle: logits must be bfloat16 or float32, "
                        f"got {logits.dtype}")
    hw = in_hw if isinstance(in_hw, torch.Tensor) else torch.tensor(
        in_hw, dtype=torch.int32, device=dev)
    if hw.dim() == 1:
        hw = hw[None].expand(k, 2).contiguous()
    _build.require_operand("survivor_rle", logits, "logits", (k, r, r),
                           logits.dtype, dev)
    _build.require_operand("survivor_rle", edit, "edit", (k, r, r),
                           torch.int8, dev)
    _build.require_operand("survivor_rle", hw, "in_hw", (k, 2), torch.int32,
                           dev)
    s = 4 * r
    packed = torch.empty((k, s, s // 8), dtype=torch.uint8, device=dev)
    cand = torch.empty((k, CAND_WORDS, s), dtype=torch.int32, device=dev)
    n_col = torch.empty((k, s), dtype=torch.int32, device=dev)
    partial = torch.empty((k, s // STRIP, 8), dtype=torch.int32, device=dev)
    summary = torch.empty((k, 8), dtype=torch.int32, device=dev)
    fn = _build.function("survivor", "survivor_rle_forward", _ARGTYPES)
    status = fn(logits.data_ptr(), int(logits.dtype == torch.float32),
                edit.data_ptr(), hw.data_ptr(), float(thresh), k, r,
                packed.data_ptr(), cand.data_ptr(), n_col.data_ptr(),
                partial.data_ptr(), summary.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "survivor_rle")
    survivor_rle.launches += 1
    return {"packed": packed, "cand": cand, "n_col": n_col,
            "summary": summary}


survivor_rle.launches = 0
