"""Run-length encoding on the host: uncompressed RLE dicts, the COCO
compressed-string codec, and the flattening of the survivor kernel's
per-column change rows.

Counterpart of the JAX package's `ops/rle.py`, with the same strings out:

- uncompressed `{"size": [h, w], "counts": [...]}` in Fortran order, as the
  reference's `segment_anything_cs/utils/amg.py:107-153`;
- COCO-compressed strings as pycocotools writes them, from the port's own
  C++ codec `csrc/rle_codec.cpp` (built by g++ through `kernels/_build.py`
  at first use).  A failed build raises: the pure-Python encoder and
  decoder (`_compress_counts_py`, `_decompress_counts_py`) are the codec's
  plain version, which `coco_encode_rle` and the tests use.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, List

import numpy as np
import torch

from crowdsam_tpu_torch.kernels import _build

_P, _I64 = ctypes.c_void_p, ctypes.c_int64
_CODEC_ARGTYPES = {
    "rle_encode_mask": (_P, _I64, _P, _I64),
    "rle_decode_mask": (ctypes.c_char_p, _I64, _P, _I64),
    "rle_encode_batch": (_P, _I64, _I64, _P, _I64, _P),
    "rle_compress_counts": (_P, _I64, _P, _I64),
    "rle_area": (ctypes.c_char_p, _I64),
}


def codec(fn_name: str):
    """A function of the C++ codec (built on first use; raises if g++
    fails)."""
    return _build.function("rle_codec", fn_name, _CODEC_ARGTYPES[fn_name],
                           restype=_I64)


# ---------------------------------------------------------------------------
# uncompressed RLE (counts lists)
# ---------------------------------------------------------------------------

def mask_to_rle(masks) -> List[Dict[str, Any]]:
    """(B, H, W) binary masks -> uncompressed Fortran-order RLE dicts.

    `masks` is a numpy array or a tensor on any device: the changes are
    found on its device, and only their positions reach the host."""
    m = masks if isinstance(masks, torch.Tensor) else torch.from_numpy(
        np.asarray(masks))
    b, h, w = m.shape
    flat = m.transpose(1, 2).reshape(b, h * w).bool()
    change = torch.nonzero(flat[:, 1:] != flat[:, :-1]).cpu().numpy()
    first = flat[:, 0].cpu().numpy()
    bounds = np.searchsorted(change[:, 0], np.arange(b + 1))
    out = []
    for i in range(b):
        pos = change[bounds[i]:bounds[i + 1], 1]
        runs = np.diff(np.concatenate([[0], pos + 1, [h * w]]))
        # A leading one-run needs an explicit zero-length 0-run first.
        counts: List[int] = [0] if first[i] else []
        counts.extend(runs.tolist())
        out.append({"size": [h, w], "counts": counts})
    return out


def rle_to_mask(rle: Dict[str, Any]) -> np.ndarray:
    """Uncompressed RLE -> (H, W) bool mask."""
    h, w = rle["size"]
    mask = np.empty(h * w, dtype=bool)
    idx, parity = 0, False
    for count in rle["counts"]:
        mask[idx:idx + count] = parity
        idx += count
        parity ^= True
    return mask.reshape(w, h).transpose()


def area_from_rle(rle: Dict[str, Any]) -> int:
    return sum(rle["counts"][1::2])


# ---------------------------------------------------------------------------
# COCO-compressed RLE (printable-ASCII delta varint strings)
# ---------------------------------------------------------------------------

def _compress_counts_py(cnts: List[int]) -> str:
    """Plain version of the codec's encoder."""
    s = []
    for i, cnt in enumerate(cnts):
        x = int(cnt)
        if i > 2:
            x -= int(cnts[i - 2])
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            s.append(chr(c + 48))
    return "".join(s)


def _decompress_counts_py(s: str) -> List[int]:
    """Plain version of the codec's decoder."""
    cnts: List[int] = []
    i = 0
    while i < len(s):
        x = k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(cnts) > 2:
            x += cnts[-2]
        cnts.append(x)
    return cnts


def coco_encode_rle(uncompressed_rle: Dict[str, Any]) -> Dict[str, Any]:
    """Uncompressed RLE dict -> {"size": [h, w], "counts": str}."""
    h, w = uncompressed_rle["size"]
    return {"size": [h, w],
            "counts": _compress_counts_py(list(uncompressed_rle["counts"]))}


def coco_decode_rle(encoded_rle: Dict[str, Any]) -> np.ndarray:
    """{"size": [h, w], "counts": str} -> (H, W) uint8 mask (C++ codec)."""
    h, w = encoded_rle["size"]
    raw = encoded_rle["counts"].encode("utf-8")
    out = np.empty(h * w, dtype=np.uint8)
    if codec("rle_decode_mask")(raw, len(raw), out.ctypes.data, h * w) != 0:
        raise ValueError(f"malformed RLE string for a {h}x{w} mask")
    return out.reshape(w, h).transpose().copy()


def encode_masks_coco(masks) -> List[Dict[str, Any]]:
    """(B, H, W) binary masks -> COCO-compressed RLE dicts, one C++ call
    over the Fortran-flattened byte batch."""
    masks = np.asarray(masks)
    if masks.ndim == 2:
        masks = masks[None]
    b, h, w = masks.shape
    if b == 0:
        return []
    flat = np.ascontiguousarray(
        masks.transpose(0, 2, 1).reshape(b, -1).astype(np.uint8))
    # At most one run per pixel, each of at most 2 chars once h*w >= 16.
    stride = h * w + 16
    out = np.empty((b, stride), dtype=np.uint8)
    lens = np.empty((b,), dtype=np.int64)
    status = codec("rle_encode_batch")(flat.ctypes.data, b, h * w,
                                       out.ctypes.data, stride,
                                       lens.ctypes.data)
    if status != 0:
        raise RuntimeError("rle_encode_batch: output buffer too small")
    return [{"size": [h, w],
             "counts": out[i, :lens[i]].tobytes().decode("utf-8")}
            for i in range(b)]


def encode_changes_coco(changes: np.ndarray, total: int,
                        size) -> Dict[str, Any]:
    """Ascending Fortran-order change positions (where the value differs
    from its predecessor, with an implicit 0 before position 0) of an
    (h, w) mask with `total` = h*w pixels -> COCO-compressed RLE dict.
    Equal to `encode_masks_coco` of the dense mask."""
    h, w = size
    changes = np.asarray(changes, dtype=np.int64)
    if changes.size == 0:
        counts = np.asarray([total], dtype=np.int64)
    else:
        counts = np.empty(changes.size + 1, dtype=np.int64)
        counts[0] = changes[0]
        counts[1:-1] = np.diff(changes)
        counts[-1] = total - changes[-1]
    cap = int(counts.size * 12 + 16)       # a 64-bit count takes <= 12 chars
    out = np.empty(cap, dtype=np.uint8)
    n = codec("rle_compress_counts")(counts.ctypes.data, counts.size,
                                     out.ctypes.data, cap)
    if n < 0:
        raise RuntimeError("rle_compress_counts: output buffer too small")
    return {"size": [int(h), int(w)],
            "counts": out[:n].tobytes().decode("utf-8")}


# ---------------------------------------------------------------------------
# the survivor kernel's change rows
# ---------------------------------------------------------------------------

def unpack_cand10(cand_packed: np.ndarray) -> np.ndarray:
    """(..., W, S) int32 words of three 10-bit change rows each (the high
    field first) -> (..., 3W, S) slot-major rows."""
    c = np.asarray(cand_packed)
    out = np.stack([(c >> 20) & 0x3FF, (c >> 10) & 0x3FF, c & 0x3FF],
                   axis=-2)                       # (..., W, 3, S)
    return out.reshape(*c.shape[:-2], c.shape[-2] * 3, c.shape[-1])


def svals_from_cand(cand: np.ndarray, n_col: np.ndarray,
                    in_h: int) -> np.ndarray:
    """(slots, S) first change rows per column and (S,) per-column counts
    (each <= slots: a mask with a fuller column takes the packed bitmap)
    -> the sorted Fortran-order change positions `encode_changes_coco`
    takes."""
    cols = np.nonzero(n_col)[0]
    reps = n_col[cols].astype(np.int64)
    col_rep = np.repeat(cols, reps)
    starts = np.cumsum(reps) - reps
    slot = np.arange(len(col_rep), dtype=np.int64) - np.repeat(starts, reps)
    rows = cand[slot, col_rep]
    return col_rep * in_h + rows
