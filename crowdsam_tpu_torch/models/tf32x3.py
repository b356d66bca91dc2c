"""3xTF32, the float32 arms' products on the tensor cores: the host side.

The float32 arms of K2-K6 (`csrc/attention_f32.cu`, `csrc/decode_tail_f32.cu`,
`csrc/mask_head_f32.cu`) compute float32-accurate products on Hopper's TF32
tensor cores: every float32 operand x is split into hi = rna_tf32(x) and lo =
rna_tf32(x - hi) (`cvt.rna.tf32.f32`), and each product is lo.hi + hi.lo +
hi.hi, the small terms first; lo.lo (2^-22 of the product) is dropped.

This module holds what the host does for those products and what the tests
hold them to:

- `tf32_round` / `split`: the rounding, on the float32 bits;
- `pack`: a float32 weight (N, K) split once into hi and lo and laid out as
  the decode arms' shared-memory stages (`csrc/tf32x3.cuh`): stages of 128
  output rows x 32 inputs, chunk-major (the stages of rows 0-127 first, k
  ascending), each stage the hi part then the lo part, each part's rows of
  128 bytes with the 16-byte chunk c of row r at position c ^ (r % 8) (the
  128-byte swizzle that wgmma's descriptors read).  A stage is one
  contiguous 32 KB block, so the kernels bring it in one bulk copy;
- `packed`: `pack` with a cache, so that a weight is split once and not at
  every call (the decode calls its kernels 16 times a frame);
- `mm`: the product's arithmetic in PyTorch, with the design's faults
  (`PRODUCT_FAULTS`), for the models of the arms in
  `decode_tail_kernel.twoway_tail_tf32x3_model` and
  `mask_head_kernel.mask_head_tf32x3_model` (tests and chip_smoke.py only).
"""

from __future__ import annotations

import collections
from typing import Optional, Sequence

import torch

STAGE_ROWS = 128        # output rows (weight rows) of a stage
STAGE_K = 32            # inputs of a stage: one 128-byte row of float32
STAGE_BYTES = 2 * STAGE_ROWS * STAGE_K * 4      # hi part, then lo part

# The order of an A operand's 8 inputs a k-step when its fragments are the
# accumulators of an earlier product (the attention arm's P, K6's second
# product): position c holds input 2c for c < 4 and 2(c - 4) + 1 otherwise.
KEY_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)

PRODUCT_FAULTS = ("lo.hi dropped", "a weight stage's lo from the next stage",
                  "A's lo kept from a stage's first k-step")


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 `x` rounded to TF32 (10 stored mantissa bits), to nearest
    with ties away from zero, as `cvt.rna.tf32.f32`: on the float32 bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    """x as hi + lo, both TF32 (x - hi - lo within 2^-22 |x|)."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def key_permutation(k: int, device=None) -> torch.Tensor:
    """Indices that put `KEY_ORDER` into each 8-input group of k inputs."""
    order = torch.tensor(KEY_ORDER, device=device)
    return (torch.arange(k, device=device).view(-1, 8)[:, order]).reshape(-1)


def pack(w: torch.Tensor, key_order: bool = False) -> torch.Tensor:
    """float32 weight w (N, K), N a multiple of 128, as the kernels' stages
    (see the module's note): uint8 of N / 128 x ceil(K / 32) x 32 KB.  K is
    padded with zeros to a multiple of 32; `key_order` puts each 8-input
    group's inputs in `KEY_ORDER` first."""
    n, k = w.shape
    if w.dtype != torch.float32 or n % STAGE_ROWS:
        raise ValueError(f"pack: a float32 weight of rows a multiple of "
                         f"{STAGE_ROWS}, got {tuple(w.shape)} {w.dtype}")
    if key_order:
        w = w[:, key_permutation(k, w.device)]
    kp = -(-k // STAGE_K) * STAGE_K
    w = torch.nn.functional.pad(w, (0, kp - k))
    x = torch.stack(split(w))                                # (2, N, K)
    x = x.reshape(2, n // STAGE_ROWS, STAGE_ROWS, kp // STAGE_K, 8, 4)
    x = x.permute(1, 3, 0, 2, 4, 5)                # (nch, nks, 2, 128, 8, 4)
    row = torch.arange(STAGE_ROWS, device=w.device)[:, None]
    src = torch.arange(8, device=w.device)[None, :] ^ (row % 8)
    x = x[:, :, :, row, src]                       # position c <- chunk c ^ r
    return x.contiguous().view(torch.uint8).reshape(-1)


def pack_columns(w: torch.Tensor, width: int) -> torch.Tensor:
    """`pack` of each `width` columns of w on its own, concatenated: the
    K-split of a deep product (block j's inputs j width ..) or the
    out-projection's heads (head h's columns, padded to a stage)."""
    return torch.cat([pack(w[:, i:i + width].contiguous())
                      for i in range(0, w.shape[1], width)])


_CACHE: "collections.OrderedDict" = collections.OrderedDict()
_CACHE_SIZE = 256


def packed(w: torch.Tensor, kind: str = "plain") -> torch.Tensor:
    """`pack` (kind "plain"), `pack(w, key_order=True)` ("key_order") or
    `pack_columns(w, width)` ("columns:<width>") of w, from a cache.  An
    entry holds w itself, so no live tensor can share its address, and
    is keyed by w's address, shape, strides and version: a weight written
    in place is packed again."""
    key = (w.data_ptr(), w.device, tuple(w.shape), tuple(w.stride()),
           w._version, kind)
    hit = _CACHE.get(key)
    if hit is not None:
        _CACHE.move_to_end(key)
        return hit[1]
    if kind == "plain":
        out = pack(w)
    elif kind == "key_order":
        out = pack(w, key_order=True)
    elif kind.startswith("columns:"):
        out = pack_columns(w, int(kind.split(":")[1]))
    else:
        raise ValueError(f"packed: unknown kind {kind!r}")
    _CACHE[key] = (w, out)
    while len(_CACHE) > _CACHE_SIZE:
        _CACHE.popitem(last=False)
    return out


def mm(a: torch.Tensor, w: torch.Tensor, fault: Optional[str] = None,
       chunk: int = STAGE_K) -> torch.Tensor:
    """a (..., K) @ w^T, w (..., N, K) float32, in the kernels' arithmetic:
    both operands split into hi + lo; each stage of `chunk` inputs summed on
    its own, lo.hi, then hi.lo, then hi.hi (lo.lo dropped; products of TF32
    values are exact in float32), and added to the sum of the stages before
    it.  `fault`, one of
    `PRODUCT_FAULTS`, computes it with that fault of the design: the lo.hi
    term left out; each stage's lo part of w taken from the next stage (the
    last from the first); A's lo of a stage's first k-step (8 inputs) used
    for its other k-steps."""
    if fault is not None and fault not in PRODUCT_FAULTS:
        raise ValueError(f"fault {fault!r}: one of {PRODUCT_FAULTS}")
    k = a.shape[-1]
    ah, al = split(a)
    wh, wl = split(w)
    wt_h, wt_l = wh.transpose(-1, -2), wl.transpose(-1, -2)
    stages = [slice(s, min(s + chunk, k)) for s in range(0, k, chunk)]
    if fault == PRODUCT_FAULTS[2]:
        al = al.clone()
        for s in stages:
            first = al[..., s.start:s.start + 8]
            for k0 in range(s.start + 8, s.stop, 8):
                al[..., k0:k0 + 8] = first[..., :min(8, s.stop - k0)]
    out = None
    for i, s in enumerate(stages):
        lo_s = s
        if fault == PRODUCT_FAULTS[1]:
            nxt = stages[(i + 1) % len(stages)]
            lo_s = nxt if nxt.stop - nxt.start == s.stop - s.start else s
        part = ah[..., s] @ wt_l[..., lo_s, :]
        if fault != PRODUCT_FAULTS[0]:
            part = al[..., s] @ wt_h[..., s, :] + part
        part = part + ah[..., s] @ wt_h[..., s, :]
        out = part if out is None else out + part
    return out


def check_fault(fault: Optional[str], allowed: Sequence[str]) -> None:
    if fault is not None and fault not in allowed:
        raise ValueError(f"fault {fault!r}: one of {tuple(allowed)}")
