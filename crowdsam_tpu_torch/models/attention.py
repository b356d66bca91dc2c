"""Attention for the two ViT backbones: the CUDA kernels K2 and K3
(`csrc/attention.cu`, TMA + wgmma with the rel-pos bias) and K4
(`csrc/flash_sm90.cu`, TMA + wgmma), and their plain PyTorch versions.

Counterparts of the JAX package's `models/attention.py`:

- `window_attention` replaces `window_attention_pallas` (K2): the SAM
  window blocks, 14x14 windows with the decomposed rel-pos bias;
- `flash_mha_decomposed_relpos` replaces the function of the same name (K3):
  SAM's global blocks, 64x64 tokens with the rel-pos bias;
- `flash_mha` replaces the function of the same name (K4): DINOv2's
  1 + 73^2 tokens, keys at or beyond `valid_len` masked.

The rel-pos bias is bias[q, k] = fh[q, row(k)] + fw[q, col(k)] with fh =
q.Rh[row(q)] and fw = q.Rw[col(q)].  K2 computes fh and fw inside the kernel
from the tables; K3 (`relpos_form`) on a grid 64 wide (SAM's) computes fh
inside and takes fw from one batched product here (a block's queries share
their grid row, not their column); on the whole of a grid 64 tall (a
portrait frame's rect encode) it does the same on the exchanged grid, read
column by column (`relpos_attention_columns`): fw inside, fh from one
batched product here; on other grids it takes both from here (two einsums,
as the JAX code computes them).  The kernels read q/k/v straight out of the
qkv projection through TMA tensor maps, so no head transpose or window
partition is materialized: K3 and K4 through one map per (B, H, S, hd)
operand, whose host-side layout `tma_layout` builds and checks (K3's
columns form splits its token axis in the entry point); K2 through 5-d
maps of the projection built in the kernel's entry point.  K2 and K3 take
head dim 64 (SAM ViT-B/L) and 80 (SAM ViT-H, its dims 64-79 as a second
slab in the kernel); K4 takes 64 (every DINOv2 arch).  K3 and K4 also take fewer
queries than keys: a rank of the spatial axis (`parallel/spatial.py`)
holds a band of the queries (K3: grid rows from `row0`) and every key.

On a CPU tensor each wrapper computes its plain version; on a CUDA tensor it
launches the kernel or raises: on bf16 operands the kernels above (f32
softmax and accumulation), on float32 ones (`tpu.compute_dtype float32`)
their float32 arms (`csrc/attention_f32.cu`: 3xTF32 on wgmma, each float32
operand split into TF32 hi + lo and each product lo.hi + hi.lo + hi.hi,
float32 softmax and accumulation).  A float32 arm's host-side preparation
(`window_f32_attention`, `relpos_f32_attention`, `flash_f32_attention`:
the window partition, the rel-pos terms fh and fw by float32 batched
products, the key count past which keys are masked) also runs on the CPU,
where `f32_attention_plain` computes the kernel's function from it;
`f32_attention_tf32x3_model` writes out the kernel's arithmetic (for the
tests and the smoke's faults only).
"""

from __future__ import annotations

import collections
import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from crowdsam_tpu_torch.kernels import _build
from crowdsam_tpu_torch.models.common import exact_float32
from crowdsam_tpu_torch.models.tf32x3 import KEY_ORDER, tf32_round
from crowdsam_tpu_torch.models.tf32x3 import split as _tf32_split

_GLOBAL_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
)
_WINDOW_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
)
_F32_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
)
_SM90_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
)
HEAD_DIM = 64           # K4 (DINOv2), and the box of one TMA load
RELPOS_HEAD_DIMS = (64, 80)   # K2, K3: SAM ViT-B/L and ViT-H
MAX_REL = 64            # K3: grids up to 64x64
MAX_WINDOW = 16         # K2's kernel: a window's keys fit two key tiles
# Tokens a TMA box of K4 brings: a block's query rows and a stage's keys
# (csrc/flash_sm90.cu BQ and BK; the kernel refuses other boxes).
TMA_Q_ROWS = 64
TMA_KV_ROWS = 128


# ---------------------------------------------------------------------------
# plain versions (f32 math, output in the input dtype)
# ---------------------------------------------------------------------------

def _softmax_av(logits: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    probs = torch.softmax(logits.float(), dim=-1)
    return probs @ v.float()


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, Hp, Wp, C) with Hp, Wp multiples of ws -> (B*nW, ws*ws, C)."""
    b, hp, wp, c = x.shape
    x = x.reshape(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_unpartition(x: torch.Tensor, ws: int, hp: int,
                       wp: int) -> torch.Tensor:
    """(B*nW, ws*ws, C) -> (B, Hp, Wp, C)."""
    c = x.shape[-1]
    b = x.shape[0] // ((hp // ws) * (wp // ws))
    x = x.reshape(b, hp // ws, wp // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp, wp, c)


def _rel_bias_terms(q: torch.Tensor, rel_h: torch.Tensor, rel_w: torch.Tensor,
                    hw: Tuple[int, int], row0: int = 0):
    """fh[.., n, j] = q[n] . Rh[row(n), j];  fw[.., n, j] = q[n] . Rw[col(n), j].

    q: (..., hq*w, D), the queries of grid rows [row0, row0 + hq) of the
    h x w grid (all of it by default); rel_h (h, h, D), rel_w (w, w, D)."""
    h, w = hw
    hq = q.shape[-2] // w
    qr = q.reshape(*q.shape[:-2], hq, w, q.shape[-1])
    fh = torch.einsum("...rwc,rjc->...rwj", qr,
                      rel_h[row0:row0 + hq].to(q.dtype))
    fw = torch.einsum("...rwc,wjc->...rwj", qr, rel_w.to(q.dtype))
    return (fh.reshape(*q.shape[:-1], h), fw.reshape(*q.shape[:-1], w))


def relpos_attention_plain(q, k, v, sm_scale: float, rel_h, rel_w, hw,
                           row0: int = 0) -> torch.Tensor:
    """(..., Sq, D) queries against (..., S, D) keys with the decomposed
    rel-pos bias, S = h*w: softmax(scale q.k + q.Rh[row(q), row(k)] +
    q.Rw[col(q), col(k)]) v.  The queries are grid rows [row0, row0 + Sq /
    w) (a query band; the whole grid by default)."""
    h, w = hw
    hq = q.shape[-2] // w
    qf, kf = q.float(), k.float()
    fh, fw = _rel_bias_terms(qf, rel_h.float(), rel_w.float(), hw, row0)
    logits = (qf * sm_scale) @ kf.transpose(-1, -2)
    lead = logits.shape[:-2]
    logits = (logits.reshape(*lead, hq, w, h, w)
              + fh.reshape(*lead, hq, w, h, 1)
              + fw.reshape(*lead, hq, w, 1, w))
    out = _softmax_av(logits.reshape(*lead, hq * w, h * w), v)
    return out.to(q.dtype)


def to_columns(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """(..., h*w, D) tokens of an h x w grid in column order: token (r, c)
    moves to c*h + r, the grid's exchange (w x h, row-major)."""
    h, w = hw
    lead, d = x.shape[:-2], x.shape[-1]
    return x.reshape(*lead, h, w, d).transpose(-3, -2).reshape(*lead,
                                                               h * w, d)


def relpos_attention_columns(q, k, v, sm_scale: float, rel_h, rel_w,
                             hw) -> torch.Tensor:
    """`relpos_attention_plain` over the whole grid as K3's columns form
    computes it: q, k and v read in column order, the tables exchanged,
    attention on the w x h grid, the output rows stored back in grid
    order.  Attention does not change when the keys are permuted, and
    permuting the queries permutes its rows alike: the same function."""
    h, w = hw
    out = relpos_attention_plain(*(to_columns(t, hw) for t in (q, k, v)),
                                 sm_scale, rel_w, rel_h, (w, h))
    return to_columns(out, (w, h))


def window_attention_plain(qkv, rel_h_tab, rel_w_tab, num_heads: int,
                           scale: float, window: int) -> torch.Tensor:
    """Plain version of `window_attention` (same contract)."""
    b, hp, wp, c3 = qkv.shape
    dim = c3 // 3
    hd = dim // num_heads
    win = window_partition(qkv, window)                      # (nw, n, 3*dim)
    nw, n = win.shape[:2]
    win = win.reshape(nw, n, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    out = relpos_attention_plain(win[0], win[1], win[2], scale, rel_h_tab,
                                 rel_w_tab, (window, window))  # (nw, nh, n, hd)
    out = out.permute(0, 2, 1, 3).reshape(nw, n, dim)
    return window_unpartition(out, window, hp, wp)


def flash_mha_plain(q, k, v, sm_scale: float,
                    valid_len: Optional[int] = None) -> torch.Tensor:
    """Plain version of `flash_mha`: (B, H, Sq, D) queries against (B, H,
    S, D) keys, softmax((q.k) scale) v with keys at or beyond valid_len
    masked."""
    s = k.shape[-2]
    vlen = s if valid_len is None else valid_len
    logits = (q.float() @ k.float().transpose(-1, -2)) * sm_scale
    if vlen < s:
        logits[..., vlen:] = float("-inf")
    return _softmax_av(logits, v).to(q.dtype)


# ---------------------------------------------------------------------------
# float32 arms: host-side preparation and the kernel's function
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class F32Attention:
    """What one launch of a float32 arm (`csrc/attention_f32.cu`) takes:
    q (B, H, Sq, D), k and v (B, H, S, D), views with a contiguous head
    dim; keys at or past `valid` masked; with the rel-pos bias (K2, K3) fh
    (B, H, Sq, gh) and fw (B, H, Sq, gw) contiguous, on the gh x gw key
    grid `grid` (row(k) = k // gw, col(k) = k % gw), the scale applied to q
    before the product; without it (K4) to the product."""

    q: torch.Tensor
    k: torch.Tensor
    v: torch.Tensor
    scale: float
    valid: int
    fh: Optional[torch.Tensor] = None
    fw: Optional[torch.Tensor] = None
    grid: Tuple[int, int] = (1, 1)


def f32_attention_plain(a: F32Attention) -> torch.Tensor:
    """The float32 arms' function on `a`, in a's dtype (float32, or
    float64 for a reference): (B, H, Sq, D)."""
    return torch.softmax(f32_attention_logits(a), dim=-1) @ a.v


def f32_attention_logits(a: F32Attention) -> torch.Tensor:
    """The logits of `f32_attention_plain(a)`, keys at or past `valid`
    masked: (B, H, Sq, S)."""
    q, k = a.q, a.k
    if a.fh is None:
        logits = (q @ k.transpose(-1, -2)) * a.scale
    else:
        gh, gw = a.grid
        lead, sq = q.shape[:-2], q.shape[-2]
        logits = ((q * a.scale) @ k.transpose(-1, -2)).reshape(
            *lead, sq, gh, gw)
        logits = (logits + a.fh.reshape(*lead, sq, gh, 1)
                  + a.fw.reshape(*lead, sq, 1, gw)).reshape(*lead, sq,
                                                            gh * gw)
    if a.valid < k.shape[-2]:
        logits[..., a.valid:] = float("-inf")
    return logits


# Key order of V^T within each 8-key group in the float32 arm: position c
# holds key 2c for c < 4 and key 2(c - 4) + 1 otherwise, the order in which
# the P V product's A fragments take the score accumulators.
TF32X3_KEY_ORDER = KEY_ORDER
TF32X3_FAULTS = ("lo.hi dropped", "V's keys unpermuted",
                 "a tile's lo part from the previous tile")
_LOG2E = 1.4426950408889634


def f32_attention_tf32x3_model(a: F32Attention,
                               fault: Optional[str] = None) -> torch.Tensor:
    """The float32 arm's arithmetic in PyTorch, on float32 `a` (CPU or
    CUDA): every operand split into TF32 hi + lo, each product lo.hi +
    hi.lo + hi.hi (lo.lo dropped; products of TF32 values are exact in
    float32), the scale on q before the product (K2/K3) or on the product
    (K4), the bias as (s + fh) + fw, keys at or past `valid` masked, an
    online softmax over 64-key tiles (exp(x - m) as 2^(x log2(e) - m
    log2(e))), and each tile's P V summed apart (keys in
    `TF32X3_KEY_ORDER` within each 8-key group of P and V^T) before it joins
    O.  `fault`, one of `TF32X3_FAULTS`, computes it with that fault of the
    design instead (the stale lo part: tile 1 takes tile 0's).  For the
    tests and chip_smoke.py's faults: no path calls it."""
    if fault is not None and fault not in TF32X3_FAULTS:
        raise ValueError(f"fault {fault!r}: one of {TF32X3_FAULTS}")
    q, k, v = a.q, a.k, a.v
    s, d = k.shape[-2], k.shape[-1]
    tiles = -(-a.valid // 64)
    width = max(64 * tiles, -(-s // 64) * 64)
    pad = (0, 0, 0, width - s)
    kh, kl = _tf32_split(torch.nn.functional.pad(k, pad))
    vh, vl = _tf32_split(torch.nn.functional.pad(v, pad))
    qh, ql = _tf32_split(q * a.scale if a.fh is not None else q)
    order = torch.tensor(TF32X3_KEY_ORDER, device=q.device)
    perm = torch.arange(64, device=q.device).view(8, 8)[:, order].reshape(-1)
    m = torch.full(q.shape[:-1] + (1,), float("-inf"), dtype=q.dtype,
                   device=q.device)
    l = torch.zeros_like(m)
    o = torch.zeros(q.shape[:-1] + (d,), dtype=q.dtype, device=q.device)
    for t in range(tiles):
        cols = slice(64 * t, 64 * t + 64)
        prev = slice(64 * t - 64, 64 * t) if t else cols
        stale = fault == TF32X3_FAULTS[2] and t == min(1, tiles - 1)
        k_hi, k_lo = kh[..., cols, :], kl[..., prev if stale else cols, :]
        v_hi, v_lo = vh[..., cols, :], vl[..., prev if stale else cols, :]
        small = qh @ k_lo.transpose(-1, -2)
        if fault != TF32X3_FAULTS[0]:
            small = ql @ k_hi.transpose(-1, -2) + small
        st = small + qh @ k_hi.transpose(-1, -2)
        key = torch.arange(64 * t, 64 * t + 64, device=q.device)
        if a.fh is None:
            st = st * a.scale
        else:
            kk = key.clamp(max=s - 1)
            st = st + a.fh[..., kk // a.grid[1]] + a.fw[..., kk % a.grid[1]]
        st = st.masked_fill(key >= a.valid, float("-inf"))
        mn = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp2((m - mn) * _LOG2E)
        p = torch.exp2(st * _LOG2E - mn * _LOG2E)
        l = l * alpha + p.sum(-1, keepdim=True)
        m = mn
        p_hi, p_lo = (x[..., perm] for x in _tf32_split(p))
        if fault != TF32X3_FAULTS[1]:
            v_hi, v_lo = v_hi[..., perm, :], v_lo[..., perm, :]
        small = p_hi @ v_lo
        if fault != TF32X3_FAULTS[0]:
            small = p_lo @ v_hi + small
        o = o * alpha + (small + p_hi @ v_hi)
    return o / l


def window_f32_attention(qkv, rel_h_tab, rel_w_tab, num_heads: int,
                         scale: float, window: int) -> F32Attention:
    """K2's float32 arm on `window_attention`'s arguments: the partitioned
    windows' q, k, v (nW, H, window^2, D) and their fh / fw, the window's
    keys all valid (the kernel masks the pad keys of its last tile)."""
    b, hp, wp, c3 = qkv.shape
    hd = c3 // 3 // num_heads
    n = window * window
    win = window_partition(qkv, window).reshape(-1, n, 3, num_heads, hd)
    q, k, v = win.permute(2, 0, 3, 1, 4)
    with exact_float32():
        fh, fw = _rel_bias_terms(q, rel_h_tab.float(), rel_w_tab.float(),
                                 (window, window))
    return F32Attention(q, k, v, scale, n, fh.contiguous(), fw.contiguous(),
                        (window, window))


def window_f32_output(o: torch.Tensor, window: int, hp: int,
                      wp: int) -> torch.Tensor:
    """The (B, Hp, Wp, dim) grid of K2's float32 output o (nW, H, n, D)."""
    nw, nh, n, hd = o.shape
    return window_unpartition(o.transpose(1, 2).reshape(nw, n, nh * hd),
                              window, hp, wp)


def relpos_f32_attention(q, k, v, sm_scale: float, rel_h, rel_w, hw,
                         row0: int = 0) -> F32Attention:
    """K3's float32 arm on `flash_mha_decomposed_relpos`'s arguments: fh
    and fw of the band's queries (grid rows from `row0`), every key
    valid."""
    with exact_float32():
        fh, fw = _rel_bias_terms(q, rel_h.float(), rel_w.float(), hw, row0)
    return F32Attention(q, k, v, sm_scale, hw[0] * hw[1], fh.contiguous(),
                        fw.contiguous(), tuple(hw))


def flash_f32_attention(q, k, v, sm_scale: float,
                        valid_len: Optional[int] = None) -> F32Attention:
    """K4's float32 arm on `flash_mha`'s arguments."""
    return F32Attention(q, k, v, sm_scale,
                        k.shape[-2] if valid_len is None else int(valid_len))


# ---------------------------------------------------------------------------
# CUDA launch
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TmaLayout:
    """Host-side layout of the TMA tensor map of one K3/K4 operand: `dims`
    in elements, innermost (the head dim, 64 or 80) first; `strides` in
    bytes, of dims 1-3; `box` the tile one load brings (64 dims x `rows`
    tokens: at head dim 80 the kernel adds a box of dims 64-79); `pos` the
    map dim (1-3) of the head, the token and the batch axis."""

    dims: Tuple[int, int, int, int]
    strides: Tuple[int, int, int]
    box: Tuple[int, int, int, int]
    pos: Tuple[int, int, int]

    def row(self) -> list:
        """The 14 int64 that `flash_sm90_forward` reads per operand."""
        return [*self.dims, *self.strides, *self.box, *self.pos]


def tma_layout(t: torch.Tensor, name: str = "operand",
               rows: int = TMA_KV_ROWS, fn: str = "flash_mha",
               head_dims: Tuple[int, ...] = (HEAD_DIM,)) -> TmaLayout:
    """The tensor map of a (B, H, S, hd) bf16 view, read in place, whose
    box brings `rows` tokens: the head, token and batch axes become map
    dims 1-3 in order of stride (the CUDA driver's maps grow outwards), an
    axis of extent 1 taking the stride past the others.  Raises on what TMA
    does not take: a head dim outside `head_dims` or not contiguous, a base
    or stride not a multiple of 16 bytes (messages name the wrapper
    `fn`)."""
    if t.dim() != 4 or t.shape[-1] not in head_dims:
        raise ValueError(f"{fn}: {name} of shape {tuple(t.shape)}: "
                         f"head dim must be one of {head_dims}")
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{fn}: {name} must be bfloat16, got {t.dtype}")
    if t.stride(-1) != 1:
        raise ValueError(f"{fn}: {name} head dim must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{fn}: {name} base must be 16-byte aligned")
    lay = _layout_of(tuple(t.shape), t.stride(), t.element_size(), rows)
    if any(st <= 0 or st % 16 for st in lay.strides):
        raise ValueError(f"{fn}: {name} strides {lay.strides} bytes: "
                         f"TMA needs positive multiples of 16")
    return lay


@functools.lru_cache(maxsize=64)
def _layout_of(shape, stride, esz: int, rows: int) -> TmaLayout:
    """`tma_layout` of a shape and strides (cached: 24 calls a frame)."""
    b, h, s, hd = shape
    axes = [(h, stride[1]), (s, stride[2]), (b, stride[0])]
    span = max([hd] + [n * st for n, st in axes if n > 1])
    axes = [(n, st if n > 1 else span) for n, st in axes]
    order = sorted(range(3), key=lambda i: axes[i][1])
    pos = tuple(order.index(i) + 1 for i in range(3))
    box = [HEAD_DIM, 1, 1, 1]
    box[pos[1]] = rows
    return TmaLayout(dims=(hd,) + tuple(axes[i][0] for i in order),
                     strides=tuple(axes[i][1] * esz for i in order),
                     box=tuple(box), pos=pos)


def _device_check(t: torch.Tensor, fn_name: str) -> bool:
    """True for CUDA (launch the kernel), False for CPU (plain version)."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{fn_name}: unsupported device {t.device}")
    return True


def _kernel_status(status: int, fn: str, maps) -> None:
    """Raise on a C entry point's status: the negative codes of
    `csrc/attention.cu` and `csrc/flash_sm90.cu`, or a CUDA error."""
    if status == -1:
        raise RuntimeError(f"{fn}: the CUDA driver has no "
                           f"cuTensorMapEncodeTiled")
    if -2 - len(maps) < status <= -2:
        raise RuntimeError(f"{fn}: tensor map of {maps[-2 - status]} "
                           f"refused")
    _build.check(status, fn)


def f32_attention_launch(a: F32Attention, fn: str) -> torch.Tensor:
    """One launch of the float32 arm on CUDA tensors: (B, H, Sq, D), a (B,
    Sq, H, D) buffer seen as (B, H, Sq, D).  Raises on what the kernel does
    not take (its message names the wrapper `fn`)."""
    q, k, v = a.q, a.k, a.v
    b, nh, sq, d = q.shape
    s = k.shape[2]
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if t.dtype != torch.float32 or t.device != q.device:
            raise TypeError(f"{fn}: {name} {t.dtype} on {t.device}: the "
                            f"float32 arm takes float32 on {q.device}")
        if (t.dim() != 4 or t.stride(-1) != 1 or t.data_ptr() % 16
                or any(st % 4 for st in t.stride()[:3])):
            raise ValueError(f"{fn}: {name} of shape {tuple(t.shape)}, "
                             f"strides {t.stride()}: the float32 arm reads "
                             f"16-byte aligned rows of a contiguous head dim")
    if (d not in RELPOS_HEAD_DIMS or k.shape != (b, nh, s, d)
            or v.shape != k.shape or max(b, nh) > 65535
            or not 0 < a.valid <= s):
        raise ValueError(f"{fn}: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, {a.valid} valid keys (head dims "
                         f"{RELPOS_HEAD_DIMS}, batch and heads up to 65535)")
    gh, gw = a.grid
    if a.fh is not None:
        if not (0 < max(gh, gw) <= MAX_REL and min(gh, gw) > 0
                and gh * gw == s):
            raise ValueError(f"{fn}: key grid {a.grid} for {s} keys (grids "
                             f"up to {MAX_REL}x{MAX_REL})")
        for t, name, n in ((a.fh, "fh", gh), (a.fw, "fw", gw)):
            _build.require_operand(fn, t, name, (b, nh, sq, n), torch.float32,
                                   q.device)
    out = torch.empty((b, sq, nh, d), dtype=torch.float32,
                      device=q.device).permute(0, 2, 1, 3)
    strides = _int64_array(tuple(x for t in (q, k, v, out)
                                 for x in t.stride()[:3]))
    kernel = _build.function("attention_f32", "attention_f32_forward",
                             _F32_ARGTYPES)
    status = kernel(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    None if a.fh is None else a.fh.data_ptr(),
                    None if a.fw is None else a.fw.data_ptr(),
                    ctypes.cast(strides, ctypes.c_void_p), b, nh, sq, s,
                    a.valid, gh, gw, d, float(a.scale),
                    torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, fn)
    return out


def window_attention(qkv: torch.Tensor, rel_h_tab: torch.Tensor,
                     rel_w_tab: torch.Tensor, num_heads: int, scale: float,
                     window: int) -> torch.Tensor:
    """Windowed attention with the decomposed rel-pos bias (K2).

    qkv: (B, Hp, Wp, 3*dim), the qkv projection of the zero-padded input
    (Hp, Wp multiples of `window`; pad tokens carry the qkv bias and take part
    as keys, as in the reference).  rel_*_tab: (window, window, hd) gathered
    tables.  Returns (B, Hp, Wp, dim).  One launch covers every window and
    head, read in place from `qkv`; fh and fw are formed in the kernel.
    Windows of more than MAX_WINDOW^2 tokens (up to 64x64) go to K3's
    kernel as batches of partitioned windows.  A float32 qkv goes to the
    float32 arm (`window_f32_attention`: every window up to 64x64)."""
    _build.refuse_grad("window_attention", qkv, rel_h_tab, rel_w_tab)
    if not _device_check(qkv, "window_attention"):
        return window_attention_plain(qkv, rel_h_tab, rel_w_tab, num_heads,
                                      scale, window)
    b, hp, wp, c3 = qkv.shape
    dim = c3 // 3
    hd = dim // num_heads
    if (hd not in RELPOS_HEAD_DIMS or c3 != 3 * num_heads * hd
            or hp % window or wp % window or not 0 < window <= MAX_REL):
        raise ValueError(f"window_attention: unsupported shape {qkv.shape}, "
                         f"heads {num_heads}, window {window} (head dims "
                         f"{RELPOS_HEAD_DIMS}, windows up to {MAX_REL})")
    if qkv.dtype == torch.float32:
        o = f32_attention_launch(window_f32_attention(
            qkv, rel_h_tab, rel_w_tab, num_heads, scale, window),
            "window_attention")
        _count(window_attention, hd, f"{hp}x{wp}", qkv.dtype)
        return window_f32_output(o, window, hp, wp)
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"window_attention: qkv must be bfloat16 or "
                        f"float32, got {qkv.dtype}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("window_attention: qkv must be contiguous and "
                         "16-byte aligned")
    if window > MAX_WINDOW:
        n = window * window
        win = window_partition(qkv, window).reshape(-1, n, 3, num_heads, hd)
        q, k, v = win.permute(2, 0, 3, 1, 4)
        o = relpos_global_launch(q, k, v, scale, rel_h_tab, rel_w_tab,
                                 (window, window),
                                 relpos_form(window, window, n))
        _count(window_attention, hd, f"{hp}x{wp}", qkv.dtype)
        return window_unpartition(o.transpose(1, 2).reshape(-1, n, dim),
                                  window, hp, wp)
    tabs = [t.to(device=qkv.device, dtype=torch.bfloat16).contiguous()
            for t in (rel_h_tab, rel_w_tab)]
    for t, name in zip(tabs, ("rel_h_tab", "rel_w_tab")):
        if t.shape != (window, window, hd):
            raise ValueError(f"window_attention: {name} of shape "
                             f"{tuple(t.shape)}")
    out = torch.empty((b, hp, wp, dim), dtype=qkv.dtype, device=qkv.device)
    fn = _build.function("attention", "relpos_window_forward",
                         _WINDOW_ARGTYPES)
    status = fn(qkv.data_ptr(), out.data_ptr(), tabs[0].data_ptr(),
                tabs[1].data_ptr(), b, hp, wp, num_heads, window, hd,
                float(scale),
                torch.cuda.current_stream(qkv.device).cuda_stream)
    _kernel_status(status, "window_attention",
                   ("k", "v", "rel_h_tab", "rel_w_tab"))
    _count(window_attention, hd, f"{hp}x{wp}", qkv.dtype)
    return out


def relpos_form(h: int, w: int, sq: int, row0: int = 0) -> str:
    """K3's form for `sq` queries from grid row `row0` of an h x w grid:
    "grid64" on a grid 64 wide (the bias in registers: a block's 64
    queries are one grid row), "columns" on the whole of a grid 64 tall and
    narrower (the same on the exchanged grid, read column by column),
    "fold" otherwise (grids under 64 both ways, a query band of a grid 64
    tall; the bias folded into the product)."""
    if w == MAX_REL:
        return "grid64"
    if h == MAX_REL and sq == h * w and row0 == 0:
        return "columns"
    return "fold"


_FORM_MODES = {"grid64": 0, "fold": 1, "columns": 2}   # csrc/attention.cu


def flash_mha_decomposed_relpos(q, k, v, sm_scale: float, rel_h, rel_w,
                                hw, row0: int = 0) -> torch.Tensor:
    """Global attention with the decomposed rel-pos bias (K3).

    k, v: (B, H, S, D), D 64 or 80, with S = h*w; q: (B, H, Sq, D), the
    queries of grid rows [row0, row0 + Sq / w) (a query band, as a rank of
    the spatial axis holds them; the whole grid, Sq = S, by default).
    Views with a contiguous head dim and 16-byte aligned strides are read
    in place (`tma_layout`); rel_h/rel_w: (h, h, D)/(w, w, D) gathered
    tables.  Returns (B, H, Sq, D), a (B, Sq, H, D) buffer seen as (B, H,
    Sq, D).  The kernel's form is `relpos_form`'s: the bias in registers on
    a grid 64 wide, on the exchange of a grid 64 tall, else folded.  On
    float32 operands the float32 arm runs (`relpos_f32_attention`: one form
    for every grid up to 64x64 and every band)."""
    _build.refuse_grad("flash_mha_decomposed_relpos", q, k, v, rel_h, rel_w)
    if not _device_check(q, "flash_mha_decomposed_relpos"):
        return relpos_attention_plain(q, k, v, sm_scale, rel_h, rel_w, hw,
                                      row0)
    hq = q.shape[2] // max(hw[1], 1)
    grid = f"{hw[0]}x{hw[1]}"
    shape = grid if hq == hw[0] else f"{hq}x{hw[1]} of {grid}"
    if q.dtype == torch.float32:
        if q.shape[2] != hq * hw[1] or not 0 <= row0 < row0 + hq <= hw[0]:
            raise ValueError(f"flash_mha_decomposed_relpos: q "
                             f"{tuple(q.shape)}, k {tuple(k.shape)}, grid "
                             f"{hw}, query rows from {row0}")
        out = f32_attention_launch(relpos_f32_attention(
            q, k, v, sm_scale, rel_h, rel_w, hw, row0),
            "flash_mha_decomposed_relpos")
        _count(flash_mha_decomposed_relpos, q.shape[-1], shape, q.dtype)
        return out
    form = relpos_form(hw[0], hw[1], q.shape[2], row0)
    out = relpos_global_launch(q, k, v, sm_scale, rel_h, rel_w, hw, form,
                               row0)
    _count(flash_mha_decomposed_relpos, q.shape[-1], shape, q.dtype)
    flash_mha_decomposed_relpos.launches_by_form[form] += 1
    return out


def _f32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The batched product a @ b in float32, not rounded to a's dtype: on
    the card one bmm of the bf16 operands with a float32 output (on the
    tensor cores), on the CPU the operands cast to float32."""
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _kernel_terms(q, rh, rw, sm_scale: float, hw, form: str, row0: int = 0):
    """What K3's entry point takes besides q, k, v in `form`: (fh, fw,
    fw_strides, table).  fold: fh/fw of the band's queries, contiguous.
    grid64: fw by one batched product over the grid's columns, read at
    column c, (batch, head) bh and the band's grid row r at c
    fw_strides[0] + bh fw_strides[1] + r fw_strides[2]; fh is formed in the
    kernel from `table` = rh.  columns: the 64-wide term q.Rh[row(q)] by
    one batched product over the grid's rows (r, bh, c by the same
    strides) and the term formed in the kernel from `table` = rw.  The
    kernel folds the terms into the product divided by the scale: at head
    dim 64 that is an exact x8 in the kernel on the bf16 term.  At 80 (x8.94)
    the term is rounded to bf16 once, after the division: grid64 and
    columns hand the kernel the float32 product (`_f32_product`), which it
    divides and rounds; fold divides here, in f32, and rounds (the entry
    point then divides by 1)."""
    hh, ww = hw
    b, nh, sq, d = q.shape
    hq = sq // ww
    wide = d != HEAD_DIM
    if form == "fold":
        if not wide:
            fh, fw = (t.contiguous() for t in _rel_bias_terms(q, rh, rw, hw,
                                                              row0))
            return fh, fw, (0, 0, 0), rh
        fh, fw = (
            (t / sm_scale).to(q.dtype).contiguous()
            for t in _rel_bias_terms(q.float(), rh.float(), rw.float(), hw,
                                     row0))
        return fh, fw, (0, 0, 0), rh
    product = _f32_product if wide else torch.bmm
    qg = q.reshape(b, nh, hq, ww, d)
    if form == "grid64":
        # one (b nh hq, d) x (d, 64) product for each grid column
        qc = qg.permute(3, 0, 1, 2, 4).reshape(ww, b * nh * hq, d)
        fw = product(qc, rw.transpose(1, 2))
        return None, fw, (b * nh * hq * ww, hq * ww, ww), rh
    # columns: one (b nh w, d) x (d, 64) product for each grid row
    qr = qg.permute(2, 0, 1, 3, 4).reshape(hh, b * nh * ww, d)
    fh = product(qr, rh.transpose(1, 2))
    return None, fh, (b * nh * ww * hh, ww * hh, hh), rw


def relpos_global_launch(q, k, v, sm_scale: float, rel_h, rel_w, hw,
                         form: str, row0: int = 0) -> torch.Tensor:
    """One launch of K3 on CUDA tensors in `form` ("grid64", "columns" or
    "fold", `relpos_form`).  q holds grid rows [row0, row0 + Sq / w)
    (`flash_mha_decomposed_relpos`, which picks the form by the grid;
    `chip_smoke.py` also times the folded form beside the others)."""
    fn_name = "flash_mha_decomposed_relpos"
    hh, ww = hw
    b, nh, sq, d = q.shape
    hq = sq // max(ww, 1)
    if (d not in RELPOS_HEAD_DIMS or not 0 < max(hh, ww) <= MAX_REL
            or min(hh, ww) < 1 or form not in _FORM_MODES
            or (form == "grid64" and ww != MAX_REL)
            or (form == "columns" and relpos_form(hh, ww, sq, row0)
                != "columns")
            or sq != hq * ww or not 0 <= row0 < row0 + hq <= hh):
        raise ValueError(f"{fn_name}: unsupported shape {tuple(q.shape)} "
                         f"grid {hw}, query rows from {row0}, form {form}")
    for t, name in ((k, "k"), (v, "v")):
        if t.shape != (b, nh, hh * ww, d) or t.device != q.device:
            raise ValueError(f"{fn_name}: {name} {tuple(t.shape)} on "
                             f"{t.device}, q {tuple(q.shape)} on {q.device}, "
                             f"grid {hw}")
    if max(b, nh) > 65535:
        raise ValueError(f"{fn_name}: batch {b} or heads {nh} above 65535")
    layouts = (tma_layout(q, "q", TMA_Q_ROWS, fn_name, RELPOS_HEAD_DIMS),
               tma_layout(k, "k", TMA_KV_ROWS, fn_name, RELPOS_HEAD_DIMS),
               tma_layout(v, "v", TMA_KV_ROWS, fn_name, RELPOS_HEAD_DIMS))
    rh = rel_h.to(device=q.device, dtype=q.dtype).contiguous()
    rw = rel_w.to(device=q.device, dtype=q.dtype).contiguous()
    fh, fw, fw_strides, table = _kernel_terms(q, rh, rw, sm_scale, hw, form,
                                              row0)
    out = torch.empty((b, sq, nh, d), dtype=q.dtype, device=q.device)
    out = out.permute(0, 2, 1, 3)
    lay = _int64_array(tuple(x for lt in layouts for x in lt.row()))
    ost = _int64_array(out.stride()[:3])
    fst = _int64_array(fw_strides)
    fn = _build.function("attention", "relpos_global_forward",
                         _GLOBAL_ARGTYPES)
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if fh is None else fh.data_ptr(), fw.data_ptr(),
                ctypes.cast(fst, ctypes.c_void_p), table.data_ptr(),
                ctypes.cast(lay, ctypes.c_void_p),
                ctypes.cast(ost, ctypes.c_void_p), b, nh, hh, ww, hq, row0,
                d, _FORM_MODES[form], float(sm_scale),
                torch.cuda.current_stream(q.device).cuda_stream)
    _kernel_status(status, fn_name, ("q", "k", "v", "rel_h"))
    return out


@functools.lru_cache(maxsize=64)
def _int64_array(values: tuple):
    """`values` as a ctypes int64 array, cached: the C side reads it only
    during the call, and the same layouts come back 24 times a frame."""
    return (ctypes.c_longlong * len(values))(*values)


def flash_mha(q, k, v, sm_scale: float,
              valid_len: Optional[int] = None) -> torch.Tensor:
    """Non-causal attention (K4): (B, H, Sq, D) queries against (B, H, S,
    D) keys and values -> (B, H, Sq, D), keys at or beyond `valid_len`
    masked.  Sq = S but for a rank of the spatial axis, which holds a band
    of the queries and every key.  Views with a contiguous head dim and
    16-byte aligned strides are read in place (`tma_layout`); the output
    is a (B, Sq, H, D) buffer seen as (B, H, Sq, D).  On float32 operands
    the float32 arm runs (`flash_f32_attention`)."""
    _build.refuse_grad("flash_mha", q, k, v)
    if not _device_check(q, "flash_mha"):
        return flash_mha_plain(q, k, v, sm_scale, valid_len)
    b, nh, sq, d = q.shape
    s = k.shape[2]
    if d != HEAD_DIM:
        raise ValueError(f"flash_mha: head dim {d} (only {HEAD_DIM})")
    for t, name in ((k, "k"), (v, "v")):
        if t.shape != (b, nh, s, d) or t.device != q.device:
            raise ValueError(f"flash_mha: {name} {tuple(t.shape)} on "
                             f"{t.device}, q {tuple(q.shape)} on {q.device}")
    shape = f"{s} tokens" if sq == s else f"{sq} of {s} tokens"
    if q.dtype == torch.float32:
        out = f32_attention_launch(flash_f32_attention(q, k, v, sm_scale,
                                                       valid_len),
                                   "flash_mha")
        _count_k4(shape, q.dtype)
        return out
    layouts = (tma_layout(q, "q", TMA_Q_ROWS), tma_layout(k, "k"),
               tma_layout(v, "v"))
    vlen = s if valid_len is None else int(valid_len)
    if not 0 < vlen <= s:
        raise ValueError(f"flash_mha: valid_len {vlen} outside (0, {s}]")
    if max(b, nh) > 65535:
        raise ValueError(f"flash_mha: batch {b} or heads {nh} above 65535")
    out = torch.empty((b, sq, nh, d), dtype=q.dtype, device=q.device)
    out = out.permute(0, 2, 1, 3)
    lay = _int64_array(tuple(x for lt in layouts for x in lt.row()))
    ost = _int64_array(out.stride()[:3])
    fn = _build.function("flash_sm90", "flash_sm90_forward", _SM90_ARGTYPES)
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                ctypes.cast(lay, ctypes.c_void_p),
                ctypes.cast(ost, ctypes.c_void_p), b, nh, sq, vlen,
                float(sm_scale),
                torch.cuda.current_stream(q.device).cuda_stream)
    _kernel_status(status, "flash_mha", ("q", "k", "v"))
    _count_k4(shape, q.dtype)
    return out


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _count(wrapper, head_dim: int, grid: str, dtype: torch.dtype) -> None:
    """One launch of K2 or K3 (either arm): its count, by head dim, by
    token grid (K2: the padded grid of its windows) and by dtype."""
    wrapper.launches += 1
    wrapper.launches_by_head_dim[head_dim] += 1
    wrapper.launches_by_shape[grid] += 1
    wrapper.launches_by_dtype[_dtype_name(dtype)] += 1


def _count_k4(shape: str, dtype: torch.dtype) -> None:
    flash_mha.launches += 1
    flash_mha.launches_by_shape[shape] += 1
    flash_mha.launches_by_dtype[_dtype_name(dtype)] += 1


window_attention.launches = 0
flash_mha_decomposed_relpos.launches = 0
flash_mha.launches = 0
# K2's and K3's launches by head dim (SAM ViT-H's 80 among them), and K2's,
# K3's and K4's by shape (the rect encode's grids among them), counted with
# `launches`.
window_attention.launches_by_head_dim = collections.Counter()
flash_mha_decomposed_relpos.launches_by_head_dim = collections.Counter()
# K3's launches by form (`relpos_form`), counted with `launches`.
flash_mha_decomposed_relpos.launches_by_form = collections.Counter()
# Every wrapper's launches by shape and by dtype ("bfloat16" for the
# kernels above, "float32" for their float32 arms), counted with `launches`.
for _wrapper in (window_attention, flash_mha_decomposed_relpos, flash_mha):
    _wrapper.launches_by_shape = collections.Counter()
    _wrapper.launches_by_dtype = collections.Counter()
