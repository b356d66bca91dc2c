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
from the tables; K3 on SAM's 64-wide grid computes fh inside and takes fw from
one batched product here (a block's queries share their grid row, not their
column), and on other grids takes both from here (two einsums, as the JAX code
computes them).  The kernels read q/k/v straight out of the qkv projection
through TMA tensor maps, so no head transpose or window partition is
materialized: K3 and K4 through one map per (B, H, S, 64) operand, whose
host-side layout `tma_layout` builds and checks; K2 through 5-d maps of the
projection built in the kernel's entry point.

On a CPU tensor each wrapper computes its plain version; on a CUDA tensor it
launches the kernel (bf16 operands, f32 softmax and accumulation) or raises.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from crowdsam_tpu_torch.kernels import _build

_GLOBAL_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_void_p,
)
_WINDOW_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_void_p,
)
_SM90_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
)
HEAD_DIM = 64
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
                    hw: Tuple[int, int]):
    """fh[.., n, j] = q[n] . Rh[row(n), j];  fw[.., n, j] = q[n] . Rw[col(n), j].

    q: (..., h*w, D); rel_h (h, h, D), rel_w (w, w, D)."""
    h, w = hw
    qr = q.reshape(*q.shape[:-2], h, w, q.shape[-1])
    fh = torch.einsum("...rwc,rjc->...rwj", qr, rel_h.to(q.dtype))
    fw = torch.einsum("...rwc,wjc->...rwj", qr, rel_w.to(q.dtype))
    return (fh.reshape(*q.shape[:-1], h), fw.reshape(*q.shape[:-1], w))


def relpos_attention_plain(q, k, v, sm_scale: float, rel_h, rel_w,
                           hw) -> torch.Tensor:
    """(..., S, D) attention with the decomposed rel-pos bias, S = h*w:
    softmax(scale q.k + q.Rh[row(q), row(k)] + q.Rw[col(q), col(k)]) v."""
    h, w = hw
    qf, kf = q.float(), k.float()
    fh, fw = _rel_bias_terms(qf, rel_h.float(), rel_w.float(), hw)
    logits = (qf * sm_scale) @ kf.transpose(-1, -2)
    lead = logits.shape[:-2]
    logits = (logits.reshape(*lead, h, w, h, w)
              + fh.reshape(*lead, h, w, h, 1)
              + fw.reshape(*lead, h, w, 1, w))
    out = _softmax_av(logits.reshape(*lead, h * w, h * w), v)
    return out.to(q.dtype)


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
    """Plain version of `flash_mha`: (B, H, S, D) softmax((q.k) scale) v with
    keys at or beyond valid_len masked."""
    s = q.shape[-2]
    vlen = s if valid_len is None else valid_len
    logits = (q.float() @ k.float().transpose(-1, -2)) * sm_scale
    if vlen < s:
        logits[..., vlen:] = float("-inf")
    return _softmax_av(logits, v).to(q.dtype)


# ---------------------------------------------------------------------------
# CUDA launch
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TmaLayout:
    """Host-side layout of the TMA tensor map of one K4 operand: `dims` in
    elements, innermost (the head dim) first; `strides` in bytes, of dims
    1-3; `box` the tile one load brings (64 dims x `rows` tokens);
    `pos` the map dim (1-3) of the head, the token and the batch axis."""

    dims: Tuple[int, int, int, int]
    strides: Tuple[int, int, int]
    box: Tuple[int, int, int, int]
    pos: Tuple[int, int, int]

    def row(self) -> list:
        """The 14 int64 that `flash_sm90_forward` reads per operand."""
        return [*self.dims, *self.strides, *self.box, *self.pos]


def tma_layout(t: torch.Tensor, name: str = "operand",
               rows: int = TMA_KV_ROWS, fn: str = "flash_mha") -> TmaLayout:
    """The tensor map of a (B, H, S, 64) bf16 view, read in place, whose
    box brings `rows` tokens: the head, token and batch axes become map
    dims 1-3 in order of stride (the CUDA driver's maps grow outwards), an
    axis of extent 1 taking the stride past the others.  Raises on what TMA
    does not take: a head dim other than 64 or not contiguous, a base or
    stride not a multiple of 16 bytes (messages name the wrapper `fn`)."""
    if t.dim() != 4 or t.shape[-1] != HEAD_DIM:
        raise ValueError(f"{fn}: {name} of shape {tuple(t.shape)}: "
                         f"head dim must be {HEAD_DIM}")
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
    b, h, s, _ = shape
    axes = [(h, stride[1]), (s, stride[2]), (b, stride[0])]
    span = max([HEAD_DIM] + [n * st for n, st in axes if n > 1])
    axes = [(n, st if n > 1 else span) for n, st in axes]
    order = sorted(range(3), key=lambda i: axes[i][1])
    pos = tuple(order.index(i) + 1 for i in range(3))
    box = [HEAD_DIM, 1, 1, 1]
    box[pos[1]] = rows
    return TmaLayout(dims=(HEAD_DIM,) + tuple(axes[i][0] for i in order),
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
    kernel as batches of partitioned windows."""
    _build.refuse_grad("window_attention", qkv, rel_h_tab, rel_w_tab)
    if not _device_check(qkv, "window_attention"):
        return window_attention_plain(qkv, rel_h_tab, rel_w_tab, num_heads,
                                      scale, window)
    b, hp, wp, c3 = qkv.shape
    dim = c3 // 3
    hd = dim // num_heads
    if (hd != HEAD_DIM or c3 != 3 * num_heads * HEAD_DIM or hp % window
            or wp % window or not 0 < window <= MAX_REL):
        raise ValueError(f"window_attention: unsupported shape {qkv.shape}, "
                         f"heads {num_heads}, window {window} (head dim "
                         f"{HEAD_DIM}, windows up to {MAX_REL})")
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"window_attention: qkv must be bfloat16, got "
                        f"{qkv.dtype}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("window_attention: qkv must be contiguous and "
                         "16-byte aligned")
    if window > MAX_WINDOW:
        n = window * window
        win = window_partition(qkv, window).reshape(-1, n, 3, num_heads, hd)
        q, k, v = win.permute(2, 0, 3, 1, 4)
        o = relpos_global_launch(q, k, v, scale, rel_h_tab, rel_w_tab,
                                 (window, window), fold=window != MAX_REL)
        window_attention.launches += 1
        return window_unpartition(o.transpose(1, 2).reshape(-1, n, dim),
                                  window, hp, wp)
    tabs = [t.to(device=qkv.device, dtype=torch.bfloat16).contiguous()
            for t in (rel_h_tab, rel_w_tab)]
    for t, name in zip(tabs, ("rel_h_tab", "rel_w_tab")):
        if t.shape != (window, window, HEAD_DIM):
            raise ValueError(f"window_attention: {name} of shape "
                             f"{tuple(t.shape)}")
    out = torch.empty((b, hp, wp, dim), dtype=qkv.dtype, device=qkv.device)
    fn = _build.function("attention", "relpos_window_forward",
                         _WINDOW_ARGTYPES)
    status = fn(qkv.data_ptr(), out.data_ptr(), tabs[0].data_ptr(),
                tabs[1].data_ptr(), b, hp, wp, num_heads, window,
                float(scale),
                torch.cuda.current_stream(qkv.device).cuda_stream)
    _kernel_status(status, "window_attention",
                   ("k", "v", "rel_h_tab", "rel_w_tab"))
    window_attention.launches += 1
    return out


def flash_mha_decomposed_relpos(q, k, v, sm_scale: float, rel_h, rel_w,
                                hw) -> torch.Tensor:
    """Global attention with the decomposed rel-pos bias (K3).

    q, k, v: (B, H, S, D) with S = h*w (views with a contiguous head dim and
    16-byte aligned strides are read in place, `tma_layout`); rel_h/rel_w:
    (h, h, D)/(w, w, D) gathered tables.  Returns (B, H, S, D), a (B, S, H,
    D) buffer seen as (B, H, S, D).  A grid 64 wide (SAM's) takes the
    kernel's bias-in-registers form, any other the folded form."""
    _build.refuse_grad("flash_mha_decomposed_relpos", q, k, v, rel_h, rel_w)
    if not _device_check(q, "flash_mha_decomposed_relpos"):
        return relpos_attention_plain(q, k, v, sm_scale, rel_h, rel_w, hw)
    out = relpos_global_launch(q, k, v, sm_scale, rel_h, rel_w, hw,
                               fold=hw[1] != MAX_REL)
    flash_mha_decomposed_relpos.launches += 1
    return out


def relpos_global_launch(q, k, v, sm_scale: float, rel_h, rel_w, hw,
                         fold: bool) -> torch.Tensor:
    """One launch of K3 on CUDA tensors: `fold` picks the folded form
    (QA KA^T in the product), else the bias in registers (grids 64 wide).
    `flash_mha_decomposed_relpos` picks by the grid; `chip_smoke.py` times
    both forms on SAM's grid."""
    fn_name = "flash_mha_decomposed_relpos"
    hh, ww = hw
    b, nh, s, d = q.shape
    if (d != HEAD_DIM or s != hh * ww or not 0 < max(hh, ww) <= MAX_REL
            or min(hh, ww) < 1 or not (fold or ww == MAX_REL)):
        raise ValueError(f"{fn_name}: unsupported shape {tuple(q.shape)} "
                         f"grid {hw}")
    for t, name in ((k, "k"), (v, "v")):
        if t.shape != q.shape or t.device != q.device:
            raise ValueError(f"{fn_name}: {name} {tuple(t.shape)} on "
                             f"{t.device}, q {tuple(q.shape)} on {q.device}")
    if max(b, nh) > 65535:
        raise ValueError(f"{fn_name}: batch {b} or heads {nh} above 65535")
    layouts = (tma_layout(q, "q", TMA_Q_ROWS, fn_name),
               tma_layout(k, "k", TMA_KV_ROWS, fn_name),
               tma_layout(v, "v", TMA_KV_ROWS, fn_name))
    rh = rel_h.to(device=q.device, dtype=q.dtype).contiguous()
    rw = rel_w.to(device=q.device, dtype=q.dtype).contiguous()
    if fold:
        fh, fw = (t.contiguous() for t in _rel_bias_terms(q, rh, rw, hw))
        fw_strides = (0, 0, 0)
    else:
        # fh is formed in the kernel (a block is one grid row); fw by one
        # batched product over the grid's columns, read in its own layout
        # (column c, then batch and head, then grid row).
        fh = None
        qc = q.reshape(b, nh, hh, ww, d).permute(3, 0, 1, 2, 4)
        fw = torch.bmm(qc.reshape(ww, b * nh * hh, d), rw.transpose(1, 2))
        fw_strides = (b * nh * hh * ww, hh * ww, ww)
    out = torch.empty((b, s, nh, d), dtype=q.dtype, device=q.device)
    out = out.permute(0, 2, 1, 3)
    lay = _int64_array(tuple(x for lt in layouts for x in lt.row()))
    ost = _int64_array(out.stride()[:3])
    fst = _int64_array(fw_strides)
    fn = _build.function("attention", "relpos_global_forward",
                         _GLOBAL_ARGTYPES)
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if fh is None else fh.data_ptr(), fw.data_ptr(),
                ctypes.cast(fst, ctypes.c_void_p), rh.data_ptr(),
                ctypes.cast(lay, ctypes.c_void_p),
                ctypes.cast(ost, ctypes.c_void_p), b, nh, hh, ww, int(fold),
                float(sm_scale),
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
    """Non-causal attention (K4): (B, H, S, D) -> (B, H, S, D), keys at or
    beyond `valid_len` masked.  Views with a contiguous head dim and 16-byte
    aligned strides are read in place (`tma_layout`); the output is a (B, S,
    H, D) buffer seen as (B, H, S, D)."""
    _build.refuse_grad("flash_mha", q, k, v)
    if not _device_check(q, "flash_mha"):
        return flash_mha_plain(q, k, v, sm_scale, valid_len)
    b, nh, s, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"flash_mha: head dim {d} (only {HEAD_DIM})")
    for t, name in ((k, "k"), (v, "v")):
        if t.shape != q.shape or t.device != q.device:
            raise ValueError(f"flash_mha: {name} {tuple(t.shape)} on "
                             f"{t.device}, q {tuple(q.shape)} on {q.device}")
    layouts = (tma_layout(q, "q", TMA_Q_ROWS), tma_layout(k, "k"),
               tma_layout(v, "v"))
    vlen = s if valid_len is None else int(valid_len)
    if not 0 < vlen <= s:
        raise ValueError(f"flash_mha: valid_len {vlen} outside (0, {s}]")
    if max(b, nh) > 65535:
        raise ValueError(f"flash_mha: batch {b} or heads {nh} above 65535")
    out = torch.empty((b, s, nh, d), dtype=q.dtype, device=q.device)
    out = out.permute(0, 2, 1, 3)
    lay = _int64_array(tuple(x for lt in layouts for x in lt.row()))
    ost = _int64_array(out.stride()[:3])
    fn = _build.function("flash_sm90", "flash_sm90_forward", _SM90_ARGTYPES)
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                ctypes.cast(lay, ctypes.c_void_p),
                ctypes.cast(ost, ctypes.c_void_p), b, nh, s, vlen,
                float(sm_scale),
                torch.cuda.current_stream(q.device).cuda_stream)
    _kernel_status(status, "flash_mha", ("q", "k", "v"))
    flash_mha.launches += 1
    return out


window_attention.launches = 0
flash_mha_decomposed_relpos.launches = 0
flash_mha.launches = 0
