"""Smoke run of the PyTorch/CUDA port (`crowdsam_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from `crowdsam_tpu_torch/csrc/` (nvcc, sm_90a, into
the gitignored `build/kernels/`), then:

1. holds every kernel against its plain PyTorch version at the main path's
   shapes in bf16, with a tolerance of its own, and shows that the same
   tolerance rejects the plain version with a known fault (a dropped key
   tile, a key tile's V read from the next tile, a tile's K dims permuted
   inside 16-byte chunks, swapped rel-pos tables, fw one column off, a
   tile half given the wrong grid row, shifted one-hot columns, a skipped
   image update, swapped sub-pixel levels, a tile's keys from the other
   ring stage, a tile max from the other warpgroup's tile, a missing
   column link, a band-boundary change dropped, bands merged out of
   order, ...);
   times kernel, plain version and the nearest single PyTorch library
   call, or for the decode kernels the PyTorch path they replace, and every
   kernel's own device time from torch.profiler beside the event time that
   includes its wrapper (K2/K3: also the union of the device time of all
   the wrapper launches, `wrapper_device_ms`, and SDPA's on a prebuilt
   bias; K5: the span of its ten overlapping launches, and each launch
   kind's duration; one JSON line per phase).  The decode kernels
   (two-way transformer, mask head) get their inputs from the full-width
   model on a seeded frame (K5 also on normal-draw tokens, held against
   float32 too), the survivor kernel person-shaped masks from the crowd
   scenes' boxes at k = 1, 32 and 320, and its change rows must give the
   COCO RLE strings of the plain masks.  The mask head's polynomial GELU,
   compiled alone, is held to the exact-erf GELU over a sweep of x, and the
   kernel's mean error against float32 to that of the plain version; the
   SASS of one GELU, the shipped one and erff, gives their CUDA-core issue
   floor;
2. runs `CrowdSAM.generate` at full width -- SAM ViT-L + DINOv2 ViT-L/14 +
   PWD-Net, bf16, seeded random weights, the defaults of
   `configs/crowdhuman.yaml` (fused decode, `test.output_rles true`) -- on
   seeded synthetic frames, with every kernel's launch count set to 0 just
   before and read just after; every kernel must have launched, but the
   survivor kernel, which random weights give no detection to reach there.
   The same model then gives the encode's share of the time, the device's
   idle share of one frame (busy and wall time from the same profiled
   window), a loaded pass on seeded crowd scenes with the pred-IoU and
   stability filters off, so that the survivor pass (cleanup, re-NMS, K7,
   RLE strings, full-res boxes) runs at full width on real detections, with
   the counts set to 0 again and every kernel required, the fused decode
   against the unfused one (same weights, frame and noise), the box-only
   `test.output_rles false` against the default on one loaded frame (K7
   must not launch there), and `generate_many` against `generate` on the
   same frames and noise; last, the model built with the shipped msgpack
   adapter (`adapter_weights/10_shot.msgpack`, read by the port's own
   reader) runs one `generate`;
   K1's backward kernel is held against autograd of the plain LayerNorm
   at the training step's shapes (dx, dw, db with max and mean bounds;
   faults: the mean(g w xhat) term dropped, one block's dw/db partial left
   out, the neighbouring row's rstd), twice bit for bit, beside
   `aten::native_layer_norm_backward`.  The full-width weights are the
   JAX package's numpy draws, timed and held to the manifest's checksums
   (`numpy init`).  The trainer runs at full width on the in-memory
   synthetic 10-shot set: 20 head-only steps, 20 full-decoder steps (K1
   forward and backward on every decoder LayerNorm), ms per step, peak
   memory, frozen leaves unchanged and every trainable leaf moved, and one
   step's gradients through K1 against those through the plain LayerNorm.
   Last, the shipped adapter on those encoders at the reference thresholds
   on the JAX bench's golden frames: detections, their share of the JAX
   bench's golden boxes, ms per image, the survivor pass and K7;
3. checks the outputs: finite boxes and scores of the expected shapes inside
   the image, every RLE string's mask inside its detection's box, and, on a
   small configuration with head dim 64, the card's bf16 kernel path
   against the plain float32 path on the CPU, detections included.

Prints the kernel table as one JSON line, the card's name and power limit,
and last `{"ok": true, "device": {...}}`.  Exits non-zero, printing no
result, when CUDA is absent or any phase fails.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import json
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12      # dense bf16 tensor cores
F32_FLOP_PER_S = 67e12        # float32 outside the tensor cores
N_IMAGES = 3
# One bf16 ulp of an output y is at most 2^-7 |y|: two roundings of nearly
# equal f32 values may land one ulp apart.
BF16_ULP = 2.0 ** -7


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _kernel_name(name: str) -> str:
    """A profiler kernel name without `void`, the anonymous namespace and
    the argument list: `row_phase<1>`, `flash_attn_sm90`."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name)
    return re.sub(r"\(.*$", "", name)


def _cuda_events(fn, iters: int, match=None, tries: int = 6):
    """The device events of `iters` calls of `fn` under torch.profiler (CUDA
    activity only, after one warm-up) whose kernel name contains `match`
    (all when None).  The profiler now and then keeps no record of a whole
    window, at times of several in a row: the window is profiled again, a
    moment later, up to `tries` times, before the measurement fails."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        if attempt:
            time.sleep(0.5)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [ev for ev in prof.events() if ev.device_type.name == "CUDA"
                  and (match is None or match in ev.name)]
        if events:
            return events
    raise AssertionError(f"no device activity {match!r} in {tries} "
                         f"profiles")


def device_split(fn, iters: int, match=None) -> dict:
    """Device ms per call of `fn` by kernel, from torch.profiler over
    `iters` calls (`_cuda_events`): for each kernel whose name contains
    `match` (every kernel when None), its median duration times its
    launches per call.  The profiler can drop records, and a sum over the
    records it kept would then read low."""
    by_name = {}
    for ev in _cuda_events(fn, iters, match):
        by_name.setdefault(ev.name, []).append(ev.device_time_total)
    out = {}
    for name, t in by_name.items():
        short = _kernel_name(name)
        out[short] = out.get(short, 0.0) + float(np.median(t)) * max(
            1, round(len(t) / iters)) / 1e3
    return out


def device_ms(fn, iters: int, match=None) -> float:
    """Device ms per call of `fn`: the sum of `device_split`."""
    return sum(device_split(fn, iters, match).values())


def device_span_ms(fn, iters: int) -> float:
    """Device ms per call of `fn`: the union of its kernels' intervals over
    `iters` calls (`_cuda_events`).  For a call whose kernels overlap
    (programmatic dependent launch: a kernel starts before the one before
    it ends and waits inside) the sum of kernel durations counts the
    overlap twice; the union does not."""
    spans = [(ev.time_range.start, ev.time_range.start + ev.device_time_total)
             for ev in _cuda_events(fn, iters)]
    return _union_us(spans) / iters / 1e3


def _union_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, -np.inf
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def bound(nbytes: float, flops: float, flop_rate: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name, got, want, atol, faults=(), require_faults=True,
            mean_atol=None, min_fault=1.0, rtol=BF16_ULP):
    """|got - want| <= atol + rtol |want| everywhere (rtol one bf16 ulp
    unless given; and, with
    `mean_atol`, a mean |got - want| of at most that), and every plain
    version with a known fault (label, tensor) breaks the bound, by more
    than `min_fault` times (a phase with several outputs passes
    require_faults=False and asks that of the outputs together,
    `require_faults_seen`).
    Returns the figures of the comparison; raises when either fails."""
    got, want = got.float(), want.float()
    tol = atol + rtol * want.abs()

    def over_tol(x):
        err = (x.float() - want).abs()
        ratio = float((err / tol).max())
        if mean_atol is not None:
            ratio = max(ratio, float(err.mean()) / mean_atol)
        return ratio

    err = (got - want).abs()
    out = {
        "max_abs_err": float(err.max()),
        "mean_abs_err": float(err.mean()),
        "out_rms": float(want.square().mean().sqrt()),
        "out_max_abs": float(want.abs().max()),
        "tol": f"{atol:g}+{rtol:g}*|y|" + (
            f", mean {mean_atol:g}" if mean_atol is not None else ""),
        "err_over_tol": over_tol(got),
        "fault_err_over_tol": {label: over_tol(f) for label, f in faults},
    }
    bad = [k for k, r in out["fault_err_over_tol"].items()
           if r <= min_fault]
    if not bool(torch.isfinite(got).all()) or out["err_over_tol"] > 1.0:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version: {out}")
    if bad and require_faults:
        raise AssertionError(f"{name}: the tolerance does not see the "
                             f"faults {bad}: {out}")
    return out


def require_faults_seen(name, outputs):
    """Every fault breaks the bound of at least one of the outputs."""
    labels = {k for o in outputs.values() for k in o["fault_err_over_tol"]}
    unseen = [k for k in sorted(labels) if max(
        o["fault_err_over_tol"].get(k, 0.0) for o in outputs.values()) <= 1.0]
    if unseen:
        raise AssertionError(f"{name}: the tolerance does not see the "
                             f"faults {unseen}: {outputs}")


@contextlib.contextmanager
def patched(module, name, fn):
    """`module.name` replaced by `fn` inside the block (fault injection into
    a plain version)."""
    real = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield real
    finally:
        setattr(module, name, real)


def _attention_plain(q, k, v, scale, bias=None, drop=None):
    """softmax(scale q.k + bias) v in f32, keys in `drop` masked: the plain
    attention with a known fault (phase checks only)."""
    logits = (q.float() @ k.float().transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias
    if drop is not None:
        logits[..., drop] = float("-inf")
    return torch.softmax(logits, dim=-1) @ v.float()


def _relpos_bias(q, rh, rw, hw, terms=None):
    """The rel-pos bias (..., S, S) built from q and the gathered tables, in
    q's dtype: the faults' bias (from float32 q) and the work a library
    call needs beside SDPA (from bf16 q).  `terms(fh, fw)`, when given,
    changes fh and fw first (a fault)."""
    from crowdsam_tpu_torch.models.attention import _rel_bias_terms

    h, w = hw
    fh, fw = _rel_bias_terms(q, rh, rw, hw)
    if terms is not None:
        fh, fw = terms(fh, fw)
    lead = q.shape[:-2]
    return (fh.reshape(*lead, h, w, h, 1)
            + fw.reshape(*lead, h, w, 1, w)).reshape(*lead, h * w, h * w)


def _shift_last(x, by):
    """x shifted by `by` along its last dim, zeros coming in."""
    out = torch.zeros_like(x)
    if by > 0:
        out[..., :-by] = x[..., by:]
    else:
        out[..., -by:] = x[..., :by]
    return out


def _relpos_extra(wrapper, sdpa, iters):
    """The K2/K3 device figures beside the kernel's own: the union of the
    device time of every kernel the wrapper launches (`wrapper_device_ms`:
    the rel-pos terms, conversions and the kernel) and SDPA's device time
    on a prebuilt bias (`library_device_ms`)."""
    return dict(wrapper_device_ms=device_span_ms(wrapper, iters),
                library_device_ms=device_ms(sdpa, iters))


# --------------------------------------------------------------------------
# kernel phases
# --------------------------------------------------------------------------

def phase_layernorm(gen):
    from crowdsam_tpu_torch.ops.layernorm import layer_norm, layer_norm_plain

    rows = []
    # SAM blocks, DINOv2 blocks, the neck, the decoder's norm4 on keys, the
    # decoder's upscaling ChannelLayerNorm.
    for n, d, eps in ((4096, 1024, 1e-6), (5330, 1024, 1e-6),
                      (4096, 256, 1e-6), (131072, 256, 1e-5),
                      (524288, 64, 1e-6)):
        x = torch.randn((n, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        w = 1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
        b = 0.1 * torch.randn(d, generator=gen, device="cuda")
        want = layer_norm_plain(x, w, b, eps)
        got = layer_norm(x, w, b, eps)
        # Outputs of rms ~1: both sides round f32 values that differ in the
        # last bits to bf16, one ulp apart at most.
        cmp = compare(f"layer_norm {n}x{d}", got, want, 1e-2)
        wb, bb = w.to(torch.bfloat16), b.to(torch.bfloat16)
        t_k = time_ms(lambda: layer_norm(x, w, b, eps), 50)
        t_p = time_ms(lambda: layer_norm_plain(x, w, b, eps), 10)
        t_l = time_ms(lambda: torch.nn.functional.layer_norm(
            x, (d,), wb, bb, eps), 50)
        d_k = device_ms(lambda: layer_norm(x, w, b, eps), 50, "ln_rows")
        d_l = device_ms(lambda: torch.nn.functional.layer_norm(
            x, (d,), wb, bb, eps), 50)
        b_ms, by = bound(2 * n * d * 2 + 2 * d * 4, 8.0 * n * d,
                         F32_FLOP_PER_S)
        rows.append(dict(shape=f"{n}x{d}", **cmp, ms=t_k, device_ms=d_k,
                         plain_ms=t_p, library_ms=t_l,
                         library_device_ms=d_l, bound_ms=b_ms,
                         bound_by=by))
        print(json.dumps({"phase": "K1 layer_norm", **rows[-1]}), flush=True)
    return rows


def phase_window(gen):
    from crowdsam_tpu_torch.models.attention import (
        window_attention,
        window_attention_plain,
        window_partition,
        window_unpartition,
    )
    from crowdsam_tpu_torch.models.image_encoder import _rel_pos_table

    ws, heads, hd, grid = 14, 16, 64, 70
    dim, n = heads * hd, ws * ws
    qkv = torch.randn((1, grid, grid, 3 * dim), generator=gen,
                      device="cuda").to(torch.bfloat16)
    rel_h = 0.1 * torch.randn((2 * ws - 1, hd), generator=gen, device="cuda")
    rel_w = 0.1 * torch.randn((2 * ws - 1, hd), generator=gen, device="cuda")
    rh, rw = _rel_pos_table(rel_h, ws), _rel_pos_table(rel_w, ws)
    scale = hd ** -0.5
    want = window_attention_plain(qkv, rh, rw, heads, scale, ws)
    got = window_attention(qkv, rh, rw, heads, scale, ws)

    win = window_partition(qkv, ws).reshape(-1, n, 3, heads, hd)
    q, k, v = win.permute(2, 0, 3, 1, 4)
    qf = q.float()

    def as_grid(o):                     # (nw, heads, n, hd) -> (1, Hp, Wp, C)
        return window_unpartition(o.permute(0, 2, 1, 3).reshape(-1, n, dim),
                                  ws, grid, grid)

    def faulty(terms=None, drop=None, tables=(rh, rw)):
        bias = _relpos_bias(qf, *tables, (ws, ws), terms)
        return as_grid(_attention_plain(q, k, v, scale, bias, drop))

    rh_next = torch.zeros_like(rh)
    rh_next[:-1] = rh[1:]
    rms = float(want.float().square().mean().sqrt())
    # Outputs of rms ~0.18, up to ~3: atol ~8% of the rms, the mean error
    # 1.5% of it.  The kernel's error (bf16 probabilities into PV, bf16
    # fh/fw) stays well inside both; every fault of the kernel's design
    # must break the bound 8-fold.
    cmp = compare("window_attention", got, want, 1.5e-2, faults=(
        ("last key tile (keys 128-195) dropped",
         faulty(drop=slice(128, n))),
        ("rel-pos tables swapped", faulty(tables=(rw, rh))),
        ("one-hot key columns shifted by one (col(k) + 1)",
         faulty(terms=lambda fh, fw: (fh, _shift_last(fw, 1)))),
        ("fh selected from the next window row's table tile",
         faulty(tables=(rh_next, rw))),
    ), mean_atol=0.015 * rms, min_fault=8.0)
    t_k = time_ms(lambda: window_attention(qkv, rh, rw, heads, scale, ws), 20)
    d_k = device_ms(lambda: window_attention(qkv, rh, rw, heads, scale, ws),
                    20, "window_attn_relpos")
    t_p = time_ms(lambda: window_attention_plain(qkv, rh, rw, heads, scale,
                                                 ws), 5)
    # Library yardstick: SDPA over the same windows with the rel-pos bias
    # materialized beforehand (not the same work: the kernel's time covers
    # the fh/fw terms and reads the windows in place) ...
    bias16 = _relpos_bias(qf, rh, rw, (ws, ws)).to(torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    t_l = time_ms(lambda: sdpa(q, k, v, attn_mask=bias16, scale=scale), 20)
    extra = _relpos_extra(
        lambda: window_attention(qkv, rh, rw, heads, scale, ws),
        lambda: sdpa(q, k, v, attn_mask=bias16, scale=scale), 20)

    # ... and the whole function in several PyTorch calls: window
    # partition, bias from q and the tables, SDPA, unpartition.
    def whole():
        w_ = window_partition(qkv, ws).reshape(-1, n, 3, heads, hd)
        q_, k_, v_ = w_.permute(2, 0, 3, 1, 4)
        return as_grid(sdpa(q_, k_, v_, scale=scale, attn_mask=_relpos_bias(
            q_, rh, rw, (ws, ws))))
    whole_err = float((whole().float() - want.float()).abs().max())
    t_w = time_ms(whole, 20)
    nw = (grid // ws) ** 2
    flops = nw * heads * (4 * n * n * hd + 2 * 2 * n * ws * hd)
    nbytes = qkv.numel() * 2 + grid * grid * dim * 2 + 2 * rh.numel() * 4
    b_ms, by = bound(nbytes, flops, BF16_FLOP_PER_S)
    row = dict(shape=f"{nw}x{heads}x{n}x{hd}", **cmp, ms=t_k, device_ms=d_k,
               **extra, plain_ms=t_p, library_ms=t_l,
               library_covers="SDPA on the partitioned windows with the bias "
                              "built beforehand",
               whole_fn_ms=t_w,
               whole_fn_covers="partition + bias from q and tables + SDPA + "
                               "unpartition (several PyTorch calls)",
               whole_fn_max_abs_err=whole_err, bound_ms=b_ms, bound_by=by)
    print(json.dumps({"phase": "K2 window_attention", **row}), flush=True)
    return row


def phase_global(gen):
    from crowdsam_tpu_torch.models.attention import (
        flash_mha_decomposed_relpos,
        relpos_attention_plain,
        relpos_global_launch,
    )
    from crowdsam_tpu_torch.models.image_encoder import _rel_pos_table

    g, heads, hd = 64, 16, 64
    s, dim = g * g, heads * hd
    qkv = torch.randn((1, s, 3 * dim), generator=gen, device="cuda").to(
        torch.bfloat16)
    q, k, v = qkv.reshape(1, s, 3, heads, hd).permute(2, 0, 3, 1, 4)
    rh = _rel_pos_table(0.1 * torch.randn((2 * g - 1, hd), generator=gen,
                                          device="cuda"), g)
    rw = _rel_pos_table(0.1 * torch.randn((2 * g - 1, hd), generator=gen,
                                          device="cuda"), g)
    scale = hd ** -0.5
    want = relpos_attention_plain(q, k, v, scale, rh, rw, (g, g))
    got = flash_mha_decomposed_relpos(q, k, v, scale, rh, rw, (g, g))
    qf = q.float()

    def faulty(terms=None, drop=None):
        bias = _relpos_bias(qf, rh, rw, (g, g), terms)
        out = _attention_plain(q, k, v, scale, bias, drop)
        del bias
        return out

    def second_half_as_first(fh, fw):
        fh = fh.clone()
        fh[..., 1::2] = fh[..., 0::2]
        return fh, fw

    rms = float(want.float().square().mean().sqrt())
    # Outputs of rms ~0.05, up to ~1 where the bias makes a row peaky: the
    # ulp term covers the large ones, atol (~12% of the rms) the rest; the
    # mean error is held to 1.5% of the rms.  Every fault of the kernel's
    # design must break the bound 8-fold.
    faults = (
        ("last key tile (keys 3968-4095) dropped",
         faulty(drop=slice(s - 128, s))),
        ("rel-pos tables swapped",
         relpos_attention_plain(q, k, v, scale, rw, rh, (g, g))),
        ("fw taken from the neighbouring column (col(k) + 1)",
         faulty(terms=lambda fh, fw: (fh, _shift_last(fw, 1)))),
        ("a 128-key tile's second half given its first half's grid row",
         faulty(terms=second_half_as_first)),
    )
    cmp = compare("flash_mha_decomposed_relpos", got, want, 6e-3,
                  faults=faults, mean_atol=0.015 * rms, min_fault=8.0)
    # The folded form (the kernel's path for grids not 64 wide) on the same
    # inputs: held to the same bound, and timed beside the main form.
    fold = relpos_global_launch(q, k, v, scale, rh, rw, (g, g), fold=True)
    cmp_fold = compare("flash_mha_decomposed_relpos (folded form)", fold,
                       want, 6e-3, faults=faults, mean_atol=0.015 * rms,
                       min_fault=8.0)
    del faults, fold
    t_k = time_ms(lambda: flash_mha_decomposed_relpos(q, k, v, scale, rh, rw,
                                                      (g, g)), 10)
    d_k = device_ms(lambda: flash_mha_decomposed_relpos(
        q, k, v, scale, rh, rw, (g, g)), 10, "flash_attn_relpos")
    d_fold = device_ms(lambda: relpos_global_launch(
        q, k, v, scale, rh, rw, (g, g), fold=True), 10, "flash_attn_relpos")
    t_p = time_ms(lambda: relpos_attention_plain(q, k, v, scale, rh, rw,
                                                 (g, g)), 3)
    bias16 = _relpos_bias(qf, rh, rw, (g, g)).to(torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    t_l = time_ms(lambda: sdpa(q, k, v, attn_mask=bias16, scale=scale), 10)
    extra = _relpos_extra(
        lambda: flash_mha_decomposed_relpos(q, k, v, scale, rh, rw,
                                                  (g, g)),
        lambda: sdpa(q, k, v, attn_mask=bias16, scale=scale), 10)
    del bias16

    def whole():    # bias from q and the tables, then SDPA
        return sdpa(q, k, v, scale=scale,
                    attn_mask=_relpos_bias(q, rh, rw, (g, g)))
    whole_err = float((whole().float() - want.float()).abs().max())
    t_w = time_ms(whole, 10)
    flops = heads * (4 * s * s * hd + 2 * 2 * s * g * hd)
    nbytes = qkv.numel() * 2 + s * dim * 2 + 2 * rh.numel() * 4
    b_ms, by = bound(nbytes, flops, BF16_FLOP_PER_S)
    row = dict(shape=f"{heads}x{s}x{hd}", **cmp, ms=t_k, device_ms=d_k,
               **extra, plain_ms=t_p, library_ms=t_l,
               library_covers="SDPA with the bias built beforehand",
               folded_form=dict(device_ms=d_fold,
                                err_over_tol=cmp_fold["err_over_tol"],
                                max_abs_err=cmp_fold["max_abs_err"]),
               whole_fn_ms=t_w,
               whole_fn_covers="bias from q and tables + SDPA (several "
                               "PyTorch calls)",
               whole_fn_max_abs_err=whole_err, bound_ms=b_ms, bound_by=by)
    print(json.dumps({"phase": "K3 flash_mha_decomposed_relpos", **row}),
          flush=True)
    return row


def _k4_case(gen, s, heads=16, hd=64):
    """K4 at (heads, s, hd) on strided views of one qkv buffer, as DINOv2
    hands them over: against the plain version, and the tolerance against
    four faults of the kernel's own design (128-key tiles)."""
    from crowdsam_tpu_torch.models.attention import (
        TMA_KV_ROWS,
        flash_mha,
        flash_mha_plain,
    )

    bk, dim = TMA_KV_ROWS, heads * hd
    qkv = torch.randn((1, s, 3 * dim), generator=gen, device="cuda").to(
        torch.bfloat16)
    q, k, v = qkv.reshape(1, s, 3, heads, hd).permute(2, 0, 3, 1, 4)
    scale = hd ** -0.5
    want = flash_mha_plain(q, k, v, scale, s)
    got = flash_mha(q, k, v, scale, valid_len=s)
    n_tiles = -(-s // bk)
    tail, j = bk * (n_tiles - 1), (n_tiles - 1) // 2
    tile, nxt = slice(j * bk, (j + 1) * bk), slice((j + 1) * bk, (j + 2) * bk)
    # A stage released too early: tile j's V already overwritten by tile
    # j+1's.  A swizzle mismatch: tile j's K dims permuted inside each
    # 16-byte chunk (8 dims rolled by one).
    v_f = v.clone()
    v_f[..., tile, :] = v[..., nxt, :]
    k_f = k.clone()
    k_f[..., tile, :] = k[..., tile, :].reshape(1, heads, bk, hd // 8, 8).roll(
        1, -1).reshape(1, heads, bk, hd)
    rms = float(want.float().square().mean().sqrt())
    # Softmax over ~s/e effective keys: atol 9% of the output's rms, the
    # mean error 1% of it.  The kernel rounds P to bf16 for the PV product
    # and otherwise accumulates in f32: its error is a fraction of either.
    # One faulty tile among dozens moves every output a little: the mean
    # sees it.
    cmp = compare(f"flash_mha s={s}", got, want, 0.09 * rms, faults=(
        (f"last key tile (keys {tail}-{s - 1}) dropped",
         _attention_plain(q, k, v, scale, drop=slice(tail, s))),
        (f"first key tile (keys 0-{bk - 1}) dropped",
         _attention_plain(q, k, v, scale, drop=slice(0, bk))),
        (f"key tile {j}'s V read from tile {j + 1} (stage released early)",
         _attention_plain(q, k, v_f, scale)),
        (f"key tile {j}'s K dims permuted inside 16-byte chunks (swizzle "
         f"mismatch)", _attention_plain(q, k_f, v, scale)),
    ), mean_atol=0.01 * rms)
    del v_f, k_f
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # Kernel and SDPA in turns, twice; the faster run of each is kept.
    runs_k, runs_l = [], []
    for _ in range(2):
        runs_k.append(time_ms(lambda: flash_mha(q, k, v, scale, valid_len=s),
                              20))
        runs_l.append(time_ms(lambda: sdpa(q, k, v, scale=scale), 20))
    d_k = device_ms(lambda: flash_mha(q, k, v, scale, valid_len=s), 20,
                    "flash_attn_sm90")
    d_l = device_ms(lambda: sdpa(q, k, v, scale=scale), 20)
    t_p = time_ms(lambda: flash_mha_plain(q, k, v, scale, s), 3)
    flops = heads * 4 * s * s * hd
    b_ms, by = bound(qkv.numel() * 2 + s * dim * 2, flops, BF16_FLOP_PER_S)
    t_k, t_l = min(runs_k), min(runs_l)
    return dict(shape=f"{heads}x{s}x{hd}", **cmp, ms=t_k, ms_runs=runs_k,
                device_ms=d_k, plain_ms=t_p, library_ms=t_l,
                library_ms_runs=runs_l, library_device_ms=d_l,
                library_covers="SDPA on the same strided views",
                kernel_over_library=t_k / t_l, bound_ms=b_ms, bound_by=by,
                bound_share=b_ms / t_k, tflops=flops / t_k / 1e9)


def phase_dino(gen):
    """K4 at the main path's 1 + 73^2 tokens, then at 4096 and 1000."""
    rows = []
    for s in (1 + 73 * 73, 4096, 1000):
        rows.append(_k4_case(gen, s))
        print(json.dumps({"phase": "K4 flash_mha", **rows[-1]}), flush=True)
    return rows


# --------------------------------------------------------------------------
# decode kernel phases: inputs from a model on a seeded frame
# --------------------------------------------------------------------------

def _decoder_inputs(model, img, n_prompts=32, seed=5):
    """The operands of one decode batch from `model` on `img`: the per-image
    shared tensors, the (P, 7, 256) tokens of seeded point prompts (a point
    and its padding token) and the packed-flat DINO map."""
    from crowdsam_tpu_torch.models.fused_decode import (
        precompute_decode_shared,
    )
    from crowdsam_tpu_torch.ops.packed import pack_spatial

    h, w = img.shape[:2]
    model.crop_image(img, [0, 0, w, h])
    model.predictor.set_image_presized(model.image)
    sam, dec = model.sam, model.sam.mask_decoder
    with torch.no_grad():
        shared = precompute_decode_shared(
            dec, sam.prompt_encoder.no_mask_embed.weight,
            model.predictor.get_image_embedding(), model.predictor.dense_pe)
        ih, iw = model.image.shape[:2]
        gen = torch.Generator().manual_seed(seed)
        coords = (torch.rand((n_prompts, 1, 2), generator=gen)
                  * torch.tensor([iw, ih], dtype=torch.float32)).cuda()
        labels = torch.ones((n_prompts, 1), dtype=torch.int64, device="cuda")
        sparse, _ = sam.prompt_encoder(points=(coords, labels))
        out_tokens = torch.cat([dec.iou_token.weight,
                                dec.mask_tokens.weight], dim=0)
        tokens = torch.cat([out_tokens[None].expand(n_prompts, -1, -1),
                            sparse.to(out_tokens.dtype)], dim=1)
        tokens = tokens.to(torch.bfloat16).contiguous()
        dino = model.predictor.dino_proj_256
        dino_packed = pack_spatial(dino.movedim(-1, 0)).reshape(
            dino.shape[-1], -1).T.contiguous()
    return shared, tokens, dino_packed


def _tail_args(shared, tokens):
    return (shared["keys0"], shared["q1i_flat"], shared["k1_flat"],
            shared["v1_flat"], tokens, shared["tail"])


def _nth_call(fn, n, faulty):
    """`fn`, except that its n-th call (from 1) goes to `faulty`."""
    count = [0]

    def wrapped(*a, **kw):
        count[0] += 1
        return (faulty if count[0] == n else fn)(*a, **kw)
    return wrapped


def phase_twoway_tail(model, img, label):
    """K5 against its plain version on one decode batch of `model`."""
    from crowdsam_tpu_torch.models import decode_tail_kernel as dtk

    shared, tokens, _ = _decoder_inputs(model, img)
    args = _tail_args(shared, tokens)
    p, t, c = tokens.shape
    m = shared["keys0"].shape[0]
    with torch.no_grad():
        want = dtk.twoway_tail_plain(*args)
        got = dtk.twoway_tail(*args)
        torch.cuda.synchronize()
        again = dtk.twoway_tail(*args)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError("twoway_tail: two runs differ bit-wise")

        # Plain versions with a known fault.
        real_attend, real_pe = dtk._t2i_attend, dtk._with_pe
        with patched(dtk, "_t2i_attend", _nth_call(
                real_attend, 2, lambda st, q, k, v, h: real_attend(
                    st, q, k[..., :-64, :], v[..., :-64, :], h))):
            f_tile = dtk.twoway_tail_plain(*args)
        with patched(dtk, "_image_update", _nth_call(
                dtk._image_update, 2,
                lambda st, prev, *a: prev.expand(p, m, c))):
            f_update = dtk.twoway_tail_plain(*args)
        with patched(dtk, "_with_pe", _nth_call(real_pe, 4,
                                                 lambda x, pe: x)):
            f_pe = dtk.twoway_tail_plain(*args)
        # Faults the batched token side and the weight ring could commit.
        real_dense = dtk._Stages.dense

        def dense_fault(pfx, fault):
            def dense(self, x, name):
                return real_dense(self, fault(x) if name == pfx else x, name)
            return dense

        with patched(dtk._Stages, "dense", dense_fault(
                "mlp1", lambda x: torch.roll(x, -1, dims=0))):
            f_rows = dtk.twoway_tail_plain(*args)

        def drop_partial(x):              # block 3's 256 hidden inputs
            x = x.clone()
            x[..., 768:1024] = 0
            return x
        with patched(dtk._Stages, "dense", dense_fault("mlp2",
                                                       drop_partial)):
            f_split = dtk.twoway_tail_plain(*args)
        stale = dict(args[5])
        widef = stale["widef"].clone()
        widef[128:256, 64:128] = widef[128:256, 0:64]
        stale["widef"] = widef
        f_stale = dtk.twoway_tail_plain(*args[:5], stale)
    faults = (("last row tile (64 rows) left out of block 2's token->image "
               "softmax", f_tile),
              ("block 2's image update skipped (keys2 = keys1)", f_update),
              ("query PE not added before block 2's token->image q "
               "projection", f_pe),
              ("block 2's MLP reads prompt p + 1's token rows for prompt p",
               f_rows),
              ("one K-split partial of block 2's MLP (hidden 768-1023) left "
               "out", f_split),
              ("row phase 2's weight chunk (widef v rows, inputs 64-127) "
               "replaced by the previous chunk (inputs 0-63)", f_stale))
    # Both outputs are LayerNorm outputs of rms ~1: atol 2% of the rms
    # covers a value that the two sides round one bf16 step apart before
    # the last LayerNorm.  Kernel and plain version round at the same
    # points, so most elements agree bit for bit: the mean error is held to
    # 2^-11 of the rms, an eighth of the mean bf16 step.  With random
    # weights the attention is nearly uniform, and a dropped row tile or a
    # missing PE shifts every element a little: that shows in the mean
    # before it shows in the maximum.
    outs = {}
    for i, name in enumerate(("keys2", "tokens")):
        outs[name] = compare(
            f"twoway_tail {label} {name}", got[i], want[i], 2e-2,
            faults=[(lb, f[i]) for lb, f in faults], require_faults=False,
            mean_atol=2.0 ** -11)
    require_faults_seen(f"twoway_tail {label}", outs)

    sam = model.sam
    src = shared["keys0"][None].expand(p, m, c)
    pos = model.predictor.dense_pe.reshape(1, m, c).to(src.dtype).expand(
        p, m, c)
    with torch.no_grad():
        t_k = time_ms(lambda: dtk.twoway_tail(*args), 20)
        # The kernel's own device time: the span of its launches per call
        # (they overlap: each starts before the one before it ends), and
        # each launch kind's median duration, waiting included.
        d_k = device_span_ms(lambda: dtk.twoway_tail(*args), 20)
        split = device_split(lambda: dtk.twoway_tail(*args), 20)
        t_p = time_ms(lambda: dtk.twoway_tail_plain(*args), 3)
        # What the fused path replaced: the unfused two-way transformer of
        # `MaskDecoder.forward` on the same prompts (no library call
        # computes K5).
        t_r = time_ms(lambda: sam.mask_decoder.transformer(src, pos, tokens),
                      3)
    mlp = shared["tail"]["mlp1_w"].shape[0]
    cd, h, ht = 128, 8, 8 * t
    flops = p * m * 2 * c * (3 * cd + 2 * cd)            # wide2, widef
    flops += 3 * p * m * ht * (cd // h) * 2 * 2          # token->image, QK+PV
    flops += 2 * p * m * (ht * (cd // h) * 2 + ht * c * 2)   # image updates
    flops += p * t * 2 * (8 * c * c + 12 * c * cd + 4 * c * mlp)  # token side
    nbytes = sum(x.numel() * x.element_size() for x in args[:5])
    nbytes += sum(x.numel() * x.element_size() for x in args[5].values())
    nbytes += sum(x.numel() * x.element_size() for x in got)
    b_ms, by = bound(nbytes, flops, BF16_FLOP_PER_S)
    row = dict(shape=f"{p}x{t}x{c} tokens, {m}x{c} image rows",
               max_abs_err=max(o["max_abs_err"] for o in outs.values()),
               outputs=outs, ms=t_k, device_ms=d_k,
               device_by_launch=split,
               device_by_launch_covers="each launch's duration, the wait "
                                       "for the launch before it included",
               plain_ms=t_p, replaced_ms=t_r,
               replaced="TwoWayTransformer.forward (unfused)",
               library_ms=None, bound_ms=b_ms, bound_by=by,
               gflop=flops / 1e9, mbytes=nbytes / 1e6)
    print(json.dumps({"phase": f"K5 twoway_tail {label}", **row}), flush=True)
    return row, got


def phase_twoway_tail_normal(model, img):
    """K5 on normal-draw tokens at the main path's 32 x 7 and M = 4096
    (ROADMAP fault F3): the kernel against its plain version under K5's
    bound (atol 2e-2 + 2^-7 |y|, mean 2^-11), and each of them against the
    plain version in float32 on the same bf16 inputs, which must find the
    kernel as close to float32 as the plain version (mean error within 5%,
    largest error over the bound within 25%)."""
    from crowdsam_tpu_torch.models import decode_tail_kernel as dtk

    shared, point_tokens, _ = _decoder_inputs(model, img)
    gen = torch.Generator(device="cuda").manual_seed(11)
    tokens = torch.randn(tuple(point_tokens.shape), generator=gen,
                         device="cuda").to(torch.bfloat16)
    args = _tail_args(shared, tokens)
    with torch.no_grad():
        got = dtk.twoway_tail(*args)
        want = dtk.twoway_tail_plain(*args)
        ref = dtk.twoway_tail_plain(
            *(x.float() for x in args[:5]),
            {k: v.float() for k, v in args[5].items()})
    torch.cuda.synchronize()

    def against_f32(a):
        err = (a.float() - ref_i).abs()
        tol = 2e-2 + BF16_ULP * ref_i.abs()
        return dict(err_over_tol=float((err / tol).max()),
                    mean_abs_err=float(err.mean()))

    outs = {}
    for i, name in enumerate(("keys2", "tokens")):
        ref_i = ref[i].float()
        k32, p32 = against_f32(got[i]), against_f32(want[i])
        outs[name] = dict(
            **compare(f"twoway_tail normal draws {name}", got[i], want[i],
                      2e-2, mean_atol=2.0 ** -11),
            kernel_vs_f32=k32, plain_vs_f32=p32)
        if (k32["mean_abs_err"] > 1.05 * p32["mean_abs_err"]
                or k32["err_over_tol"] > 1.25 * p32["err_over_tol"]):
            raise AssertionError(f"twoway_tail normal draws {name}: the "
                                 f"kernel is further from float32 than the "
                                 f"plain version: {outs[name]}")
    row = dict(shape=f"{tokens.shape[0]}x{tokens.shape[1]}x256 normal-draw "
                     f"tokens, {args[0].shape[0]}x256 image rows",
               max_abs_err=max(o["max_abs_err"] for o in outs.values()),
               outputs=outs)
    print(json.dumps({"phase": "K5 twoway_tail normal draws", **row}),
          flush=True)
    return row


def phase_msgpack_adapter(img):
    """The shipped adapter, a flax msgpack tree, through the port's own
    reader on this machine: the full-width model built with
    `model.sam_adapter_checkpoint` set back to `configs/crowdhuman.yaml`'s
    value holds its values, and one `generate` runs.  Returns the model."""
    from crowdsam_tpu_torch.config import modify_config
    from crowdsam_tpu_torch.pipeline.crowdsam import CrowdSAM
    from crowdsam_tpu_torch.utils import msgpack_io
    from crowdsam_tpu_torch.utils.synthetic import full_width_config
    from crowdsam_tpu_torch.utils.weights import mask_decoder_state_dict

    path = "./adapter_weights/10_shot.msgpack"
    model = CrowdSAM(modify_config(full_width_config(), [
        "model.sam_adapter_checkpoint", path]), device="cuda")
    want = mask_decoder_state_dict(msgpack_io.load(path))
    got = model.sam.mask_decoder.state_dict()
    bad = [k for k, v in want.items()
           if not torch.equal(got[k].cpu(), v.to(got[k].dtype))]
    if bad:
        raise AssertionError(f"msgpack adapter: decoder differs at {bad}")
    data, ms = _timed_generate(model, img)
    row = dict(adapter=path, decoder_tensors_checked=len(want),
               detections=len(data["boxes"]), ms=ms)
    print(json.dumps({"phase": "msgpack adapter", **row}), flush=True)
    return model


def phase_mask_head(model, img, label, tail_out, probe):
    """K6 (`emit_exp` off and on) against its plain version, on the keys2
    and hypernetwork vectors of one decode batch of `model`; each of them
    also against the plain version in float32 (no hi + lo splits), which
    must find the kernel as close to float32 as the plain version (mean
    error and largest error over the bound within 25%); and the CUDA-core
    issue floor of the GELUs alone (`probe`, `finish_gelu_probe`)."""
    from crowdsam_tpu_torch.models import fused_decode as fd
    from crowdsam_tpu_torch.models import mask_head_kernel as mhk

    shared, _, dino = _decoder_inputs(model, img)
    dec = model.sam.mask_decoder
    keys2, tok = tail_out
    p, m, c = keys2.shape
    k = dec.num_mask_tokens
    weights = shared["mask_head"]
    with torch.no_grad():
        # With random weights the hypernetwork vectors give mask logits of
        # rms ~0.005, and exp(mask - max) is 1 everywhere.  Scaled by 2^10
        # (exact in bf16) the logits have the spread of a trained decoder's
        # (rms ~5), so that e and the tile maxes carry information.
        hyper = (fd._hyper_in(dec, tok[:, 1:1 + k, :]) * 1024.0).contiguous()
        want = mhk.mask_head_plain(keys2, hyper, weights, emit_exp=True)
        ref = mhk.mask_head_plain(
            keys2.float(), hyper.float(),
            {k_: v.float() for k_, v in weights.items()}, emit_exp=True)
        got_off = mhk.mask_head(keys2, hyper, weights)
        got = mhk.mask_head(keys2, hyper, weights, emit_exp=True)
        torch.cuda.synchronize()

        def ln_all_lanes(x, w, b):          # over (4, c1), not per group
            u = x.mean((-1, -2), keepdim=True)
            s = (x - u).square().mean((-1, -2), keepdim=True)
            return (x - u) * torch.rsqrt(s + mhk.LN_EPS) * w + b
        with patched(mhk, "_group_ln", ln_all_lanes):
            f_ln = mhk.mask_head_plain(keys2, hyper, weights)
        f_swap = want[0].reshape(p, k, m, 4, 4).transpose(-1, -2).reshape(
            p, k, m, 16)
        # Faults of the persistent design: block b walks tiles b + i G (G =
        # min(tiles, SMs)) through two keys stages, warpgroup i % 2 taking
        # tile i.  The other stage holds the walk's neighbour, tile i - 1
        # (i odd) or i + 1, or nothing (zeros) in a block of one tile.
        n_t = p * (m // mhk.ROW_TILE)
        grid = min(n_t, torch.cuda.get_device_properties(0)
                   .multi_processor_count)
        t = torch.arange(n_t, device="cuda")
        other = torch.where((t // grid) % 2 == 1, t - grid, t + grid)
        has_other = other < n_t
        tiles = keys2.reshape(n_t, mhk.ROW_TILE, c)
        f_keys = torch.where(has_other[:, None, None],
                             tiles[other.clamp(max=n_t - 1)], 0.0)
        f_stage = mhk.mask_head_plain(f_keys.reshape(p, m, c), hyper,
                                      weights, emit_exp=True)
        # The tile max from the other warpgroup's tile (where the block has
        # one tile, from the next tile's).
        mx_other = want[2].reshape(-1)[torch.where(has_other, other, t ^ 1)
                                       .clamp(max=n_t - 1)].reshape(p, -1)
        f_mx_e = (want[1].float().reshape(p, k, n_t // p, -1)
                  * torch.exp(want[2] - mx_other)[:, None, :, None]
                  ).reshape(p, k, m, 16)
    rms = float(want[0].float().square().mean().sqrt())
    # Masks are a 32-term dot of GELU outputs with the hypernetwork vector,
    # the operands as hi + lo on both sides: atol 3% of the masks' rms
    # covers their own bf16 rounding.
    atol = 0.03 * rms
    stage_fault = "a tile's keys read from the other ring stage"
    mx_fault = "the tile max taken from the other warpgroup's tile"
    faults = (("LayerNorm over all 256 lanes, not per group of 64", f_ln),
              ("sub-pixel levels swapped (q1 <-> q2)", f_swap),
              (stage_fault, f_stage[0]))
    outs = {
        "masks": compare(f"mask_head {label} masks", got_off, want[0], atol,
                         faults=faults),
        "masks (emit_exp)": compare(f"mask_head {label} masks (emit_exp)",
                                    got[0], want[0], atol, faults=faults),
        # e in (0, 1]: a mask off by d moves e by d e; the f32 masks of the
        # two sides agree to ~1e-3 at this scale, and e is rounded to bf16.
        "e": compare(f"mask_head {label} e", got[1], want[1], 2e-2,
                     faults=((stage_fault, f_stage[1]),
                             (mx_fault, f_mx_e))),
        "mx": compare(f"mask_head {label} mx", got[2], want[2], atol,
                      faults=((stage_fault, f_stage[2]),
                              (mx_fault, mx_other))),
    }
    with torch.no_grad():
        # The pooled result: the kernel's e and mx against the plain ones,
        # against the plain ones with the maxes of two tiles exchanged (per
        # prompt the tiles with the largest and the smallest max), and
        # against the explicit softmax pooling of the kernel's masks.
        pooled = fd._pooled_from_exp(got[1], got[2], dino, torch.bfloat16)
        pooled_want = fd._pooled_from_exp(want[1], want[2], dino,
                                          torch.bfloat16)
        mx_f = want[2].clone()
        hi = want[2].argmax(1, keepdim=True)
        lo = want[2].argmin(1, keepdim=True)
        mx_f.scatter_(1, hi, want[2].gather(1, lo))
        mx_f.scatter_(1, lo, want[2].gather(1, hi))
        pooled_fault = fd._pooled_from_exp(want[1], mx_f, dino,
                                           torch.bfloat16)
        soft = torch.softmax(got[0].float().reshape(p, k, -1), dim=-1)
        pooled_soft = soft @ dino.float()
    p_rms = float(pooled_want.float().square().mean().sqrt())
    p_max = float(pooled_want.float().abs().max())
    # Pooled DINO features, a softmax average over 65536 pixels: 5% of
    # their rms (e carries the masks' differences, see above).
    outs["pooled"] = compare(
        f"mask_head {label} pooled", pooled, pooled_want, 0.05 * p_rms,
        faults=(("maxes of two tiles exchanged", pooled_fault),))
    # Against the softmax of the kernel's bf16 masks: e comes from the
    # unrounded f32 masks.  One bf16 step of the largest logits (2^-8 * 32)
    # moves a single weight by up to 13%, and where few pixels dominate the
    # pooled vector moves by that share of a feature: 5% of the largest
    # pooled value.
    outs["pooled vs softmax of masks"] = compare(
        f"mask_head {label} pooled vs softmax", pooled, pooled_soft,
        0.05 * p_max)

    no_kernel = {k_: v for k_, v in shared.items() if k_ != "mask_head"}
    with torch.no_grad():
        t_k = time_ms(lambda: mhk.mask_head(keys2, hyper, weights,
                                            emit_exp=True), 20)
        t_k0 = time_ms(lambda: mhk.mask_head(keys2, hyper, weights), 20)
        d_k = device_ms(lambda: mhk.mask_head(keys2, hyper, weights,
                                              emit_exp=True), 20)
        d_k2 = device_ms(lambda: mhk.mask_head(keys2, hyper, weights,
                                               emit_exp=True), 20)
        t_p = time_ms(lambda: mhk.mask_head_plain(keys2, hyper, weights,
                                                  emit_exp=True), 3)
        # What K6 replaced: the module-level packed head and softmax
        # pooling; beside it the same heads through K6 and its exp terms.
        t_r = time_ms(lambda: fd._decode_heads(dec, no_kernel, tok, keys2,
                                               dino, True, True), 3)
        t_h = time_ms(lambda: fd._decode_heads(dec, shared, tok, keys2, dino,
                                               True, True), 10)
    c1, c2 = weights["ln_w"].shape[0], hyper.shape[-1]
    flops = p * m * 2 * (c * 4 * c1 + 4 * c1 * 4 * c2 + 16 * c2 * k)
    nbytes = (keys2.numel() + hyper.numel()) * 2
    nbytes += sum(x.numel() * x.element_size() for x in weights.values())
    nbytes += sum(x.numel() * x.element_size() for x in got)
    b_ms, by = bound(nbytes, flops, BF16_FLOP_PER_S)
    # Kernel and plain version against float32: the polynomial GELU and the
    # kernel's products must cost no accuracy that the plain version's
    # exact erf and its own f32 products keep (mx is f32, unrounded).
    vs_f32 = {}
    for i, name, tol_ in ((0, "masks", atol), (1, "e", 2e-2), (2, "mx", atol)):
        r = ref[i].float()

        def against_f32(x):
            err = (x.float() - r).abs()
            return dict(err_over_tol=float(
                (err / (tol_ + BF16_ULP * r.abs())).max()),
                mean_abs_err=float(err.mean()))
        vs_f32[name] = dict(kernel=against_f32(got[i]),
                            plain=against_f32(want[i]))
    far = [name for name, o in vs_f32.items() if any(
        o["kernel"][key] > 1.25 * o["plain"][key]
        for key in ("mean_abs_err", "err_over_tol"))]
    if far:
        raise AssertionError(f"mask_head {label} {far}: the kernel is "
                             f"further from float32 than the plain version: "
                             f"{vs_f32}")
    # The GELUs alone at four warp instructions a clock on every SM at the
    # card's maximum SM clock: 768 a row (4 x 64 after the first product,
    # 16 x 32 after the second), SASS instructions from the probes.
    clock_hz = 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gelus = p * m * (4 * c1 + 16 * c2)
    floor = {kind: gelus * n / 32 / (4 * sms * clock_hz) * 1e3
             for kind, n in probe["sass_per_gelu"].items()}
    row = dict(shape=f"{p}x{m}x{c} keys2, {p}x{k}x{c2} hyper_in, emit_exp",
               max_abs_err=outs["masks (emit_exp)"]["max_abs_err"],
               outputs=outs, vs_f32=vs_f32, ms=t_k, device_ms=d_k,
               device_ms_again=d_k2, sass_per_gelu=probe["sass_per_gelu"],
               gelu_issue_floor_ms=floor, gelus=gelus,
               max_sm_clock_mhz=clock_hz / 1e6, ms_no_exp=t_k0,
               plain_ms=t_p,
               replaced_ms=t_r, heads_with_kernel_ms=t_h,
               replaced="module-level packed head + softmax pooling "
                        "(_decode_heads)",
               library_ms=None, bound_ms=b_ms, bound_by=by,
               gflop=flops / 1e9, mbytes=nbytes / 1e6)
    print(json.dumps({"phase": f"K6 mask_head {label}", **row}), flush=True)
    return row


_GELU_PROBES = """
extern "C" __global__ void copy_probe(const float* x, float* y) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  y[i] = x[i];
}
extern "C" __global__ void gelu_probe(const float* x, float* y) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  y[i] = gelu(x[i]);
}
extern "C" __global__ void erf_probe(const float* x, float* y) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  y[i] = 0.5f * x[i] * (1.f + erff(x[i] * 0.70710678118654752f));
}
extern "C" int gelu_sweep(const float* x, float* y, int n, void* stream) {
  if (n <= 0 || n % 256) return (int)cudaErrorInvalidValue;
  gelu_probe<<<n / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(x, y);
  return (int)cudaGetLastError();
}
"""


def start_gelu_probe():
    """Start nvcc, beside the kernels' build, on a probe library: K6's own
    `gelu` (the source included) in a kernel of one call a thread, with a
    launcher for a sweep of x, and the same kernel with erff, the plain
    version's GELU.  Returns the process and the library;
    `finish_gelu_probe` waits."""
    from crowdsam_tpu_torch.kernels import _build

    out = _build.BUILD_DIR / "k6_gelu"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "gelu_probe.cu"
    src.write_text(f'#include "{_build.CSRC_DIR / "mask_head.cu"}"\n'
                   + _GELU_PROBES)
    lib = out / "libgelu_probe.so"
    return subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib


def _sass_count(lib, fn):
    """Instructions of kernel `fn` in a library's SASS, up to its EXIT."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    body = text.split(f"Function : {fn}\n")[1]
    n = 0
    for line in body.splitlines():
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
        if m:
            n += 1
            if m.group(1).strip().startswith("EXIT"):
                return n
    raise AssertionError(f"no EXIT in the SASS of {fn}")


def finish_gelu_probe(job):
    """Wait for `start_gelu_probe`; the SASS instructions of one GELU, the
    shipped polynomial and erff, and the sweep's entry point."""
    import ctypes

    proc, lib = job
    text, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"K6 GELU probe failed to build:\n{text}")
    fn = ctypes.CDLL(str(lib)).gelu_sweep
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    copy = _sass_count(lib, "copy_probe")
    return {"sweep": fn, "sass_per_gelu": {
        kind: _sass_count(lib, probe) - copy
        for kind, probe in (("poly", "gelu_probe"), ("erf", "erf_probe"))}}


def phase_gelu(probe):
    """K6's polynomial GELU, compiled as the kernel compiles it (ex2.approx
    included), against the exact-erf GELU in float64 over a sweep of x in
    [-12, 12] and the points around the polynomial's clamp at 4 sqrt 2: the
    error must stay within 2^-22 max(|x|, 1), the source's claim, far below
    the 2^-17 of the kernel's hi + lo split."""
    n = 1 << 22
    x = torch.linspace(-12.0, 12.0, n - 256)
    edge = torch.tensor([5.656854, -5.656854])
    around = torch.cat([edge + d for d in torch.arange(-64, 64) * 4.8e-7])
    x = torch.cat([x, around]).cuda()
    y = torch.empty_like(x)
    status = probe["sweep"](x.data_ptr(), y.data_ptr(), x.numel(),
                            torch.cuda.current_stream().cuda_stream)
    if status:
        raise RuntimeError(f"gelu_sweep: CUDA error {status}")
    xd = x.cpu().double()
    want = 0.5 * xd * (1.0 + torch.erf(xd / np.sqrt(2.0)))
    rel = (y.cpu().double() - want).abs() / xd.abs().clamp(min=1.0)
    worst = int(rel.argmax())
    row = dict(points=x.numel(), max_err_over_max_abs_x_1=float(rel.max()),
               at_x=float(xd[worst]), bound=2.0 ** -22,
               sass_per_gelu=probe["sass_per_gelu"])
    print(json.dumps({"phase": "K6 GELU sweep", **row}), flush=True)
    if not bool(torch.isfinite(y).all()) or row[
            "max_err_over_max_abs_x_1"] > 2.0 ** -22:
        raise AssertionError(f"K6 GELU beyond its bound: {row}")
    return row


# --------------------------------------------------------------------------
# survivor kernel phase: person-shaped masks from the crowd scenes
# --------------------------------------------------------------------------

def _survivor_inputs(k, seed, r=256):
    """k survivor masks as the engine hands them to K7: bf16 logits (k, r,
    r) of person-shaped masks (a head disc over a body ellipse, the port's
    crowd-scene boxes on the low-res grid) with ragged boundaries from
    seeded noise, the cleanup edits of the engine's small-region pass, and
    per-mask in_hw of the frame sizes.  Every 16th mask is noise, whose
    columns overflow the 24 change slots."""
    from crowdsam_tpu_torch.ops.connected import remove_small_regions
    from crowdsam_tpu_torch.utils.synthetic import FRAME_SIZES, crowd_scene

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:r, 0:r] + 0.5
    logits, hws, i = [], [], 0
    while len(logits) < k:
        h, w = FRAME_SIZES[i % len(FRAME_SIZES)]
        _, boxes = crowd_scene(seed + i, h, w)
        i += 1
        c = r / max(h, w)                        # image px -> low-res cells
        for bx, by, bw, bh in boxes:
            if len(logits) == k:
                break
            if len(logits) % 16 == 0:
                lg = rng.normal(0.0, 4.0, (r, r))
            else:
                hr = max(2, bw // 4) * c
                hx, hy = (bx + bw / 2) * c, by * c + hr
                a, b = max(2, bw // 2) * c, (bh * c - 2 * hr) / 2
                head = np.hypot(xx - hx, yy - hy) / hr
                body = np.hypot((xx - hx) / a, (yy - hy - hr - b) / max(b, 1))
                d = np.minimum(head, body)
                lg = 8.0 * (1.0 - d) + rng.normal(0.0, 1.5, (r, r))
            logits.append(lg)
            hws.append((h, w))
    logits = torch.tensor(np.stack(logits), dtype=torch.float32,
                          device="cuda").bfloat16()
    binm = logits.float() > 0.0
    area = 100.0 * (r / 1024) ** 2            # min_mask_region_area at 256^2
    m1, _ = remove_small_regions(binm, area, "holes", 192)
    m2, _ = remove_small_regions(m1, area, "islands", 192)
    edit = (~binm & m2).to(torch.int8) - (binm & ~m2).to(torch.int8)
    hw = torch.tensor(hws, dtype=torch.int32, device="cuda")
    return logits, edit, hw


def _rle_strings(out, hw):
    """COCO strings of K7's outputs as the pipeline builds them: from the
    change rows, or from the packed bitmap for a mask with a column of more
    changes than the rows keep."""
    from crowdsam_tpu_torch.ops.rle import (
        encode_changes_coco,
        encode_masks_coco,
        svals_from_cand,
        unpack_cand10,
    )

    summary = out["summary"].cpu().numpy()
    cand = unpack_cand10(out["cand"].cpu().numpy())
    ncol = out["n_col"].cpu().numpy()
    packed = out["packed"].cpu().numpy()
    strings = []
    for i, (h, w) in enumerate(hw.tolist()):
        if summary[i, 6]:
            full = np.unpackbits(packed[i], axis=-1)[:h, :w]
            strings.append(encode_masks_coco(full)[0])
        else:
            strings.append(encode_changes_coco(
                svals_from_cand(cand[i], ncol[i], h), h * w, (h, w)))
    return strings


def _survivor_merge_faults(want, hw, band_rows):
    """The plain outputs with a fault of K7's band merge, from the plain
    bitmap: the change at each band boundary (rows b * band_rows, b >= 1)
    dropped, and the bands' change rows merged in reverse band order.  The
    same construction in band order must give the plain outputs."""
    from crowdsam_tpu_torch.ops import survivor_kernel as sk

    k, s, _ = want["packed"].shape
    dev = want["packed"].device
    full = torch.tensor(np.unpackbits(want["packed"].cpu().numpy(), -1),
                        device=dev).bool()
    hw_l = hw.long().clamp(1, s)
    ys = torch.arange(s, device=dev)
    inside = ((ys[None, :, None] < hw_l[:, 0, None, None])
              & (ys[None, None, :] < hw_l[:, 1, None, None]))
    prev = torch.empty_like(full)
    prev[:, 1:] = full[:, :-1]
    prev[:, 0] = sk._column_link(full, hw_l)
    change = inside & (full != prev)

    def merged(change, order):
        perm = torch.cat([torch.arange(b * band_rows, (b + 1) * band_rows)
                          for b in order]).to(dev)
        ch = change[:, perm]
        n_col = ch.sum(1)
        rank = ch.int().cumsum(1)
        kk, yy, xx = torch.nonzero(ch & (rank <= sk.COL_SLOTS),
                                   as_tuple=True)
        rows = torch.full((k, sk.COL_SLOTS, s), s - 1, dtype=torch.int32,
                          device=dev)
        rows[kk, rank[kk, yy, xx] - 1, xx] = perm[yy].int()
        rows = rows.reshape(k, sk.CAND_WORDS, 3, s)
        summary = want["summary"].clone()
        summary[:, 5] = n_col.sum(1).int()
        summary[:, 6] = (n_col.amax(1) > sk.COL_SLOTS).int()
        return {"packed": want["packed"],
                "cand": (rows[:, :, 0] << 20) | (rows[:, :, 1] << 10)
                | rows[:, :, 2],
                "n_col": n_col.int(), "summary": summary}

    bands = list(range(s // band_rows))
    same = merged(change, bands)
    if not all(torch.equal(same[x], want[x]) for x in want):
        raise AssertionError("survivor_rle: the band-merge emulation does "
                             "not reproduce the plain version")
    dropped = change.clone()
    dropped[:, band_rows::band_rows] = False
    return (("band-boundary change dropped", merged(dropped, bands)),
            ("bands merged out of order", merged(change, bands[::-1])))


def phase_survivor(k, seed):
    """K7 against its plain version on k person-shaped masks; the RLE
    strings built from its change rows against `encode_masks_coco` of the
    plain masks; plain versions with a known fault must disagree."""
    from crowdsam_tpu_torch.ops import survivor_kernel as sk
    from crowdsam_tpu_torch.ops.rle import encode_masks_coco

    logits, edit, hw = _survivor_inputs(k, seed)
    r = logits.shape[-1]
    s = 4 * r
    keys = ("packed", "cand", "n_col", "summary")
    with torch.no_grad():
        want = sk.survivor_rle_plain(logits, edit, hw)
        got = sk.survivor_rle(logits, edit, hw)
        torch.cuda.synchronize()
        again = sk.survivor_rle(logits, edit, hw)
        if not all(torch.equal(got[x], again[x]) for x in keys):
            raise AssertionError("survivor_rle: two runs differ bit-wise")
        # A pixel may flip only where the plain float32 value lies within
        # 1e-5 of the threshold (none is expected: both round the same
        # float32 operations).
        bits_k = torch.tensor(np.unpackbits(got["packed"].cpu().numpy(), -1))
        bits_p = torch.tensor(np.unpackbits(want["packed"].cpu().numpy(), -1))
        flipped = bits_k != bits_p
        flips = int(flipped.sum())
        if flips:
            up = sk.upsample_plain(logits).cpu()
            if not bool((up[flipped].abs() <= 1e-5).all()):
                raise AssertionError("survivor_rle: pixels flipped away from "
                                     "the threshold")
        mismatch = {x: int((got[x] != want[x]).sum()) for x in keys}
        max_err = max(float((got[x].long() - want[x].long()).abs().max())
                      for x in keys)
        with patched(sk, "_column_link",
                     lambda full, hw_: torch.zeros_like(full[:, 0])):
            f_link = sk.survivor_rle_plain(logits, edit, hw)
        f_sign = sk.survivor_rle_plain(logits, -edit, hw)
        f_merge = _survivor_merge_faults(want, hw, s // sk.BANDS)
    faults = {label: sum(int((f[x] != got[x]).sum()) for x in keys)
              for label, f in (("column link dropped", f_link),
                               ("edit signs swapped", f_sign), *f_merge)}
    h_w = hw.tolist()
    strings = _rle_strings(got, hw)
    bits_p = bits_p.numpy()
    dense = [encode_masks_coco(bits_p[i, :h, :w])[0]
             for i, (h, w) in enumerate(h_w)]
    rle_mismatch = sum(a != b for a, b in zip(strings, dense))
    overflow = int(want["summary"][:, 6].sum())
    n_edits = int((edit != 0).sum())
    with torch.no_grad():
        t_k = time_ms(lambda: sk.survivor_rle(logits, edit, hw), 20)
        d_k = device_ms(lambda: sk.survivor_rle(logits, edit, hw), 20)
        t_p = time_ms(lambda: sk.survivor_rle_plain(logits, edit, hw), 3)
        # Only the upsample and the threshold: no edits, crop, packing,
        # box or change rows.
        t_i = time_ms(lambda: torch.nn.functional.interpolate(
            logits[:, None], scale_factor=4, mode="bilinear",
            align_corners=False) > 0.0, 10)
    nbytes = k * (r * r * 3 + 8) + k * (s * s // 8 + 9 * s * 4 + 32)
    flops = sum(4.75 * h * w for h, w in h_w)
    b_ms, by = bound(nbytes, flops, F32_FLOP_PER_S)
    row = dict(shape=f"{k}x{r}x{r} bf16 + int8 edits -> {k}x{s}x{s // 8} "
                     f"uint8 + {k}x9x{s} + {k}x8 int32",
               mismatch=mismatch, pixel_flips=flips, max_abs_err=max_err,
               fault_mismatch=faults, rle_strings=len(strings),
               rle_mismatch=rle_mismatch, overflow_masks=overflow,
               edited_cells=n_edits, ms=t_k, device_ms=d_k, plain_ms=t_p,
               replaced_ms=t_p, replaced="the plain version",
               interpolate_threshold_ms=t_i,
               interpolate_covers="F.interpolate bilinear + threshold only",
               library_ms=None, bound_ms=b_ms, bound_by=by,
               mbytes=nbytes / 1e6, mflop=flops / 1e6)
    print(json.dumps({"phase": f"K7 survivor_rle k={k}", **row}), flush=True)
    if any(mismatch.values()) or rle_mismatch:
        raise AssertionError(f"survivor_rle disagrees with its plain "
                             f"version: {row}")
    if min(faults.values()) == 0 or overflow == 0 or n_edits == 0:
        raise AssertionError(f"survivor_rle phase does not see its faults, "
                             f"or has no overflow or edits: {row}")
    return row


# --------------------------------------------------------------------------
# end to end
# --------------------------------------------------------------------------

def _counters():
    from crowdsam_tpu_torch.models import (
        attention,
        decode_tail_kernel,
        mask_head_kernel,
    )
    from crowdsam_tpu_torch.ops import layernorm, survivor_kernel

    return {
        "twoway_tail": decode_tail_kernel.twoway_tail,
        "mask_head": mask_head_kernel.mask_head,
        "layer_norm": layernorm.layer_norm,
        "window_attention": attention.window_attention,
        "flash_mha_decomposed_relpos": attention.flash_mha_decomposed_relpos,
        "flash_mha": attention.flash_mha,
        "survivor_rle": survivor_kernel.survivor_rle,
    }


def _reset_counts():
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    return counters


def _timed_generate(model, img, noise=None):
    """Detections of one frame, checked, and the host-clock ms of the call
    (`noise`: the candidate order, drawn by the model when absent)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    data = model.generate(img, noise=None if noise is None else [noise])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    n = len(data["boxes"])
    boxes, scores = np.asarray(data["boxes"]), np.asarray(data["scores"])
    # An image without detections carries the JAX package's (0, 4) empty
    # score array.
    assert boxes.shape == (n, 4) and scores.shape[0] == n, "shapes"
    assert np.isfinite(boxes).all() and np.isfinite(scores).all()
    # Box-only boxes come from the whole low-res mask, as in the JAX
    # package: they stay inside the square frame the model saw (long side
    # by long side), which may reach past the image's short side.
    assert (boxes >= 0).all() and (boxes <= max(img.shape[:2]) + 1e-3).all()
    assert len(data["rles"]) == n
    return data, ms


def _check_rles(data, img):
    """Every detection carries a COCO RLE string of the image's size; a
    nonempty mask spans exactly its detection's full-res box (one crop,
    frames whose long side is the model's 1024, so no rescale).  Returns
    the number of nonempty masks."""
    from crowdsam_tpu_torch.ops.rle import coco_decode_rle

    nonempty = 0
    for rle, box in zip(data["rles"], np.asarray(data["boxes"])):
        assert isinstance(rle["counts"], str)
        assert rle["size"] == list(img.shape[:2]), rle["size"]
        m = coco_decode_rle(rle)
        if not m.any():
            continue
        ys, xs = np.nonzero(m)
        assert np.array_equal([xs.min(), ys.min(), xs.max(), ys.max()], box), \
            (box, [xs.min(), ys.min(), xs.max(), ys.max()])
        nonempty += 1
    return nonempty


def _encode_ms(model, img) -> float:
    """Host-clock ms of the dual-backbone encode alone (host resize, SAM,
    DINOv2, projections) on one frame."""
    h, w = img.shape[:2]
    torch.cuda.synchronize()
    t = time.perf_counter()
    model.crop_image(img, [0, 0, w, h])
    model.predictor.set_image_presized(model.image)
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


def _device_busy(model, img):
    """One `generate` under torch.profiler with CUDA activity only: the
    wall time of the profiled window and the union of the device's activity
    intervals inside it.  Returns (wall ms, busy ms, top kernels)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA]
    with profile(activities=acts):          # the profiler's own start-up
        model.generate(img)
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        model.generate(img)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    intervals, by_name = [], {}
    for ev in prof.events():
        if ev.device_type.name != "CUDA":
            continue
        start = ev.time_range.start
        intervals.append((start, start + ev.device_time_total))
        ms, calls = by_name.get(ev.name, (0.0, 0))
        by_name[ev.name] = (ms + ev.device_time_total / 1e3, calls + 1)
    busy = _union_us(intervals)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return wall, busy / 1e3, {_kernel_name(k)[:80]: {"ms": v[0],
                                                     "calls": v[1]}
                              for k, v in top}


def phase_end_to_end(model):
    from crowdsam_tpu_torch.utils.synthetic import (
        FRAME_SIZES,
        crowd_scene,
        synthetic_images,
    )

    assert model.engine_cfg.fused_decode and model.output_rles
    reference_cfg = model.engine_cfg
    images = synthetic_images(0, N_IMAGES + 1)
    model.generate(images[-1])          # warm-up (cuBLAS / allocator)
    torch.cuda.synchronize()
    counters = _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    runs = [_timed_generate(model, img) for img in images[:N_IMAGES]]
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    times = [ms for _, ms in runs]
    encode = [_encode_ms(model, img) for img in images[:N_IMAGES]]
    wall, busy, top = _device_busy(model, images[0])
    print(json.dumps({
        "phase": "end_to_end",
        "config": "vit_l + dinov2_vitl14 + PWD-Net, bf16, random weights, "
                  "configs/crowdhuman.yaml defaults (fused_decode true, "
                  "output_rles true)",
        "image_hw": [list(i.shape[:2]) for i in images[:N_IMAGES]],
        "ms_per_image": times,
        "ms_per_image_mean": float(np.mean(times)),
        "encode_ms_per_image": encode,
        "detections_per_image": [len(d["boxes"]) for d, _ in runs],
        "peak_memory_gib": peak,
        "launches": launches,
        "launches_per_image": {k: v / N_IMAGES for k, v in launches.items()},
    }), flush=True)
    print(json.dumps({
        "phase": "device_profile", "image_hw": list(images[0].shape[:2]),
        "wall_ms": wall, "device_busy_ms": busy,
        "device_idle_share": 1.0 - busy / wall, "kernels_ms": top,
    }), flush=True)
    # Random weights leave no detection at the reference thresholds, so no
    # survivor reaches K7 here: the loaded pass below requires it.
    exempt = {"survivor_rle": "0 detections at the reference thresholds "
                              "with random weights; required in "
                              "end_to_end_loaded"}
    print(json.dumps({"phase": "end_to_end launch check",
                      "exempt": exempt}), flush=True)
    missing = [k for k, v in launches.items() if v == 0 and k not in exempt]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")

    # With the pred-IoU and stability filters off the same model keeps
    # detections, and the survivor pass (cleanup, re-NMS, K7, RLE strings,
    # full-res boxes) runs at full width on them.
    model.engine_cfg = dataclasses.replace(
        reference_cfg, pred_iou_thresh=0.0, stability_score_thresh=0.0)
    loaded_cfg = model.engine_cfg
    scenes = [crowd_scene(20 + i, *hw)[0]
              for i, hw in enumerate(FRAME_SIZES[:N_IMAGES])]
    import crowdsam_tpu_torch.pipeline.crowdsam as pipeline

    _timed_generate(model, scenes[-1])     # warm-up of the survivor path
    rle_ms, survivor_ms = [], []

    def timed(fn, acc, sync):
        def wrapped(*a, **kw):
            if sync:
                torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            if sync:
                torch.cuda.synchronize()
            acc[-1] += (time.perf_counter() - t) * 1e3
            return out
        return wrapped

    # The product path, with only a host clock around the RLE strings
    # (which end in device-to-host copies, so they add no sync).
    counters = _reset_counts()
    loaded, survivors, nonempty = [], [], []
    with patched(model, "_rles", timed(model._rles, rle_ms, False)):
        for img in scenes:
            rle_ms.append(0.0)
            loaded.append(_timed_generate(model, img))
            # Rows of the post-NMS slab that enter the survivor pass.
            survivors.append(int((model.last_engine["summary"][:, 0] > 0.5)
                                 .sum()))
    loaded_launches = {k: fn.launches for k, fn in counters.items()}
    # The survivor pass's device time, from a second run of the same frames
    # synchronized around it.
    with patched(pipeline, "survivor_core",
                 timed(pipeline.survivor_core, survivor_ms, True)):
        for img in scenes:
            survivor_ms.append(0.0)
            _timed_generate(model, img)
    for (data, _), img in zip(loaded, scenes):
        nonempty.append(_check_rles(data, img))
    dets = [len(d["boxes"]) for d, _ in loaded]
    print(json.dumps({
        "phase": "end_to_end_loaded",
        "config": "as end_to_end, pred_iou_thresh 0, "
                  "stability_score_thresh 0; crowd scenes",
        "image_hw": [list(i.shape[:2]) for i in scenes],
        "ms_per_image": [ms for _, ms in loaded],
        "ms_per_image_mean": float(np.mean([ms for _, ms in loaded])),
        "host_rle_ms_per_image": rle_ms,
        "survivor_pass_ms_per_image": survivor_ms,
        "survivor_pass_covers": "cleanup, re-NMS, edits, K7; a second run, "
                                "synchronized around the pass",
        "detections_per_image": dets,
        "nonempty_masks_per_image": nonempty,
        "survivors_per_image": survivors,
        "launches": loaded_launches,
    }), flush=True)
    if min(dets) == 0:
        raise AssertionError(f"loaded pass: a frame without detections "
                             f"{dets}")
    missing = [k for k, v in loaded_launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched in the loaded pass: "
                             f"{missing}")
    phase_box_only(model, scenes[0])
    phase_fused_vs_unfused(model, scenes[0])
    phase_generate_many(model, reference_cfg, loaded_cfg)
    model.engine_cfg = reference_cfg
    return launches, loaded_launches


def phase_box_only(model, img):
    """`test.output_rles false` on one loaded frame against the default on
    the same frame and noise, the counts set to 0 just before the box-only
    run: K1-K6 must launch and K7 not; the detection count and scores must
    be equal.  The boxes differ: box-only ones are the low-res boxes times
    4, the default's come from the full-resolution masks."""
    noise = torch.rand(model.engine_cfg.grid_size ** 2,
                       generator=torch.Generator().manual_seed(9))
    rle, ms_rle = _timed_generate(model, img, noise)
    model.output_rles = False
    try:
        _timed_generate(model, img, noise)          # warm-up
        counters = _reset_counts()
        box, ms_box = _timed_generate(model, img, noise)
        launches = {k: fn.launches for k, fn in counters.items()}
    finally:
        model.output_rles = True
    n_r, n_b = len(rle["boxes"]), len(box["boxes"])
    same = n_r == n_b and np.array_equal(np.asarray(rle["scores"]),
                                         np.asarray(box["scores"]))
    row = {
        "phase": "box_only", "config": "as end_to_end_loaded, "
                                       "output_rles false",
        "image_hw": list(img.shape[:2]), "detections": [n_r, n_b],
        "scores_equal": same,
        "box_abs_diff_px_max": (float(np.abs(
            np.asarray(rle["boxes"]) - np.asarray(box["boxes"])).max())
            if same and n_b else None),
        "ms": [ms_rle, ms_box], "ms_covers": ["output_rles true", "false"],
        "launches": launches,
    }
    print(json.dumps(row), flush=True)
    if n_b == 0 or not same or any(r is not None for r in box["rles"]):
        raise AssertionError(f"box-only path differs from the default: {row}")
    wrong = [k for k, v in launches.items()
             if (v == 0) != (k == "survivor_rle")]
    if wrong:
        raise AssertionError(f"box-only launches: K7 must not launch, the "
                             f"others must: {wrong}")


def phase_generate_many(model, reference_cfg, loaded_cfg, n=8):
    """`generate_many` against `generate` on n seeded crowd scenes, the
    generator reset to one seed before each run so that both draw the same
    noise: equal boxes, scores and RLE strings, at the reference
    thresholds and with the filters off.  ms per image of `generate` from
    the host clock (synchronized), of `generate_many` from its
    `times_out`, and of both the wall time over n; beside them the host ms
    per image of the dispatch (encode, EPS loop) and of the tail (survivor
    pass, RLE) inside `generate`."""
    from crowdsam_tpu_torch.utils.synthetic import FRAME_SIZES, crowd_scene

    scenes = [crowd_scene(40 + i, *FRAME_SIZES[i % len(FRAME_SIZES)])[0]
              for i in range(n)]
    row = {"phase": "generate_many", "images": n}
    spans = {"dispatch": [], "tail": []}

    def timed(fn, acc):
        def wrapped(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            acc.append((time.perf_counter() - t) * 1e3)
            return out
        return wrapped

    for name, cfg in (("reference", reference_cfg), ("loaded", loaded_cfg)):
        model.engine_cfg = cfg
        with patched(model, "_dispatch_crop",
                     timed(model._dispatch_crop, spans["dispatch"])), \
                patched(model, "_finalize_crop",
                        timed(model._finalize_crop, spans["tail"])):
            model.generator.manual_seed(123)
            one = [_timed_generate(model, img) for img in scenes]
        host = {k: float(np.mean(v)) for k, v in spans.items()}
        for v in spans.values():
            v.clear()
        model.generator.manual_seed(123)
        times = []
        torch.cuda.synchronize()
        t = time.perf_counter()
        many = model.generate_many(scenes, times_out=times)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
        equal = len(many) == n and all(
            np.array_equal(a["boxes"], b["boxes"])
            and np.array_equal(a["scores"], b["scores"])
            and a["rles"] == b["rles"] for a, (b, _) in zip(many, one))
        row[name] = {
            "detections_per_image": [len(b["boxes"]) for b, _ in one],
            "generate_ms_per_image": [ms for _, ms in one],
            "generate_ms_per_image_mean": float(np.mean(
                [ms for _, ms in one])),
            "generate_many_ms_per_image": [x * 1e3 for x in times],
            "generate_many_wall_ms_per_image": wall / n,
            "generate_host_ms_per_image": host,
            "equal": equal,
        }
        if not equal:
            print(json.dumps(row), flush=True)
            raise AssertionError(f"generate_many differs from generate "
                                 f"({name})")
    print(json.dumps(row), flush=True)


def phase_fused_vs_unfused(model, img):
    """The fused decode (K5, K6, packed masks) against the unfused one (the
    plain `MaskDecoder`, spatial masks) at full width: same weights, frame
    and candidate order, the pred-IoU and stability filters off so that the
    slab holds valid rows.

    Tolerance: two bf16 paths that round at different places (the JAX
    package's CPU test of its tail kernel against its XLA path allows a
    median relative error of 0.02).  Required: equal consumed counts; the
    `valid` flags of the pre-NMS slab agree on >= 98% of the rows; over the
    rows valid in both, the fused IoU within 0.02 in the median and 0.12 at
    most, and the low-res boxes (256^2 frame) equal in the median and within
    one cell of the decoder's 64^2 grid (4 px) on >= 95% of the rows (a
    logit near 0 at a mask's edge flips with the rounding and moves that
    edge); equal detection counts."""
    noise = torch.rand(model.engine_cfg.grid_size ** 2,
                       generator=torch.Generator().manual_seed(7))
    out = {}
    for name, fused in (("fused", True), ("unfused", False)):
        model.engine_cfg = dataclasses.replace(model.engine_cfg,
                                               fused_decode=fused)
        _timed_generate(model, img, noise)           # warm-up
        data, ms = _timed_generate(model, img, noise)
        res = model.last_engine
        out[name] = dict(data=data, ms=ms, consumed=int(res["num_consumed"]),
                         **{k: v.float().cpu() for k, v in
                            res["pre_nms"].items()})
    model.engine_cfg = dataclasses.replace(model.engine_cfg,
                                           fused_decode=True)
    f, u = out["fused"], out["unfused"]
    both = (f["valid"] > 0.5) & (u["valid"] > 0.5)
    agree = float(((f["valid"] > 0.5) == (u["valid"] > 0.5)).float().mean())
    d_iou = (f["iou"] - u["iou"]).abs()[both]
    d_box = (f["boxes"] - u["boxes"]).abs().amax(dim=1)[both]
    n_f, n_u = len(f["data"]["boxes"]), len(u["data"]["boxes"])
    det_box = (float(np.abs(np.asarray(f["data"]["boxes"])
                            - np.asarray(u["data"]["boxes"])).max())
               if n_f == n_u and n_f else None)
    row = {
        "phase": "fused_vs_unfused", "image_hw": list(img.shape[:2]),
        "consumed": [f["consumed"], u["consumed"]],
        "slab_rows_valid_in_both": int(both.sum()),
        "valid_agreement": agree,
        "iou_abs_diff_median": float(d_iou.median()),
        "iou_abs_diff_max": float(d_iou.max()),
        "box_abs_diff_px_median": float(d_box.median()),
        "box_abs_diff_px_max": float(d_box.max()),
        "box_within_4px_share": float((d_box <= 4.0).float().mean()),
        "detections": [n_f, n_u], "detection_box_max_abs_diff_px": det_box,
        "ms_per_image": [f["ms"], u["ms"]],
    }
    print(json.dumps(row), flush=True)
    ok = (f["consumed"] == u["consumed"] and int(both.sum()) > 0
          and agree >= 0.98 and row["iou_abs_diff_median"] <= 0.02
          and row["iou_abs_diff_max"] <= 0.12
          and row["box_abs_diff_px_median"] == 0.0
          and row["box_within_4px_share"] >= 0.95 and n_f == n_u)
    if not ok:
        raise AssertionError(f"fused and unfused decode disagree: {row}")


def _small_config():
    """A small configuration with head dim 64 (SAM ViT-B at 256^2, DINOv2
    ViT-S/14; 256 image rows in the decoder), the IoU and stability filters
    off, so that random weights leave detections for the survivor pass."""
    from crowdsam_tpu_torch.config import modify_config
    from crowdsam_tpu_torch.utils.synthetic import full_width_config

    return modify_config(full_width_config(), [
        "model.sam_model", "vit_b", "model.image_size", "256",
        "model.dino_model", "dinov2_vits14", "test.max_size", "256",
        "test.grid_size", "48", "test.max_prompts", "64",
        "test.pred_iou_thresh", "0.0", "test.stability_score_thresh", "0.0",
    ])


def _small_image():
    from crowdsam_tpu_torch.utils.synthetic import synthetic_images

    return synthetic_images(1, 1)[0][:171, :256]


def phase_small_reference(gpu):
    """The small configuration: the card's bf16 kernel path (`gpu`, fused
    decode through K5 and K6) against the plain float32 path on the CPU,
    same weights."""
    from crowdsam_tpu_torch.config import modify_config
    from crowdsam_tpu_torch.pipeline.crowdsam import CrowdSAM

    cfg = _small_config()
    cpu_cfg = modify_config(cfg, ["tpu.compute_dtype", "float32"])
    cpu = CrowdSAM(cpu_cfg, device="cpu")
    cpu.sam.load_state_dict({k: v.float().cpu() for k, v in
                             gpu.sam.state_dict().items()})
    cpu.dino.load_state_dict({k: v.float().cpu() for k, v in
                              gpu.dino.state_dict().items()})
    img = _small_image()
    out = {}
    for name, m in (("gpu", gpu), ("cpu", cpu)):
        m.predictor.set_image_presized(img)
        out[name] = {
            "features": m.predictor.features.float().cpu(),
            "dino": m.predictor.dino_feats.float().cpu(),
            "fg": m.predictor.predict_fg_map().float().cpu(),
        }
    rel = {k: float((out["gpu"][k] - out["cpu"][k]).norm()
                    / out["cpu"][k].norm()) for k in out["cpu"]}
    det = gpu.generate(img)
    det_cpu = cpu.generate(img)
    n_gpu, n_cpu = len(det["boxes"]), len(det_cpu["boxes"])
    box_err = (float(np.abs(np.asarray(det["boxes"])
                            - np.asarray(det_cpu["boxes"])).max())
               if n_gpu == n_cpu and n_gpu else None)
    # Boxes of masks thresholded at 64^2 and drawn on the 256^2 frame: bf16
    # logits may move a mask edge by one low-res cell, 4 px.
    print(json.dumps({"phase": "small_reference", "relative_l2": rel,
                      "tol": 5e-2, "gpu_detections": n_gpu,
                      "cpu_detections": n_cpu, "box_max_abs_diff_px": box_err,
                      "box_tol_px": 4.0}), flush=True)
    if not all(v < 5e-2 for v in rel.values()):
        raise AssertionError(f"bf16 CUDA path far from the f32 CPU path: {rel}")
    if n_gpu == 0 or n_gpu != n_cpu or box_err > 4.0:
        raise AssertionError(f"detections differ: {n_gpu} on the card, "
                             f"{n_cpu} on the CPU, boxes {box_err} px apart")


# --------------------------------------------------------------------------
# K1 backward, the JAX package's weights, training, the shipped adapter
# --------------------------------------------------------------------------

def _ln_backward_faults(x, g, w, eps, blocks):
    """The plain backward with a known fault each: (label, dx, dw, db).
    The mean(g w xhat) term of dx dropped; one block's rows left out of the
    dw/db sums (the kernel's own block of rows, `blocks` of them); the rstd
    of the neighbouring row."""
    xf, gf = x.float(), g.float()
    mu = xf.mean(-1, keepdim=True)
    rstd = torch.rsqrt((xf - mu).square().mean(-1, keepdim=True) + eps)
    n = xf.shape[0]

    def dx_of(r, drop_c2=False):
        xh = (xf - mu) * r
        gw = gf * w
        a = gw.mean(-1, keepdim=True)
        c2 = 0.0 if drop_c2 else (gw * xh).mean(-1, keepdim=True)
        return (r * (gw - a - xh * c2)).to(x.dtype)

    xh = (xf - mu) * rstd
    dw, db = (gf * xh).sum(0), gf.sum(0)
    per = -(-n // blocks)
    k = blocks // 2
    rows = slice(k * per, min((k + 1) * per, n))
    dw_drop = dw - (gf[rows] * xh[rows]).sum(0)
    db_drop = db - gf[rows].sum(0)
    good = dx_of(rstd)
    return [("c2 term dropped", dx_of(rstd, True), dw, db),
            ("one block's partial left out", good, dw_drop, db_drop),
            ("rstd of the neighbouring row",
             dx_of(torch.roll(rstd, 1, 0)), dw, db)]


def phase_layernorm_backward(gen):
    """K1's backward against the plain version's autograd at the training
    step's shapes (full decoder, 60 prompts, bf16: norm4 245760x256, the
    token norms 420x256, the upscaling's 983040x64) and the DINOv2 width in
    float32: dx, dw and db each with a max and a mean bound, and faults of
    the kernel's design that must break them."""
    from crowdsam_tpu_torch.kernels import _build
    from crowdsam_tpu_torch.ops import layernorm as ln

    rows = []
    for n, d, dtype, eps in ((245760, 256, torch.bfloat16, 1e-5),
                             (983040, 64, torch.bfloat16, 1e-6),
                             (420, 256, torch.bfloat16, 1e-5),
                             (5330, 1024, torch.float32, 1e-6)):
        x = torch.randn((n, d), generator=gen, device="cuda").to(dtype)
        w = 1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
        b = 0.1 * torch.randn(d, generator=gen, device="cuda")
        g = torch.randn((n, d), generator=gen, device="cuda").to(dtype)
        _, mean, rstd = ln._forward(x, w, b, eps, stats=True)
        got = ln.layer_norm_backward(g, x, w, mean, rstd)
        want = ln.layer_norm_grads_plain(g, x, w, b, eps)
        blocks = _build.function("layernorm", "ln_backward_blocks",
                                 (ctypes.c_longlong,))(n)
        faults = _ln_backward_faults(x, g, w, eps, blocks)
        bf16 = dtype == torch.bfloat16
        # dx: both sides round one f32 value to x's dtype (one ulp apart at
        # most); dw, db: f32 sums over n rows in another order.
        out = {"dx": compare(
            f"ln_backward dx {n}x{d}", got[0], want[0],
            1e-2 if bf16 else 1e-5, [(f[0], f[1]) for f in faults],
            require_faults=False, mean_atol=1e-3 if bf16 else 1e-6,
            rtol=BF16_ULP if bf16 else 0.0)}
        for i, key in ((1, "dw"), (2, "db")):
            scale = float(want[i].abs().max())
            out[key] = compare(
                f"ln_backward {key} {n}x{d}", got[i], want[i], 2e-5 * scale,
                [(f[0], f[1 + i]) for f in faults], require_faults=False,
                mean_atol=4e-6 * scale, rtol=0.0)
        require_faults_seen(f"ln_backward {n}x{d}", out)
        again = ln.layer_norm_backward(g, x, w, mean, rstd)
        if not all(torch.equal(a, c) for a, c in zip(again, got)):
            raise AssertionError("ln_backward: two calls differ")
        wl, bl = w.to(dtype), b.to(dtype)
        _, mean2, rstd2 = torch.native_layer_norm(x, [d], wl, bl, eps)

        def library():
            return torch.ops.aten.native_layer_norm_backward(
                g, x, [d], mean2, rstd2, wl, bl, [True, True, True])

        t_k = time_ms(lambda: ln.layer_norm_backward(g, x, w, mean, rstd), 30)
        t_p = time_ms(lambda: ln.layer_norm_grads_plain(g, x, w, b, eps), 5)
        t_l = time_ms(library, 30)
        d_k = device_ms(lambda: ln.layer_norm_backward(g, x, w, mean, rstd),
                        30, "ln_bwd")
        d_l = device_ms(library, 30)
        esz = x.element_size()
        b_ms, by = bound(3 * n * d * esz + 8 * n + 3 * 4 * d, 12.0 * n * d,
                         F32_FLOP_PER_S)
        row = dict(shape=f"{n}x{d}", dtype=str(dtype).replace("torch.", ""),
                   max_abs_err=max(o["max_abs_err"] for o in out.values()),
                   err_over_tol={k: o["err_over_tol"] for k, o in
                                 out.items()},
                   fault_err_over_tol={k: o["fault_err_over_tol"] for k, o in
                                       out.items()},
                   tol={k: o["tol"] for k, o in out.items()},
                   deterministic=True, ms=t_k, device_ms=d_k, plain_ms=t_p,
                   library_ms=t_l, library_device_ms=d_l, bound_ms=b_ms,
                   bound_by=by, partial_blocks=blocks)
        rows.append(row)
        print(json.dumps({"phase": "K1 backward", **row}), flush=True)
        del x, g, got, want, faults
        torch.cuda.empty_cache()
    return rows


def phase_numpy_init():
    """The full-width model's weights, drawn on the host as the JAX package
    draws them (SAM ViT-L from seed 0, DINOv2 ViT-L/14 from environ.seed
    42): the draw's time, and each module's elements, sum and sum of squares
    against the manifest's checksums (numpy's draws are the same on any
    machine).  The draws stay cached for the models built after."""
    from crowdsam_tpu_torch.utils import init

    t = time.perf_counter()
    sam = init.sam_state_dict("vit_l", 0, None, 1, 1024)
    dino = init.dino_state_dict("dinov2_vitl14", 42)
    draw_s = time.perf_counter() - t
    want = init.manifest()["checksums"]
    got = {f"sam/vit_l/0/{k}": v for k, v in init.sam_checksums(sam).items()}
    got["dino/dinov2_vitl14/42"] = init.checksum(dino.values())
    rel = {}
    for key, (n, total, sq) in got.items():
        leaves, n_want, total_want, sq_want = want[key]
        if n != n_want:
            raise AssertionError(f"numpy init {key}: {n} elements, the "
                                 f"manifest {n_want}")
        rel[key] = max(abs(total - total_want) / abs(total_want),
                       abs(sq - sq_want) / abs(sq_want))
    row = {"phase": "numpy init", "draw_s": draw_s,
           "elements": {k: v[0] for k, v in got.items()},
           "leaves_in_manifest": {k: want[k][0] for k in got},
           "sum_sumsq_rel_diff": rel, "tol": 1e-9}
    print(json.dumps(row), flush=True)
    if max(rel.values()) > 1e-9:
        raise AssertionError(f"numpy init differs from the manifest: {row}")
    return row


def _train_run(model, cfg, label, data, plain_check=False):
    """One `AdapterTrainer.train` run of cfg's steps on `model` (whose
    decoder it trains in place), timed per step, with K1's launches."""
    from crowdsam_tpu_torch.ops import layernorm as ln
    from crowdsam_tpu_torch.train.trainer import AdapterTrainer

    trainer = AdapterTrainer(cfg, model.predictor)
    torch.cuda.synchronize()
    t = time.perf_counter()
    trainer.cache_features(data)
    torch.cuda.synchronize()
    cache_ms = (time.perf_counter() - t) * 1e3
    before = {k: v.clone() for k, v in
              model.sam.mask_decoder.state_dict().items()}
    check = None
    if plain_check:
        check = _plain_ln_gradients(trainer)
    step_ms, losses = [], []
    last = [time.perf_counter()]

    def on_step(step, ls):
        torch.cuda.synchronize()
        now = time.perf_counter()
        step_ms.append((now - last[0]) * 1e3)
        last[0] = now
        losses.append({k: float(v) for k, v in ls.items()})

    fwd, bwd = ln.layer_norm.launches, ln.layer_norm_backward.launches
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    last[0] = time.perf_counter()
    params = trainer.train(data, on_step=on_step)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = len(step_ms)
    launches = {"layer_norm": ln.layer_norm.launches - fwd,
                "layer_norm_backward": ln.layer_norm_backward.launches - bwd}
    after = model.sam.mask_decoder.state_dict()
    frozen_changed = [k for k in before if k not in params
                      and not torch.equal(after[k], before[k])]
    unmoved = [k for k in params if torch.equal(after[k], before[k])]
    finite = all(np.isfinite(v) for ls in losses for v in ls.values())
    row = {"phase": f"train {label}", "steps": steps,
           "trainable_leaves": len(params),
           "cache_features_ms": cache_ms,
           "cache_shots": len(trainer.cache["n_boxes"]),
           "ms_per_step": step_ms,
           "ms_per_step_median": float(np.median(step_ms[1:])),
           "peak_memory_gib": peak, "first_losses": losses[0],
           "last_losses": losses[-1], "launches": launches,
           "launches_per_step": {k: v / steps for k, v in launches.items()},
           "frozen_changed": frozen_changed, "trainable_unmoved": unmoved}
    if check is not None:
        row["plain_layer_norm_gradients"] = check
    print(json.dumps(row), flush=True)
    if frozen_changed or unmoved or not finite:
        raise AssertionError(f"train {label}: {row}")
    return row


def _plain_ln_gradients(trainer):
    """One full-decoder step's gradients through K1 (forward and
    backward) and through the plain LayerNorm (an explicit call), from the
    same parameters and draws: the largest difference over the global
    gradient norm."""
    import crowdsam_tpu_torch.models.common as common
    from crowdsam_tpu_torch.ops import layernorm as ln

    params = trainer.trainable_params()
    draws = trainer.draw(0)
    bwd = ln.layer_norm_backward.launches
    _, l_k, g_k = trainer.loss_and_grads(params, 0, draws)
    kernel_launches = ln.layer_norm_backward.launches - bwd
    with patched(common, "layer_norm", ln.layer_norm_plain):
        _, l_p, g_p = trainer.loss_and_grads(params, 0, draws)
    norm = float(torch.sqrt(sum(g.double().square().sum()
                                for g in g_p.values())))
    err = max(float((g_k[k] - g_p[k]).abs().max()) for k in g_p)
    row = {"max_abs_diff_over_global_norm": err / norm,
           "global_norm": norm, "tol": 2e-2,
           "loss_kernel": {k: float(v) for k, v in l_k.items()},
           "loss_plain": {k: float(v) for k, v in l_p.items()},
           "backward_launches_kernel_step": kernel_launches}
    if not err / norm <= 2e-2 or kernel_launches == 0:
        raise AssertionError(f"plain LayerNorm gradients: {row}")
    return row


def phase_train(model):
    """The 10-shot trainer at full width on the in-memory synthetic set
    (`ten_shot_arrays(0)`): 20 head-only steps at the config's lr, then 20
    with `train.full_decoder` at the bench recipe's lr 2e-4 (which runs
    every decoder LayerNorm through K1 forward and backward).  The model's
    decoder is trained in place; nothing after reads it."""
    import copy

    from crowdsam_tpu_torch.config import modify_config
    from crowdsam_tpu_torch.train.dataset import ArrayDataset
    from crowdsam_tpu_torch.utils.fixtures import ten_shot_arrays

    data = ArrayDataset(*ten_shot_arrays(0))
    head = modify_config(copy.deepcopy(model.config), ["train.steps", "20"])
    rows = {"head_only": _train_run(model, head, "head-only", data)}
    full = modify_config(copy.deepcopy(head), ["train.full_decoder", "True",
                                               "train.lr", "2e-4"])
    rows["full_decoder"] = _train_run(model, full, "full decoder", data,
                                      plain_check=True)
    return rows


def _match_share(boxes, golden, thr=0.5):
    """The share of `golden` boxes (xyxy, by falling score) matched one to
    one, greedily, by a box of `boxes` at IoU >= thr."""
    boxes = np.asarray(boxes, dtype=np.float64).reshape(-1, 4)
    golden = np.asarray(golden, dtype=np.float64).reshape(-1, 4)
    if len(golden) == 0:
        return None
    used = np.zeros(len(boxes), bool)
    hits = 0
    for gb in golden:
        if not len(boxes):
            break
        x0 = np.maximum(boxes[:, 0], gb[0])
        y0 = np.maximum(boxes[:, 1], gb[1])
        x1 = np.minimum(boxes[:, 2], gb[2])
        y1 = np.minimum(boxes[:, 3], gb[3])
        inter = np.clip(x1 - x0, 0, None) * np.clip(y1 - y0, 0, None)
        area = ((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
                + (gb[2] - gb[0]) * (gb[3] - gb[1]) - inter)
        iou = np.where(used, -1.0, inter / np.maximum(area, 1e-9))
        j = int(np.argmax(iou))
        if iou[j] >= thr:
            used[j] = True
            hits += 1
    return hits / len(golden)


def phase_loaded_reference(model):
    """The shipped adapter (`adapter_weights/10_shot.msgpack`, the JAX
    bench's decoder) on the JAX package's own random encoders, every filter
    at the defaults of `configs/crowdhuman.yaml`, on the JAX bench's golden
    frames `crowd_scene(0)` and `mid_scene(7)`: detections, ms per image,
    the survivor pass's ms, K7's launches, and the share of the JAX bench's
    golden boxes (`adapter_weights/bench_golden_detections.json`) matched
    at IoU >= 0.5.  The engine noise is the port's (not `jax.random`), so
    the counts are printed, not gated; crowd_scene(0) must give
    detections."""
    import crowdsam_tpu_torch.pipeline.crowdsam as pipeline
    from crowdsam_tpu_torch.utils.bench_fixture import crowd_scene, mid_scene

    with open("adapter_weights/bench_golden_detections.json") as f:
        golden = json.load(f)["regimes"]
    frames = [("crowded", "crowd_scene(0)", crowd_scene(0)[0]),
              ("sparse", "mid_scene(7)", mid_scene(7)[0])]
    _timed_generate(model, frames[0][2])                # warm-up
    out = []
    for regime, name, img in frames:
        counters = _reset_counts()
        data, ms = _timed_generate(model, img)
        k7 = counters["survivor_rle"].launches
        surv = [0.0]

        def timed_core(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = real_core(*a, **kw)
            torch.cuda.synchronize()
            surv[0] += (time.perf_counter() - t) * 1e3
            return res

        real_core = pipeline.survivor_core
        with patched(pipeline, "survivor_core", timed_core):
            _timed_generate(model, img)
        gold = golden[regime]
        if list(gold["hw"]) != list(img.shape[:2]):
            raise AssertionError(f"golden frame {regime}: {gold['hw']}")
        nonempty = _check_rles(data, img) if len(data["boxes"]) else 0
        out.append({"frame": name, "golden_regime": regime,
                    "detections": len(data["boxes"]),
                    "jax_bench_detections": len(gold["boxes"]),
                    "golden_matched_share_iou50": _match_share(
                        data["boxes"], gold["boxes"]),
                    "ms_per_image": ms, "survivor_pass_ms": surv[0],
                    "survivor_rle_launches": k7,
                    "nonempty_masks": nonempty})
    row = {"phase": "loaded at the reference thresholds",
           "adapter": "adapter_weights/10_shot.msgpack",
           "config": "configs/crowdhuman.yaml defaults, JAX-drawn encoders",
           "frames": out}
    print(json.dumps(row), flush=True)
    if out[0]["detections"] == 0:
        raise AssertionError(f"crowd_scene(0) gives no detection: {row}")
    return row


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; nothing to run")
        return 2
    from crowdsam_tpu_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    k6_job = start_gelu_probe()
    _build.build_all(ptxas_verbose=True)
    k6_probe = finish_gelu_probe(k6_job)
    log(f"kernels built in {time.time() - t0:.1f} s")
    for name, text in _build.BUILD_LOGS.items():
        log(f"--- ptxas {name}.cu\n{text}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    # Serving and the kernels without a backward run under no_grad; K1's
    # backward and the trainer take their gradients themselves.
    with torch.no_grad():
        phase_gelu(k6_probe)
        ln_rows = phase_layernorm(gen)
        k2 = phase_window(gen)
        k3 = phase_global(gen)
        k4 = phase_dino(gen)[0]
    ln_bwd_rows = phase_layernorm_backward(gen)
    torch.cuda.empty_cache()

    from crowdsam_tpu_torch.pipeline.crowdsam import CrowdSAM
    from crowdsam_tpu_torch.utils.synthetic import (
        full_width_config,
        synthetic_images,
    )

    phase_numpy_init()
    t0 = time.time()
    model = CrowdSAM(full_width_config(), device="cuda")
    small = CrowdSAM(_small_config(), device="cuda")
    torch.cuda.synchronize()
    log(f"models built in {time.time() - t0:.1f} s")
    frame = synthetic_images(3, 1)[0]
    with torch.no_grad():
        k5, tail_out = phase_twoway_tail(model, frame, "main path, M=4096")
        k6 = phase_mask_head(model, frame, "main path, M=4096", tail_out,
                             k6_probe)
        phase_twoway_tail_normal(model, frame)
        _, tail_small = phase_twoway_tail(small, _small_image(),
                                          "small, M=256")
        phase_mask_head(small, _small_image(), "small, M=256", tail_small,
                        k6_probe)
        del tail_out, tail_small
        torch.cuda.empty_cache()
        phase_survivor(1, 70)
        k7 = phase_survivor(32, 50)
        phase_survivor(model.engine_cfg.max_keep, 60)
        torch.cuda.empty_cache()
    launches, loaded_launches = phase_end_to_end(model)
    phase_small_reference(small)
    del small
    torch.cuda.empty_cache()
    train = phase_train(model)
    del model
    torch.cuda.empty_cache()
    adapted = phase_msgpack_adapter(frame)
    phase_loaded_reference(adapted)
    del adapted
    torch.cuda.empty_cache()

    ln = next(r for r in ln_rows if r["shape"] == "5330x1024")
    src_attn = "crowdsam_tpu_torch/csrc/attention.cu"
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    table = [
        dict(name="layer_norm", route="cuda",
             source="crowdsam_tpu_torch/csrc/layernorm.cu",
             replaces="crowdsam_tpu/ops/layernorm.py:34",
             launches=launches["layer_norm"],
             max_abs_err=max(r["max_abs_err"] for r in ln_rows),
             **{k: ln[k] for k in keys}, device_ms=ln["device_ms"],
             library_device_ms=ln["library_device_ms"]),
    ]
    bw = next(r for r in ln_bwd_rows if r["shape"] == "245760x256")
    table.append(dict(
        name="layer_norm_backward", route="cuda",
        source="crowdsam_tpu_torch/csrc/layernorm.cu",
        replaces="crowdsam_tpu/ops/layernorm.py:34",
        replaces_note="K1's backward: the Pallas kernel has no VJP; the "
                      "JAX trainer differentiates jnp _ln_impl "
                      "(crowdsam_tpu/models/common.py:33)",
        launches=train["full_decoder"]["launches"]["layer_norm_backward"],
        launches_in="train full decoder, 20 steps",
        max_abs_err=max(r["max_abs_err"] for r in ln_bwd_rows),
        **{k: bw[k] for k in keys}, device_ms=bw["device_ms"],
        library_device_ms=bw["library_device_ms"]))
    for name, src, rep, row, extra in (
            ("window_attention", src_attn,
             "crowdsam_tpu/models/attention.py:163", k2,
             ("wrapper_device_ms", "library_device_ms", "whole_fn_ms")),
            ("flash_mha_decomposed_relpos", src_attn,
             "crowdsam_tpu/models/attention.py:126", k3,
             ("wrapper_device_ms", "library_device_ms", "folded_form",
              "whole_fn_ms")),
            ("flash_mha", "crowdsam_tpu_torch/csrc/flash_sm90.cu",
             "crowdsam_tpu/models/attention.py:86", k4,
             ("library_device_ms", "kernel_over_library"))):
        table.append(dict(name=name, route="cuda", source=src,
                          replaces=rep, launches=launches[name],
                          max_abs_err=row["max_abs_err"],
                          **{k: row[k] for k in keys},
                          device_ms=row["device_ms"],
                          **{k: row[k] for k in extra}))
    for name, src, rep, row in (
            ("twoway_tail", "crowdsam_tpu_torch/csrc/decode_tail.cu",
             "crowdsam_tpu/models/decode_tail_kernel.py:359", k5),
            ("mask_head", "crowdsam_tpu_torch/csrc/mask_head.cu",
             "crowdsam_tpu/models/mask_head_kernel.py:165", k6)):
        table.append(dict(name=name, route="cuda", source=src, replaces=rep,
                          launches=launches[name],
                          max_abs_err=row["max_abs_err"],
                          **{k: row[k] for k in keys},
                          device_ms=row["device_ms"],
                          replaced_ms=row["replaced_ms"]))
    table[-2]["device_by_launch"] = k5["device_by_launch"]
    table.append(dict(name="survivor_rle", route="cuda",
                      source="crowdsam_tpu_torch/csrc/survivor.cu",
                      replaces="crowdsam_tpu/ops/survivor_kernel.py:231",
                      launches=loaded_launches["survivor_rle"],
                      launches_in="end_to_end_loaded",
                      max_abs_err=k7["max_abs_err"],
                      **{k: k7[k] for k in keys},
                      device_ms=k7["device_ms"],
                      replaced_ms=k7["replaced_ms"],
                      interpolate_threshold_ms=k7[
                          "interpolate_threshold_ms"]))
    print(json.dumps({"kernels": table}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
