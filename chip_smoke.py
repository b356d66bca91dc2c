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
   K1's forward (phases `K1 layer_norm`, `K1 1280`) is held with a max and
   a mean bound and faults of its design (a lane segment with the
   neighbouring row's statistics, w and b of another segment's columns,
   the last chunk or row group left unwritten), its layout (`ln_plan`)
   against the Python description the CPU tests check, and every K1
   instantiation's registers and spilled bytes (none may spill);
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
   Then the shipped adapter on those encoders at the reference thresholds
   on the JAX bench's golden frames: detections, their share of the JAX
   bench's golden boxes, ms per image, the survivor pass and K7.
   The user-facing paths, each with the counts set to 0 just before and
   read just after: the automatic mask generator on SAM ViT-L with that
   decoder (32 points a side, 64 a batch, coco_rle) at its default filters
   and loaded (filters off, cleanup at 100 px), K1-K3 required (phase
   `amg`); and the annotation job through the command-line tools in-process
   on 8 seeded frames written as a CrowdHuman-style dataset: `tools.test`
   with `configs/crowdhuman.yaml` as shipped (K1-K6 required, the result
   dicts equal to `generate_many` with the same noise), the COCO
   conversion, `tools.crowdhuman_eval` (AP, MR^-2, Recall, tp, fp; AP above
   0 required) and `tools.batch_eval --inline` printing the same metrics
   (phase `cli`);
   The other archs, each with the counts set to 0 just before and read
   just after: SAM ViT-H (width 1280, head dim 80) at full width and depth
   with the shipped adapter on the three frames, a loaded crowd scene and
   the rect encode of two frames 64 tall (phase `vit_h`: K1 must launch at
   width 1280 and K2/K3 at head dim 80 only, K3 in the columns form on
   64x48 and 64x44; the kernels K1 at 4096x1280 and K2/K3 at head dim 80
   are held against their plain versions beforehand, phases `K1 1280`,
   `K2 hd80`, `K3 hd80` and `K3 rect 64x48 hd80` / `64x44 hd80`, with two
   faults of the head's 16-dim slab besides those of their design; K3's
   also with four of its blocks of two consumers: the second consumer's
   fh from the first's Rh row, its QA from the first's, its rows stored
   at the first's tokens, a ring stage released after one consumer only;
   a head-dim-80 K3 kernel that ptxas reports spilling fails the phase),
   `sam_hq` on ViT-L (K5/K6 must not launch: the HQ
   decoder decodes unfused) and `mobile_sam` (K2/K3 must not);
   float32 on the card (`tpu.compute_dtype float32`): each float32 arm of
   K2-K4 (`csrc/attention_f32.cu`) at the float32 path's shapes against a
   float64 evaluation of the same function on the card, its max and mean
   error at most 2x the plain float32 version's and the faults of its
   design 8-fold over that (phases `K2 float32`, `K3 float32`, `K4
   float32`), K1's float32 forward (`K1 float32`); the float32 path with
   the unfused decode and the shipped adapter against the same run with
   the plain versions of K1-K4 patched in, a TF32 tripwire and the bf16
   main path's distance from it (`float32 path`); 3 float32 full-decoder
   steps against the CPU's (`train float32`); the AMG in float32 (`amg
   float32`); the float32 arms of K5 and K6 (`csrc/decode_tail_f32.cu`,
   `csrc/mask_head_f32.cu`, 3xTF32 on wgmma) against float64 in the same
   way at the fused decode's shapes (main path, small config, two images,
   a prompt shard, T = 8; phases `K5 float32`, `K6 float32`; the faults of
   their 3xTF32 models too, every HGMMA of their SASS TF32, no ptxas
   spill); the float32 path with the
   fused decode (its default) against its plain-patched run (K1-K6) and
   against the unfused float32 run (`float32 fused path`), batched at B =
   2 and prompt-sharded at M = 2 bit for bit against one process
   (`float32 batched`), and SAM ViT-H in float32 on one frame against its
   plain-patched run (`float32 vit_h`);
   the opt-in modes and the train-free branch, each with the counts set to
   0 just before and read just after: each mode alone on
   the main model, filters off, one crowd scene (`modes`: mask_selection
   max_area / min_area, accumulate_occupy, fuse_simmap, fullres_cleanup,
   under which K7 must not launch); `tpu.rect_encode` against the square
   encode on the three frames (`rect_encode`: the encode's device and
   host ms, ms per image, launches by shape and by K3's form; the kernels
   K2 on the bands' 56x70 / 70x56 grids, K3 at 44x64 / 48x64 (bias in
   registers) and 64x48 / 64x44 (bias in registers on the exchanged grid,
   read column by column, with faults of the exchange; the folded form
   timed beside), K4 at 3724 and 4016 tokens held against their plain
   versions beforehand, phases `K2 rect`, `K3 rect`, `K4 rect`; K2 and K3
   print each instantiation's shared memory, blocks an SM and spilled
   bytes);
   `configs/crowdhuman_trainfree.yaml` as shipped (`trainfree`: its
   missing reference feature's warning, then a template feature from a
   seeded scene; K4 48 launches a frame, the sim map against the CPU's
   float32) and `configs/crowdhuman_mc.yaml` (`crop_n_layers 1`: five
   crops, K4 120 launches);
   the serving export (`utils/export.py`, phase `export`): the main
   model's decoder exported with `torch.export` at 32 prompts and its
   serving head at one image (683x1024 output, a mask input; single-mask
   and with the extra metrics), each saved to bytes and loaded back, bit
   for bit against the eager module on the card, one K1 launch a call for
   each K1 node of the graph (10 / 12; K1 held at the serving head's
   widths 4 and 16 in phase `K1 layer_norm`), and the same program moved to
   the CPU within 5% relative L2; export, load and per-call times;
   the multi-device paths on `torch.distributed`, one process a rank
   (`parallel/launch.run_ranks`), gloo on this one card: K5 and K6 at a
   prompt shard's counts (16 and 8 prompts, 4 images x 8) against their
   plain versions (`K5/K6 prompt shards`); `install_prompt_sharding` at
   M = 2 on the main path's frames and a loaded crowd scene
   (`prompt_shard`); `ShardedPipeline` with the data axis (2, 1) at batch
   4 on 8 crowd scenes (and 7, a partial chunk) and the composed (2, 2)
   with the prompt axis (`data_shard`), each against this process's
   results on the same noise, every rank's equal to rank 0's, every
   kernel launched on every rank (counts set to 0 in the rank just before
   its run); `ShardedPipeline` with the spatial axis (`spatial_shard`: a
   (1, 2) mesh on the main path's frames and a loaded crowd scene, a (2, 2)
   mesh with the prompt axis on 4 loaded scenes; each rank encodes a band
   of token rows of SAM's ViT and DINOv2), against this process, every
   rank bit for bit rank 0, K3 4 and K4 24 launches a rank an image on
   band shapes, the features within 1e-2 relative L2 of this process's,
   the axis's all-reduces, bytes and peak memory a rank; K3 and K4 on the
   bands a rank holds at M = 2 are held against their plain versions
   beforehand (phases `K3 band`: rows 0-42 and 42-64 of the 64x64 grid,
   head dims 64 and 80, the folded form, and rows 21-42 at head dim 80, an
   odd band from an odd row; `K4 band`: tokens 0-2702 and
   2702-5330 of 5330), with a fault of the band (Rh from row 0 on) and
   against the same rows of the whole launch; the collectives on a
   one-rank NCCL group and one try of two NCCL ranks on the card, whose
   error is printed (`nccl_world1`); the ranks build the model from the
   weights this process drew (saved under a temporary directory) and load
   this process's kernel build;
3. checks the outputs: finite boxes and scores of the expected shapes inside
   the image, every RLE string's mask inside its detection's box, every
   AMG record's mask inside its bbox with its area, and, on a small
   configuration with head dim 64, the card's bf16 kernel path against the
   plain float32 path on the CPU, detections and AMG records included,
   and the same at head dim 80 (SAM ViT-H at 256^2), for the train-free
   branch (its sim map too), the rect encode, the full-resolution
   cleanup, `sam_hq`, `mobile_sam` and crop layers.

Prints the kernel table as one JSON line, the card's name and power limit,
and last `{"ok": true, "device": {...}}`.  Exits non-zero, printing no
result, when CUDA is absent or any phase fails.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import functools
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12      # dense bf16 tensor cores
# float32-accurate products on the tensor cores: three TF32 products
# (3xTF32, each operand split into hi + lo) at 495 TFLOP/s each, the
# least time of the float32 arms' products (K2-K6 f32).
F32_FLOP_PER_S = 495e12 / 3
FFMA_FLOP_PER_S = 67e12       # float32 elementwise work (CUDA cores)
N_IMAGES = 3
# The share of the small configuration's CPU AMG records that the card's
# records match at box IoU >= 0.9 (bf16 kernels against float32).
AMG_SMALL_MATCH_BOUND = 0.9
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


class NoDeviceRecords(AssertionError):
    """torch.profiler kept no record of the kernels asked for in any of
    its windows."""


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
        device = [ev for ev in prof.events()
                  if ev.device_type.name == "CUDA"]
        events = [ev for ev in device if match is None or match in ev.name]
        if events:
            return events
    raise NoDeviceRecords(
        f"no device activity {match!r} in {tries} profiles (the last: "
        f"{len(device)} device records, "
        f"{sorted({_kernel_name(ev.name) for ev in device})[:6]})")


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


def _relpos_bias(q, rh, rw, hw, terms=None, row0=0):
    """The rel-pos bias (..., Sq, S) built from q and the gathered tables,
    in q's dtype: the faults' bias (from float32 q) and the work a library
    call needs beside SDPA (from bf16 q); q holds grid rows from `row0` on
    (`relpos_attention_plain`).  `terms(fh, fw)`, when given, changes fh
    and fw first (a fault)."""
    from crowdsam_tpu_torch.models.attention import _rel_bias_terms

    h, w = hw
    hq = q.shape[-2] // w
    fh, fw = _rel_bias_terms(q, rh, rw, hw, row0)
    if terms is not None:
        fh, fw = terms(fh, fw)
    lead = q.shape[:-2]
    return (fh.reshape(*lead, hq, w, h, 1)
            + fw.reshape(*lead, hq, w, 1, w)).reshape(*lead, hq * w, h * w)


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


def _ptxas_report(lib: str = "attention") -> dict:
    """Registers and spilled bytes by kernel instantiation, from ptxas's
    report of the last verbose build of `csrc/<lib>.cu`: keys
    `flash_attn_relpos<MODE,NSLAB,HD,COLS>`, `flash_attn_relpos_wide<MODE>`
    and `window_attn_relpos<TK,HD>` from the mangled names' template
    arguments; K1's `ln_fwd_vec<T,L,VPL>`, `ln_fwd_direct<T,L,VPL>`,
    `ln_bwd_vec<T,L,VPL>`, `ln_rows<T,VPT>` and `ln_bwd_rows<T,VPT>` with
    T bf16 or f32; the float32 arms' `attn_f32<HD,RELPOS>`,
    `tok_stage<S>`, `tok_qkv<L>`, `tok_mlp<L>`, `t2i_merge<S>`,
    `row_phase<S>` and `mask_head_f32<EMIT_EXP>`."""
    from crowdsam_tpu_torch.kernels import _build

    out, name = {}, None
    for line in _build.BUILD_LOGS.get(lib, "").splitlines():
        m = re.search(r"Compiling entry function '_Z\w*?\d"
                      r"(flash_attn_relpos(?:_wide)?|window_attn_relpos"
                      r"|ln_fwd_vec|ln_fwd_direct|ln_bwd_vec|ln_bwd_rows"
                      r"|ln_rows|attn_f32|tok_stage|tok_mlp|tok_qkv"
                      r"|t2i_merge|row_phase|mask_head_f32)"
                      r"I(\w+?)EEv", line)
        if m:
            args = re.findall(r"L[ib](\d+)E", m.group(2) + "E")
            if m.group(1).startswith("ln_"):
                args.insert(0, "bf16" if m.group(2).startswith(
                    "13__nv_bfloat16") else "f32")
            name = f"{m.group(1)}<" + ",".join(args) + ">"
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name is not None:
            out[name] = dict(spill_store_bytes=int(m.group(1)),
                             spill_load_bytes=int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name in out:
            out[name]["registers"] = int(m.group(1))
            name = None
    return out


def _ptxas_spills(lib: str = "attention") -> dict:
    """Spilled bytes (stores, loads) by kernel instantiation
    (`_ptxas_report`)."""
    return {k: [v["spill_store_bytes"], v["spill_load_bytes"]]
            for k, v in _ptxas_report(lib).items()}


def _instantiation(head_dim: int, form: str, arg: int) -> dict:
    """One K2/K3 kernel instantiation's dynamic shared memory, blocks an SM
    (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`, through the source's
    `relpos_occupancy`) and the bytes ptxas reported spilled: K3 in `form`
    (`arg`: FOLD's 64-dim slabs of the bias terms, else 1), K2 (`form`
    "window") for windows of `arg` x `arg`."""
    from crowdsam_tpu_torch.kernels import _build
    from crowdsam_tpu_torch.models.attention import _FORM_MODES

    fn = _build.function("attention", "relpos_occupancy",
                         (ctypes.c_int, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p))
    out = (ctypes.c_int * 2)()
    window = form == "window"
    _build.check(fn(head_dim, 3 if window else _FORM_MODES[form], arg,
                    ctypes.cast(out, ctypes.c_void_p)),
                 f"relpos_occupancy {form} {arg}")
    if window:
        name = f"window_attn_relpos<{112 if arg * arg <= 224 else 128}," \
               f"{head_dim}>"
    elif head_dim == 80 and form != "fold":
        name = f"flash_attn_relpos_wide<{_FORM_MODES[form]}>"
    else:
        name = (f"flash_attn_relpos<{0 if form != 'fold' else 1},"
                f"{arg if form == 'fold' else 1},{head_dim},"
                f"{int(form == 'columns')}>")
    spills = _ptxas_spills().get(name)
    if head_dim == 80 and not window and spills and any(spills):
        raise AssertionError(f"{name}: ptxas spilled {spills} bytes (stores, "
                             f"loads); K3's head-dim-80 kernels spill none")
    return dict(kernel=name, smem_bytes=out[0], blocks_per_sm=out[1],
                spill_store_bytes=None if spills is None else spills[0],
                spill_load_bytes=None if spills is None else spills[1])


# --------------------------------------------------------------------------
# kernel phases
# --------------------------------------------------------------------------

# The K2/K3 figures each row of the kernel table carries beside the contract's.
RELPOS_EXTRA = ("wrapper_device_ms", "library_device_ms",
                "kernel_over_library_device", "whole_fn_ms", "instantiations")

K1_PLAN_KEYS = ("lanes", "vectors_per_lane", "warps", "rows_per_group",
                "chunk_rows", "blocks", "spread", "smem_bytes",
                "blocks_per_sm", "sms", "direct")


def _k1_plan(backward: bool, n: int, d: int, dtype) -> dict:
    """How K1's forward (or backward) lays out n x d rows on this card (the
    source's `ln_plan`; `spread`: the forward's chunks, the backward's rows
    a block), held against the Python description the CPU tests check
    (`ops.layernorm.forward_plan` / `backward_plan`)."""
    from crowdsam_tpu_torch.kernels import _build
    from crowdsam_tpu_torch.ops import layernorm as ln

    fn = _build.function("layernorm", "ln_plan",
                         (ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p))
    out = (ctypes.c_longlong * len(K1_PLAN_KEYS))()
    _build.check(fn(int(backward), n, d, ln._DTYPES[dtype],
                    ctypes.cast(out, ctypes.c_void_p)), "ln_plan")
    plan = dict(zip(K1_PLAN_KEYS, (int(v) for v in out)))
    want = (ln.backward_plan(n, d, dtype, plan["sms"]) if backward else
            ln.forward_plan(n, d, dtype, plan["sms"], plan["blocks_per_sm"]))
    got = dict(arm=(plan["lanes"], plan["vectors_per_lane"])
               if plan["lanes"] else None,
               rows_per_group=plan["rows_per_group"],
               chunk_rows=plan["chunk_rows"], grid=plan["blocks"],
               direct=bool(plan["direct"]),
               **{("rows_per_block" if backward else "chunks"):
                  plan["spread"]})
    if got != want:
        raise AssertionError(f"K1 plan {n}x{d}: the source's {got}, the "
                             f"Python description's {want}")
    return plan


def _k1_kernel(backward: bool, d: int, dtype, plan: dict) -> str:
    """The name of the K1 instantiation a call launches (as
    `_ptxas_report` names it)."""
    t = "bf16" if dtype == torch.bfloat16 else "f32"
    if plan["lanes"]:
        kind = "bwd_vec" if backward else (
            "fwd_direct" if plan["direct"] else "fwd_vec")
        return (f"ln_{kind}<{t},{plan['lanes']},"
                f"{plan['vectors_per_lane']}>")
    vpt = next(v for v, top in ((2, 64), (4, 128), (8, 256), (16, 512),
                                (32, 1024), (40, 1280)) if d <= top)
    return f"ln_{'bwd_rows' if backward else 'rows'}<{t},{vpt}>"


def _k1_instantiations(backward: bool, n: int, d: int, dtype):
    """The layout of one K1 call and its instantiation's registers and
    spilled bytes; and every K1 instantiation's from the build's ptxas
    report.  A K1 instantiation that spills fails the phase."""
    report = _ptxas_report("layernorm")
    spilled = {k: v for k, v in report.items()
               if v["spill_store_bytes"] or v["spill_load_bytes"]}
    if not report or spilled:
        raise AssertionError(f"K1: ptxas report {report or 'missing'}; "
                             f"spilled: {spilled}")
    plan = _k1_plan(backward, n, d, dtype)
    kernel = _k1_kernel(backward, d, dtype, plan)
    return dict(kernel=kernel, **plan, **report.get(kernel, {})), report


def _ln_forward_faults(x, w, b, eps, plan):
    """The plain forward with a known fault of K1's design each: a lane
    segment that takes the neighbouring row's statistics (every odd row the
    row before's); w and b of another segment's columns (the next 16-byte
    vector's, the next column's on the scalar arm); the last chunk of the
    grid left unwritten (zeros from its first row); the last row group
    left unwritten."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    rstd = torch.rsqrt((xf - mu).square().mean(-1, keepdim=True) + eps)
    n = x.shape[0]

    def y_of(m, r, w_=w, b_=b):
        return ((xf - m) * r * w_ + b_).to(x.dtype)

    prev = torch.arange(n, device=x.device)
    prev[1::2] -= 1
    vec = 16 // x.element_size() if plan["lanes"] else 1
    good = y_of(mu, rstd)
    chunk = good.clone()
    chunk[(n - 1) // plan["chunk_rows"] * plan["chunk_rows"]:] = 0
    group = good.clone()
    group[(n - 1) // plan["rows_per_group"] * plan["rows_per_group"]:] = 0
    return (("a segment takes the neighbouring row's statistics",
             y_of(mu[prev], rstd[prev])),
            ("w and b of another segment's columns",
             y_of(mu, rstd, torch.roll(w, -vec), torch.roll(b, -vec))),
            ("the last chunk left unwritten", chunk),
            ("the last row group left unwritten", group))


# K1's forward launches by shape (rows x width) of the runs named by key,
# filled by `end_to_end` (the main path) and `fused_vs_unfused` (the
# unfused decode), read by the kernel table.
K1_SHAPES = {}


@contextlib.contextmanager
def k1_by_shape(key: str):
    """K1's forward launches by shape inside the block, into
    `K1_SHAPES[key]`: the op's launch `ops.layernorm._forward` wrapped for
    the block alone (the port counts K1 by width; a count by shape would
    be host work on every call of the main path)."""
    from crowdsam_tpu_torch.ops import layernorm as ln

    seen = K1_SHAPES.setdefault(key, collections.Counter())
    real = ln._forward

    def counted(x, weight, bias, eps, stats):
        d = x.shape[-1]
        seen[f"{x.numel() // d}x{d}"] += 1
        return real(x, weight, bias, eps, stats)

    with patched(ln, "_forward", counted):
        yield seen


def _k1_custom_op():
    """K1's launch registered through `torch.library.custom_op`, the other
    way to bind it, to time its dispatch beside the port's define + impl
    op (phase `K1 layer_norm`)."""
    from crowdsam_tpu_torch.ops import layernorm as ln

    @torch.library.custom_op("chip_smoke::k1_custom_op", mutates_args=())
    def k1(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           eps: float) -> torch.Tensor:
        return ln._forward(x, weight, bias, eps, stats=False)[0]

    return k1


def phase_layernorm(gen):
    from crowdsam_tpu_torch.ops import layernorm as ln
    from crowdsam_tpu_torch.ops.layernorm import layer_norm, layer_norm_plain

    rows = []
    report = None
    # SAM blocks, DINOv2 blocks, the neck, the decoder's norm4 on keys, the
    # decoder's upscaling ChannelLayerNorm; SAM ViT-H's blocks (phase `K1
    # 1280`); the serving head's mask downscaling (widths 4 and 16).
    for n, d, eps in ((4096, 1024, 1e-6), (5330, 1024, 1e-6),
                      (4096, 256, 1e-6), (131072, 256, 1e-5),
                      (524288, 64, 1e-6), (4096, 1280, 1e-6),
                      (16384, 4, 1e-6), (4096, 16, 1e-6)):
        x = torch.randn((n, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        w = 1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
        b = 0.1 * torch.randn(d, generator=gen, device="cuda")
        want = layer_norm_plain(x, w, b, eps)
        got = layer_norm(x, w, b, eps)
        inst, report = _k1_instantiations(False, n, d, x.dtype)
        # Outputs of rms ~1: both sides round f32 values that differ in the
        # last bits to bf16, one ulp apart at most, and few of them: a
        # mean error of 2e-4 is ~50 such ulps in 10^4 elements.  The faults
        # of the kernel's design must break the bound.
        cmp = compare(f"layer_norm {n}x{d}", got, want, 1e-2,
                      _ln_forward_faults(x, w, b, eps, inst),
                      mean_atol=2e-4)
        wb, bb = w.to(torch.bfloat16), b.to(torch.bfloat16)
        t_k = time_ms(lambda: layer_norm(x, w, b, eps), 50)
        t_p = time_ms(lambda: layer_norm_plain(x, w, b, eps), 10)
        t_l = time_ms(lambda: torch.nn.functional.layer_norm(
            x, (d,), wb, bb, eps), 50)
        d_k = device_ms(lambda: layer_norm(x, w, b, eps), 50, "ln_")
        d_l = device_ms(lambda: torch.nn.functional.layer_norm(
            x, (d,), wb, bb, eps), 50)
        b_ms, by = bound(2 * n * d * 2 + 2 * d * 4, 8.0 * n * d,
                         FFMA_FLOP_PER_S)
        rows.append(dict(shape=f"{n}x{d}", **cmp, ms=t_k, device_ms=d_k,
                         plain_ms=t_p, library_ms=t_l,
                         library_device_ms=d_l, bound_ms=b_ms,
                         bound_by=by, instantiation=inst))
        if (n, d) == (5330, 1024):
            # The wrapper's cost of the dispatcher: K1 launched through the
            # op (`layer_norm`), the same launch called directly, and the
            # same launch registered by `torch.library.custom_op` (the
            # registration not chosen), in turns.
            custom_op = _k1_custom_op()
            fns = {"op": lambda: layer_norm(x, w, b, eps),
                   "direct_launch": lambda: ln._forward(x, w, b, eps,
                                                        stats=False),
                   "custom_op": lambda: custom_op(x, w, b, eps)}
            times = {k: [] for k in fns}
            for _ in range(5):
                for k, fn in fns.items():
                    times[k].append(time_ms(fn, 50))
            rows[-1].update({f"ms_{k}_median": float(np.median(t))
                             for k, t in times.items()})
        name = "K1 1280" if d == 1280 else "K1 layer_norm"
        print(json.dumps({"phase": name, **rows[-1]}), flush=True)
    print(json.dumps({"phase": "K1 instantiations",
                      "instantiations": report}), flush=True)
    return rows


def _slab_faults(q, v, attend):
    """Faults of head dim 80's second slab (dims 64-79): its k-step left
    out of Q K^T (q.k over dims 0-63, the bias terms from the whole q), and
    V's slab misaligned (its two 16-byte chunks swapped).  `attend(q, v)`
    runs the plain attention on the faulty operands."""
    q_cut = q.clone()
    q_cut[..., 64:] = 0
    v_sw = v.clone()
    v_sw[..., 64:72], v_sw[..., 72:80] = v[..., 72:80], v[..., 64:72]
    return (("the 16-dim slab left out of Q K^T", attend(q_cut, v)),
            ("V's 16-dim slab misaligned (its 16-byte chunks swapped)",
             attend(q, v_sw)))


def _pair_faults(q, k, v, scale, rh, rw, hw, form, want, row0=0):
    """Faults of K3's head-dim-80 blocks (`flash_attn_relpos_wide`), whose
    two consumers hold the exchanged grid's rows 2x and 2x + 1 (grid rows
    from `row0` on; the columns form: grid columns) and share the K/V
    ring: the second consumer's fh from the first's Rh row, or its QA (the
    folded term) from the first's; the second's output rows stored at the
    first's tokens (its own never written); a ring stage released after
    one consumer only (the second's V of every key tile from the tile three
    on, the stage's next occupant)."""
    h, w = hw
    lead, d = q.shape[:-2], q.shape[-1]
    cols = form == "columns"
    hq = q.shape[-2] // w
    # The exchanged rows' axis of a (..., hq, w, x) view of the queries.
    axis = -2 if cols else -3
    qf = q.float()

    def from_first(x, ax):
        """x with each odd entry along `ax` replaced by the one before."""
        odd = torch.arange(1, x.shape[ax], 2, device=x.device)
        return x.index_copy(ax % x.dim(), odd,
                            x.index_select(ax % x.dim(), odd - 1))

    def attend(rh_=rh, rw_=rw, terms=None, vv=v):
        bias = _relpos_bias(qf, rh_, rw_, hw, terms, row0)
        out = _attention_plain(q, k, vv, scale, bias)
        del bias
        return out

    def second(x):                # the second consumers' rows of x
        odd = torch.zeros(hq, w, 1, dtype=torch.bool, device=x.device)
        if cols:
            odd[:, 1::2] = True
        else:
            odd[1::2] = True
        return odd.reshape(hq * w, 1)

    # Rh[row] (columns: Rw[column]) of the first consumer's row.
    if cols:
        table_fault = attend(rw_=from_first(rw, 0))
    else:
        rows = torch.arange(row0 + 1, row0 + hq, 2, device=rh.device)
        rh_f = rh.clone()
        rh_f[rows] = rh[rows - 1]
        table_fault = attend(rh_=rh_f)

    def qa_from_first(fh, fw):    # the folded term: fw (columns: fh)
        t = fh if cols else fw
        t = from_first(t.reshape(*lead, hq, w, t.shape[-1]), axis).reshape(
            t.shape)
        return (t, fw) if cols else (fh, t)

    grid = want.float().reshape(*lead, hq, w, d)
    odd = torch.arange(1, grid.shape[axis], 2, device=grid.device)
    stored = grid.index_copy(axis % grid.dim(), odd - 1,
                             grid.index_select(axis % grid.dim(), odd))
    stored = stored.index_fill(axis % grid.dim(), odd, 0.0)
    # The stage's next occupant: key tile j + 3 (128 tokens a tile;
    # columns: two grid columns a tile).
    v_next = v.clone()
    if cols:
        vg, vn = v.reshape(*lead, h, w, d), v_next.reshape(*lead, h, w, d)
        vn[..., :, :w - 6, :] = vg[..., :, 6:, :]
    else:
        v_next[..., :-384, :] = v[..., 384:, :]
    early = torch.where(second(want), attend(vv=v_next), want.float())
    return (("the second consumer's fh from the first's Rh row",
             table_fault),
            ("the second consumer's QA from the first's",
             attend(terms=qa_from_first)),
            ("the second consumer's rows stored at the first's tokens",
             stored.reshape(want.shape)),
            ("a ring stage released after one consumer only (the second's "
             "V of each key tile from the tile 3 on)", early))


def phase_window(gen, hd=64, grid=(70, 70), label=None):
    """K2 at SAM ViT-B/L's head dim 64, or ViT-H's 80 (phase `K2 hd80`), on
    the main path's 70x70 padded grid, a rect encode's band (phase `K2
    rect HpxWp`) or the windows a spatial band touches (`label`)."""
    from crowdsam_tpu_torch.models.attention import (
        window_attention,
        window_attention_plain,
        window_partition,
        window_unpartition,
    )
    from crowdsam_tpu_torch.models.image_encoder import _rel_pos_table

    ws, heads = 14, 16
    gh, gw = grid
    dim, n = heads * hd, ws * ws
    qkv = torch.randn((1, gh, gw, 3 * dim), generator=gen,
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
                                  ws, gh, gw)

    def faulty(terms=None, drop=None, tables=(rh, rw), qq=q, vv=v):
        bias = _relpos_bias(qf, *tables, (ws, ws), terms)
        return as_grid(_attention_plain(qq, k, vv, scale, bias, drop))

    rh_next = torch.zeros_like(rh)
    rh_next[:-1] = rh[1:]
    rms = float(want.float().square().mean().sqrt())
    # Outputs of rms ~0.18, up to ~3: atol ~8% of the rms, the mean error
    # 1.5% of it.  The kernel's error (bf16 probabilities into PV, bf16
    # fh/fw) stays well inside both; every fault of the kernel's design
    # must break the bound 8-fold.
    faults = (
        ("last key tile (keys 128-195) dropped",
         faulty(drop=slice(128, n))),
        ("rel-pos tables swapped", faulty(tables=(rw, rh))),
        ("one-hot key columns shifted by one (col(k) + 1)",
         faulty(terms=lambda fh, fw: (fh, _shift_last(fw, 1)))),
        ("fh selected from the next window row's table tile",
         faulty(tables=(rh_next, rw))),
    )
    if hd == 80:
        faults += _slab_faults(q, v, lambda qq, vv: faulty(qq=qq, vv=vv))
        # Head dim 80 lays Rh's slab over QA: QA written before every warp's
        # G = Q Rh^T has read it leaves fh without dims 64-79 of Rh.
        rh_cut = rh.clone()
        rh_cut[..., 64:] = 0
        faults += (("Rh's 16-dim slab overwritten before G = Q Rh^T read it "
                    "(fh from dims 0-63 of Rh)",
                    faulty(tables=(rh_cut, rw))),)
    cmp = compare(f"window_attention hd {hd}", got, want, 1.5e-2,
                  faults=faults, mean_atol=0.015 * rms, min_fault=8.0)
    del faults
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
    nw = (gh // ws) * (gw // ws)
    flops = nw * heads * (4 * n * n * hd + 2 * 2 * n * ws * hd)
    nbytes = qkv.numel() * 2 + gh * gw * dim * 2 + 2 * rh.numel() * 4
    b_ms, by = bound(nbytes, flops, BF16_FLOP_PER_S)
    row = dict(shape=f"{nw}x{heads}x{n}x{hd}", **cmp, ms=t_k, device_ms=d_k,
               **extra, plain_ms=t_p, library_ms=t_l,
               kernel_over_library_device=d_k / extra["library_device_ms"],
               instantiations=[_instantiation(hd, "window", ws)],
               library_covers="SDPA on the partitioned windows with the bias "
                              "built beforehand",
               whole_fn_ms=t_w,
               whole_fn_covers="partition + bias from q and tables + SDPA + "
                               "unpartition (several PyTorch calls)",
               whole_fn_max_abs_err=whole_err, bound_ms=b_ms, bound_by=by)
    name = label or ("K2 hd80" if hd == 80 else "K2 window_attention"
                     if grid == (70, 70) else f"K2 rect {gh}x{gw}")
    print(json.dumps({"phase": name, **row}), flush=True)
    return row


def phase_global(gen, hd=64, hw=(64, 64)):
    """K3 at SAM ViT-B/L's head dim 64, or ViT-H's 80 (phase `K3 hd80`), on
    SAM's 64x64 grid or a rect encode's (phase `K3 rect HxW`), in the form
    `relpos_form` picks (the bias in registers on a grid 64 wide or on the
    exchange of one 64 tall; else folded), the folded form timed beside it;
    its tables those of the 64-wide model resized to the grid as the
    encoder resizes them."""
    from crowdsam_tpu_torch.models.attention import (
        flash_mha_decomposed_relpos,
        relpos_attention_columns,
        relpos_attention_plain,
        relpos_form,
        relpos_global_launch,
        to_columns,
    )
    from crowdsam_tpu_torch.models.image_encoder import _rel_pos_table

    g, heads = 64, 16
    hh, ww = hw
    s, dim = hh * ww, heads * hd
    qkv = torch.randn((1, s, 3 * dim), generator=gen, device="cuda").to(
        torch.bfloat16)
    q, k, v = qkv.reshape(1, s, 3, heads, hd).permute(2, 0, 3, 1, 4)
    p_h, p_w = (0.1 * torch.randn((2 * g - 1, hd), generator=gen,
                                  device="cuda") for _ in range(2))
    rh, rw = _rel_pos_table(p_h, hh), _rel_pos_table(p_w, ww)
    scale = hd ** -0.5
    form = relpos_form(hh, ww, s)
    want = relpos_attention_plain(q, k, v, scale, rh, rw, hw)
    got = flash_mha_decomposed_relpos(q, k, v, scale, rh, rw, hw)
    qf = q.float()

    def faulty(terms=None, drop=None, qq=q, vv=v):
        bias = _relpos_bias(qf, rh, rw, hw, terms)
        out = _attention_plain(qq, k, vv, scale, bias, drop)
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
        (f"last key tile (keys {s - 128}-{s - 1}) dropped",
         faulty(drop=slice(s - 128, s))),
        ("rel-pos tables swapped" if hh == ww else
         "rel-pos tables from the neighbouring grid row and column",
         relpos_attention_plain(q, k, v, scale, rw, rh, hw) if hh == ww
         else relpos_attention_plain(q, k, v, scale, rh.roll(1, 0),
                                     rw.roll(1, 0), hw)),
        ("fw taken from the neighbouring column (col(k) + 1)",
         faulty(terms=lambda fh, fw: (fh, _shift_last(fw, 1)))),
        ("a 128-key tile's second half given its first half's grid row",
         faulty(terms=second_half_as_first)),
    )
    if form == "columns":
        # The exchange's own faults: the grid exchanged but each axis's
        # table built from the other axis's parameters (Rh and Rw not
        # exchanged), and the output rows left in column order (stored in
        # the exchanged grid's order); on the exchanged grid a key tile is
        # two grid columns, and the folded term is fh.
        def second_column_as_first(fh, fw):
            fw = fw.clone()
            fw[..., 1::2] = fw[..., 0::2]
            return fh, fw

        faults += (
            ("Rh and Rw not exchanged",
             relpos_attention_columns(q, k, v, scale, _rel_pos_table(p_w, hh),
                                      _rel_pos_table(p_h, ww), hw)),
            ("output rows stored in grid order (not exchanged back)",
             to_columns(want, hw)),
            ("fh taken from the neighbouring row (row(k) + 1)",
             faulty(terms=lambda fh, fw: (_shift_last(fh, 1), fw))),
            ("a 128-key tile's second half given its first half's grid "
             "column", faulty(terms=second_column_as_first)),
        )
    if hd == 80:
        faults += _slab_faults(q, v, lambda qq, vv: faulty(qq=qq, vv=vv))
        if form != "fold":
            faults += _pair_faults(q, k, v, scale, rh, rw, hw, form, want)
    cmp = compare(f"flash_mha_decomposed_relpos hd {hd} {hh}x{ww}", got, want,
                  6e-3, faults=faults, mean_atol=0.015 * rms, min_fault=8.0)
    forms = {"grid64": "bias in registers",
             "columns": "bias in registers on the exchanged grid, read "
                        "column by column",
             "fold": "folded"}
    nslab = 1 if hh + ww <= 64 else 2
    instantiations = [_instantiation(hd, form, nslab if form == "fold"
                                     else 1)]
    folded = {}
    if form != "fold":
        # The folded form (the kernel's path for grids neither 64 wide nor
        # 64 tall) on the same inputs: held to the same bound, and timed
        # beside the main form.
        fold = relpos_global_launch(q, k, v, scale, rh, rw, hw, "fold")
        cmp_fold = compare("flash_mha_decomposed_relpos (folded form)", fold,
                           want, 6e-3, faults=faults, mean_atol=0.015 * rms,
                           min_fault=8.0)
        del fold
        folded = dict(folded_form=dict(
            device_ms=device_ms(lambda: relpos_global_launch(
                q, k, v, scale, rh, rw, hw, "fold"), 10,
                "flash_attn_relpos"),
            err_over_tol=cmp_fold["err_over_tol"],
            max_abs_err=cmp_fold["max_abs_err"]))
        instantiations.append(_instantiation(hd, "fold", nslab))
    del faults
    t_k = time_ms(lambda: flash_mha_decomposed_relpos(q, k, v, scale, rh, rw,
                                                      hw), 10)
    d_k = device_ms(lambda: flash_mha_decomposed_relpos(
        q, k, v, scale, rh, rw, hw), 10, "flash_attn_relpos")
    t_p = time_ms(lambda: relpos_attention_plain(q, k, v, scale, rh, rw,
                                                 hw), 3)
    bias16 = _relpos_bias(qf, rh, rw, hw).to(torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    t_l = time_ms(lambda: sdpa(q, k, v, attn_mask=bias16, scale=scale), 10)
    extra = _relpos_extra(
        lambda: flash_mha_decomposed_relpos(q, k, v, scale, rh, rw, hw),
        lambda: sdpa(q, k, v, attn_mask=bias16, scale=scale), 10)
    del bias16

    def whole():    # bias from q and the tables, then SDPA
        return sdpa(q, k, v, scale=scale,
                    attn_mask=_relpos_bias(q, rh, rw, hw))
    whole_err = float((whole().float() - want.float()).abs().max())
    t_w = time_ms(whole, 10)
    flops = heads * (4 * s * s * hd + 2 * s * (hh + ww) * hd)
    nbytes = qkv.numel() * 2 + s * dim * 2 + (rh.numel() + rw.numel()) * 4
    b_ms, by = bound(nbytes, flops, BF16_FLOP_PER_S)
    row = dict(shape=f"{heads}x{s}x{hd}", grid=f"{hh}x{ww}",
               form=forms[form], **cmp, ms=t_k, device_ms=d_k,
               **extra, plain_ms=t_p, library_ms=t_l,
               kernel_over_library_device=d_k / extra["library_device_ms"],
               library_covers="SDPA with the bias built beforehand",
               **folded, instantiations=instantiations,
               whole_fn_ms=t_w,
               whole_fn_covers="bias from q and tables + SDPA (several "
                               "PyTorch calls)",
               whole_fn_max_abs_err=whole_err, bound_ms=b_ms, bound_by=by)
    name = ("K3 hd80" if hd == 80 and hw == (g, g)
            else "K3 flash_mha_decomposed_relpos" if hw == (g, g)
            else f"K3 rect {hh}x{ww}" + (f" hd{hd}" if hd == 80 else ""))
    print(json.dumps({"phase": name, **row}), flush=True)
    return row


def _k4_case(gen, s, heads=16, hd=64, band=None):
    """K4 at (heads, s, hd) on strided views of one qkv buffer, as DINOv2
    hands them over: against the plain version, and the tolerance against
    four faults of the kernel's own design (128-key tiles).  `band` (lo,
    hi): the queries of tokens [lo, hi) only, against every key (a rank of
    the spatial axis), also held against the same rows of the whole
    launch."""
    from crowdsam_tpu_torch.models.attention import (
        TMA_KV_ROWS,
        flash_mha,
        flash_mha_plain,
    )

    bk, dim = TMA_KV_ROWS, heads * hd
    qkv = torch.randn((1, s, 3 * dim), generator=gen, device="cuda").to(
        torch.bfloat16)
    q, k, v = qkv.reshape(1, s, 3, heads, hd).permute(2, 0, 3, 1, 4)
    lo, hi = band or (0, s)
    qb, sq = q[:, :, lo:hi], hi - lo
    scale = hd ** -0.5
    want = flash_mha_plain(qb, k, v, scale, s)
    got = flash_mha(qb, k, v, scale, valid_len=s)
    same = {}
    if band is not None:
        same = _same_rows(got, flash_mha(q, k, v, scale,
                                         valid_len=s)[:, :, lo:hi])
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
    cmp = compare(f"flash_mha s={s} queries {lo}-{hi}", got, want,
                  0.09 * rms, faults=(
        (f"last key tile (keys {tail}-{s - 1}) dropped",
         _attention_plain(qb, k, v, scale, drop=slice(tail, s))),
        (f"first key tile (keys 0-{bk - 1}) dropped",
         _attention_plain(qb, k, v, scale, drop=slice(0, bk))),
        (f"key tile {j}'s V read from tile {j + 1} (stage released early)",
         _attention_plain(qb, k, v_f, scale)),
        (f"key tile {j}'s K dims permuted inside 16-byte chunks (swizzle "
         f"mismatch)", _attention_plain(qb, k_f, v, scale)),
    ), mean_atol=0.01 * rms)
    del v_f, k_f
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # Kernel and SDPA in turns, twice; the faster run of each is kept.
    runs_k, runs_l = [], []
    for _ in range(2):
        runs_k.append(time_ms(lambda: flash_mha(qb, k, v, scale,
                                                valid_len=s), 20))
        runs_l.append(time_ms(lambda: sdpa(qb, k, v, scale=scale), 20))
    d_k = device_ms(lambda: flash_mha(qb, k, v, scale, valid_len=s), 20,
                    "flash_attn_sm90")
    d_l = device_ms(lambda: sdpa(qb, k, v, scale=scale), 20)
    t_p = time_ms(lambda: flash_mha_plain(qb, k, v, scale, s), 3)
    flops = heads * 4 * sq * s * hd
    # q and o of the queries, k and v of every key.
    b_ms, by = bound(2 * dim * (2 * sq + 2 * s), flops, BF16_FLOP_PER_S)
    t_k, t_l = min(runs_k), min(runs_l)
    return dict(shape=f"{heads}x{s}x{hd}" if band is None
                else f"{heads}x{sq}x{hd} of {s} keys",
                **({} if band is None else {"band": f"tokens {lo}-{hi}"}),
                **cmp, **same, ms=t_k, ms_runs=runs_k,
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


def _same_rows(band, full) -> dict:
    """A band launch against the same rows of the whole launch: exact, or
    their largest difference."""
    diff = float((band.float() - full.float()).abs().max())
    return dict(same_rows_of_whole_launch_exact=diff == 0.0,
                same_rows_of_whole_launch_max_abs_diff=diff)


def phase_global_band(gen, hd=64, band=(42, 64), fold=False):
    """K3 on a query band, a rank's of the spatial axis at M = 2: grid rows
    [band) of SAM's 64x64 grid against its 4096 keys (row 42 on: the
    second rank's 22 rows, Rh from row 42 on), the bias in registers at
    head dims 64 and 80, and the folded form (fh/fw cut to the band), under
    `phase_global`'s bounds and faults, and a fault of the band: Rh taken
    from row 0 on (the band's offset dropped); against the same rows of the
    whole launch; timed beside SDPA on the same Sq x Sk with the bias built
    beforehand."""
    from crowdsam_tpu_torch.models.attention import (
        flash_mha_decomposed_relpos,
        relpos_attention_plain,
        relpos_global_launch,
    )
    from crowdsam_tpu_torch.models.image_encoder import _rel_pos_table

    g, heads = 64, 16
    hw, (lo, hi) = (g, g), band
    s, dim, sq = g * g, heads * hd, (hi - lo) * g
    qkv = torch.randn((1, s, 3 * dim), generator=gen, device="cuda").to(
        torch.bfloat16)
    q, k, v = qkv.reshape(1, s, 3, heads, hd).permute(2, 0, 3, 1, 4)
    qb = q[:, :, lo * g:hi * g]
    rh, rw = (_rel_pos_table(0.1 * torch.randn((2 * g - 1, hd), generator=gen,
                                               device="cuda"), g)
              for _ in range(2))
    scale = hd ** -0.5

    def kernel():
        if fold:
            return relpos_global_launch(qb, k, v, scale, rh, rw, hw, "fold",
                                        row0=lo)
        return flash_mha_decomposed_relpos(qb, k, v, scale, rh, rw, hw, lo)

    want = relpos_attention_plain(qb, k, v, scale, rh, rw, hw, lo)
    got = kernel()
    whole = relpos_global_launch(q, k, v, scale, rh, rw, hw,
                                 "fold" if fold else "grid64")
    same = _same_rows(got, whole[:, :, lo * g:hi * g])
    del whole
    qf = qb.float()

    def faulty(terms=None, drop=None):
        return _attention_plain(qb, k, v, scale, _relpos_bias(
            qf, rh, rw, hw, terms, row0=lo), drop)

    rms = float(want.float().square().mean().sqrt())
    faults = [(f"last key tile (keys {s - 128}-{s - 1}) dropped",
               faulty(drop=slice(s - 128, s))),
              ("fw taken from the neighbouring column (col(k) + 1)",
               faulty(terms=lambda fh, fw: (fh, _shift_last(fw, 1))))]
    if lo:
        faults.append(("Rh from row 0 on (the band's offset dropped)",
                       relpos_attention_plain(qb, k, v, scale, rh, rw, hw)))
    if hd == 80 and not fold:
        faults += _pair_faults(qb, k, v, scale, rh, rw, hw, "grid64", want,
                               row0=lo)
    cmp = compare(f"K3 band rows {lo}-{hi} hd {hd}"
                  + (" folded" if fold else ""), got, want, 6e-3,
                  faults=faults, mean_atol=0.015 * rms, min_fault=8.0)
    del faults
    t_k = time_ms(kernel, 10)
    d_k = device_ms(kernel, 10, "flash_attn_relpos")
    t_p = time_ms(lambda: relpos_attention_plain(qb, k, v, scale, rh, rw, hw,
                                                 lo), 3)
    bias16 = _relpos_bias(qb, rh, rw, hw, row0=lo).to(torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    t_l = time_ms(lambda: sdpa(qb, k, v, attn_mask=bias16, scale=scale), 10)
    d_l = device_ms(lambda: sdpa(qb, k, v, attn_mask=bias16, scale=scale), 10)
    del bias16
    flops = heads * (4 * sq * s * hd + 2 * sq * 2 * g * hd)
    # q of the band, k and v of the grid, o of the band, the tables.
    nbytes = 2 * (sq * dim + 2 * s * dim + sq * dim) + (rh.numel()
                                                        + rw.numel()) * 2
    b_ms, by = bound(nbytes, flops, BF16_FLOP_PER_S)
    row = dict(shape=f"{heads}x{sq}x{hd} of {s} keys",
               band=f"rows {lo}-{hi} of {g}x{g}",
               form="folded" if fold else "bias in registers", **cmp,
               **same, ms=t_k, device_ms=d_k, plain_ms=t_p, library_ms=t_l,
               library_device_ms=d_l,
               library_covers="SDPA on the same Sq x Sk with the bias built "
                              "beforehand",
               instantiations=[_instantiation(hd, "fold" if fold else "grid64",
                                              2 if fold else 1)],
               bound_ms=b_ms, bound_by=by, bound_share=b_ms / d_k)
    print(json.dumps({"phase": "K3 band", **row}), flush=True)
    return row


# DINOv2's token bands at M = 2: the cls token and patch rows 0-36, rows
# 37-72 of the 73x73 grid.
K4_BANDS = ((0, 1 + 73 * 37), (1 + 73 * 37, 1 + 73 * 73))


def phase_dino_band(gen, bands=K4_BANDS):
    """K4 with fewer queries than keys: token bands of DINOv2 (each rank's
    at M = 2 by default) against all 5330 keys (`_k4_case`)."""
    rows = []
    for band in bands:
        rows.append(_k4_case(gen, K4_BANDS[-1][1], band=band))
        print(json.dumps({"phase": "K4 band", **rows[-1]}), flush=True)
    return rows


def _token_bands(parts: int, grid: int = 73):
    """DINOv2's token bands at M = parts: `split_rows` of the patch rows,
    the cls token with the first."""
    from crowdsam_tpu_torch.parallel.spatial import Band, split_rows

    return Band(None, split_rows(grid, parts)).with_cls(grid).bounds


# The spatial axis past ViT-L's window rows (M = 6): the padded window grids
# a rank's K2 sees (one or two window rows of the 70-wide grid), K3's query
# bands of 11 and 10 rows (the first and the last), K4's token bands of 13
# and 12 patch rows; TinyViT's DINOv2 bands at M = 3 (25 and 24 rows).
HALO_K2_GRIDS = ((14, 70), (28, 70))
HALO_K3_BANDS = ((0, 11), (54, 64))
HALO_K4_BANDS = _token_bands(6)[:2]
TINY_K4_BANDS = _token_bands(3)[:2]


# --------------------------------------------------------------------------
# decode kernel phases: inputs from a model on a seeded frame
# --------------------------------------------------------------------------

def _decoder_inputs(model, img, n_prompts=32, seed=5, n_points=1):
    """The operands of one decode batch from `model` on `img`: the per-image
    shared tensors, the (P, 6 + n_points, 256) tokens of seeded point
    prompts (the points and a padding token) in the decoder's dtype and the
    packed-flat DINO map."""
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
        coords = (torch.rand((n_prompts, n_points, 2), generator=gen)
                  * torch.tensor([iw, ih], dtype=torch.float32)).cuda()
        labels = torch.ones((n_prompts, n_points), dtype=torch.int64,
                            device="cuda")
        sparse, _ = sam.prompt_encoder(points=(coords, labels))
        out_tokens = torch.cat([dec.iou_token.weight,
                                dec.mask_tokens.weight], dim=0)
        tokens = torch.cat([out_tokens[None].expand(n_prompts, -1, -1),
                            sparse.to(out_tokens.dtype)], dim=1)
        tokens = tokens.to(dec.dino_proj.weight.dtype).contiguous()
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


def phase_twoway_tail(model, img, label, n_prompts=32):
    """K5 against its plain version on one decode batch of `model` of
    `n_prompts` prompts."""
    from crowdsam_tpu_torch.models import decode_tail_kernel as dtk

    shared, tokens, _ = _decoder_inputs(model, img, n_prompts)
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


def _images_decoder_inputs(model, frames, n_prompts=32, n_points=1):
    """The operands of one lockstep decode iteration over `frames`: the
    shared tensors of their stacked embeddings (the unbatched form for one
    frame), each frame's `n_prompts` seeded point prompts' tokens, each
    prompt's image (None for one frame) and the frames' packed-flat DINO
    maps (B, R*R, C)."""
    from crowdsam_tpu_torch.models.fused_decode import (
        precompute_decode_shared,
    )

    feats, toks, dinos = [], [], []
    for i, img in enumerate(frames):
        _, tokens, dino = _decoder_inputs(model, img, n_prompts, seed=5 + i,
                                          n_points=n_points)
        feats.append(model.predictor.get_image_embedding())
        toks.append(tokens)
        dinos.append(dino)
    sam = model.sam
    shared = precompute_decode_shared(
        sam.mask_decoder, sam.prompt_encoder.no_mask_embed.weight,
        torch.cat(feats), model.predictor.dense_pe)
    b = len(frames)
    img = None if b == 1 else torch.arange(
        b, dtype=torch.int32, device="cuda").repeat_interleave(n_prompts)
    return shared, torch.cat(toks), img, torch.stack(dinos)


def _k5_bound(args, got, p, t, m, flop_rate=BF16_FLOP_PER_S):
    """K5's bound (`phase_twoway_tail`'s count) for P prompts of this
    call's operands: every input and output once, the products' flops at
    `flop_rate`."""
    c, cd, h, ht = 256, 128, 8, 8 * t
    mlp = args[5]["mlp1_w"].shape[0]
    flops = p * m * 2 * c * (3 * cd + 2 * cd)
    flops += 3 * p * m * ht * (cd // h) * 2 * 2
    flops += 2 * p * m * (ht * (cd // h) * 2 + ht * c * 2)
    flops += p * t * 2 * (8 * c * c + 12 * c * cd + 4 * c * mlp)
    nbytes = sum(x.numel() * x.element_size() for x in args[:5])
    nbytes += sum(x.numel() * x.element_size() for x in args[5].values())
    nbytes += sum(x.numel() * x.element_size() for x in got)
    return bound(nbytes, flops, flop_rate)


def phase_twoway_tail_images(model, frames):
    """K5 with the image axis (the batched pipeline's lockstep decode): B =
    4 frames x 32 prompts against the plain version, under the bounds of
    `phase_twoway_tail` (atol 2e-2 + 2^-7 |y|, mean 2^-11), once with each
    image's prompts together and once interleaved (every pair of prompts
    that a block of row phase 0 serves straddles two images, so its k/v
    tile is reloaded), each with a fault of the image axis that must break
    the bound: a prompt reading its neighbour image's keys0 and k1 rows,
    and the k/v tile not reloaded inside a pair.  K6 then takes the grouped
    case's keys2 (P = 128) against its plain version
    (`_mask_head_images`).  Then K5's time at B = 1, 2, 4, 8 frames x 32
    prompts (8 frames needed)."""
    from crowdsam_tpu_torch.models import decode_tail_kernel as dtk

    b = 4
    shared, tokens, img, dino = _images_decoder_inputs(model, frames[:b])
    args = _tail_args(shared, tokens)
    keys0, q1i, k1, v1 = args[:4]
    p, t, _ = tokens.shape
    m = keys0.shape[1]
    interleaved = (torch.arange(p, device="cuda") % b).to(torch.int32)
    rows = {}
    for case, ii in (("grouped", img), ("interleaved", interleaved)):
        with torch.no_grad():
            got = dtk.twoway_tail(*args, img=ii)
            want = dtk.twoway_tail_plain(*args, img=ii)
            torch.cuda.synchronize()
            again = dtk.twoway_tail(*args, img=ii)
            if not all(torch.equal(a, c) for a, c in zip(got, again)):
                raise AssertionError("twoway_tail images: two runs differ "
                                     "bit-wise")
            roll = [keys0.roll(-1, 0), q1i, k1.roll(-1, 0), v1]
            f_neighbour = dtk.twoway_tail_plain(*roll, tokens, args[5],
                                                img=ii)
        faults = [("each prompt reads its neighbour image's keys0 and k1 "
                   "rows", f_neighbour)]
        if case == "interleaved":
            # Pairs (2j, 2j+1) interleaved are images (2i, 2i+1): the
            # second prompt keeps the first one's k/v tile.
            stale = [0, 0, 2, 2]
            with torch.no_grad():
                faults.append((
                    "row phase 0's k/v tile not reloaded for the second "
                    "prompt of a pair", dtk.twoway_tail_plain(
                        keys0, q1i, k1[stale], v1[stale], tokens, args[5],
                        img=ii)))
        outs = {}
        for i, name in enumerate(("keys2", "tokens")):
            outs[name] = compare(
                f"twoway_tail images {case} {name}", got[i], want[i], 2e-2,
                faults=[(lb, f[i]) for lb, f in faults],
                require_faults=False, mean_atol=2.0 ** -11)
        require_faults_seen(f"twoway_tail images {case}", outs)
        rows[case] = outs
        if case == "grouped":
            k6 = _mask_head_images(model, shared, got, dino)
        del got, want, again, f_neighbour, faults
    del shared, args
    torch.cuda.empty_cache()

    timing = {}
    for nb in (1, 2, 4, 8):
        sh, tok, ii, _ = _images_decoder_inputs(model, frames[:nb])
        a = _tail_args(sh, tok)
        with torch.no_grad():
            fn = (lambda: dtk.twoway_tail(*a, img=ii))
            out = fn()
            b_ms, by = _k5_bound(a, out, tok.shape[0], tok.shape[1],
                                 sh["keys0"].shape[-2])
            timing[nb] = dict(prompts=int(tok.shape[0]),
                              ms=time_ms(fn, 10),
                              device_ms=device_span_ms(fn, 10),
                              bound_ms=b_ms, bound_by=by)
            if nb == 4:
                timing[nb]["plain_ms"] = time_ms(
                    lambda: dtk.twoway_tail_plain(*a, img=ii), 2, warmup=1)
        del sh, a, out
        torch.cuda.empty_cache()
    row = dict(shape=f"{b} images x 32 prompts x {t} tokens, {m}x256 image "
                     "rows an image",
               max_abs_err=max(o["max_abs_err"] for r in rows.values()
                               for o in r.values()),
               outputs=rows, by_images=timing, k6_images=k6)
    print(json.dumps({"phase": "K5 twoway_tail images", **row}), flush=True)
    return row


def _mask_head_images(model, shared, tail_out, dino):
    """K6 on the keys2 of B images x 32 prompts (one lockstep iteration)
    against its plain version, masks and mx within 3% of the masks' rms, e
    within 2e-2 (`phase_mask_head`'s bounds, hypernetwork vectors scaled by
    2^10 as there); the pooled head from the kernel's e and mx, each group
    of 32 prompts with its own image's DINO map, against the same from the
    plain version's, within 5% of its rms (`phase_mask_head`'s bound), and
    a group given its neighbour's map must break that bound."""
    from crowdsam_tpu_torch.models import fused_decode as fd
    from crowdsam_tpu_torch.models import mask_head_kernel as mhk

    dec = model.sam.mask_decoder
    keys2, tok = tail_out
    k = dec.num_mask_tokens
    with torch.no_grad():
        hyper = (fd._hyper_in(dec, tok[:, 1:1 + k, :]) * 1024.0).contiguous()
        want = mhk.mask_head_plain(keys2, hyper, shared["mask_head"],
                                   emit_exp=True)
        got = mhk.mask_head(keys2, hyper, shared["mask_head"],
                            emit_exp=True)
        pooled = fd._pooled_from_exp(got[1], got[2], dino, torch.bfloat16)
        pooled_want = fd._pooled_from_exp(want[1], want[2], dino,
                                          torch.bfloat16)
        pooled_fault = fd._pooled_from_exp(want[1], want[2],
                                           dino.roll(1, 0), torch.bfloat16)
    atol = 0.03 * float(want[0].float().square().mean().sqrt())
    p_atol = 0.05 * float(pooled_want.float().square().mean().sqrt())
    return {
        "prompts": int(keys2.shape[0]),
        "masks": compare("mask_head images masks", got[0], want[0], atol),
        "e": compare("mask_head images e", got[1], want[1], 2e-2),
        "mx": compare("mask_head images mx", got[2], want[2], atol),
        "pooled": compare("mask_head images pooled", pooled, pooled_want,
                          p_atol, faults=(("each group pooled with its "
                                           "neighbour image's DINO map",
                                           pooled_fault),)),
    }


# Card against CPU for the exported programs: the smoke's unfused bf16
# card-against-CPU tolerance (`_compare_small`), relative L2 per output.
EXPORT_CPU_REL_L2 = 5e-2


def _rel_l2(got, want) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def _median_ms_pair(fn_a, fn_b, reps=7, iters=3):
    """Median CUDA-event ms per call of two functions over `reps` rounds
    of `iters` calls each, taken in turns after a warm-up."""
    ta, tb = [], []
    for fn in (fn_a, fn_b):
        fn()
    for _ in range(reps):
        ta.append(time_ms(fn_a, iters, warmup=0))
        tb.append(time_ms(fn_b, iters, warmup=0))
    return float(np.median(ta)), float(np.median(tb))


def phase_export(model, img):
    """The serving export (`utils/export.py`) on the main-path model (SAM
    ViT-L's decoder at full width, bf16): `export_decoder` at 32 prompts on
    the features and DINO projection of `img`, and `export_serving` (one
    image, 2 prompts, a mask input with `has_mask_input` 1, output size
    683x1024) single-mask and with the extra metrics.  Each program is
    saved to bytes and loaded back; the loaded program must equal the eager
    module bit for bit on the card, hold one K1 node a LayerNorm on the
    path (10; the serving head 12, at widths 4 and 16 too), launch K1
    exactly that many times a call, and agree with the same program moved
    to the CPU (the plain LayerNorm, no launch) within EXPORT_CPU_REL_L2.
    Returns the rows."""
    import io

    from torch.export.passes import move_to_device_pass

    from crowdsam_tpu_torch.ops import layernorm as ln
    from crowdsam_tpu_torch.utils import export as ex

    sam = model.sam
    h, w = img.shape[:2]
    model.crop_image(img, [0, 0, w, h])
    model.predictor.set_image_presized(model.image)
    feats = model.predictor.get_image_embedding()
    dino = model.predictor.dino_proj_256
    ih, iw = model.image.shape[:2]
    gen = torch.Generator().manual_seed(5)
    scale = torch.tensor([iw, ih], dtype=torch.float32)
    coords = (torch.rand((32, 1, 2), generator=gen) * scale).cuda()
    labels = torch.ones((32, 1), dtype=torch.int32, device="cuda")
    with torch.no_grad():
        low_res = ex.build_decoder_fn(sam)(feats, dino, coords, labels)[0]
    mask_in = low_res[0, 1][None, :, :, None].float().contiguous()
    has_mask = torch.ones((), dtype=torch.float32, device="cuda")
    point = (torch.rand((1, 2, 2), generator=gen) * scale).cuda()
    corners = torch.tensor([[[0.2 * iw, 0.2 * ih], [0.6 * iw, 0.9 * ih]]],
                           device="cuda")
    serve_kw = dict(batch=1, num_points=2, return_single_mask=True,
                    orig_im_size=(h, w))
    cases = (
        ("decoder b32", ex.export_decoder, dict(batch=32),
         ex.build_decoder_fn(sam), (feats, dino, coords, labels), 10),
        ("serving single-mask", ex.export_serving, serve_kw,
         ex.build_serving_fn(sam, True, orig_im_size=(h, w)),
         (feats, point, torch.tensor([[1.0, 0.0]], device="cuda"), mask_in,
          has_mask), 12),
        ("serving extra metrics", ex.export_serving,
         dict(serve_kw, return_extra_metrics=True),
         ex.build_serving_fn(sam, True, return_extra_metrics=True,
                             orig_im_size=(h, w)),
         (feats, corners, torch.tensor([[2.0, 3.0]], device="cuda"),
          mask_in, has_mask), 12),
    )
    rows = []
    for label, export_fn, kw, eager, args, want_nodes in cases:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blob = export_fn(sam, "", **kw)
        t_export = time.perf_counter() - t0
        t0 = time.perf_counter()
        run = ex.load_exported(blob)
        t_load = time.perf_counter() - t0
        nodes = sum(1 for n in run.graph.nodes if n.target is ln.LAYER_NORM)
        with torch.no_grad():
            before = ln.layer_norm.launches
            widths = collections.Counter(ln.layer_norm.launches_by_width)
            got = run(*args)
            torch.cuda.synchronize()
            launches = ln.layer_norm.launches - before
            by_width = dict(collections.Counter(
                ln.layer_norm.launches_by_width) - widths)
            want = eager(*args)
            same = [bool(torch.equal(g, e)) for g, e in zip(got, want)]
            ms_loaded, ms_eager = _median_ms_pair(lambda: run(*args),
                                                  lambda: eager(*args))
            # Device time a call (the kernels alone): the same kernels run,
            # so a gap in ms is the host's.
            dev_loaded = device_ms(lambda: run(*args), 3)
            dev_eager = device_ms(lambda: eager(*args), 3)
            t0 = time.perf_counter()
            on_cpu = move_to_device_pass(torch.export.load(io.BytesIO(blob)),
                                         "cpu").module()
            before = ln.layer_norm.launches
            cpu_out = on_cpu(*[a.cpu() for a in args])
            cpu_launches = ln.layer_norm.launches - before
            t_cpu = time.perf_counter() - t0
        rel = [_rel_l2(g, c) for g, c in zip(got, cpu_out)]
        row = dict(case=label, export_and_save_s=t_export, load_s=t_load,
                   blob_bytes=len(blob), k1_nodes=nodes,
                   k1_launches_per_call=launches,
                   k1_launches_by_width=by_width,
                   bit_for_bit_vs_eager=same,
                   output_shapes=[list(g.shape) for g in got],
                   ms_loaded=ms_loaded, ms_eager=ms_eager,
                   device_ms_loaded=dev_loaded, device_ms_eager=dev_eager,
                   graph_call_nodes=sum(1 for n in run.graph.nodes
                                        if n.op == "call_function"),
                   cpu_relative_l2=rel, cpu_tol=EXPORT_CPU_REL_L2,
                   cpu_k1_launches=cpu_launches, cpu_load_and_run_s=t_cpu)
        print(json.dumps({"phase": "export", **row}), flush=True)
        if not all(same):
            raise AssertionError(f"export {label}: the loaded program "
                                 f"differs from the eager module: {row}")
        if not nodes == launches == want_nodes or cpu_launches:
            raise AssertionError(f"export {label}: K1 nodes / launches: "
                                 f"{row}")
        if want_nodes == 12 and not {4, 16} <= set(by_width):
            raise AssertionError(f"export {label}: K1 widths {by_width}")
        if not all(torch.isfinite(g.float()).all() for g in got) or not all(
                r <= EXPORT_CPU_REL_L2 for r in rel):
            raise AssertionError(f"export {label}: card against CPU: {row}")
        rows.append(row)
    return rows


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
    with _no_default_init():
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
    b_ms, by = bound(nbytes, flops, FFMA_FLOP_PER_S)
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
        for tally in ("launches_by_width", "launches_by_head_dim",
                      "launches_by_shape", "launches_by_form",
                      "launches_by_dtype"):
            if hasattr(fn, tally):
                getattr(fn, tally).clear()
    return counters


def _launches_by_shape():
    """K1's launches by row width, K2's and K3's by head dim, K2's, K3's
    and K4's by token grid (K2: its windows' padded grid) and K3's by form,
    since the counts were last set to 0."""
    c = _counters()
    attn = ("window_attention", "flash_mha_decomposed_relpos")
    k3 = c["flash_mha_decomposed_relpos"]
    return {"layer_norm_by_width": dict(c["layer_norm"].launches_by_width),
            "flash_mha_decomposed_relpos_by_form": dict(k3.launches_by_form),
            **{f"{k}_by_head_dim": dict(c[k].launches_by_head_dim)
               for k in attn},
            **{f"{k}_by_shape": dict(c[k].launches_by_shape)
               for k in attn + ("flash_mha",)}}


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
    with k1_by_shape("main path"):
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
        "k1_launches_by_shape": dict(K1_SHAPES["main path"]),
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
    batch = phase_generate_batch(model, reference_cfg, loaded_cfg)
    multi = phase_multi_device(model, reference_cfg, loaded_cfg)
    model.engine_cfg = reference_cfg
    return launches, loaded_launches, batch, multi


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


def _survivor_rows(cfg, res, in_hw):
    """The slab logits of an image's detections, in output order: the
    engine's valid rows that the survivor pass keeps."""
    from crowdsam_tpu_torch.pipeline.engine import survivor_core

    idx = torch.nonzero(res["summary"][:, 0] > 0.5).flatten()
    sp = survivor_core(cfg, res["logits"][idx], torch.tensor(
        in_hw, dtype=torch.int32, device=res["logits"].device), True)
    return res["logits"][idx[sp["summary"][:, 0] > 0.5]]


def _threshold_ties(cfg, got, want, res_got, res_want):
    """The pixels where the RLE strings of the same detection differ, each
    traced to a threshold tie: either the two runs' upsampled logits lie on
    both sides of the threshold there (within the two runs' largest
    difference of that mask's logits of it, since the upsample is a convex
    combination), or the low-res cleanup's edit of the pixel's cell differs
    between the runs (its input differs only at such ties).  Returns
    (pixels at an upsample tie, pixels through the cleanup), or raises."""
    from crowdsam_tpu_torch.ops.connected import remove_small_regions
    from crowdsam_tpu_torch.ops.rle import coco_decode_rle
    from crowdsam_tpu_torch.ops.survivor_kernel import upsample_plain

    area = cfg.min_mask_region_area * (cfg.low_res / cfg.img_size) ** 2

    def edit(logits):
        binm = logits > cfg.mask_threshold
        if cfg.min_mask_region_area <= 0:
            return torch.zeros_like(binm, dtype=torch.int8)
        m1, _ = remove_small_regions(binm, area, "holes", cfg.cc_max_iters)
        m2, _ = remove_small_regions(m1, area, "islands", cfg.cc_max_iters)
        return m2.to(torch.int8) - binm.to(torch.int8)

    direct = through_cleanup = 0
    rows = None
    for d, (a, b) in enumerate(zip(got["rles"], want["rles"])):
        if a == b:
            continue
        h, w = a["size"]
        if rows is None:
            rows = [_survivor_rows(cfg, r, (h, w))
                    for r in (res_got, res_want)]
        lg, lw = (r[d:d + 1].float() for r in rows)
        up_tie = ((upsample_plain(lg) > cfg.mask_threshold)
                  != (upsample_plain(lw) > cfg.mask_threshold))[0, :h, :w]
        cell = (edit(lg) != edit(lw)).repeat_interleave(4, 1) \
            .repeat_interleave(4, 2)[0, :h, :w]
        up_tie, cell = up_tie.cpu().numpy(), cell.cpu().numpy()
        diff = coco_decode_rle(a) != coco_decode_rle(b)
        if not (up_tie | cell)[diff].all():
            raise AssertionError(f"detection {d}: mask pixels differ away "
                                 f"from a threshold tie")
        direct += int((diff & up_tie).sum())
        through_cleanup += int((diff & ~up_tie).sum())
    return direct, through_cleanup


def _same_detections(got, want, exact):
    """Counts and categories equal, boxes within 0.5 px, scores within
    1e-4 (with `exact`, every field equal bit for bit)."""
    if len(got["boxes"]) != len(want["boxes"]):
        return False
    if len(got["boxes"]) == 0:
        return set(got.keys()) == set(want.keys())
    if exact:
        return set(got.keys()) == set(want.keys()) and all(
            np.array_equal(got[k], want[k]) if isinstance(got[k], np.ndarray)
            else got[k] == want[k] for k in got.keys())
    return (np.array_equal(got["categories"], want["categories"])
            and np.allclose(got["boxes"], want["boxes"], rtol=0, atol=0.5)
            and np.allclose(got["scores"], want["scores"], rtol=0,
                            atol=1e-4))


def _profiled_busy(fn):
    """`fn()` under torch.profiler (CUDA activity only), after one run for
    the profiler's start-up: (wall ms, device busy ms)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA]
    with profile(activities=acts):
        fn()
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    spans = [(ev.time_range.start, ev.time_range.start + ev.device_time_total)
             for ev in prof.events() if ev.device_type.name == "CUDA"]
    return wall, _union_us(spans) / 1e3


def phase_generate_batch(model, reference_cfg, loaded_cfg, n=8):
    """`ShardedPipeline.generate_batch` (the batched pipeline on one card:
    one encode, one lockstep EPS loop, one survivor pass a chunk) against
    `generate_many` on the n seeded crowd scenes of `generate_many`'s
    phase, the generator reset to one seed before each run, at the
    reference thresholds and loaded (filters off), at B = 1, 2, 4, 8.

    Required: item by item the same detection counts and categories, boxes
    within 0.5 px, scores within 1e-4, RLE strings equal or differing only
    at threshold ties (counted); at B = 1 every field equal bit for bit; in
    the loaded runs every kernel launched (the counts set to 0 just before
    the batched run and read just after), K5 and K6 once a lockstep
    iteration; the loop at most one host sync an iteration.  Reported a B:
    ms per image of both from the host clock (synchronized) in turns
    (batch, many, batch; the first is the checked run), the host syncs an iteration (the
    engine's count and torch's sync-debug warnings inside the loop), K5, K6
    and K7 launches per image, the device busy and idle share of one
    profiled call of B images, and the peak device memory at B = 8."""
    from crowdsam_tpu_torch.parallel.eval_shard import ShardedPipeline
    from crowdsam_tpu_torch.pipeline import engine
    from crowdsam_tpu_torch.utils.synthetic import FRAME_SIZES, crowd_scene

    scenes = [crowd_scene(40 + i, *FRAME_SIZES[i % len(FRAME_SIZES)])[0]
              for i in range(n)]
    row = {"phase": "generate_batch", "images": n,
           "config": "configs/crowdhuman.yaml defaults at full width "
                     "(vit_l + dinov2_vitl14 + PWD-Net, bf16, fused decode, "
                     "RLEs), random weights"}
    real_dispatch = model._dispatch_crop
    loops = []
    counted_loop = _sync_counted_loop(engine._eps_loop, loops)

    def timed_many():
        torch.cuda.synchronize()
        t = time.perf_counter()
        model.generate_many(scenes)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / n

    all_launches = {}
    for name, cfg in (("reference", reference_cfg), ("loaded", loaded_cfg)):
        model.engine_cfg = cfg
        engines = []

        def recording(*a, **kw):
            res, meta = real_dispatch(*a, **kw)
            engines.append(res)
            return res, meta

        with patched(model, "_dispatch_crop", recording):
            model.generator.manual_seed(123)
            want = model.generate_many(scenes)
        out = {}
        for b in (1, 2, 4, 8):
            pipe = ShardedPipeline(model, batch=b)
            batched = []

            def run(pipe=pipe, batched=batched):
                got = []
                for c0 in range(0, n, pipe.batch):
                    got += pipe.generate_batch(scenes[c0:c0 + pipe.batch])
                    batched.extend(pipe.last_engine)
                return got

            model.generator.manual_seed(123)
            counters = _reset_counts()
            if b == 8:
                torch.cuda.reset_peak_memory_stats()
            loops.clear()
            with patched(engine, "_eps_loop", counted_loop):
                torch.cuda.synchronize()
                t = time.perf_counter()
                got = run()
                torch.cuda.synchronize()
                first_ms = (time.perf_counter() - t) * 1e3 / n
            launches = {k: fn.launches for k, fn in counters.items()}
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            iters = sum(lp["iterations"] for lp in loops)
            ok, ties = [], []
            box_diff = max((float(np.abs(g["boxes"] - w["boxes"]).max())
                            for g, w in zip(got, want) if len(g["boxes"])
                            and len(g["boxes"]) == len(w["boxes"])),
                           default=0.0)
            score_diff = max((float(np.abs(g["scores"] - w["scores"]).max())
                              for g, w in zip(got, want) if len(g["boxes"])
                              and len(g["boxes"]) == len(w["boxes"])),
                             default=0.0)
            for i in range(n):
                same = _same_detections(got[i], want[i], exact=b == 1)
                if same and got[i]["rles"] != want[i]["rles"]:
                    same = b > 1 and len(got[i]["rles"]) == len(
                        want[i]["rles"])
                    if same:
                        ties.append(_threshold_ties(
                            model.engine_cfg, got[i], want[i], batched[i],
                            engines[i]))
                else:
                    ties.append((0, 0))
                ok.append(bool(same))
            # Repeated pairs against generate_many on the host clock.
            batch_ms, many_ms = [first_ms], []
            for order in ("many", "batch"):
                if order == "many":
                    many_ms.append(timed_many())
                else:
                    model.generator.manual_seed(123)
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    pipe.generate_batch(scenes)
                    torch.cuda.synchronize()
                    batch_ms.append((time.perf_counter() - t) * 1e3 / n)
            wall, busy = _profiled_busy(
                lambda: pipe.generate_batch(scenes[:b]))
            out[b] = {
                "equal_items": ok,
                "max_box_diff_px": box_diff,
                "max_score_diff": score_diff,
                "rle_tie_pixels": ties,
                "rle_tie_pixels_are": "(upsampled logits on both sides of "
                                      "the threshold, through the low-res "
                                      "cleanup's edit of a tie) an image",
                "detections_per_image": [len(g["boxes"]) for g in got],
                "ms_per_image_batch": batch_ms,
                "ms_per_image_many": many_ms,
                "ms_per_image_batch_median": float(np.median(batch_ms)),
                "ms_per_image_many_median": float(np.median(many_ms)),
                "lockstep_iterations": iters,
                "loop_syncs": sum(lp["syncs"] for lp in loops),
                "loop_sync_warnings": sum(lp["warned"] for lp in loops),
                "syncs_per_iteration": (sum(lp["syncs"] for lp in loops)
                                        / max(iters, 1)),
                "launches": launches,
                "k5_k6_k7_launches_per_image": {
                    k: launches[k] / n for k in ("twoway_tail", "mask_head",
                                                 "survivor_rle")},
                "profiled_call_images": b,
                "profiled_wall_ms": wall, "profiled_busy_ms": busy,
                "device_idle_share": 1.0 - busy / wall,
            }
            if b == 8:
                out[b]["peak_memory_gib"] = peak
            row[name] = out
            if not all(ok):
                print(json.dumps(row), flush=True)
                raise AssertionError(f"generate_batch differs from "
                                     f"generate_many ({name}, B={b}): {ok}")
            if any(lp["syncs"] > lp["iterations"] + 1 for lp in loops):
                raise AssertionError(f"generate_batch: more than one host "
                                     f"sync a lockstep iteration: {loops}")
            if launches["twoway_tail"] != iters or (
                    launches["mask_head"] != iters):
                raise AssertionError(f"generate_batch: K5/K6 not once a "
                                     f"lockstep iteration: {launches}, "
                                     f"{iters} iterations")
            if name == "loaded":
                missing = [k for k, v in launches.items() if v == 0]
                if missing:
                    raise AssertionError(f"generate_batch B={b}: kernels "
                                         f"not launched: {missing}")
                all_launches[b] = launches
    print(json.dumps(row), flush=True)
    return row


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
        with k1_by_shape(f"{name} decode"):
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
        "k1_launches_by_shape": {k: dict(K1_SHAPES[f"{k} decode"])
                                 for k in ("fused", "unfused")},
    }
    print(json.dumps(row), flush=True)
    ok = (f["consumed"] == u["consumed"] and int(both.sum()) > 0
          and agree >= 0.98 and row["iou_abs_diff_median"] <= 0.02
          and row["iou_abs_diff_max"] <= 0.12
          and row["box_abs_diff_px_median"] == 0.0
          and row["box_within_4px_share"] >= 0.95 and n_f == n_u)
    if not ok:
        raise AssertionError(f"fused and unfused decode disagree: {row}")


SMALL_OVERRIDES = (
    "model.sam_model", "vit_b", "model.image_size", "256",
    "model.dino_model", "dinov2_vits14", "test.max_size", "256",
    "test.grid_size", "48", "test.max_prompts", "64",
    "test.pred_iou_thresh", "0.0", "test.stability_score_thresh", "0.0")


def _small_config():
    """A small configuration with head dim 64 (SAM ViT-B at 256^2, DINOv2
    ViT-S/14; 256 image rows in the decoder), the IoU and stability filters
    off, so that random weights leave detections for the survivor pass."""
    from crowdsam_tpu_torch.config import modify_config
    from crowdsam_tpu_torch.utils.synthetic import full_width_config

    return modify_config(full_width_config(), list(SMALL_OVERRIDES))


def _small_image():
    from crowdsam_tpu_torch.utils.synthetic import synthetic_images

    return synthetic_images(1, 1)[0][:171, :256]


def phase_small_reference(gpu):
    """The small configuration: the card's bf16 kernel path (`gpu`, fused
    decode through K5 and K6) against the plain float32 path on the CPU,
    same weights; then the AMG on it."""
    cpu = _compare_small(gpu, _small_config(), "small_reference")
    phase_small_amg(gpu, cpu, _small_image())


def _compare_small(gpu, cfg, label):
    """The model `gpu` of the small configuration `cfg` against the same
    weights in float32 on the CPU: features, DINOv2 tokens and the FG map
    (train-free: also its sim map, the reference feature drawn from a seed
    on both sides) within 5% relative L2, the same detection count, boxes
    within 4 px.  Returns the CPU model."""
    from crowdsam_tpu_torch.config import modify_config
    from crowdsam_tpu_torch.ops.transforms import stretch_bilinear
    from crowdsam_tpu_torch.pipeline.crowdsam import CrowdSAM

    cpu_cfg = modify_config(cfg, ["tpu.compute_dtype", "float32"])
    with _no_default_init():
        cpu = CrowdSAM(cpu_cfg, device="cpu")
    cpu.sam.load_state_dict({k: v.float().cpu() for k, v in
                             gpu.sam.state_dict().items()})
    cpu.dino.load_state_dict({k: v.float().cpu() for k, v in
                              gpu.dino.state_dict().items()})
    img = _small_image()
    if gpu.train_free:
        ref = torch.from_numpy(np.random.default_rng(0).normal(
            size=gpu.dino.embed_dim).astype(np.float32))
        gpu.ref_feature, cpu.ref_feature = ref.cuda(), ref
    out = {}
    for name, m in (("gpu", gpu), ("cpu", cpu)):
        m.predictor.set_image_presized(img)
        out[name] = {
            "features": m.predictor.features.float().cpu(),
            "dino": m.predictor.dino_feats.float().cpu(),
            "fg": m.predictor.predict_fg_map().float().cpu(),
        }
        if m.train_free:
            d = m.predictor.dino_input
            out[name]["trainfree_sim"] = m.predictor.trainfree_sim(
                stretch_bilinear(img, (d, d)), m.ref_feature).cpu()
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
    print(json.dumps({"phase": label, "relative_l2": rel,
                      "tol": 5e-2, "gpu_detections": n_gpu,
                      "cpu_detections": n_cpu, "box_max_abs_diff_px": box_err,
                      "box_tol_px": 4.0}), flush=True)
    if not all(v < 5e-2 for v in rel.values()):
        raise AssertionError(f"bf16 CUDA path far from the f32 CPU path: {rel}")
    if n_gpu == 0 or n_gpu != n_cpu or box_err > 4.0:
        raise AssertionError(f"detections differ: {n_gpu} on the card, "
                             f"{n_cpu} on the CPU, boxes {box_err} px apart")
    return cpu


def _xywh_to_xyxy(records):
    b = np.asarray([r["bbox"] for r in records], np.float64).reshape(-1, 4)
    return np.concatenate([b[:, :2], b[:, :2] + b[:, 2:]], axis=1)


def phase_small_amg(gpu, cpu, img):
    """The automatic mask generator on the small configuration: the card's
    bf16 kernel path against the plain float32 path on the CPU (same
    weights, filters off so that random weights leave records): the share
    of the CPU's records whose box a record of the card matches at IoU >=
    0.9, gated at AMG_SMALL_MATCH_BOUND."""
    from crowdsam_tpu_torch.pipeline.amg_generator import (
        SamAutomaticMaskGenerator,
    )

    kw = dict(points_per_side=16, points_per_batch=64, pred_iou_thresh=0.0,
              stability_score_thresh=0.0, output_mode="coco_rle")
    on_card = SamAutomaticMaskGenerator(gpu.sam, device="cuda",
                                        **kw).generate(img)
    on_cpu = SamAutomaticMaskGenerator(cpu.sam, device="cpu",
                                       **kw).generate(img)
    share = _match_share(_xywh_to_xyxy(on_card), _xywh_to_xyxy(on_cpu),
                         thr=0.9)
    row = {"phase": "small_reference amg", "gpu_records": len(on_card),
           "cpu_records": len(on_cpu), "cpu_records_matched_iou90": share,
           "bound": AMG_SMALL_MATCH_BOUND, **{k: v for k, v in kw.items()
                                              if k != "output_mode"}}
    print(json.dumps(row), flush=True)
    if not on_cpu or share is None or share < AMG_SMALL_MATCH_BOUND:
        raise AssertionError(f"AMG on the card far from the CPU: {row}")


# --------------------------------------------------------------------------
# K1 backward, the JAX package's weights, training, the shipped adapter
# --------------------------------------------------------------------------

def _ln_backward_faults(x, g, w, eps, blocks):
    """The plain backward with a known fault each: (label, dx, dw, db).
    The mean(g w xhat) term of dx dropped; one block's rows left out of the
    dw/db sums (the kernel's own contiguous range of rows, block blocks // 2
    of the `blocks` that `ln_backward_blocks` describes); the rstd of the
    neighbouring row."""
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
        inst, _ = _k1_instantiations(True, n, d, dtype)
        if inst["blocks"] != blocks:
            raise AssertionError(f"ln_backward {n}x{d}: {blocks} blocks "
                                 f"described, {inst['blocks']} launched")
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
                         FFMA_FLOP_PER_S)
        row = dict(shape=f"{n}x{d}", dtype=str(dtype).replace("torch.", ""),
                   max_abs_err=max(o["max_abs_err"] for o in out.values()),
                   err_over_tol={k: o["err_over_tol"] for k, o in
                                 out.items()},
                   fault_err_over_tol={k: o["fault_err_over_tol"] for k, o in
                                       out.items()},
                   tol={k: o["tol"] for k, o in out.items()},
                   deterministic=True, ms=t_k, device_ms=d_k, plain_ms=t_p,
                   library_ms=t_l, library_device_ms=d_l, bound_ms=b_ms,
                   bound_by=by, partial_blocks=blocks,
                   instantiation=inst)
        rows.append(row)
        print(json.dumps({"phase": "K1 backward", **row}), flush=True)
        del x, g, got, want, faults
        torch.cuda.empty_cache()
    return rows


# The keys of `init.sam_state_dict` / `dino_state_dict` as `build_models`
# calls them for the full-width model and for SAM ViT-H.
MAIN_SAM_KEY = ("vit_l", 0, None, 1, 1024, False)
MAIN_DINO_KEY = ("dinov2_vitl14", 42)
VIT_H_KEY = ("vit_h", 0, None, 1, 1024, False)


class HostDraw:
    """A host draw of random weights in a thread of its own, started while
    the card works (numpy's generator and its casts let go of the GIL):
    `get()` waits for it; `seconds` is its time in that thread, beside the
    kernel build and the phases it overlapped."""

    def __init__(self, fn):
        import threading

        self.result = self.error = self.seconds = None
        self._fn = fn
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        t = time.perf_counter()
        try:
            self.result = self._fn()
        except BaseException as e:           # re-raised by get()
            self.error = e
        self.seconds = time.perf_counter() - t

    def get(self):
        self._thread.join()
        if self.error is not None:
            raise self.error
        return self.result


def start_draws() -> dict:
    """The full-width model's draws and SAM ViT-H's, each in a thread."""
    from crowdsam_tpu_torch.utils import init

    return {"main": HostDraw(lambda: (init.sam_state_dict(*MAIN_SAM_KEY),
                                      init.dino_state_dict(*MAIN_DINO_KEY))),
            "vit_h": HostDraw(lambda: init.sam_state_dict(*VIT_H_KEY))}


def _held(real, held: dict):
    """`init.sam_state_dict` that answers the keys of `held` from it."""
    def fn(*key):
        return held[key] if key in held else real(*key)
    return fn


def phase_numpy_init(draw: HostDraw):
    """The full-width model's weights, drawn on the host as the JAX package
    draws them (SAM ViT-L from seed 0, DINOv2 ViT-L/14 from environ.seed
    42; `draw`, made in a thread during the kernel build and the kernel
    phases): the draw's time in its thread, and each module's elements,
    sum and sum of squares against the manifest's checksums (numpy's draws
    are the same on any machine).  The draws stay cached for the models
    built after."""
    from crowdsam_tpu_torch.utils import init

    sam, dino = draw.get()
    draw_s = draw.seconds
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
           "draw_in": "a thread, beside the kernel build and phases",
           "elements": {k: v[0] for k, v in got.items()},
           "leaves_in_manifest": {k: want[k][0] for k in got},
           "sum_sumsq_rel_diff": rel, "tol": 1e-9}
    print(json.dumps(row), flush=True)
    if max(rel.values()) > 1e-9:
        raise AssertionError(f"numpy init differs from the manifest: {row}")
    return row


@functools.lru_cache(maxsize=1)
def _ten_shot():
    """The synthetic 10-shot set (`utils.fixtures.ten_shot_arrays(0)`),
    drawn once for the three trainer phases (~10 s of host time a draw)."""
    from crowdsam_tpu_torch.utils.fixtures import ten_shot_arrays

    return ten_shot_arrays(0)


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

    data = ArrayDataset(*_ten_shot())
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
    frames = [("crowded", "crowd_scene(0)", crowd_scene(0)),
              ("sparse", "mid_scene(7)", mid_scene(7))]
    _timed_generate(model, frames[0][2][0])             # warm-up
    out = []
    for regime, name, (img, drawn) in frames:
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
                    # The drawn persons (the `cli` phase's ground truth)
                    # matched by the JAX bench's own detections.
                    "drawn_matched_by_golden_share_iou50": _match_share(
                        gold["boxes"], [(x, y, x + w, y + h)
                                        for x, y, w, h in drawn]),
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


@contextlib.contextmanager
def _plain_calls():
    """A count of the calls of the plain versions of K2-K4 inside the block
    (on the card a wrapper launches its kernel or raises: none may run).
    K1's op takes its plain version only by the CPU dispatch key."""
    from crowdsam_tpu_torch.models import attention

    calls = collections.Counter()
    with contextlib.ExitStack() as stack:
        for name in ("window_attention_plain", "relpos_attention_plain",
                     "flash_mha_plain"):
            module, real = attention, getattr(attention, name)

            def spy(*a, _real=real, _name=name, **kw):
                calls[_name] += 1
                return _real(*a, **kw)

            stack.enter_context(patched(module, name, spy))
        yield calls


def _probe_box_gap(got, want, by_score):
    """The largest box gap (px) of two probe or engine results with the
    same count, paired by falling score (`by_score`) or in output order;
    None where the counts differ."""
    if len(got["boxes"]) != len(want["boxes"]):
        return None
    gi = np.argsort(-np.asarray(got["scores"]), kind="stable") \
        if by_score else slice(None)
    wi = np.argsort(-np.asarray(want["scores"]), kind="stable") \
        if by_score else slice(None)
    return float(np.abs(np.asarray(got["boxes"], np.float64)[gi]
                        - np.asarray(want["boxes"], np.float64)[wi]
                        ).max(initial=0.0))


def phase_deviation_probe():
    """The deviation probe (`utils/deviation_probe.py`) through its driver
    (`tools/probe_deviations.py`) at full width: `configs/crowdhuman.yaml`
    in bf16 with random encoders and the committed trained decoder of the
    driver's recipe (`build_model`), on crowd_scene(0) (683x1024) with a
    fixed noise vector.

    The engine runs unfused and fused; `run_probe` runs every variant and
    scores them by cross-AP on this one scene.  Parity mode (all documented
    deviations in effect) against the unfused engine, which decodes the
    same batches with the same decoder: equal consumed and detection
    counts, boxes within 1 px and scores within 1e-3, paired by falling
    score, with the probe's re-NMS visiting the survivors in the engine's
    order (`renms_order="score"`).  In its own order (the JAX probe's:
    detection order, where the JAX engine too takes falling score) it may
    keep the other one of two overlapping cleaned masks; that run's gap is
    printed.  The CPU tests find the JAX pair equal on the tiny model,
    which drops no mask in the re-NMS.  The parity run, with the counts set to 0
    just before it, must launch K1-K4 and call no plain version of K2-K4,
    and
    launch neither K5, K6 nor K7 (the probe decodes unfused and keeps
    boxes).  Then the small configuration (`SMALL_OVERRIDES`, bf16 kernels
    on the card) in parity and exact_all against the same probe in float32
    on the CPU, same weights and noise: the same detection count and boxes
    within 4 px in output order, as `_compare_small` requires."""
    from crowdsam_tpu_torch.config import modify_config
    from crowdsam_tpu_torch.pipeline.crowdsam import CrowdSAM
    from crowdsam_tpu_torch.tools.probe_deviations import (
        VARIANTS,
        build_model,
        run_probe,
    )
    from crowdsam_tpu_torch.utils.deviation_probe import DeviationProbe
    from crowdsam_tpu_torch.utils.synthetic import crowd_scene

    t0 = time.perf_counter()
    with _no_default_init():
        model, meta = build_model("cuda")
    build_s = time.perf_counter() - t0
    scene = crowd_scene(0)[0]
    noise = torch.rand(model.engine_cfg.grid_size ** 2,
                       generator=torch.Generator().manual_seed(24)).numpy()
    engine = {}
    for name, fused in (("unfused", False), ("fused", True)):
        model.engine_cfg = dataclasses.replace(model.engine_cfg,
                                               fused_decode=fused)
        data, ms = _timed_generate(model, scene, noise)
        engine[name] = dict(data=data, ms=ms,
                            consumed=int(model.last_engine["num_consumed"]))

    probe = DeviationProbe(model)
    probe.generate(scene, noise)                        # warm-up
    counters = _reset_counts()
    with _plain_calls() as plain:
        torch.cuda.synchronize()
        t = time.perf_counter()
        parity = probe.generate(scene, noise)
        torch.cuda.synchronize()
        parity_s = time.perf_counter() - t
    launches = {k: fn.launches for k, fn in counters.items()}
    _require_launches("deviation probe parity", launches,
                      ("layer_norm", "window_attention",
                       "flash_mha_decomposed_relpos", "flash_mha"),
                      ("twoway_tail", "mask_head", "survivor_rle"))
    if sum(plain.values()):
        raise AssertionError(f"deviation probe: plain versions ran on the "
                             f"card: {dict(plain)}")
    boxes = np.asarray(parity["boxes"])
    if not (len(boxes) and np.isfinite(boxes).all() and (boxes >= 0).all()
            and (boxes[:, [0, 2]] <= scene.shape[1]).all()
            and (boxes[:, [1, 3]] <= scene.shape[0]).all()):
        raise AssertionError(f"deviation probe: parity boxes {boxes}")

    # Parity mode against the unfused engine: in the probe's own re-NMS
    # order (the JAX probe's, detection order) for the record, and in the
    # engine's (falling score), which must agree.
    unfused = engine["unfused"]
    by_score = probe.generate(scene, noise, renms_order="score")
    vs_engine = {}
    for name, got in (("renms_by_score", by_score),
                      ("renms_by_detection", parity)):
        box_gap = _probe_box_gap(got, unfused["data"], by_score=True)
        vs_engine[name] = {
            "consumed": [got["num_consumed"], unfused["consumed"]],
            "detections": [len(got["boxes"]), len(unfused["data"]["boxes"])],
            "n_dropped_renms": got["n_dropped_renms"],
            "box_max_abs_diff_px": box_gap,
            "score_max_abs_diff": None if box_gap is None else float(np.abs(
                np.sort(np.asarray(got["scores"])) - np.sort(np.asarray(
                    unfused["data"]["scores"]))).max(initial=0.0))}
    vs_engine.update(box_tol_px=1.0, score_tol=1e-3)

    # Every variant through the driver (its engine is the default, fused).
    seconds = {}
    model.engine_cfg = dataclasses.replace(model.engine_cfg,
                                           fused_decode=True)
    report = run_probe(model, [scene], [noise], fixture=meta,
                       seconds=seconds, log=log)
    variants = {name: {
        "detections": report["detections"][name][0],
        "consumed": report["consumed"][name][0],
        "n_changed": report["diag"][name]["n_changed"][0],
        "n_dropped_renms": report["diag"][name]["n_dropped_renms"][0],
        "seconds": seconds[name]} for name in VARIANTS}
    del model, probe
    torch.cuda.empty_cache()

    # The small configuration: the card against the CPU in float32.
    with _no_default_init():
        gpu = CrowdSAM(_small_config(), device="cuda")
        cpu = CrowdSAM(modify_config(_small_config(),
                                     ["tpu.compute_dtype", "float32"]),
                       device="cpu")
    cpu.sam.load_state_dict({k: v.float().cpu() for k, v in
                             gpu.sam.state_dict().items()})
    cpu.dino.load_state_dict({k: v.float().cpu() for k, v in
                              gpu.dino.state_dict().items()})
    img = _small_image()
    small_noise = torch.rand(
        gpu.engine_cfg.grid_size ** 2,
        generator=torch.Generator().manual_seed(25)).numpy()
    small = {}
    for name in ("parity", "exact_all"):
        got = DeviationProbe(gpu).generate(img, small_noise, VARIANTS[name])
        want = DeviationProbe(cpu).generate(img, small_noise, VARIANTS[name])
        small[name] = {"gpu_detections": len(got["boxes"]),
                       "cpu_detections": len(want["boxes"]),
                       "box_max_abs_diff_px": _probe_box_gap(
                           got, want, by_score=False),
                       "box_tol_px": 4.0}
    del gpu, cpu
    torch.cuda.empty_cache()

    row = {"phase": "deviation probe", "fixture": meta,
           "model_build_s": build_s, "scene": "crowd_scene(0)",
           "image_hw": list(scene.shape[:2]),
           "engine": {k: {"detections": len(v["data"]["boxes"]),
                          "consumed": v["consumed"], "ms": v["ms"]}
                      for k, v in engine.items()},
           "parity_vs_unfused_engine": vs_engine, "parity_s": parity_s,
           "parity_launches": launches, "plain_calls": dict(plain),
           "variants": variants, "engine_s": seconds["engine"],
           "cross_ap": report["cross_ap"],
           "small_gpu_vs_cpu_f32": small}
    print(json.dumps(row), flush=True)
    held = vs_engine["renms_by_score"]
    ok = (held["consumed"][0] == held["consumed"][1]
          and held["box_max_abs_diff_px"] is not None
          and held["box_max_abs_diff_px"] <= 1.0
          and held["score_max_abs_diff"] <= 1e-3)
    if not ok:
        raise AssertionError(f"deviation probe: parity mode against the "
                             f"unfused engine: {vs_engine}")
    for name, r in small.items():
        if r["gpu_detections"] == 0 or r["box_max_abs_diff_px"] is None \
                or r["box_max_abs_diff_px"] > 4.0:
            raise AssertionError(f"deviation probe, small {name}: the card "
                                 f"far from the CPU: {r}")
    return row


def _amg_records_check(records, hw):
    """Every record's mask has the image's size, its `area` pixels, and
    lies inside its xywh `bbox`."""
    from crowdsam_tpu_torch.ops.rle import coco_decode_rle

    for r in records:
        m = coco_decode_rle(r["segmentation"])
        assert m.shape == tuple(hw), m.shape
        assert int(m.sum()) == r["area"], (int(m.sum()), r["area"])
        if r["area"]:
            ys, xs = np.nonzero(m)
            x, y, w, h = r["bbox"]
            assert (xs.min() >= x and xs.max() <= x + w and ys.min() >= y
                    and ys.max() <= y + h), (r["bbox"], xs.min(), xs.max(),
                                             ys.min(), ys.max())


def phase_amg(sam):
    """Path (b): `SamAutomaticMaskGenerator.generate` on SAM ViT-L (the
    JAX-drawn encoder, the shipped adapter's decoder, bf16, no DINOv2) at
    the reference defaults (32 points a side, 64 a batch, 4 masks a point)
    in coco_rle on crowd_scene(0), once at the generator's default filters
    (after a warm-up call) and once loaded: the pred-IoU and stability
    filters off and min_mask_region_area 100, so that records reach the
    NMS, the small-region cleanup and the RLE, on 16 points a side (the
    host's cleanup takes ~18 ms a mask: ~840 records at 32 a side took
    15 s of it).  The counts are set to 0
    just before each call and read just after; K1, K2 and K3 must launch,
    the loaded call must give a record, and every record's mask lies
    inside its bbox with its area's pixel count.  Prints records, ms per
    image, the cleanup's ms and the launches."""
    from crowdsam_tpu_torch.pipeline.amg_generator import (
        SamAutomaticMaskGenerator,
    )
    from crowdsam_tpu_torch.utils.bench_fixture import crowd_scene

    img = crowd_scene(0)[0]
    row = {"phase": "amg", "frame": "crowd_scene(0)",
           "model": "SAM ViT-L (JAX-drawn encoder) + "
                    "adapter_weights/10_shot.msgpack decoder, bf16",
           "points_per_batch": 64, "output_mode": "coco_rle"}
    runs = (("default_filters", dict(points_per_side=32)),
            ("loaded", dict(points_per_side=16, pred_iou_thresh=0.0,
                            stability_score_thresh=0.0,
                            min_mask_region_area=100)))
    for name, kw in runs:
        gen = SamAutomaticMaskGenerator(
            sam, points_per_batch=64, output_mode="coco_rle",
            device="cuda", **kw)
        cleanup = [0.0]
        real = gen.postprocess_small_regions

        def timed_cleanup(*a, real=real, cleanup=cleanup):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = real(*a)
            torch.cuda.synchronize()
            cleanup[0] += (time.perf_counter() - t) * 1e3
            return out

        gen.postprocess_small_regions = timed_cleanup
        if name == "default_filters":
            gen.generate(img)                           # warm-up
            cleanup[0] = 0.0
        counters = _reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        records = gen.generate(img)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        launches = {k: fn.launches for k, fn in counters.items()}
        _amg_records_check(records, img.shape[:2])
        row[name] = {"records": len(records), "ms_per_image": ms,
                     "cleanup_ms": cleanup[0], "launches": launches, **kw}
        del gen
        torch.cuda.empty_cache()
    print(json.dumps(row), flush=True)
    for name, _ in runs:
        missing = [k for k in ("layer_norm", "window_attention",
                               "flash_mha_decomposed_relpos")
                   if row[name]["launches"][k] == 0]
        if missing:
            raise AssertionError(f"amg {name}: {missing} never launched")
    if row["loaded"]["records"] == 0:
        raise AssertionError(f"amg: the loaded call gives no record: {row}")
    return row


def _write_cli_dataset(root, n=8):
    """A CrowdHuman-style dataset of n seeded 683x1024 frames under root:
    crowd_scene(s) for the first half, mid_scene(s) for the rest, each
    drawn person's box its ground truth; Images/*.png, a COCO json and an
    odgt (fbox = vbox).  Returns the frames (RGB)."""
    import cv2

    from crowdsam_tpu_torch.utils.bench_fixture import crowd_scene, mid_scene

    os.makedirs(os.path.join(root, "Images"))
    frames, images, annots, odgt = [], [], [], []
    for i in range(n):
        img, boxes = crowd_scene(i) if i < n // 2 else mid_scene(i)
        name = f"scene_{i:02d}"
        cv2.imwrite(os.path.join(root, "Images", name + ".png"),
                    img[..., ::-1])
        frames.append(img)
        h, w = img.shape[:2]
        images.append({"file_name": name + ".png", "id": i, "height": h,
                       "width": w})
        for x, y, bw, bh in boxes:
            annots.append({"image_id": i, "bbox": [x, y, bw, bh],
                           "id": len(annots), "category_id": 1, "ignore": 0,
                           "iscrowd": False, "area": bw * bh})
        odgt.append({"ID": name, "width": w, "height": h, "gtboxes": [
            {"tag": "person", "fbox": list(b), "vbox": list(b), "extra": {}}
            for b in boxes]})
    with open(os.path.join(root, "val.json"), "w") as f:
        json.dump({"images": images, "annotations": annots, "categories": [
            {"id": 1, "name": "person", "supercategory": "person"}]}, f)
    with open(os.path.join(root, "val.odgt"), "w") as f:
        f.write("\n".join(json.dumps(r) for r in odgt))
    return frames


def _printed(fn, argv):
    """fn(argv)'s standard output, echoed, and its metric lines parsed."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    text = buf.getvalue()
    log(text.rstrip())
    metrics = {}
    for line in text.splitlines():
        key, _, val = line.partition(": ")
        if key in ("AP", "MR", "Recall", "tp", "fp"):
            metrics[key] = float(val)
    return metrics


def phase_cli():
    """Path (a), the annotation job through the port's own entry points:
    `tools.test` in-process (`main(argv)`, -c configs/crowdhuman.yaml as
    shipped, data paths overridden) on 8 seeded frames written as a
    CrowdHuman-style dataset, the conversion to COCO, `tools.crowdhuman_eval`
    on it, and `tools.batch_eval --inline` on the same data, which must
    print the same metrics.  The counts are set to 0 just before the
    `tools.test` run and read just after: K1-K6 must launch (K7 launches
    on every frame with a detection).  The result dicts must equal
    `generate_many` on the same frames with the same noise (the CLI's model,
    its generator reset to `environ.seed`), every detection's RLE mask
    must span its box, and AP must be above 0 (AP itself is printed, not
    gated: seeded synthetic scenes, random encoders)."""
    import tempfile

    from crowdsam_tpu_torch.evallib.coco_convert import convert_to_coco
    from crowdsam_tpu_torch.tools import batch_eval, crowdhuman_eval
    from crowdsam_tpu_torch.tools import test as test_cli

    root = tempfile.mkdtemp(prefix="crowdsam_cli_")
    try:
        frames = _write_cli_dataset(root)
        n = len(frames)
        data = ["data.dataset_root", root,
                "data.json_file", os.path.join(root, "val.json"),
                "data.odgt_file", os.path.join(root, "val.odgt"),
                "environ.output_dir", os.path.join(root, "out")]
        result_path = os.path.join(root, "result.json")
        captured = []

        class Capturing(test_cli.CrowdSAM):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                captured.append(self)

        counters = _reset_counts()
        with patched(test_cli, "CrowdSAM", Capturing):
            torch.cuda.synchronize()
            t = time.perf_counter()
            test_cli.main(["-c", "configs/crowdhuman.yaml", "-s",
                           result_path] + data)
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t
        launches = {k: fn.launches for k, fn in counters.items()}
        with open(result_path) as f:
            results = json.load(f)
        nonempty = sum(_check_rles(r, img) for r, img in zip(results, frames)
                       if r["boxes"])

        model = captured.pop()
        model.generator.manual_seed(int(model.config["environ"]["seed"]))
        times = []
        many = model.generate_many(frames, times_out=times)
        del model
        torch.cuda.empty_cache()
        same = len(many) == len(results) == n and all(
            json.loads(json.dumps({k: np.asarray(m[k]).tolist() for k in
                                   ("boxes", "scores", "categories")}))
            == {k: r[k] for k in ("boxes", "scores", "categories")}
            and m["rles"] == r["rles"] for m, r in zip(many, results))

        with open(os.path.join(root, "val.json")) as f:
            gt_js = json.load(f)
        det_path = os.path.join(root, "det.json")
        with open(det_path, "w") as f:
            json.dump(convert_to_coco(results, gt_js), f)
        metrics = _printed(crowdhuman_eval.main, [
            "-d", det_path, "-g", os.path.join(root, "val.odgt"), "-f", "-v",
            "-o", os.path.join(root, "record.txt")])
        batch = _printed(batch_eval.main, ["-c", "configs/crowdhuman.yaml",
                                           "--inline"] + data)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    row = {"phase": "cli", "config": "configs/crowdhuman.yaml as shipped",
           "frames": f"crowd_scene(0..3), mid_scene(4..7), 683x1024, n={n}",
           "metrics": metrics, "batch_eval_inline_metrics": batch,
           "detections_per_image": [len(r["boxes"]) for r in results],
           "gt_per_image": [sum(a["image_id"] == i
                                for a in gt_js["annotations"])
                            for i in range(n)],
           "nonempty_masks": nonempty,
           "ms_per_image": float(np.mean(times)) * 1e3,
           "ms_per_image_each": [x * 1e3 for x in times],
           "tools_test_wall_s": cli_s,
           "launches_per_image": {k: v / n for k, v in launches.items()},
           "equal_to_generate_many": same}
    print(json.dumps(row), flush=True)
    missing = [k for k, v in launches.items()
               if v == 0 and k != "survivor_rle"]
    if missing:
        raise AssertionError(f"cli: {missing} never launched")
    if not same:
        raise AssertionError("cli: result.json differs from generate_many")
    if batch != metrics:
        raise AssertionError(f"cli: batch_eval {batch} != {metrics}")
    if not metrics.get("AP", 0.0) > 0.0:
        raise AssertionError(f"cli: AP is 0: {row}")
    return row


# --------------------------------------------------------------------------
# the other archs: SAM ViT-H (head dim 80), sam_hq, mobile_sam
# --------------------------------------------------------------------------

ADAPTER = "./adapter_weights/10_shot.msgpack"


def _arch_model(overrides):
    from crowdsam_tpu_torch.config import modify_config
    from crowdsam_tpu_torch.pipeline.crowdsam import CrowdSAM
    from crowdsam_tpu_torch.utils.synthetic import full_width_config

    t = time.time()
    with _no_default_init():
        model = CrowdSAM(modify_config(full_width_config(), overrides),
                         device="cuda")
    torch.cuda.synchronize()
    return model, time.time() - t


def _require_launches(label, launches, required, absent=()):
    missing = [k for k in required if launches[k] == 0]
    present = [k for k in absent if launches[k] != 0]
    if missing or present:
        raise AssertionError(f"{label}: kernels not launched {missing}, "
                             f"launched where they must not {present}: "
                             f"{launches}")


def phase_vit_h(draw: HostDraw):
    """SAM ViT-H (width 1280, head dim 80) at full width and depth with
    DINOv2 ViT-L/14 and the shipped adapter, `configs/crowdhuman.yaml`'s
    defaults (fused decode, RLEs): the three synthetic frames, then one
    crowd scene with the pred-IoU and stability filters off (K7 on its
    detections); the counts set to 0 just before each and read just after.
    K1 must have launched at width 1280 and K2/K3 at head dim 80 (and at
    no other head dim).  Also the encode's ms, the device's idle share and
    peak memory.  Returns the launches by shape."""
    from crowdsam_tpu_torch.utils import init
    from crowdsam_tpu_torch.utils.synthetic import crowd_scene, synthetic_images

    held = {VIT_H_KEY: draw.get()}
    with patched(init, "sam_state_dict", _held(init.sam_state_dict, held)):
        model, build_s = _arch_model(["model.sam_model", "vit_h",
                                      "model.sam_adapter_checkpoint",
                                      ADAPTER])
    assert model.sam.image_encoder.embed_dim == 1280
    images = synthetic_images(0, N_IMAGES + 1)
    model.generate(images[-1])               # warm-up
    torch.cuda.synchronize()
    counters = _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    runs = [_timed_generate(model, img) for img in images[:N_IMAGES]]
    launches = {k: fn.launches for k, fn in counters.items()}
    by_shape = _launches_by_shape()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    encode = [_encode_ms(model, img) for img in images[:N_IMAGES]]
    wall, busy, top = _device_busy(model, images[0])
    reference_cfg = model.engine_cfg
    model.engine_cfg = dataclasses.replace(
        reference_cfg, pred_iou_thresh=0.0, stability_score_thresh=0.0)
    scene = crowd_scene(20, 683, 1024)[0]
    _timed_generate(model, scene)            # warm-up of the survivor path
    counters = _reset_counts()
    loaded, loaded_ms = _timed_generate(model, scene)
    loaded_launches = {k: fn.launches for k, fn in counters.items()}
    nonempty = _check_rles(loaded, scene)
    model.engine_cfg = reference_cfg
    # The rect encode of frames 64 tall: K3 at head dim 80 in the columns
    # form on the portrait frame's 64x48 grid and on the first frame turned
    # on its side (64x44).
    tall = [images[1], np.ascontiguousarray(images[0].transpose(1, 0, 2))]
    model.predictor.rect_encode = True
    for img in tall:                          # warm-up
        model.generate(img)
    counters = _reset_counts()
    rect_runs = [_timed_generate(model, img) for img in tall]
    rect_launches = {k: fn.launches for k, fn in counters.items()}
    rect_shapes = _launches_by_shape()
    model.predictor.rect_encode = False
    row = {
        "phase": "vit_h",
        "config": "vit_h (1280 wide, 32 blocks, head dim 80) + dinov2_vitl14 "
                  "+ the shipped adapter, bf16, configs/crowdhuman.yaml "
                  "defaults (fused decode, RLEs)",
        "build_s": build_s, "host_draw_s": draw.seconds,
        "host_draw_in": "a thread, beside the phases before this one",
        "image_hw": [list(i.shape[:2]) for i in images[:N_IMAGES]],
        "ms_per_image": [ms for _, ms in runs],
        "ms_per_image_mean": float(np.mean([ms for _, ms in runs])),
        "encode_ms_per_image": encode,
        "detections_per_image": [len(d["boxes"]) for d, _ in runs],
        "peak_memory_gib": peak,
        "launches_per_image": {k: v / N_IMAGES for k, v in launches.items()},
        "launches_by_shape": by_shape,
        "device_profile": {"wall_ms": wall, "device_busy_ms": busy,
                           "device_idle_share": 1.0 - busy / wall,
                           "kernels_ms": top},
        "loaded": {"image_hw": list(scene.shape[:2]),
                   "filters": "pred_iou_thresh 0, stability_score_thresh 0",
                   "ms": loaded_ms, "detections": len(loaded["boxes"]),
                   "nonempty_masks": nonempty,
                   "launches": loaded_launches},
        "rect_encode": {"image_hw": [list(i.shape[:2]) for i in tall],
                        "ms_per_image": [ms for _, ms in rect_runs],
                        "detections_per_image": [len(d["boxes"])
                                                 for d, _ in rect_runs],
                        "launches": rect_launches,
                        "launches_by_shape": rect_shapes},
    }
    print(json.dumps(row), flush=True)
    _require_launches("vit_h", launches,
                      [k for k in launches if k != "survivor_rle"])
    _require_launches("vit_h loaded", loaded_launches, list(loaded_launches))
    _require_launches("vit_h rect_encode", rect_launches,
                      [k for k in rect_launches if k != "survivor_rle"])
    for shapes in (by_shape, rect_shapes):
        if (shapes["layer_norm_by_width"].get(1280, 0) == 0
                or set(shapes["window_attention_by_head_dim"]) != {80}
                or set(shapes["flash_mha_decomposed_relpos_by_head_dim"])
                != {80}):
            raise AssertionError(f"vit_h: K1 not at width 1280 or K2/K3 "
                                 f"not at head dim 80 alone: {shapes}")
    k3_rect = rect_shapes["flash_mha_decomposed_relpos_by_shape"]
    if (any(k3_rect.get(f"{h}x{w}", 0) == 0 for h, w in RECT_K3_GRIDS_80)
            or rect_shapes["flash_mha_decomposed_relpos_by_form"].get(
                "columns", 0) != sum(k3_rect.get(f"{h}x{w}", 0)
                                     for h, w in RECT_K3_GRIDS_80)):
        raise AssertionError(f"vit_h rect_encode: K3 not in the columns "
                             f"form on {RECT_K3_GRIDS_80}: {rect_shapes}")
    return dict(by_shape, rect=rect_shapes)


def _cropped(full: dict):
    """A stand-in for `init.sam_state_dict` at a smaller size: `full`, a
    draw of the same arch at its default size, each tensor cut to the
    leading block of the shape the smaller model's parameter has (the
    positional embedding, the global blocks' rel-pos tables, the DINOv2
    projection).  Random weights either way; the comparison that uses them
    holds the card and the CPU to the same ones, and no draw of 637 M
    normals is made again."""
    from crowdsam_tpu_torch.models.build import sam_model_registry

    def fn(arch, seed=0, image_size=None, n_class=1, dino_dim=1024,
           hq=False):
        kw = dict(n_class=n_class, dino_dim=dino_dim, hq=hq)
        if image_size:
            kw["image_size"] = int(image_size)
        with torch.device("meta"):
            shapes = {k: v.shape for k, v in
                      sam_model_registry[arch](**kw).state_dict().items()}
        return {k: v[tuple(slice(0, n) for n in shapes[k])].contiguous()
                for k, v in full.items()}
    return fn


def phase_small_vit_h(draw: HostDraw):
    """A small head-dim-80 configuration (SAM ViT-H at 256^2, DINOv2
    ViT-S/14): the card's bf16 kernel path (K1 at 1280, K2/K3 at head dim
    80, fused decode through K5/K6) against the plain float32 path on the
    CPU, same weights (`_cropped` from `phase_vit_h`'s draw), with the
    bounds of `small_reference`."""
    from crowdsam_tpu_torch.config import modify_config
    from crowdsam_tpu_torch.pipeline.crowdsam import CrowdSAM
    from crowdsam_tpu_torch.utils import init

    cfg = modify_config(_small_config(), ["model.sam_model", "vit_h"])
    with patched(init, "sam_state_dict", _cropped(draw.get())):
        with _no_default_init():
            gpu = CrowdSAM(cfg, device="cuda")
        _compare_small(gpu, cfg, "small_reference hd80")
    del gpu
    torch.cuda.empty_cache()


def _arch_once(label, overrides, required, absent):
    """One arch's model: a warm-up and one timed `generate` on a synthetic
    frame, the counts set to 0 just before it."""
    from crowdsam_tpu_torch.utils.synthetic import synthetic_images

    model, build_s = _arch_model(overrides)
    img = synthetic_images(0, 1)[0]
    model.generate(img)                      # warm-up
    torch.cuda.synchronize()
    counters = _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    data, ms = _timed_generate(model, img)
    launches = {k: fn.launches for k, fn in counters.items()}
    row = {"phase": label, "overrides": overrides, "build_s": build_s,
           "image_hw": list(img.shape[:2]), "ms_per_image": ms,
           "detections": len(data["boxes"]),
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches_per_image": launches,
           "launches_by_shape": _launches_by_shape()}
    print(json.dumps(row), flush=True)
    _require_launches(label, launches, required, absent)
    del model
    torch.cuda.empty_cache()
    return row


def phase_sam_hq():
    """`sam_hq` on SAM ViT-L at full width: the HQ decoder decodes unfused
    whatever `tpu.fused_decode` says, so K5 and K6 must not launch."""
    return _arch_once(
        "sam_hq", ["model.sam_arch", "sam_hq", "model.sam_model", "vit_l"],
        ["layer_norm", "window_attention", "flash_mha_decomposed_relpos",
         "flash_mha"], ["twoway_tail", "mask_head"])


def phase_mobile_sam():
    """`mobile_sam` (TinyViT-5M, no window/global rel-pos attention: K2 and
    K3 must not launch) with the fused decode."""
    return _arch_once(
        "mobile_sam", ["model.sam_arch", "mobile_sam", "model.sam_model",
                       "vit_t"],
        ["layer_norm", "flash_mha", "twoway_tail", "mask_head"],
        ["window_attention", "flash_mha_decomposed_relpos"])


# --------------------------------------------------------------------------
# float32 on the card, the train-free branch, the opt-in modes, rect encode
# --------------------------------------------------------------------------

TRAINFREE_CONFIG = "configs/crowdhuman_trainfree.yaml"
MC_CONFIG = "configs/crowdhuman_mc.yaml"
# The rect encode's shapes on the three frames (683x1024, 1024x768,
# 768x1024, 64 px buckets): K2's padded bands of 4x5 or 5x4 windows, K3's
# global grids (64 wide: the bias in registers; 64x48: the folded form;
# 64x44 as well, a 1024x683 frame's), K4's truncated DINOv2 grids + 1.
RECT_K2_GRIDS = ((56, 70), (70, 56))
RECT_K3_GRIDS = ((44, 64), (48, 64), (64, 48), (64, 44))
# Grids 64 tall of ViT-H's rect encode (head dim 80): a portrait frame's and
# the first frame turned on its side (phase `vit_h`).
RECT_K3_GRIDS_80 = ((64, 48), (64, 44))
# A band of an odd row count from an odd row (head dim 80: the last block of
# two consumers holds one row).
ODD_K3_BAND = (21, 42)
RECT_K4_TOKENS = (51 * 73 + 1, 55 * 73 + 1)
# The opt-in modes, each alone on the loaded configuration.
MODES = (("mask_selection max_area", dict(mask_selection="max_area")),
         ("mask_selection min_area", dict(mask_selection="min_area")),
         ("accumulate_occupy", dict(accumulate_occupy=True)),
         ("fuse_simmap", dict(fuse_simmap=True)),
         ("fullres_cleanup", dict(fullres_cleanup=True)))
# Small configurations held card against CPU (`_compare_small`), with the
# filters of `_small_config` off.
SMALL_CASES = (
    ("small trainfree", ["model.trainfree", "true", "model.sam_arch", "sam",
                         "test.mask_selection", "max_area",
                         "test.pos_sim_thresh", "0.05",
                         "test.filter_thresh", "0.99"]),
    ("small rect_encode", ["tpu.rect_encode", "true"]),
    ("small fullres_cleanup", ["tpu.fullres_cleanup", "true"]),
    ("small sam_hq", ["model.sam_arch", "sam_hq"]),
    ("small mobile_sam", ["model.sam_arch", "mobile_sam",
                          "model.sam_model", "vit_t"]),
    ("small crop_n_layers 1", ["test.crop_n_layers", "1"]),
)


def _sync_timed(fn, acc):
    """`fn` with a synchronized host clock around each call, its ms added
    to acc[-1]."""
    def wrapped(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        acc[-1] += (time.perf_counter() - t) * 1e3
        return out
    return wrapped


# --------------------------------------------------------------------------
# float32 on the card: the float32 arms of K2-K4, K1's float32 forward, and
# the paths that run them
# --------------------------------------------------------------------------

# The float32 arms' shapes: K2 (padded grid, head dim), K3 (grid, head dim,
# query rows), K4 (tokens, query tokens).
F32_K2 = (((70, 70), 64), ((70, 70), 80), ((28, 70), 64))
F32_K3 = (((64, 64), 64, (0, 64)), ((64, 48), 64, (0, 64)),
          ((44, 64), 64, (0, 44)), ((64, 64), 80, (0, 64)),
          ((64, 64), 64, (42, 64)))
F32_K4 = ((5330, (0, 5330)), (4096, (0, 4096)), (5330, (2628, 5330)),
          (1000, (0, 1000)))
# K1's float32 forward at the float32 path's shapes: DINOv2's and SAM's
# blocks, the neck, SAM ViT-H's blocks.
F32_K1 = ((5330, 1024), (4096, 1024), (4096, 256), (4096, 1280))


def _f32_arm_inputs(gen, arm, case):
    """(F32Attention, the wrapper call, its shape, K2's padded grid) of one
    case on float32 CUDA tensors laid out as the encoders hand them over: K2
    on the qkv projection of a padded grid of 14x14 windows, K3 and K4 on
    strided views of one qkv buffer, 16 heads."""
    from crowdsam_tpu_torch.models import attention as att
    from crowdsam_tpu_torch.models.image_encoder import _rel_pos_table

    heads = 16
    if arm == "K2":
        (gh, gw), hd = case
        qkv = torch.randn((1, gh, gw, 3 * heads * hd), generator=gen,
                          device="cuda")
        tabs = [_rel_pos_table(0.1 * torch.randn((27, hd), generator=gen,
                                                 device="cuda"), 14)
                for _ in range(2)]
        a = att.window_f32_attention(qkv, *tabs, heads, hd ** -0.5, 14)
        nw = (gh // 14) * (gw // 14)
        return (a, lambda: att.window_attention(qkv, *tabs, heads,
                                                hd ** -0.5, 14),
                f"{nw}x{heads}x196x{hd}", (gh, gw))
    if arm == "K3":
        (hh, ww), hd, (lo, hi) = case
        qkv = torch.randn((1, hh * ww, 3, heads, hd), generator=gen,
                          device="cuda")
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        q = q[:, :, lo * ww:hi * ww]
        rh, rw = (_rel_pos_table(0.1 * torch.randn(
            (127, hd), generator=gen, device="cuda"), n) for n in (hh, ww))
        a = att.relpos_f32_attention(q, k, v, hd ** -0.5, rh, rw, (hh, ww),
                                     lo)
        shape = (f"{heads}x{hh * ww}x{hd}" if (lo, hi) == (0, hh) else
                 f"{heads}x{(hi - lo) * ww}x{hd} of {hh * ww} keys")
        return (a, lambda: att.flash_mha_decomposed_relpos(
            q, k, v, hd ** -0.5, rh, rw, (hh, ww), lo), shape, (hh, ww))
    s, (lo, hi) = case
    qkv = torch.randn((1, s, 3, heads, 64), generator=gen, device="cuda")
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    q = q[:, :, lo:hi]
    a = att.flash_f32_attention(q, k, v, 0.125, s)
    shape = (f"{heads}x{s}x64" if (lo, hi) == (0, s)
             else f"{heads}x{hi - lo}x64 of {s} keys")
    return (a, lambda: att.flash_mha(q, k, v, 0.125, valid_len=s), shape,
            None)


def _f32_faults(a, arm):
    """The plain function with the faults of the float32 arm's design: the
    last 64-key tile dropped, valid_len one short, fh from the next grid
    row (row(k) + 1) and fw one column off (col(k) + 1) for K2 and K3, and
    where the keys do not fill the last tile (K2's 196 keys, K4 at 5330 and
    1000), one of its pad keys unmasked: K and V are zero-filled there, so
    a key of logit 0 and value 0.  Then the 3xTF32 model
    (`f32_attention_tf32x3_model`) with each fault of its own design: lo.hi
    dropped, V's keys unpermuted within their 8-key groups, a tile's lo
    part from the previous tile (a stale stage)."""
    from crowdsam_tpu_torch.models.attention import (
        TF32X3_FAULTS,
        f32_attention_logits,
        f32_attention_plain,
        f32_attention_tf32x3_model,
    )

    s = a.k.shape[-2]
    tail = 64 * ((a.valid - 1) // 64)
    faults = [(f"last key tile (keys {tail}-{a.valid - 1}) dropped",
               dataclasses.replace(a, valid=tail)),
              (f"valid_len off by one ({a.valid - 1})",
               dataclasses.replace(a, valid=a.valid - 1))]
    if a.fh is not None:
        faults += [("fh from the next grid row (row(k) + 1)",
                    dataclasses.replace(a, fh=_shift_last(a.fh, 1))),
                   ("fw one column off (col(k) + 1)",
                    dataclasses.replace(a, fw=_shift_last(a.fw, 1)))]
    out = [(label, f32_attention_plain(f)) for label, f in faults]
    if s % 64:
        logits = f32_attention_logits(a)
        logits = torch.cat([logits, torch.zeros_like(logits[..., :1])], -1)
        probs = torch.softmax(logits, -1)[..., :-1]
        out.append((("a window's pad key" if arm == "K2" else
                     "a pad key of the last tile")
                    + f" unmasked (key {s}: logit 0, value 0)",
                    probs @ a.v))
    out += [(f"3xTF32: {fault}", f32_attention_tf32x3_model(a, fault))
            for fault in TF32X3_FAULTS]
    return out


def _as_float64(a):
    return dataclasses.replace(a, **{
        k: getattr(a, k).double() for k in ("q", "k", "v", "fh", "fw")
        if getattr(a, k) is not None})


def _sdpa_backend(fn) -> dict:
    """The kernels one call of `fn` (an SDPA call) launches, and the
    backend their names show: memory-efficient (`fmha` / `efficient`),
    flash, cuDNN, or the math path (products and a softmax)."""
    names = sorted({_kernel_name(ev.name)[:60]
                    for ev in _cuda_events(fn, 1)})
    text = " ".join(names).lower()
    backend = ("EFFICIENT_ATTENTION" if "fmha" in text or "efficient" in text
               else "FLASH_ATTENTION" if "flash" in text
               else "CUDNN_ATTENTION" if "cudnn" in text else "MATH")
    return dict(sdpa_backend=backend, sdpa_kernels=names)


@functools.lru_cache(maxsize=None)
def _f32_sass(lib: str) -> dict:
    """Each kernel of a float32 arm's library (`csrc/<lib>.cu`: the
    attention arm's `attn_f32<HD,RELPOS>`, the decode arms' kernels): its
    tensor-core instructions (the HGMMA opcodes, by variant) and FFMAs,
    from cuobjdump of the built library; names as `_ptxas_report`'s."""
    from crowdsam_tpu_torch.kernels import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    path = _build._target(_build.sources()[lib])
    text = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for body in text.split("Function : ")[1:]:
        m = re.search(r"\d(attn_f32|tok_stage|tok_mlp|tok_qkv|t2i_merge"
                      r"|row_phase|mask_head_f32)I(\w+?)EEv",
                      body.splitlines()[0])
        if not m:
            continue
        args = re.findall(r"L[ib](\d+)E", m.group(2) + "E")
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                         r"([A-Z][A-Z0-9_.x]*)", body)
        out[f"{m.group(1)}<{','.join(args)}>"] = dict(
            hgmma=dict(collections.Counter(o for o in ops
                                           if o.startswith("HGMMA"))),
            ffma=sum(o.startswith("FFMA") for o in ops))
    return out


def _f32_instantiation(hd: int, relpos: bool, grid) -> dict:
    """The float32 arm's kernel at one call's shape: its dynamic shared
    memory and blocks an SM (`attention_f32_occupancy`), ptxas's registers
    and spilled bytes, and its SASS's HGMMA opcodes (each must be TF32) and
    FFMAs."""
    from crowdsam_tpu_torch.kernels import _build

    fn = _build.function("attention_f32", "attention_f32_occupancy",
                         (ctypes.c_int, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p))
    out = (ctypes.c_int * 2)()
    gh, gw = grid
    _build.check(fn(hd, int(relpos), gh, gw, ctypes.cast(out,
                                                          ctypes.c_void_p)),
                 "attention_f32_occupancy")
    name = f"attn_f32<{hd},{int(relpos)}>"
    rep = _ptxas_report("attention_f32").get(name, {})
    if rep.get("spill_store_bytes") or rep.get("spill_load_bytes"):
        raise AssertionError(f"{name}: ptxas spilled {rep}")
    sass = _f32_sass("attention_f32").get(name, {})
    if not sass.get("hgmma") or not all("TF32" in op
                                        for op in sass["hgmma"]):
        raise AssertionError(f"{name}: no TF32 HGMMA in its SASS: {sass}")
    return dict(kernel=name, smem_bytes=out[0], blocks_per_sm=out[1], **rep,
                sass=sass)


def phase_f32_arm(gen, arm, case):
    """One float32 arm (K2, K3 or K4 on float32 CUDA tensors) at one of the
    float32 path's shapes, against a float64 evaluation of the same
    function on the card and the plain float32 version (TF32 off): its max
    and mean absolute error from float64 each at most 2x the plain float32
    version's, with a floor of 1e-7 of max |out|; the faults of its design
    (`_f32_faults`) must break that bound 8-fold.  SDPA in float32 on the
    same prebuilt bias (its backend named) is measured against the same
    bound and printed (`library_err_over_tol`, not held to it).  Times the wrapper (CUDA events), the
    kernel alone (torch.profiler), the plain version and SDPA beside the
    bound (4 Sq S hd FLOP a head at 165 TFLOP/s, three TF32 products at
    495, or the bytes)."""
    from crowdsam_tpu_torch.models import attention as att

    a, call, shape, grid = _f32_arm_inputs(gen, arm, case)
    wrapper = {"K2": att.window_attention,
               "K3": att.flash_mha_decomposed_relpos,
               "K4": att.flash_mha}[arm]
    n0 = wrapper.launches_by_dtype["float32"]
    got = call()
    torch.cuda.synchronize()
    if wrapper.launches_by_dtype["float32"] != n0 + 1:
        raise AssertionError(f"{arm} float32 {shape}: the arm did not launch")

    def as_out(o):
        return (att.window_f32_output(o, 14, *grid) if arm == "K2" else o)

    want = as_out(att.f32_attention_plain(_as_float64(a)))
    plain = as_out(att.f32_attention_plain(a))
    floor = 1e-7 * float(want.abs().max())

    def errs(x):
        d = (x.double() - want).abs()
        return float(d.max()), float(d.mean())

    got_max, got_mean = errs(got)
    pl_max, pl_mean = errs(plain)
    tol_max, tol_mean = max(2 * pl_max, floor), max(2 * pl_mean, floor)

    def over(x):
        mx, mn = errs(x)
        return max(mx / tol_max, mn / tol_mean)

    faults = {label: over(as_out(f)) for label, f in _f32_faults(a, arm)}
    b, nh, sq, hd = a.q.shape
    s = a.k.shape[2]
    gh, gw = a.grid
    bias = None if a.fh is None else (
        a.fh.reshape(b, nh, sq, gh, 1) + a.fw.reshape(b, nh, sq, 1, gw)
    ).reshape(b, nh, sq, s)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def lib():
        return sdpa(a.q, a.k, a.v, attn_mask=bias, scale=a.scale)
    row = dict(shape=shape, max_abs_err=got_max, mean_abs_err=got_mean,
               plain_max_abs_err=pl_max, plain_mean_abs_err=pl_mean,
               out_max_abs=float(want.abs().max()),
               tol="max and mean |err| from float64 <= 2x the plain "
                   "float32 version's, floor 1e-7 max|out|",
               err_over_tol=over(got), fault_err_over_tol=faults,
               library_err_over_tol=over(as_out(lib())))
    del want, plain
    bad = [k for k, r in faults.items() if r <= 8.0]
    if not bool(torch.isfinite(got).all()) or row["err_over_tol"] > 1.0 \
            or bad:
        raise AssertionError(f"{arm} float32 {shape}: {row} (faults within "
                             f"8x the bound: {bad})")
    del got
    iters = 10 if arm != "K2" else 20
    t_k = time_ms(call, iters)
    d_k = device_ms(call, iters, "attn_f32")
    t_p = time_ms(lambda: att.f32_attention_plain(a), 3)
    t_l = time_ms(lib, iters)
    d_l = device_ms(lib, iters)
    backend = _sdpa_backend(lib)
    del bias
    flops = 4.0 * b * nh * sq * a.valid * hd
    nbytes = 4 * (b * nh * (2 * sq + 2 * s) * hd
                  + (0 if a.fh is None else a.fh.numel() + a.fw.numel()))
    b_ms, by = bound(nbytes, flops, F32_FLOP_PER_S)
    row.update(ms=t_k, device_ms=d_k, plain_ms=t_p, library_ms=t_l,
               library_device_ms=d_l, **backend,
               library_covers="SDPA in float32 on the same q, k, v with the "
                              "bias built beforehand" if a.fh is not None
               else "SDPA in float32 on the same strided views",
               bound_ms=b_ms, bound_by=by, bound_share=b_ms / d_k,
               tflops=flops / d_k / 1e9,
               instantiation=_f32_instantiation(hd, a.fh is not None,
                                                a.grid))
    print(json.dumps({"phase": f"{arm} float32", **row}), flush=True)
    return row


def phase_f32_arms(gen):
    """Every float32 arm at the float32 path's shapes (`phase_f32_arm`)."""
    rows = {"K2": [phase_f32_arm(gen, "K2", c) for c in F32_K2]}
    torch.cuda.empty_cache()
    rows["K3"] = [phase_f32_arm(gen, "K3", c) for c in F32_K3]
    torch.cuda.empty_cache()
    rows["K4"] = [phase_f32_arm(gen, "K4", c) for c in F32_K4]
    torch.cuda.empty_cache()
    return rows


def phase_layernorm_f32(gen):
    """K1's float32 forward at the float32 path's shapes against its plain
    version (1e-5 + 1e-5 |y|, mean 1e-6: float32 on both sides), with its
    bound and `F.layer_norm`'s time."""
    from crowdsam_tpu_torch.ops.layernorm import layer_norm, layer_norm_plain

    rows = []
    for n, d in F32_K1:
        x = torch.randn((n, d), generator=gen, device="cuda")
        w = 1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
        b = 0.1 * torch.randn(d, generator=gen, device="cuda")
        cmp = compare(f"layer_norm float32 {n}x{d}", layer_norm(x, w, b, 1e-6),
                      layer_norm_plain(x, w, b, 1e-6), 1e-5,
                      require_faults=False, mean_atol=1e-6, rtol=1e-5)
        t_k = time_ms(lambda: layer_norm(x, w, b, 1e-6), 50)
        d_k = device_ms(lambda: layer_norm(x, w, b, 1e-6), 50, "ln_")
        t_p = time_ms(lambda: layer_norm_plain(x, w, b, 1e-6), 10)
        lib = (lambda: torch.nn.functional.layer_norm(x, (d,), w, b, 1e-6))
        t_l, d_l = time_ms(lib, 50), device_ms(lib, 50)
        b_ms, by = bound(2 * n * d * 4 + 2 * d * 4, 8.0 * n * d,
                         FFMA_FLOP_PER_S)
        rows.append(dict(shape=f"{n}x{d}", **cmp, ms=t_k, device_ms=d_k,
                         plain_ms=t_p, library_ms=t_l, library_device_ms=d_l,
                         bound_ms=b_ms, bound_by=by))
        print(json.dumps({"phase": "K1 float32", **rows[-1]}), flush=True)
    return rows


F32_PATH = ["model.sam_adapter_checkpoint", ADAPTER,
            "tpu.compute_dtype", "float32", "tpu.fused_decode", "false"]


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


@contextlib.contextmanager
def _counted_by_dtype_shape():
    """K1-K7's launches inside the block by dtype and shape: K1 through its
    launch `ops.layernorm._forward`, K2-K4 from their wrappers' counts, K5
    and K6 through the fused decode's calls of their wrappers, K7 through
    the engine's."""
    from crowdsam_tpu_torch.models import fused_decode as fd
    from crowdsam_tpu_torch.ops import layernorm as ln
    from crowdsam_tpu_torch.pipeline import engine

    counters = _reset_counts()
    k1 = collections.Counter()
    k56 = {"twoway_tail": collections.Counter(),
           "mask_head": collections.Counter(),
           "survivor_rle": collections.Counter()}
    real = ln._forward

    def counted(x, weight, bias, eps, stats):
        d = x.shape[-1]
        k1[f"{_dtype_name(x)} {x.numel() // d}x{d}"] += 1
        return real(x, weight, bias, eps, stats)

    def k5(*a, **kw):
        keys0, tokens = a[0], a[4]
        images = f", {keys0.shape[0]} images" if keys0.dim() == 3 else ""
        k56["twoway_tail"][f"{_dtype_name(keys0)} {tokens.shape[0]}x"
                           f"{tokens.shape[1]} tokens, {keys0.shape[-2]} "
                           f"rows{images}"] += 1
        return real_k5(*a, **kw)

    def k6(keys2, hyper_in, weights, emit_exp=False):
        k56["mask_head"][f"{_dtype_name(keys2)} {keys2.shape[0]}x"
                         f"{keys2.shape[1]}"
                         + (" emit_exp" if emit_exp else "")] += 1
        return real_k6(keys2, hyper_in, weights, emit_exp=emit_exp)

    def k7(logits, *a, **kw):
        k56["survivor_rle"][f"{_dtype_name(logits)} "
                            f"{'x'.join(map(str, logits.shape))}"] += 1
        return real_k7(logits, *a, **kw)

    real_k5, real_k6, real_k7 = fd.twoway_tail, fd.mask_head, \
        engine.survivor_rle
    out = {}
    with patched(ln, "_forward", counted), patched(fd, "twoway_tail", k5), \
            patched(fd, "mask_head", k6), \
            patched(engine, "survivor_rle", k7):
        yield out
    out["launches"] = {k: fn.launches for k, fn in counters.items()}
    out["layer_norm_by_dtype_shape"] = dict(k1)
    for k in ("window_attention", "flash_mha_decomposed_relpos",
              "flash_mha", "twoway_tail", "mask_head"):
        fn = counters[k]
        out[f"{k}_by_dtype"] = dict(fn.launches_by_dtype)
        out[f"{k}_by_shape"] = dict(k56[k] if k in k56
                                    else fn.launches_by_shape)
    out["survivor_rle_by_dtype_shape"] = dict(k56["survivor_rle"])


def _f32_run(model, frames, noises):
    """`generate` on each frame (after a warm-up), with the frame's SAM and
    DINOv2 features (on the host) and the host-clock ms."""
    out = []
    for img, nz in zip(frames, noises):
        data, ms = _timed_generate(model, img, nz)
        p = model.predictor
        out.append(dict(data=data, ms=ms, sam=p.features.float().cpu(),
                        dino=p.dino_feats.float().cpu(),
                        engine=model.last_engine))
    return out


def _match_iou(got, want, thr=0.5):
    """Detections of `want` matched greedily (by score) to those of `got`
    at box IoU >= thr: (matched share, score gaps of the matches)."""
    gb, wb = np.asarray(got["boxes"], float), np.asarray(want["boxes"], float)
    if len(wb) == 0:
        return None, []
    used, gaps = set(), []
    for i in np.argsort(-np.asarray(want["scores"])):
        if len(gb) == 0:
            break
        lt = np.maximum(gb[:, :2], wb[i, :2])
        rb = np.minimum(gb[:, 2:], wb[i, 2:])
        inter = np.prod(np.clip(rb - lt, 0, None), axis=1)
        area = lambda b: (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
        iou = inter / (area(gb) + area(wb[i]) - inter + 1e-9)
        iou[list(used)] = -1
        j = int(np.argmax(iou))
        if iou[j] >= thr:
            used.add(j)
            gaps.append(float(abs(got["scores"][j] - want["scores"][i])))
    return len(gaps) / len(wb), gaps


def phase_f32_path(bf16_model):
    """`configs/crowdhuman.yaml` with `tpu.compute_dtype float32` and
    `tpu.fused_decode false` at full width and depth (SAM ViT-L, DINOv2
    ViT-L/14, the shipped adapter, which keeps detections there; random
    encoders) on the main path's three frames at the reference
    thresholds: ms/image, the encode's device ms, the
    device idle share, peak memory, and K1-K4's launches by dtype and shape
    (every one float32; K5 and K6 none).

    Held against the same run with the plain versions patched in
    (`_against_plain`: K1-K4, as K5 and K6 do not run in the unfused
    decode; TF32 off): SAM and DINOv2 features within 1e-4 relative L2,
    equal detection counts, boxes within 0.5 px and scores within 1e-4, RLE
    strings equal or differing only at threshold ties (`_threshold_ties`,
    their pixels named).  TF32 tripwire: the first frame run
    again after this script sets `torch.backends.cudnn.allow_tf32 = True`
    and `torch.set_float32_matmul_precision("high")` gives features bit for
    bit those of the first run.  Last, the bf16 main path's distance from
    this run (`bf16_model`: the same config in bf16 with the fused decode):
    the features' relative L2, and detections matched at IoU 0.5 with their
    score gaps.  Returns (the float32 model, its row, its runs)."""
    from crowdsam_tpu_torch.config import modify_config
    from crowdsam_tpu_torch.pipeline.crowdsam import CrowdSAM
    from crowdsam_tpu_torch.utils.synthetic import (
        full_width_config,
        synthetic_images,
    )

    t = time.time()
    with _no_default_init():
        model = CrowdSAM(modify_config(full_width_config(), F32_PATH),
                         device="cuda")
    torch.cuda.synchronize()
    build_s = time.time() - t
    frames = synthetic_images(0, N_IMAGES)
    noises = [torch.rand(model.engine_cfg.grid_size ** 2,
                         generator=torch.Generator().manual_seed(40 + i))
              for i in range(len(frames))]
    _timed_generate(model, frames[0], noises[0])        # warm-up
    torch.cuda.reset_peak_memory_stats()
    with _counted_by_dtype_shape() as counts:
        runs = _f32_run(model, frames, noises)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    encode_dev = [_encode_device_ms(model, img) for img in frames[:N_IMAGES]]
    wall, busy, top = _device_busy(model, frames[0])
    vs_plain = _against_plain("float32 path", model, runs, frames, noises)
    # The tripwire: TF32 switched on by the caller, restored after.
    saved = (torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        wire = _f32_run(model, frames[:1], noises[:1])[0]
        flags_after = (torch.backends.cudnn.allow_tf32,
                       torch.get_float32_matmul_precision())
    finally:
        torch.backends.cudnn.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])
    tripwire = {k: bool(torch.equal(wire[k], runs[0][k]))
                for k in ("sam", "dino")}
    bf16 = _f32_run(bf16_model, frames, noises)
    vs_bf16 = []
    for r, q in zip(runs, bf16):
        share, gaps = _match_iou(q["data"], r["data"])
        vs_bf16.append(dict(
            sam_rel_l2=_rel_l2(q["sam"], r["sam"]),
            dino_rel_l2=_rel_l2(q["dino"], r["dino"]),
            detections=[len(r["data"]["boxes"]), len(q["data"]["boxes"])],
            matched_share_iou_0_5=share,
            score_gap_max=max(gaps) if gaps else None,
            score_gap_median=float(np.median(gaps)) if gaps else None))
    row = {
        "phase": "float32 path",
        "config": "configs/crowdhuman.yaml + tpu.compute_dtype float32 "
                  "tpu.fused_decode false, SAM ViT-L + DINOv2 ViT-L/14 + "
                  f"{ADAPTER}, random encoders",
        "build_s": build_s,
        "image_hw": [list(f.shape[:2]) for f in frames],
        "ms_per_image": [r["ms"] for r in runs],
        "encode_device_ms": encode_dev,
        "device_profile": {"wall_ms": wall, "device_busy_ms": busy,
                           "device_idle_share": 1.0 - busy / wall,
                           "kernels_ms": top},
        "peak_memory_gib": peak,
        "detections_per_image": [len(r["data"]["boxes"]) for r in runs],
        **counts,
        "vs_plain": vs_plain,
        "tf32_tripwire": {"bit_for_bit": tripwire,
                          "caller_flags_inside_and_after": list(flags_after)},
        "bf16_main_path_vs_float32": vs_bf16,
    }
    print(json.dumps(row), flush=True)
    launches = counts["launches"]
    _require_launches("float32 path", launches,
                      ["layer_norm", "window_attention",
                       "flash_mha_decomposed_relpos", "flash_mha"],
                      ["twoway_tail", "mask_head"])
    not_f32 = {k: v for k in ("window_attention",
                              "flash_mha_decomposed_relpos", "flash_mha")
               for v in [counts[f"{k}_by_dtype"]] if set(v) != {"float32"}}
    not_f32.update({k: v for k, v in counts[
        "layer_norm_by_dtype_shape"].items() if not k.startswith("float32")})
    if not_f32:
        raise AssertionError(f"float32 path: launches not float32 {not_f32}")
    if not all(tripwire.values()) or flags_after != (True, "high"):
        raise AssertionError(f"float32 path: TF32 tripwire {tripwire}, "
                             f"flags {flags_after}")
    return model, row, runs


TRAIN_F32_REFERENCE = "--train-f32-reference"
TRAIN_F32_THREADS = 3         # the CPU reference process's torch threads


def phase_train_f32(model):
    """`cache_features` of 3 shots and 3 full-decoder steps (one a shot) in
    float32 on the card (the float32 path's model; its decoder is not
    changed: the steps run on master copies): ms/step, peak memory, K1's
    float32 launches.  The same steps on the CPU, from the card's cached
    features, each from the card step's parameters and draws, run in a
    process of their own (`_train_f32_reference`, 3 torch threads: a
    full-width decoder step takes 13-17 s of CPU) while the rest of the
    script goes on; `finish_train_f32` holds the card against them.
    Returns the job."""
    import atexit
    import copy
    import tempfile

    from crowdsam_tpu_torch.config import modify_config
    from crowdsam_tpu_torch.ops import layernorm as ln
    from crowdsam_tpu_torch.train.dataset import ArrayDataset
    from crowdsam_tpu_torch.train.trainer import AdamW, AdapterTrainer

    cfg = modify_config(copy.deepcopy(model.config), [
        "train.n_shot", "3", "train.steps", "3", "train.full_decoder", "True",
        "train.lr", "2e-4"])
    data = ArrayDataset(*_ten_shot())
    trainer = AdapterTrainer(cfg, model.predictor)
    torch.cuda.synchronize()
    t = time.perf_counter()
    trainer.cache_features(data)
    torch.cuda.synchronize()
    cache_ms = (time.perf_counter() - t) * 1e3
    params = trainer.trainable_params()
    opt = AdamW(trainer.lr, trainer.weight_decay, trainer.clip_grad)
    state = opt.init(params)
    n_cached = len(trainer.cache["n_boxes"])
    ln0, bw0 = ln.layer_norm.launches, ln.layer_norm_backward.launches
    torch.cuda.reset_peak_memory_stats()
    steps, ms = [], []
    for step in range(trainer.steps):
        draws = trainer.draw(step)
        before = {k: v.cpu().clone() for k, v in params.items()}
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, losses, grads = trainer.loss_and_grads(params, step % n_cached,
                                                  draws)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        steps.append(dict(shot=step % n_cached, params=before, draws=draws,
                          losses={k: float(v) for k, v in losses.items()},
                          grads={k: v.cpu().clone()
                                 for k, v in grads.items()}))
        opt.step(params, grads, state)
    row = {"phase": "train float32", "steps": len(steps),
           "cache_features_ms": cache_ms, "ms_per_step": ms,
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "layer_norm_launches": ln.layer_norm.launches - ln0,
           "layer_norm_backward_launches":
               ln.layer_norm_backward.launches - bw0}
    # The CPU side: the prompt encoder and the decoder, copied, over the
    # card's cache.
    sam_cpu = torch.nn.Module()
    sam_cpu.prompt_encoder = copy.deepcopy(model.sam.prompt_encoder).cpu()
    sam_cpu.mask_decoder = copy.deepcopy(model.sam.mask_decoder).cpu()
    sam_cpu.img_size = model.sam.img_size
    sam_cpu.mask_threshold = model.sam.mask_threshold
    work = tempfile.mkdtemp(prefix="train_f32_")
    path = os.path.join(work, "steps.pt")
    torch.save({"config": cfg, "sam": sam_cpu, "steps": steps,
                "cache": {k: v.cpu() if isinstance(v, torch.Tensor) else v
                          for k, v in trainer.cache.items()}}, path)
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             TRAIN_F32_REFERENCE, path])
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return dict(row=row, proc=proc, work=work, path=path)


def _train_f32_reference(path: str) -> int:
    """The CPU side of `phase_train_f32`, in a process of its own: each
    step's loss terms and gradients from that step's parameters and draws
    over the card's cache, held against the card's; writes the figures
    beside `path`."""
    import types

    from crowdsam_tpu_torch.train.trainer import AdapterTrainer

    torch.set_num_threads(TRAIN_F32_THREADS)
    job = torch.load(path, weights_only=False)
    cpu = AdapterTrainer(job["config"], types.SimpleNamespace(
        model=job["sam"], device=torch.device("cpu"),
        dino_model=torch.nn.Module()))
    cpu.cache = job["cache"]
    out = []
    for st in job["steps"]:
        t = time.perf_counter()
        _, l_c, g_c = cpu.loss_and_grads(st["params"], st["shot"],
                                         st["draws"])
        norm = float(torch.sqrt(sum(g.double().square().sum()
                                    for g in g_c.values())))
        out.append(dict(
            loss_rel_diff={k: abs(st["losses"][k] - float(v))
                           / max(abs(float(v)), 1e-30)
                           for k, v in l_c.items()},
            grad_max_diff_over_norm=max(
                float((st["grads"][k] - g_c[k]).abs().max()) for k in g_c)
            / norm, global_norm=norm, loss=st["losses"],
            cpu_step_s=time.perf_counter() - t))
    with open(path + ".json", "w") as f:
        json.dump(out, f)
    return 0


def finish_train_f32(job, timeout_s: float = 300.0):
    """Wait for `phase_train_f32`'s CPU reference and hold the card's steps
    against it: loss terms within 1e-5 relative, gradients within 1e-4 of
    the global norm; the process must end with 0."""
    try:
        rc = job["proc"].wait(timeout=timeout_s)
    finally:
        if job["proc"].poll() is None:
            job["proc"].kill()
    row = dict(job["row"])
    if rc != 0:
        raise AssertionError(f"train float32: the CPU reference exited {rc}")
    with open(job["path"] + ".json") as f:
        steps = json.load(f)
    shutil.rmtree(job["work"], ignore_errors=True)
    row.update(by_step=steps, cpu_reference=f"the same steps on the CPU "
               f"({TRAIN_F32_THREADS} torch threads, a process of its own)",
               tol={"loss_rel": 1e-5, "grad_over_norm": 1e-4})
    print(json.dumps(row), flush=True)
    worst_loss = max(v for s in steps for v in s["loss_rel_diff"].values())
    worst_grad = max(s["grad_max_diff_over_norm"] for s in steps)
    if worst_loss > 1e-5 or worst_grad > 1e-4 or row[
            "layer_norm_launches"] == 0:
        raise AssertionError(f"train float32: card against CPU {row}")
    return row


def phase_amg_f32(sam):
    """The automatic mask generator on the float32 path's SAM (float32
    arms of K1-K3) on crowd_scene(0) at 16 points a side, the filters off
    and no small-region cleanup: records (each mask inside its bbox), ms,
    K1-K3's float32 launches."""
    from crowdsam_tpu_torch.pipeline.amg_generator import (
        SamAutomaticMaskGenerator,
    )
    from crowdsam_tpu_torch.utils.bench_fixture import crowd_scene

    img = crowd_scene(0)[0]
    gen = SamAutomaticMaskGenerator(
        sam, points_per_side=16, points_per_batch=64, pred_iou_thresh=0.0,
        stability_score_thresh=0.0, min_mask_region_area=0,
        output_mode="coco_rle", device="cuda")
    gen.generate(img)                                   # warm-up
    with _counted_by_dtype_shape() as counts:
        torch.cuda.synchronize()
        t = time.perf_counter()
        records = gen.generate(img)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
    _amg_records_check(records, img.shape[:2])
    row = {"phase": "amg float32", "frame": "crowd_scene(0)",
           "points_per_side": 16, "records": len(records), "ms": ms,
           **counts}
    print(json.dumps(row), flush=True)
    launches = counts["launches"]
    _require_launches("amg float32", launches,
                      ["layer_norm", "window_attention",
                       "flash_mha_decomposed_relpos"],
                      ["twoway_tail", "mask_head"])
    if any(set(counts[f"{k}_by_dtype"]) != {"float32"}
           for k in ("window_attention", "flash_mha_decomposed_relpos")) \
            or not records:
        raise AssertionError(f"amg float32: {row}")
    return row


# --------------------------------------------------------------------------
# float32 with the fused decode: the float32 arms of K5 and K6
# (`csrc/decode_tail_f32.cu`, `csrc/mask_head_f32.cu`) and the paths that
# run them
# --------------------------------------------------------------------------

# `configs/crowdhuman.yaml` in float32 with the fused decode (its default).
F32_FUSED = ["model.sam_adapter_checkpoint", ADAPTER,
             "tpu.compute_dtype", "float32"]


def _f64_held(label, outs, faults):
    """A float32 arm's outputs (name -> (arm, plain float32, float64)) held
    to the float64 evaluation: max and mean |err| each at most 2x the plain
    float32 version's, with a floor of 1e-7 max |out|; every fault (label,
    name -> tensor, the plain version with a fault of the arm's design)
    over 8x that bound on at least one output.  Returns the figures;
    raises past either."""
    rows, tols = {}, {}
    for name, (got, plain, want) in outs.items():
        want = want.double()

        def errs(x, want=want):
            d = (x.double() - want).abs()
            return float(d.max()), float(d.mean())

        g, p = errs(got), errs(plain)
        floor = 1e-7 * float(want.abs().max())
        tol = (max(2 * p[0], floor), max(2 * p[1], floor))
        tols[name] = (want, tol)
        rows[name] = dict(max_abs_err=g[0], mean_abs_err=g[1],
                          plain_max_abs_err=p[0], plain_mean_abs_err=p[1],
                          out_max_abs=float(want.abs().max()),
                          err_over_tol=max(g[0] / tol[0], g[1] / tol[1]),
                          finite=bool(torch.isfinite(got).all()))

    def over(name, x):
        want, tol = tols[name]
        d = (x.double() - want).abs()
        return max(float(d.max()) / tol[0], float(d.mean()) / tol[1])

    fault_rows = {lb: {n: over(n, x) for n, x in f.items()}
                  for lb, f in faults}
    row = dict(outputs=rows, fault_err_over_tol=fault_rows,
               tol="max and mean |err| from float64 <= 2x the plain float32 "
                   "version's, floor 1e-7 max|out|; faults > 8x")
    bad = [lb for lb, r in fault_rows.items() if max(r.values()) <= 8.0]
    failed = [n for n, r in rows.items()
              if r["err_over_tol"] > 1.0 or not r["finite"]]
    if failed or bad:
        raise AssertionError(f"{label}: outputs over the bound {failed}, "
                             f"faults within 8x {bad}: {row}")
    return row


# The float32 decode arms' kernels that multiply on the tensor cores (the
# others, row phase 0 and the merges, have no product).
DECODE_F32_PRODUCTS = ("tok_stage", "tok_qkv", "tok_mlp", "row_phase<1>",
                       "row_phase<2>", "mask_head_f32")


def _f32_arm_report(lib: str, entry: str, n: int) -> dict:
    """A float32 decode arm's kernels: dynamic shared memory and blocks an
    SM (the source's occupancy entry, `n` ints), ptxas's registers and
    spilled bytes, and their SASS's HGMMA opcodes (`_f32_sass`); a
    kernel that spills fails, and so does a product kernel without HGMMA
    or any HGMMA that is not TF32."""
    from crowdsam_tpu_torch.kernels import _build

    fn = _build.function(lib, entry, (ctypes.c_void_p,))
    out = (ctypes.c_int * n)()
    _build.check(fn(ctypes.cast(out, ctypes.c_void_p)), entry)
    rep = _ptxas_report(lib)
    spilled = {k: v for k, v in rep.items()
               if v.get("spill_store_bytes") or v.get("spill_load_bytes")}
    if spilled or not rep:
        raise AssertionError(f"{lib}: ptxas spilled {spilled} ({rep})")
    sass = _f32_sass(lib)
    bad = {k: v for k, v in sass.items()
           if not all("TF32" in op for op in v["hgmma"])
           or (k.startswith(DECODE_F32_PRODUCTS) and not v["hgmma"])}
    if bad or not sass:
        raise AssertionError(f"{lib}: HGMMA missing or not TF32 in {bad} "
                             f"({sass})")
    return dict(occupancy=list(out), kernels=rep, sass=sass)


def _f32_k5_cases(model, small):
    """(label, model, shared, tokens, img, dino) of K5's float32 shapes:
    the main path's 32 x 7 at 4096 rows, the small config's 32 x 7 at
    256, 2 images x 32 prompts, a prompt shard's 16 (M = 2) and T = 8 (two
    points and the padding token)."""
    from crowdsam_tpu_torch.utils.synthetic import synthetic_images

    frame = synthetic_images(3, 1)[0]
    sh, tok, _, dino = _images_decoder_inputs(model, [frame])
    sm_sh, sm_tok, _, sm_dino = _images_decoder_inputs(small,
                                                       [_small_image()])
    im_sh, im_tok, im_img, im_dino = _images_decoder_inputs(
        model, synthetic_images(20, 2))
    t8_sh, t8_tok, _, t8_dino = _images_decoder_inputs(model, [frame],
                                                       n_points=2)
    return [("main path, 32x7, M=4096", model, sh, tok, None, dino[0]),
            ("small, 32x7, M=256", small, sm_sh, sm_tok, None, sm_dino[0]),
            ("image axis, 2 images x 32x7, M=4096", model, im_sh, im_tok,
             im_img, im_dino),
            ("prompt shard M=2, 16x7, M=4096", model, sh, tok[:16], None,
             dino[0]),
            ("T=8, 32x8, M=4096", model, t8_sh, t8_tok, None, t8_dino[0])]


def _k5_f32_faults(args, img):
    """The plain version with faults of the float32 arm's design: the last
    row tile's partial left out of block 2's merge, kpe2 (the PE-side term
    of block 2's k) left out, the MLPs' ReLU dropped, and prompt p's token
    stage reading prompt p + 1's rows (block 2's MLP) or, over several
    images, every prompt reading the next image's rows; and the faults of
    its arithmetic on its model, `twoway_tail_tf32x3_model`
    (`TWOWAY_FAULTS`: lo.hi dropped, a stage's lo from the next stage, A's
    lo not split again at a k-step, a prompt's folded values from the next
    prompt)."""
    from crowdsam_tpu_torch.models import decode_tail_kernel as dtk

    def plain(*a, params=args[5]):
        return dtk.twoway_tail_plain(*a, params, img=img)

    real_attend = dtk._t2i_attend
    with patched(dtk, "_t2i_attend", _nth_call(
            real_attend, 2, lambda st, q, k, v, h: real_attend(
                st, q, k[..., :-64, :], v[..., :-64, :], h))):
        f_tile = plain(*args[:5])
    f_pe = plain(*args[:5], params=dict(
        args[5], kpe2=torch.zeros_like(args[5]["kpe2"])))
    with patched(torch, "relu", lambda x: x):
        f_relu = plain(*args[:5])
    real_dense = dtk._Stages.dense

    def next_rows(self, x, name):
        return real_dense(self, torch.roll(x, -1, dims=0)
                          if name == "mlp1" else x, name)
    with patched(dtk._Stages, "dense", next_rows):
        f_rows = plain(*args[:5])
    faults = [("the last row tile's partial left out of block 2's merge",
               f_tile), ("kpe2 left out of block 2's k", f_pe),
              ("the MLPs' ReLU dropped", f_relu),
              ("block 2's MLP reads prompt p + 1's token rows", f_rows)]
    if img is not None:
        faults.append(("every prompt reads the next image's rows", plain(
            *(x.roll(-1, 0) for x in args[:4]), args[4])))
    # The faults of the arm's arithmetic, on its model (3xTF32 in PyTorch).
    from crowdsam_tpu_torch.models.common import exact_float32
    with exact_float32():
        for f in dtk.TWOWAY_FAULTS:
            faults.append((f"model: {f}", dtk.twoway_tail_tf32x3_model(
                *args, img=img, fault=f)))
    return [(lb, {"keys2": f[0], "tokens": f[1]}) for lb, f in faults]


def phase_k5_f32(model, small):
    """K5's float32 arm (`csrc/decode_tail_f32.cu`) on the operands of the
    float32 path's model (`model`, the shipped adapter) and of the small
    config in float32 (`small`, random weights) at `_f32_k5_cases`'
    shapes, against a float64 evaluation of the plain version on the card
    and the plain float32 version (`_f64_held`, keys2 and the tokens; the
    faults of `_k5_f32_faults`); two calls bit for bit.  Times the wrapper
    (CUDA events), its sixteen launches' span and each launch kind's
    duration (torch.profiler, `device_by_launch`), the plain
    version and the path it replaces in float32 (the unfused
    `TwoWayTransformer.forward` of each prompt's image, TF32 off) beside
    the bound (`_k5_bound` at 165 TFLOP/s, `F32_FLOP_PER_S`).  Returns
    (the rows, each case's operands and outputs for `phase_k6_f32`)."""
    from crowdsam_tpu_torch.models import decode_tail_kernel as dtk
    from crowdsam_tpu_torch.models.common import exact_float32

    report = _f32_arm_report("decode_tail_f32", "twoway_tail_f32_occupancy",
                             4)
    rows, outs = [], []
    for label, mdl, shared, tokens, img, dino in _f32_k5_cases(model, small):
        args = _tail_args(shared, tokens)
        p, t, c = tokens.shape
        m = args[0].shape[-2]
        n0 = dtk.twoway_tail.launches_by_dtype["float32"]
        got = dtk.twoway_tail(*args, img=img)
        again = dtk.twoway_tail(*args, img=img)
        torch.cuda.synchronize()
        if dtk.twoway_tail.launches_by_dtype["float32"] != n0 + 2:
            raise AssertionError(f"K5 float32 {label}: the arm did not "
                                 "launch")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"K5 float32 {label}: two calls differ")
        # Each prompt on its own: the first image's prompts alone (or the
        # first 8) give the same bits as in the whole call.
        rows_i = (torch.arange(8, device="cuda") if img is None
                  else torch.nonzero(img == 0).flatten())
        alone = dtk.twoway_tail(*(x[0] if img is not None else x
                                  for x in args[:4]),
                                tokens[rows_i].contiguous(), args[5])
        if not all(torch.equal(a, b[rows_i]) for a, b in zip(alone, got)):
            raise AssertionError(f"K5 float32 {label}: a prompt's result "
                                 "depends on the call's other prompts")
        del alone
        plain = dtk.twoway_tail_plain(*args, img=img)
        want = dtk.twoway_tail_plain(
            *(x.double() for x in args[:5]),
            {k: v.double() for k, v in args[5].items()}, img=img)
        held = _f64_held(f"K5 float32 {label}", {
            "keys2": (got[0], plain[0], want[0]),
            "tokens": (got[1], plain[1], want[1])},
            _k5_f32_faults(args, img))
        del plain, want, again
        fn = (lambda: dtk.twoway_tail(*args, img=img))
        keys0 = args[0] if img is None else args[0][img.long()]
        src = keys0.expand(p, m, c)
        pos = mdl.predictor.dense_pe.reshape(1, m, c).expand(p, m, c)
        with exact_float32():
            t_r = time_ms(lambda: mdl.sam.mask_decoder.transformer(
                src, pos, tokens), 2, warmup=1)
        b_ms, by = _k5_bound(args, got, p, t, m, F32_FLOP_PER_S)
        # Its sixteen launches overlap (each a programmatic dependent
        # launch that starts before the one before it ends and waits): the
        # span of their union a call, and each launch kind's duration, its
        # wait included (torch.profiler; None where it kept no record).
        d_k = _profiled(device_span_ms, fn, 10)
        split = _profiled(device_split, fn, 10)
        rows.append(dict(
            shape=label, max_abs_err=max(
                o["max_abs_err"] for o in held["outputs"].values()),
            **held, ms=time_ms(fn, 5), device_ms=d_k,
            device_by_launch=split,
            device_by_launch_covers="each launch's duration, the wait for "
                                    "the launch before it included",
            plain_ms=time_ms(lambda: dtk.twoway_tail_plain(*args, img=img),
                             2, warmup=1),
            replaced_ms=t_r,
            replaced="TwoWayTransformer.forward (unfused) in float32",
            library_ms=None, bound_ms=b_ms, bound_by=by,
            bound_share=b_ms / d_k if d_k else None, **report))
        print(json.dumps({"phase": "K5 float32", **rows[-1]}), flush=True)
        outs.append((label, mdl, shared, got, dino))
        del keys0, src, pos
    torch.cuda.empty_cache()
    return rows, outs


def _k6_f32_faults(keys2, hyper, weights, emit_exp, plain):
    """The plain version with faults of the float32 arm's design: the
    LayerNorm over all 256 channels of a row (not a group of 64), the
    sub-pixels q1 and q2 swapped, mask k given hypernetwork vector k + 1,
    and (with `emit_exp`) the tile max from the first warp's eight rows
    only; and the faults of its arithmetic on its model,
    `mask_head_tf32x3_model` (`MASK_HEAD_FAULTS`: those of every product
    and the second weight's inputs out of the accumulators' order).
    `plain`: the plain version's outputs (masks[, e, mx])."""
    from crowdsam_tpu_torch.models import mask_head_kernel as mhk

    def ln_all_lanes(x, w, b):
        u = x.mean((-1, -2), keepdim=True)
        s = (x - u).square().mean((-1, -2), keepdim=True)
        return (x - u) * torch.rsqrt(s + mhk.LN_EPS) * w + b

    def as_dict(out):
        out = out if emit_exp else (out,)
        return dict(zip(("masks", "e", "mx"), out))

    with patched(mhk, "_group_ln", ln_all_lanes):
        f_ln = mhk.mask_head_plain(keys2, hyper, weights, emit_exp)
    p, k, m = keys2.shape[0], hyper.shape[1], keys2.shape[1]
    swap = {n: x.reshape(p, k, m, 4, 4).transpose(-1, -2).reshape(
        p, k, m, 16) for n, x in zip(("masks", "e"), plain)}
    faults = [("the LayerNorm over 256 channels, not a group of 64",
               as_dict(f_ln)), ("sub-pixels q1 and q2 swapped", swap),
              ("mask k given hypernetwork vector k + 1", as_dict(
                  mhk.mask_head_plain(keys2, hyper.roll(-1, 1), weights,
                                      emit_exp)))]
    if emit_exp:
        masks = plain[0].reshape(p, k, m // 64, 64, 16)
        mx = masks[:, :, :, :8].amax(dim=(1, 3, 4))
        e = torch.exp(masks - mx[:, None, :, None, None]).reshape(p, k, m, 16)
        faults.append(("the tile max from the first warp's rows only",
                       {"e": e, "mx": mx}))
    # The faults of the arm's arithmetic, on its model (3xTF32 in PyTorch).
    from crowdsam_tpu_torch.models.common import exact_float32
    with exact_float32():
        for f in mhk.MASK_HEAD_FAULTS:
            faults.append((f"model: {f}", as_dict(mhk.mask_head_tf32x3_model(
                keys2, hyper, weights, emit_exp, fault=f))))
    return faults


def _k6_f32_kernel_ms(keys2, hyper, weights, emit, iters=20):
    """K6's float32 kernel alone: CUDA events over `iters` back-to-back
    calls of its C entry point on operands, packed weights and outputs made
    beforehand (no wrapper, no allocation between the launches)."""
    from crowdsam_tpu_torch.kernels import _build
    from crowdsam_tpu_torch.models import mask_head_kernel as mhk
    from crowdsam_tpu_torch.models import tf32x3

    fn = _build.function("mask_head_f32", "mask_head_f32_forward",
                         mhk._ARGTYPES)
    p, m, _ = keys2.shape
    masks = torch.empty((p, hyper.shape[1], m, 16), device="cuda")
    e = torch.empty_like(masks) if emit else None
    mx = torch.empty((p, m // 64), device="cuda") if emit else None
    w0 = tf32x3.packed(weights["w0t"])
    w2 = tf32x3.packed(weights["w2t"], "key_order")
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        _build.check(fn(keys2.data_ptr(), hyper.data_ptr(), w0.data_ptr(),
                        weights["b0"].data_ptr(), weights["ln_w"].data_ptr(),
                        weights["ln_b"].data_ptr(), w2.data_ptr(),
                        weights["b2"].data_ptr(), masks.data_ptr(),
                        e.data_ptr() if emit else None,
                        mx.data_ptr() if emit else None, p, m, int(emit),
                        stream), "mask_head_f32")
    return time_ms(call, iters)


def phase_k6_f32(k5_outs, erf_sass=None):
    """K6's float32 arm (`csrc/mask_head_f32.cu`) on the keys2 and
    hypernetwork vectors of K5's float32 cases (`phase_k5_f32`): 32 x 4096
    with and without `emit_exp`, the small config's 32 x 256 and a prompt
    shard's 16 x 4096; against a float64 evaluation of the plain version
    and the plain float32 version (`_f64_held`: masks, e, mx; the faults
    of `_k6_f32_faults`).  The small config's random decoder gives mask
    logits of rms ~0.005: its hypernetwork vectors are scaled by 2^10, as
    `phase_mask_head` scales the bf16 model's.  Times the wrapper, the
    kernel alone, the plain version and the path it replaces in float32
    (the module-level packed head and pooling, `_decode_heads` without
    K6, TF32 off) beside the bound (165 TFLOP/s, `F32_FLOP_PER_S`); the
    kernel alone by CUDA events (`kernel_ms`, `_k6_f32_kernel_ms`), which
    stands where torch.profiler keeps no record; with `erf_sass` (one erff
    GELU's SASS instructions, `finish_gelu_probe`) the issue floor of its
    GELUs alone, as `phase_mask_head` gives K6's."""
    from crowdsam_tpu_torch.models import fused_decode as fd
    from crowdsam_tpu_torch.models import mask_head_kernel as mhk
    from crowdsam_tpu_torch.models.common import exact_float32

    report = _f32_arm_report("mask_head_f32", "mask_head_f32_occupancy", 2)
    by_label = {o[0]: o for o in k5_outs}
    cases = [("main path, 32x4096, emit_exp", "main path, 32x7, M=4096",
              32, True),
             ("main path, 32x4096", "main path, 32x7, M=4096", 32, False),
             ("small, 32x256, emit_exp", "small, 32x7, M=256", 32, True),
             ("prompt shard M=2, 16x4096, emit_exp",
              "main path, 32x7, M=4096", 16, True)]
    rows = []
    for label, k5_label, p, emit in cases:
        _, mdl, shared, (keys2, tok), dino = by_label[k5_label]
        dec = mdl.sam.mask_decoder
        k = dec.num_mask_tokens
        keys2, tok = keys2[:p].contiguous(), tok[:p].contiguous()
        hyper = fd._hyper_in(dec, tok[:, 1:1 + k, :])
        if mdl.config["model"].get("sam_adapter_checkpoint", "") == "":
            hyper = hyper * 1024.0
        hyper = hyper.contiguous()
        weights = shared["mask_head"]
        n0 = mhk.mask_head.launches_by_dtype["float32"]
        got = mhk.mask_head(keys2, hyper, weights, emit_exp=emit)
        torch.cuda.synchronize()
        if mhk.mask_head.launches_by_dtype["float32"] != n0 + 1:
            raise AssertionError(f"K6 float32 {label}: the arm did not "
                                 "launch")
        alone = mhk.mask_head(keys2[:8].contiguous(), hyper[:8].contiguous(),
                              weights, emit_exp=emit)
        if not all(torch.equal(a, b[:8]) for a, b in zip(
                (alone,) if not emit else alone, (got,) if not emit
                else got)):
            raise AssertionError(f"K6 float32 {label}: a prompt's result "
                                 "depends on the call's other prompts")
        del alone
        plain = mhk.mask_head_plain(keys2, hyper, weights, emit)
        want = mhk.mask_head_plain(
            keys2.double(), hyper.double(),
            {n: v.double() for n, v in weights.items()}, emit)
        names = ("masks", "e", "mx") if emit else ("masks",)
        tup = (lambda x: x if emit else (x,))
        held = _f64_held(f"K6 float32 {label}", {
            n: (g, q, w) for n, g, q, w in zip(names, tup(got), tup(plain),
                                               tup(want))},
            _k6_f32_faults(keys2, hyper, weights, emit, tup(plain)))
        del plain, want
        fn = (lambda: mhk.mask_head(keys2, hyper, weights, emit_exp=emit))
        no_kernel = {n: v for n, v in shared.items() if n != "mask_head"}
        with exact_float32():
            t_r = time_ms(lambda: fd._decode_heads(
                dec, no_kernel, tok, keys2, dino if emit else None, True,
                True), 2, warmup=1)
        m, c = keys2.shape[1:]
        c1, c2 = weights["ln_w"].shape[0], hyper.shape[-1]
        flops = p * m * 2 * (c * 4 * c1 + 4 * c1 * 4 * c2 + 16 * c2 * k)
        nbytes = (keys2.numel() + hyper.numel()) * 4
        nbytes += sum(x.numel() * x.element_size() for x in weights.values())
        nbytes += sum(x.numel() * x.element_size() for x in tup(got))
        b_ms, by = bound(nbytes, flops, F32_FLOP_PER_S)
        d_k = _profiled(device_ms, fn, 20)
        floor = None
        if erf_sass is not None:
            # 768 erff GELUs a row at four warp instructions a clock on
            # every SM at the card's maximum SM clock.
            clock_hz = 1e6 * float(subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.max.sm",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True, check=True).stdout.split()[0])
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            floor = (p * m * (4 * c1 + 16 * c2) * erf_sass / 32
                     / (4 * sms * clock_hz) * 1e3)
        rows.append(dict(
            shape=label, max_abs_err=held["outputs"]["masks"]["max_abs_err"],
            **held, ms=time_ms(fn, 5), device_ms=d_k,
            kernel_ms=_k6_f32_kernel_ms(keys2, hyper, weights, emit),
            plain_ms=time_ms(lambda: mhk.mask_head_plain(
                keys2, hyper, weights, emit), 2, warmup=1),
            replaced_ms=t_r,
            replaced="module-level packed head" + (" + softmax pooling"
                                                   if emit else "")
                     + " (_decode_heads) in float32",
            library_ms=None, bound_ms=b_ms, bound_by=by,
            bound_share=b_ms / d_k if d_k else None, gflop=flops / 1e9,
            gelu_issue_floor_ms=floor, sass_per_erf_gelu=erf_sass,
            **report))
        print(json.dumps({"phase": "K6 float32", **rows[-1]}), flush=True)
    return rows


@contextlib.contextmanager
def _plain_kernels():
    """The plain versions of K1-K6 in place of their wrappers inside the
    block (an explicit call: the plain-patched run of a float32 path)."""
    from crowdsam_tpu_torch.models import common as common_mod
    from crowdsam_tpu_torch.models import decode_tail_kernel as dtk
    from crowdsam_tpu_torch.models import dinov2 as dinov2_mod
    from crowdsam_tpu_torch.models import fused_decode as fd
    from crowdsam_tpu_torch.models import image_encoder as encoder_mod
    from crowdsam_tpu_torch.models import mask_head_kernel as mhk
    from crowdsam_tpu_torch.models.attention import (
        flash_mha_plain,
        relpos_attention_plain,
        window_attention_plain,
    )
    from crowdsam_tpu_torch.ops.layernorm import layer_norm_plain

    with patched(encoder_mod, "window_attention", window_attention_plain), \
            patched(encoder_mod, "flash_mha_decomposed_relpos",
                    relpos_attention_plain), \
            patched(dinov2_mod, "flash_mha", flash_mha_plain), \
            patched(common_mod, "layer_norm", layer_norm_plain), \
            patched(fd, "twoway_tail", dtk.twoway_tail_plain), \
            patched(fd, "mask_head", mhk.mask_head_plain):
        yield


def _profiled(measure, *args):
    """A torch.profiler measurement of a float32 arm, or None where the
    profiler kept no record in any of its windows: late in this script it
    drops records (whole windows at times), and the arm's CUDA-event time
    (`ms`, launches queued back to back) stands beside it."""
    try:
        return measure(*args)
    except NoDeviceRecords as e:
        log(f"torch.profiler: {e}")
        return None


def _kernel_times(model, img, noise, launches) -> dict:
    """One `generate` under torch.profiler (after a warm-up): each
    kernel's median duration and records kept, for K5's float32 launches
    (`tok_stage`, `tok_qkv`, `tok_mlp`, `t2i_merge`, `row_phase`), K6's
    (`mask_head_f32`) and K1-K4's float32 arms; the decode's device ms of
    the frame from the medians and the frame's launches of K5 and K6
    (`launches`, each K5 call runs each of its sixteen kernels once),
    which the profiler's dropped records do not lower but which counts the
    time a K5 kernel waits for the one before it (they overlap); and
    `decode_span_ms`, the union of the decode kernels' records, which
    counts no wait twice but reads low where records were dropped."""
    decode_kinds = ("tok_stage", "tok_qkv", "tok_mlp", "t2i_merge",
                    "row_phase", "mask_head_f32")
    by, spans = {}, []
    for ev in _cuda_events(lambda: model.generate(img, noise=[noise]), 1):
        name = _kernel_name(ev.name)
        if name.startswith(decode_kinds + ("attn_f32", "ln_")):
            by.setdefault(name, []).append(ev.device_time_total / 1e3)
        if name.startswith(decode_kinds):
            spans.append((ev.time_range.start,
                          ev.time_range.start + ev.device_time_total))
    med = {k: dict(median_ms=float(np.median(v)), records=len(v))
           for k, v in by.items()}
    decode = {k: v["median_ms"] * launches[
        "mask_head" if k.startswith("mask_head") else "twoway_tail"]
        for k, v in med.items() if k.startswith(decode_kinds)}
    return dict(kernels=med, decode_by_kernel=decode,
                decode_device_ms=sum(decode.values()),
                decode_span_ms=_union_us(spans) / 1e3)


def _against_plain(label, model, runs, frames, noises, tol=1e-4):
    """A float32 run (`_f32_run`) against the same run with the plain
    versions of K1-K6 patched in: SAM and DINOv2 features within `tol`
    relative L2, equal detections (boxes within 0.5 px, scores within
    1e-4), RLE strings equal or differing at threshold ties (their pixels
    named).  Returns the figures; raises past the bounds."""
    with _plain_kernels():
        plain = _f32_run(model, frames, noises)
    rel = {k: [_rel_l2(r[k], p[k]) for r, p in zip(runs, plain)]
           for k in ("sam", "dino")}
    same, ties = [], {}
    for i, (r, p) in enumerate(zip(runs, plain)):
        same.append(_same_detections(r["data"], p["data"], exact=False))
        if same[-1] and len(r["data"]["boxes"]) and any(
                x != y for x, y in zip(r["data"]["rles"], p["data"]["rles"])):
            ties[str(i)] = list(_threshold_ties(
                model.engine_cfg, r["data"], p["data"], r["engine"],
                p["engine"]))
    out = {"sam_rel_l2": rel["sam"], "dino_rel_l2": rel["dino"], "tol": tol,
           "same_detections": same, "rle_threshold_tie_pixels": ties,
           "detections": [len(p["data"]["boxes"]) for p in plain],
           "plain_ms_per_image": [p["ms"] for p in plain]}
    if max(rel["sam"] + rel["dino"]) > tol or not all(same):
        raise AssertionError(f"{label}: the run differs from the "
                             f"plain-patched one: {out}")
    return out


def _against_unfused(model, runs, unfused, tol=2e-4):
    """The fused float32 run against the unfused one (`phase_f32_path`'s,
    same frames and noise): equal detection counts and categories, scores
    within `tol` (the port's CPU bound for the fused decode against the
    XLA path in float32), boxes within 0.5 px or, on a detection whose RLE
    string differs, within a threshold tie's `TIE_BOX_PX` (its pixels
    traced by `_threshold_ties`)."""
    out = []
    for i, (r, u) in enumerate(zip(runs, unfused)):
        g, w = r["data"], u["data"]
        row = dict(detections=[len(g["boxes"]), len(w["boxes"])],
                   ms_per_image=[r["ms"], u["ms"]])
        if len(g["boxes"]) != len(w["boxes"]) or not np.array_equal(
                g["categories"], w["categories"]):
            raise AssertionError(f"float32 fused path frame {i}: "
                                 f"detections differ from the unfused "
                                 f"run: {row}")
        if len(g["boxes"]):
            ds = np.abs(np.asarray(g["scores"]) - np.asarray(w["scores"]))
            db = np.abs(np.asarray(g["boxes"]) - np.asarray(w["boxes"])
                        ).max(axis=1)
            tie = np.array([a != b for a, b in zip(g["rles"], w["rles"])])
            row.update(max_score_diff=float(ds.max()),
                       max_box_diff_px=float(db.max()),
                       rle_differ=int(tie.sum()))
            if tie.any():
                row["rle_threshold_tie_pixels"] = list(_threshold_ties(
                    model.engine_cfg, g, w, r["engine"], u["engine"]))
            if (ds > tol).any() or (db > np.where(tie, TIE_BOX_PX,
                                                  0.5)).any():
                raise AssertionError(f"float32 fused path frame {i}: "
                                     f"scores or boxes apart from the "
                                     f"unfused run: {row}")
        out.append(row)
    return out


def phase_f32_fused_path(unfused):
    """`configs/crowdhuman.yaml` with `tpu.compute_dtype float32` and the
    fused decode (its default) at full width and depth (SAM ViT-L, DINOv2
    ViT-L/14, the shipped adapter) on the main path's three frames at the
    reference thresholds: ms/image, the decode's device ms (K5 + K6 of one
    frame), the device idle share, peak memory and K1-K7's launches by
    dtype and shape (every K5 and K6 launch float32).  Held against the
    same run with the plain versions of K1-K6 patched in (`_against_plain`)
    and against `phase_f32_path`'s unfused float32 run on the same frames
    and noise (`unfused`; `_against_unfused`).  Returns (the model, its
    row)."""
    from crowdsam_tpu_torch.config import modify_config
    from crowdsam_tpu_torch.pipeline.crowdsam import CrowdSAM
    from crowdsam_tpu_torch.utils.synthetic import (
        full_width_config,
        synthetic_images,
    )

    t = time.time()
    with _no_default_init():
        model = CrowdSAM(modify_config(full_width_config(), F32_FUSED),
                         device="cuda")
    torch.cuda.synchronize()
    build_s = time.time() - t
    frames = synthetic_images(0, N_IMAGES)
    noises = [torch.rand(model.engine_cfg.grid_size ** 2,
                         generator=torch.Generator().manual_seed(40 + i))
              for i in range(len(frames))]
    _timed_generate(model, frames[0], noises[0])        # warm-up
    torch.cuda.reset_peak_memory_stats()
    with _counted_by_dtype_shape() as counts:
        runs = _f32_run(model, frames, noises)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    decode = _profiled(_kernel_times, model, frames[0], noises[0], {
        k: counts["launches"][k] / N_IMAGES
        for k in ("twoway_tail", "mask_head")})
    wall, busy, top = _device_busy(model, frames[0])
    row = {
        "phase": "float32 fused path",
        "config": "configs/crowdhuman.yaml + tpu.compute_dtype float32 "
                  "(fused decode), SAM ViT-L + DINOv2 ViT-L/14 + "
                  f"{ADAPTER}, random encoders",
        "build_s": build_s,
        "image_hw": [list(f.shape[:2]) for f in frames],
        "ms_per_image": [r["ms"] for r in runs],
        "unfused_ms_per_image": [u["ms"] for u in unfused],
        "first_frame_device": decode,
        "device_profile": {"wall_ms": wall, "device_busy_ms": busy,
                           "device_idle_share": 1.0 - busy / wall,
                           "kernels_ms": top},
        "peak_memory_gib": peak,
        "detections_per_image": [len(r["data"]["boxes"]) for r in runs],
        **counts,
    }
    print(json.dumps(row), flush=True)
    launches = counts["launches"]
    _require_launches("float32 fused path", launches,
                      ["layer_norm", "window_attention",
                       "flash_mha_decomposed_relpos", "flash_mha",
                       "twoway_tail", "mask_head"])
    not_f32 = {k: v for k in ("window_attention",
                              "flash_mha_decomposed_relpos", "flash_mha",
                              "twoway_tail", "mask_head")
               for v in [counts[f"{k}_by_dtype"]] if set(v) != {"float32"}}
    if not_f32:
        raise AssertionError(f"float32 fused path: launches not float32 "
                             f"{not_f32}")
    row = {"phase": "float32 fused path, held",
           "vs_plain": _against_plain("float32 fused path", model, runs,
                                      frames, noises),
           "vs_unfused": _against_unfused(model, runs, unfused)}
    print(json.dumps(row), flush=True)
    return model, dict(row, ms_per_image=[r["ms"] for r in runs], **counts)


def _f32_items_close(label, got, want):
    """Item by item: equal detection counts and categories, boxes within
    0.5 px, scores within 1e-5, RLE strings equal (a float32 path batched
    or prompt-sharded against one process).  Returns each item's largest
    differences and whether it is bit for bit; raises past the bounds."""
    out = []
    for i, (g, w) in enumerate(zip(got, want)):
        row = dict(bit_for_bit=_same_detections(g, w, exact=True),
                   detections=[len(g["boxes"]), len(w["boxes"])])
        if len(g["boxes"]) != len(w["boxes"]) or not np.array_equal(
                g["categories"], w["categories"]):
            raise AssertionError(f"{label} item {i}: {row}")
        if len(g["boxes"]):
            row.update(
                max_score_diff=float(np.abs(np.asarray(g["scores"])
                                            - np.asarray(w["scores"])).max()),
                max_box_diff_px=float(np.abs(np.asarray(g["boxes"])
                                             - np.asarray(w["boxes"])).max()),
                rle_equal=g["rles"] == w["rles"])
            if (row["max_score_diff"] > 1e-5 or row["max_box_diff_px"] > 0.5
                    or not row["rle_equal"]):
                raise AssertionError(f"{label} item {i}: {row}")
        out.append(row)
    return out


def _row_count_probe(dec) -> dict:
    """Whether the fused decode's PyTorch products outside K5 and K6 give
    a prompt the same bits in a call of 32 prompts (one image) as in one of
    64 (the batched call's two images): the hypernetwork MLPs
    (`_hyper_in`), the IoU head, the pooling from K6's exp terms
    (`_pooled_from_exp`, one DINO map against two) and the point
    classifier, on seeded float32 operands of the main path's shapes."""
    from crowdsam_tpu_torch.models import fused_decode as fd
    from crowdsam_tpu_torch.models.common import exact_float32

    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((64, 5, 256), generator=g, device="cuda")
    e = torch.rand((64, 4, 4096, 16), generator=g, device="cuda")
    mx = torch.randn((64, 64), generator=g, device="cuda")
    dino = torch.randn((2, 4096 * 16, 256), generator=g, device="cuda")
    with exact_float32():
        pooled = fd._pooled_from_exp(e, mx, dino, torch.float32)
        return {
            "hyper_in": bool(torch.equal(fd._hyper_in(dec, x[:32, 1:]),
                                         fd._hyper_in(dec, x[:, 1:])[:32])),
            "iou_prediction_head": bool(torch.equal(
                dec.iou_prediction_head(x[:32, 0]),
                dec.iou_prediction_head(x[:, 0])[:32])),
            "pooled_from_exp": bool(torch.equal(fd._pooled_from_exp(
                e[:32], mx[:32], dino[0], torch.float32), pooled[:32])),
            "point_classifier": bool(torch.equal(
                dec.point_classifier(pooled[:32]),
                dec.point_classifier(pooled)[:32]))}


def phase_f32_batched(model):
    """The float32 fused path's model (`phase_f32_fused_path`) batched:
    `ShardedPipeline.generate_batch` at B = 2 on the main path's first two
    frames against `generate_many` on the same frames, the generator reset
    to one seed before each: whether each item is bit for bit; required,
    `_f32_items_close` (scores within 1e-5) and K5 and K6 launched in
    float32.  The float32 arms compute each prompt on its own, so their
    sums do not depend on B or P (`phase_k5_f32` / `phase_k6_f32` hold
    that bit for bit); the batched encode's SAM and DINOv2 features against
    the single ones show whether a difference comes from the encode.  The prompt-sharded engine (M
    = 2) in float32 runs in `phase_multi_device`'s spawn of 2 ranks."""
    from crowdsam_tpu_torch.parallel.eval_shard import ShardedPipeline
    from crowdsam_tpu_torch.utils.synthetic import synthetic_images

    frames = synthetic_images(0, 2)
    single = []
    real_generate = model.generate

    def generate(img, **kw):
        out = real_generate(img, **kw)
        single.append({k: getattr(model.predictor, k).float().cpu()
                       for k in ("features", "dino_feats")})
        return out

    model.generator.manual_seed(123)
    t = time.perf_counter()
    with patched(model, "generate", generate):
        want = model.generate_many(frames)
    torch.cuda.synchronize()
    many_ms = (time.perf_counter() - t) * 1e3 / len(frames)
    pipe = ShardedPipeline(model, batch=2)
    model.generator.manual_seed(123)
    pipe.generate_batch(frames)                          # warm-up
    batched = []
    real_encode = model.predictor.encode_batch

    def encode_batch(*a, **kw):
        enc = real_encode(*a, **kw)
        batched.append({k: enc[k].float().cpu()
                        for k in ("features", "dino_feats")})
        return enc

    model.generator.manual_seed(123)
    counters = _reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    with patched(model.predictor, "encode_batch", encode_batch):
        got = pipe.generate_batch(frames)
    torch.cuda.synchronize()
    batch_ms = (time.perf_counter() - t) * 1e3 / len(frames)
    row = {"phase": "float32 batched", "path": "generate_batch B=2",
           "frames": [list(f.shape[:2]) for f in frames],
           "items": _f32_items_close("float32 batched", got, want),
           "encode_bit_for_bit": {k: [
               bool(torch.equal(batched[0][k][i].reshape(s[k].shape), s[k]))
               for i, s in enumerate(single)]
               for k in ("features", "dino_feats")},
           "heads_same_bits_at_32_and_64_prompts": _row_count_probe(
               model.sam.mask_decoder),
           "ms_per_image": batch_ms, "generate_many_ms_per_image": many_ms,
           "launches": {k: fn.launches for k, fn in counters.items()},
           "launches_by_dtype": {
               k: dict(counters[k].launches_by_dtype)
               for k in ("twoway_tail", "mask_head")}}
    print(json.dumps(row), flush=True)
    if any(set(v) != {"float32"} for v in row["launches_by_dtype"].values()):
        raise AssertionError(f"float32 batched: {row}")
    return row


def phase_vit_h_f32(draw: HostDraw):
    """SAM ViT-H in float32 with the fused decode (DINOv2 ViT-L/14, the
    shipped adapter; the weights from the smoke's ViT-H draw) on the main
    path's first frame, against its plain-patched run with the bounds of
    `phase_f32_fused_path` (`_against_plain`): K1's float32 arm at width
    1280 and K2/K3's at head dim 80, their launches and device ms on the
    run."""
    from crowdsam_tpu_torch.utils import init
    from crowdsam_tpu_torch.utils.synthetic import synthetic_images

    held = {VIT_H_KEY: draw.get()}
    with patched(init, "sam_state_dict", _held(init.sam_state_dict, held)):
        model, build_s = _arch_model(["model.sam_model", "vit_h",
                                      *F32_FUSED])
    frames = synthetic_images(0, 1)
    noises = [torch.rand(model.engine_cfg.grid_size ** 2,
                         generator=torch.Generator().manual_seed(40))]
    _timed_generate(model, frames[0], noises[0])        # warm-up
    with _counted_by_dtype_shape() as counts:
        runs = _f32_run(model, frames, noises)
    by_shape = _launches_by_shape()
    device = _profiled(_kernel_times, model, frames[0], noises[0],
                       counts["launches"])
    row = {"phase": "float32 vit_h", "build_s": build_s,
           "image_hw": list(frames[0].shape[:2]),
           "ms_per_image": runs[0]["ms"],
           "detections": len(runs[0]["data"]["boxes"]), **counts,
           "by_head_dim": {k: by_shape[f"{k}_by_head_dim"] for k in (
               "window_attention", "flash_mha_decomposed_relpos")},
           "device": device,
           "vs_plain": _against_plain("float32 vit_h", model, runs, frames,
                                      noises)}
    print(json.dumps(row), flush=True)
    k1 = counts["layer_norm_by_dtype_shape"]
    if (k1.get("float32 4096x1280", 0) == 0
            or any(set(counts[f"{k}_by_dtype"]) != {"float32"}
                   for k in ("window_attention",
                             "flash_mha_decomposed_relpos", "twoway_tail",
                             "mask_head"))
            or any(set(v) != {80} for v in row["by_head_dim"].values())):
        raise AssertionError(f"float32 vit_h: launches {row}")
    del model
    torch.cuda.empty_cache()
    return row


def _template_feature(model, seed=30):
    """A reference feature as the train-free branch's pickle holds one: the
    mean DINOv2 token (ImageNet-normalized frame stretched to the square
    input) over the persons of a seeded crowd scene."""
    from crowdsam_tpu_torch.ops.transforms import stretch_bilinear
    from crowdsam_tpu_torch.pipeline.predictor import imagenet_tokens
    from crowdsam_tpu_torch.utils.synthetic import crowd_scene

    img, boxes = crowd_scene(seed, 683, 1024)
    model.crop_image(img, [0, 0, img.shape[1], img.shape[0]])
    d, g = model.predictor.dino_input, model.predictor.dino_grid
    tokens = imagenet_tokens(model.dino, stretch_bilinear(model.image,
                                                          (d, d)))
    in_h, in_w = model.image.shape[:2]
    cy = (np.arange(g) + 0.5) * 14 * in_h / d
    cx = (np.arange(g) + 0.5) * 14 * in_w / d
    inside = np.zeros((g, g), bool)
    for x, y, w, h in boxes:
        inside |= (((cy >= y) & (cy < y + h))[:, None]
                   & ((cx >= x) & (cx < x + w))[None, :])
    return tokens[torch.from_numpy(inside).cuda()].mean(dim=0)


def phase_trainfree():
    """`configs/crowdhuman_trainfree.yaml` at full width (vanilla SAM
    ViT-L + DINOv2 ViT-L/14, bf16; its checkpoints are absent, so the JAX
    package's random weights): it builds and warns that its reference
    feature is missing (zeros).  Then a reference feature is set
    (`_template_feature`), so that the sim map has candidates, and one
    frame runs after a warm-up, the counts set to 0 just before it: ms,
    detections, K4's launches (the encode's DINOv2 and the sim map's, 24
    each), every kernel but K7 (box-only output) launched.  The frame's sim
    map against the same function in float32 (DINOv2 ViT-L, same weights,
    on the card through the plain versions of K1 and K4 with TF32 off):
    relative L2 within 5%."""
    import logging

    from crowdsam_tpu_torch.config import load_config
    from crowdsam_tpu_torch.models import common as common_mod
    from crowdsam_tpu_torch.models import dinov2 as dinov2_mod
    from crowdsam_tpu_torch.models.attention import flash_mha_plain
    from crowdsam_tpu_torch.models.dinov2 import dino_model_registry
    from crowdsam_tpu_torch.ops.layernorm import layer_norm_plain
    from crowdsam_tpu_torch.ops.transforms import stretch_bilinear
    from crowdsam_tpu_torch.pipeline.crowdsam import CrowdSAM
    from crowdsam_tpu_torch.pipeline.predictor import (
        cosine_map,
        imagenet_tokens,
    )
    from crowdsam_tpu_torch.utils.synthetic import crowd_scene

    warnings = []

    class Keep(logging.Handler):
        def emit(self, record):
            warnings.append(record.getMessage())

    logger = logging.getLogger("chip_smoke.trainfree")
    logger.addHandler(Keep(level=logging.WARNING))
    cfg = load_config(TRAINFREE_CONFIG)
    t = time.time()
    with _no_default_init():
        model = CrowdSAM(cfg, device="cuda", logger=logger)
    torch.cuda.synchronize()
    build_s = time.time() - t
    p, ecfg = model.predictor, model.engine_cfg
    if not (any("ref_feature missing" in w for w in warnings)
            and not bool(model.ref_feature.any())):
        raise AssertionError(f"trainfree: no zeros and warning for the "
                             f"missing reference feature: {warnings}")
    assert model.train_free and not model.output_rles
    assert ecfg.grid_size == p.dino_grid == 73 and p.dino_input == 1022
    assert ecfg.mask_selection == "max_area"
    model.ref_feature = _template_feature(model)
    img = crowd_scene(20, 683, 1024)[0]
    _timed_generate(model, img)              # warm-up
    counters = _reset_counts()
    data, ms = _timed_generate(model, img)
    launches = {k: fn.launches for k, fn in counters.items()}
    by_shape = _launches_by_shape()
    d = p.dino_input
    sq = stretch_bilinear(model.image, (d, d))
    sim = p.trainfree_sim(sq, model.ref_feature).cpu()
    with _no_default_init():
        f32_dino = dino_model_registry[cfg["model"]["dino_model"]]()
    f32_dino.load_state_dict({k: v.float() for k, v in
                              model.dino.state_dict().items()})
    f32_dino = f32_dino.cuda().eval()
    torch.cuda.synchronize()
    t = time.time()
    # The same function in float32 through the plain versions of K1 and
    # K4 (TF32 is off): the reference, not the path under test.
    with patched(dinov2_mod, "flash_mha", flash_mha_plain), \
            patched(common_mod, "layer_norm", layer_norm_plain):
        sim_f32 = cosine_map(imagenet_tokens(f32_dino, sq),
                             model.ref_feature.float()).cpu()
    torch.cuda.synchronize()
    f32_s = time.time() - t
    rel = float((sim - sim_f32).norm() / sim_f32.norm())
    depth = len(model.dino.blocks)
    row = {
        "phase": "trainfree", "config": TRAINFREE_CONFIG + " as shipped "
        "(checkpoints absent: random weights), bf16",
        "build_s": build_s, "warnings": warnings,
        "reference_feature": "mean train-free DINOv2 token over the persons "
                             "of crowd_scene(30)",
        "image_hw": list(img.shape[:2]), "ms_per_image": ms,
        "detections": len(data["boxes"]),
        "categories": sorted(set(np.asarray(data.get(
            "categories", [])).tolist())),
        "candidates": int((model.fg_sim > ecfg.pos_sim_thresh).sum()),
        "sim_quantiles": np.quantile(sim.numpy(), [0.0, 0.5, 0.9, 1.0])
        .tolist(),
        "sim_relative_l2_vs_f32": rel, "sim_tol": 5e-2,
        "f32_reference": "DINOv2 in float32 on the card through the plain "
                         "versions of K1 and K4, TF32 off",
        "f32_sim_s": f32_s,
        "launches_per_image": launches, "launches_by_shape": by_shape,
    }
    print(json.dumps(row), flush=True)
    if launches["flash_mha"] != 2 * depth:
        raise AssertionError(f"trainfree: K4 launched "
                             f"{launches['flash_mha']} times, not "
                             f"{2 * depth} (encode + sim map)")
    _require_launches("trainfree", launches,
                      [k for k in launches if k != "survivor_rle"],
                      ["survivor_rle"])
    if not rel < 5e-2:
        raise AssertionError(f"trainfree: sim map {rel} from float32's")
    if set(row["categories"]) - {0}:
        raise AssertionError(f"trainfree: categories {row['categories']}")
    del model, f32_dino
    torch.cuda.empty_cache()
    return row


def phase_modes(model, reference_cfg):
    """Each opt-in mode alone on the main model with the pred-IoU and
    stability filters off, on one crowd scene with the same noise: ms per
    image (the survivor pass synchronized around, its ms), detections,
    launches (every kernel; K7 none under `fullres_cleanup`, whose
    cleanup runs on the 1024^2 masks in PyTorch ops), RLE strings spanning
    their boxes."""
    import crowdsam_tpu_torch.pipeline.crowdsam as pipeline
    from crowdsam_tpu_torch.utils.synthetic import crowd_scene

    scene = crowd_scene(20, 683, 1024)[0]
    noise = np.random.default_rng(7).uniform(
        size=reference_cfg.grid_size ** 2).astype(np.float32)
    base = dataclasses.replace(reference_cfg, pred_iou_thresh=0.0,
                               stability_score_thresh=0.0)
    model.engine_cfg = base
    _timed_generate(model, scene, noise)      # warm-up
    rows = []
    for label, kw in MODES:
        model.engine_cfg = dataclasses.replace(base, **kw)
        surv = [0.0]
        counters = _reset_counts()
        with patched(pipeline, "survivor_core",
                     _sync_timed(pipeline.survivor_core, surv)):
            data, ms = _timed_generate(model, scene, noise)
        launches = {k: fn.launches for k, fn in counters.items()}
        row = {"phase": "modes", "mode": label,
               "image_hw": list(scene.shape[:2]), "ms_per_image": ms,
               "survivor_pass_ms": surv[0],
               "detections": len(data["boxes"]),
               "nonempty_masks": _check_rles(data, scene),
               "score_range": [float(np.min(data["scores"])),
                               float(np.max(data["scores"]))]
               if len(data["boxes"]) else None,
               "launches_per_image": launches}
        print(json.dumps(row), flush=True)
        rows.append(row)
        fullres = kw.get("fullres_cleanup", False)
        _require_launches(f"modes {label}", launches,
                          [k for k in launches
                           if not (fullres and k == "survivor_rle")],
                          ["survivor_rle"] if fullres else [])
        if not row["detections"]:
            raise AssertionError(f"modes {label}: no detection")
    model.engine_cfg = reference_cfg
    return rows


def _encode_device_ms(model, img) -> float:
    """Device ms of the dual-backbone encode of one frame: the union of its
    kernels' intervals (torch.profiler, `device_span_ms`), over 3 calls."""
    h, w = img.shape[:2]
    model.crop_image(img, [0, 0, w, h])
    return device_span_ms(
        lambda: model.predictor.set_image_presized(model.image), 3)


def phase_rect(model, reference_cfg):
    """`tpu.rect_encode` on the main model and path (the reference
    thresholds) against the square encode on the three frames, in the same
    call: per frame the encode's device ms, and its host ms and ms per
    image in turns (square, rect, rect, square, square, rect) after a
    warm-up of both; launches by shape of the first rect run (counts set
    to 0 just before it), each of K2's, K3's and K4's shapes one that a
    kernel phase held against its plain version."""
    from crowdsam_tpu_torch.utils.synthetic import synthetic_images

    frames = synthetic_images(0, N_IMAGES)
    model.engine_cfg = reference_cfg
    p = model.predictor
    for rect in (False, True):               # warm-up of both encodes
        p.rect_encode = rect
        for img in frames:
            model.generate(img)
    runs = {"square": [], "rect": []}
    device = {}
    launches = by_shape = None
    for rect in (False, True, True, False, False, True):
        p.rect_encode = rect
        first_rect = rect and launches is None
        if first_rect:
            counters = _reset_counts()
        out = [_timed_generate(model, img) for img in frames]
        if first_rect:
            launches = {k: fn.launches for k, fn in counters.items()}
            by_shape = _launches_by_shape()
        runs["rect" if rect else "square"].append({
            "ms_per_image": [ms for _, ms in out],
            "encode_ms_per_image": [_encode_ms(model, img)
                                    for img in frames],
            "detections_per_image": [len(d["boxes"]) for d, _ in out]})
    for rect in (False, True):
        p.rect_encode = rect
        device["rect" if rect else "square"] = [
            _encode_device_ms(model, img) for img in frames]
    p.rect_encode = False

    def median(key, what):
        return [float(np.median([r[what][i] for r in runs[key]]))
                for i in range(len(frames))]

    row = {"phase": "rect_encode",
           "config": "configs/crowdhuman.yaml defaults, vit_l + "
                     "dinov2_vitl14, bf16; tpu.rect_encode against square",
           "image_hw": [list(i.shape[:2]) for i in frames],
           "encode_device_ms": device,
           "encode_device_rect_over_square": [
               r / q for r, q in zip(device["rect"], device["square"])],
           "encode_ms_median": {k: median(k, "encode_ms_per_image")
                                for k in runs},
           "ms_per_image_median": {k: median(k, "ms_per_image")
                                   for k in runs},
           **runs, "launches_rect": launches,
           "launches_by_shape_rect": by_shape}
    print(json.dumps(row), flush=True)
    _require_launches("rect_encode", launches,
                      [k for k in launches if k != "survivor_rle"])
    held = {"window_attention_by_shape": {f"{h}x{w}" for h, w in
                                          RECT_K2_GRIDS + ((70, 70),)},
            "flash_mha_decomposed_relpos_by_shape": {
                f"{h}x{w}" for h, w in RECT_K3_GRIDS + ((64, 64),)},
            "flash_mha_by_shape": {f"{s} tokens" for s in
                                   RECT_K4_TOKENS + (1 + 73 * 73,)}}
    unheld = {k: sorted(set(by_shape[k]) - v) for k, v in held.items()}
    if any(unheld.values()):
        raise AssertionError(f"rect_encode: shapes no kernel phase held: "
                             f"{unheld}")
    # K3 on the grids 64 tall in the columns form, the others 64 wide in
    # GRID64's: none folded.
    k3_shapes = by_shape["flash_mha_decomposed_relpos_by_shape"]
    tall = sum(n for g, n in k3_shapes.items() if g.startswith("64x")
               and g != "64x64")
    forms = by_shape["flash_mha_decomposed_relpos_by_form"]
    if tall == 0 or forms.get("columns", 0) != tall or forms.get("fold"):
        raise AssertionError(f"rect_encode: K3 on the grids 64 tall not in "
                             f"the columns form alone: {k3_shapes}, {forms}")
    return row


def phase_crop_layers():
    """`configs/crowdhuman_mc.yaml` (`test.crop_n_layers 1`: the frame and
    four overlapping crops, each encoded and decoded, then the inter-crop
    NMS) at full width with the shipped adapter, one frame after a
    warm-up, the counts set to 0 just before it: ms, detections, crops'
    launches (every kernel but K7 required: the shipped thresholds may
    leave no detection for the survivor pass)."""
    from crowdsam_tpu_torch.config import load_config
    from crowdsam_tpu_torch.pipeline.crowdsam import CrowdSAM
    from crowdsam_tpu_torch.utils.synthetic import crowd_scene

    t = time.time()
    with _no_default_init():
        model = CrowdSAM(load_config(MC_CONFIG), device="cuda")
    torch.cuda.synchronize()
    build_s = time.time() - t
    assert model.crop_n_layers == 1
    img = crowd_scene(20, 683, 1024)[0]
    _timed_generate(model, img)              # warm-up
    counters = _reset_counts()
    data, ms = _timed_generate(model, img)
    launches = {k: fn.launches for k, fn in counters.items()}
    print(json.dumps({
        "phase": "crop_n_layers 1", "config": MC_CONFIG + " as shipped "
        "(SAM/DINOv2 checkpoints absent: random encoders), bf16",
        "build_s": build_s, "image_hw": list(img.shape[:2]),
        "ms_per_image": ms, "detections": len(data["boxes"]),
        "launches_per_image": launches}), flush=True)
    _require_launches("crop_n_layers 1", launches,
                      [k for k in launches if k != "survivor_rle"])
    if launches["flash_mha"] != 5 * 24:
        raise AssertionError(f"crop_n_layers 1: K4 launched "
                             f"{launches['flash_mha']} times, not 5 x 24")
    del model
    torch.cuda.empty_cache()


def phase_small_cases():
    """Each small case of `SMALL_CASES` (the train-free branch, the rect
    encode, the full-resolution cleanup, `sam_hq`, `mobile_sam`, crop
    layers): the card's path against the plain float32 path on the CPU,
    same weights (`_compare_small`)."""
    from crowdsam_tpu_torch.config import modify_config
    from crowdsam_tpu_torch.pipeline.crowdsam import CrowdSAM

    for label, opts in SMALL_CASES:
        with _no_default_init():
            gpu = CrowdSAM(modify_config(_small_config(), list(opts)),
                           device="cuda")
        _compare_small(gpu, modify_config(_small_config(), list(opts)),
                       label)
        del gpu
        torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# multi-device (torch.distributed): the prompt axis, the data axis, NCCL
# --------------------------------------------------------------------------

SHARING = ("{n} processes sharing one {card} over gloo: not a multi-card "
           "figure")


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def phase_decode_prompt_shards(model, frame, frames, probe):
    """K5 and K6 at the prompt counts a rank of the prompt axis gives them
    (32 / M: 16 and 8 prompts of one image, and 4 images x 8 prompts of a
    composed rank's lockstep iteration) against their plain versions, with
    the bounds and faults of `phase_twoway_tail`, `phase_mask_head` and
    `phase_twoway_tail_images`, and their device ms beside the 32-prompt
    rows'."""
    from crowdsam_tpu_torch.models import decode_tail_kernel as dtk

    rows = {}
    for p in (16, 8):
        k5, tail_out = phase_twoway_tail(model, frame, f"prompt shard, P={p}",
                                         n_prompts=p)
        k6 = phase_mask_head(model, frame, f"prompt shard, P={p}", tail_out,
                             probe)
        rows[str(p)] = dict(k5=k5, k6=k6)
        del tail_out
    shared, tokens, img, dino = _images_decoder_inputs(model, frames[:4], 8)
    args = _tail_args(shared, tokens)
    with torch.no_grad():
        got = dtk.twoway_tail(*args, img=img)
        want = dtk.twoway_tail_plain(*args, img=img)
        keys0, q1i, k1, v1 = args[:4]
        f_neighbour = dtk.twoway_tail_plain(
            keys0.roll(-1, 0), q1i, k1.roll(-1, 0), v1, tokens, args[5],
            img=img)
    outs = {}
    for i, name in enumerate(("keys2", "tokens")):
        outs[name] = compare(
            f"twoway_tail 4x8 {name}", got[i], want[i], 2e-2,
            faults=[("each prompt reads its neighbour image's keys0 and k1 "
                     "rows", f_neighbour[i])], require_faults=False,
            mean_atol=2.0 ** -11)
    require_faults_seen("twoway_tail 4x8", outs)
    k6 = _mask_head_images(model, shared, got, dino)
    with torch.no_grad():
        k6.update(_mask_head_times(model, shared, got),
                  max_abs_err=k6["masks"]["max_abs_err"])
        fn = (lambda: dtk.twoway_tail(*args, img=img))
        b_ms, by = _k5_bound(args, got, tokens.shape[0], tokens.shape[1],
                             keys0.shape[-2])
        k5 = dict(outputs=outs, max_abs_err=max(
            o["max_abs_err"] for o in outs.values()), ms=time_ms(fn, 10),
            device_ms=device_span_ms(fn, 10), bound_ms=b_ms, bound_by=by,
            plain_ms=time_ms(lambda: dtk.twoway_tail_plain(*args, img=img),
                             2, warmup=1))
    rows["4x8"] = dict(k5=k5, k6=k6)
    del shared, args, got, want, f_neighbour
    torch.cuda.empty_cache()
    summary = {
        key: dict(k5_device_ms=r["k5"]["device_ms"],
                  k5_bound_ms=r["k5"]["bound_ms"],
                  k5_max_abs_err=r["k5"]["max_abs_err"],
                  k6_device_ms=r["k6"].get("device_ms"),
                  k6_bound_ms=r["k6"].get("bound_ms"))
        for key, r in rows.items()}
    print(json.dumps({"phase": "K5/K6 prompt shards", "by_prompts": summary,
                      "k5_4x8": rows["4x8"]["k5"],
                      "k6_4x8": rows["4x8"]["k6"]}), flush=True)
    return rows


def _mask_head_times(model, shared, tail_out) -> dict:
    """K6 (`emit_exp`) on a decode batch's keys2: event and device ms, the
    plain version's ms and the bound (`phase_mask_head`'s count)."""
    from crowdsam_tpu_torch.models import fused_decode as fd
    from crowdsam_tpu_torch.models import mask_head_kernel as mhk

    dec = model.sam.mask_decoder
    keys2, tok = tail_out
    p, m, c = keys2.shape
    k = dec.num_mask_tokens
    weights = shared["mask_head"]
    hyper = (fd._hyper_in(dec, tok[:, 1:1 + k, :]) * 1024.0).contiguous()
    fn = (lambda: mhk.mask_head(keys2, hyper, weights, emit_exp=True))
    got = fn()
    c1, c2 = weights["ln_w"].shape[0], hyper.shape[-1]
    flops = p * m * 2 * (c * 4 * c1 + 4 * c1 * 4 * c2 + 16 * c2 * k)
    nbytes = (keys2.numel() + hyper.numel()) * 2
    nbytes += sum(x.numel() * x.element_size() for x in weights.values())
    nbytes += sum(x.numel() * x.element_size() for x in got)
    b_ms, by = bound(nbytes, flops, BF16_FLOP_PER_S)
    return dict(ms=time_ms(fn, 10), device_ms=device_ms(fn, 10),
                plain_ms=time_ms(lambda: mhk.mask_head_plain(
                    keys2, hyper, weights, emit_exp=True), 2, warmup=1),
                bound_ms=b_ms, bound_by=by)


def _sync_counted_loop(real_loop, records: list):
    """`engine._eps_loop` run under torch's sync-debug mode: each call
    appends {iterations, syncs (the engine's own count of its reads of
    the device), warned (torch's warnings of a synchronizing call inside
    the loop)} to `records`."""
    import warnings

    def loop(*a, **kw):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                st = real_loop(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        records.append(dict(iterations=st["iterations"], syncs=st["syncs"],
                            warned=sum("synchroniz" in str(w.message)
                                       for w in caught)))
        return st

    return loop


@contextlib.contextmanager
def _no_default_init():
    """Module construction without torch's default parameter fills: every
    parameter of a `CrowdSAM` is overwritten by the drawn (or saved) state
    dict, whose loader refuses a missing key, so the fills are wasted host
    time (seconds a full-width model, more with ranks sharing the host)."""
    names = ("kaiming_uniform_", "kaiming_normal_", "uniform_", "normal_",
             "trunc_normal_", "xavier_uniform_", "xavier_normal_",
             "constant_", "zeros_", "ones_")
    real = {n: getattr(torch.nn.init, n) for n in names}
    try:
        for n in names:
            setattr(torch.nn.init, n, lambda t, *a, **k: t)
        yield
    finally:
        for n, fn in real.items():
            setattr(torch.nn.init, n, fn)


def _rank_model(weights: str, overrides=()):
    """The full-width model of `full_width_config()` (with `overrides`) on
    cuda:0 with the weights the parent drew (`torch.save`d at `weights`,
    read through a memory map), without drawing them again."""
    from crowdsam_tpu_torch.config import modify_config
    from crowdsam_tpu_torch.pipeline.crowdsam import CrowdSAM
    from crowdsam_tpu_torch.utils import init
    from crowdsam_tpu_torch.utils.synthetic import full_width_config

    torch.cuda.set_device(0)
    sd = torch.load(weights, weights_only=True, mmap=True)
    with patched(init, "sam_state_dict", lambda *a, **k: sd["sam"]), \
            patched(init, "dino_state_dict", lambda *a, **k: sd["dino"]), \
            _no_default_init():
        return CrowdSAM(modify_config(full_width_config(), list(overrides)),
                        device="cuda")


def _save_weights(model, path: str) -> float:
    """`torch.save` of the model's SAM and DINOv2 weights (on the host) for
    `_rank_model`; the seconds it took."""
    t = time.perf_counter()
    torch.save({k: {n: v.cpu() for n, v in m.state_dict().items()}
                for k, m in (("sam", model.sam), ("dino", model.dino))},
               path)
    return time.perf_counter() - t


def _kept_rows(res) -> dict:
    """An engine result's valid rows (summary, slab logits) on the host,
    enough for `_threshold_ties`."""
    idx = torch.nonzero(res["summary"][:, 0] > 0.5).flatten()
    return {"summary": res["summary"][idx].cpu(),
            "logits": res["logits"][idx].cpu()}


def _on_card(rows: dict) -> dict:
    return {k: v.cuda() for k, v in rows.items()}


def _plain(data) -> dict:
    return {k: data[k] for k in data.keys()}


def _rank_task(rank: int, world: int, weights: str, task: dict):
    """One rank of a multi-device phase (`run_ranks`, gloo on cuda:0): the
    model, the mesh, then each run of `task` with the kernel counts set to
    0 just before and read just after; per run its results, host-clock ms
    per image, loop records, kernel launches, peak device memory, and the
    host syncs of each engine loop as torch's sync-debug mode sees them
    (`_sync_counted_loop`; the timed run carries that mode's cost); the
    seconds from entry to the model, the mesh and each warm-up and run
    (`timeline_s`) and to the last (`task_s`)."""
    from crowdsam_tpu_torch.parallel.eval_shard import ShardedPipeline
    from crowdsam_tpu_torch.parallel.mesh import create_mesh
    from crowdsam_tpu_torch.parallel.prompt_shard import (
        install_prompt_sharding,
    )
    from crowdsam_tpu_torch.pipeline import engine

    from crowdsam_tpu_torch.parallel import spatial as spatial_mod

    marks = [("enter", time.time())]
    real_halo = spatial_mod.gather_halo
    with torch.no_grad():
        model = _rank_model(weights, task.get("overrides", ()))
        marks.append(("model", time.time()))
        mesh = create_mesh(task["mesh"], device="cuda")
        coord = mesh.get_coordinate()
        pipe = None
        if task["kind"] == "prompt_shard":
            install_prompt_sharding(model, mesh)
        else:
            pipe = ShardedPipeline(model, mesh=mesh, batch=task["batch"],
                                   prompt_axis=task.get("prompt_axis"),
                                   spatial_axis=task.get("spatial_axis"))
        spatial = pipe.spatial if pipe is not None else None
        encodes, spent = [], {"encode": 0.0, "all_reduce": 0.0, "halo": 0.0}
        if spatial is not None:
            # Each encode's frames and features, and the host-clock seconds
            # of the encodes, of the spatial axis's all-reduces and of its
            # row-halo exchanges (each synchronized around).
            def synced(fn, key):
                def run(*a, **kw):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    out = fn(*a, **kw)
                    torch.cuda.synchronize()
                    spent[key] += time.perf_counter() - t
                    return out
                return run

            real_encode = synced(model.predictor.encode_batch, "encode")

            def encode_batch(frames, in_hw, **kw):
                enc = real_encode(frames, in_hw, **kw)
                encodes.append((frames.cpu(), in_hw,
                                enc["features"].cpu()))
                return enc

            model.predictor.encode_batch = encode_batch
            spatial.all_reduce = synced(spatial.all_reduce, "all_reduce")
            spatial_mod.gather_halo = synced(spatial_mod.gather_halo, "halo")
        marks.append(("mesh", time.time()))
        out = dict(rank=rank, coordinate=coord, runs=[])
        for name, cfg, images, noises in task["runs"]:
            model.engine_cfg = cfg
            if task["kind"] == "prompt_shard":     # warm-up
                model.generate(images[0], noise=[noises[0]])
            else:
                model.generator.manual_seed(task.get("seed", 0))
                pipe.generate_batch(images[:task["batch"]])
            marks.append((f"{name} warm-up", time.time()))
            model.generator.manual_seed(task.get("seed", 0))
            counters = _reset_counts()
            torch.cuda.reset_peak_memory_stats()
            encodes.clear()
            spent.update(encode=0.0, all_reduce=0.0, halo=0.0)
            if spatial is not None:
                spatial.calls = spatial.bytes = 0
            results, loops, rows, checked = [], [], {}, []
            torch.cuda.synchronize()
            t = time.perf_counter()
            with patched(engine, "_eps_loop", _sync_counted_loop(
                    engine._eps_loop, checked)):
                _rank_run(task, model, images, noises, mesh, pipe, coord,
                          results, loops, rows)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3 / len(images)
            out["runs"].append(dict(
                name=name, results=results, loops=loops, rows=rows,
                sync_checks=checked, ms_per_image=ms,
                launches={k: fn.launches for k, fn in counters.items()},
                launches_by_dtype={
                    k: dict(fn.launches_by_dtype)
                    for k, fn in counters.items()
                    if hasattr(fn, "launches_by_dtype")},
                peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30))
            if spatial is not None:
                out["runs"][-1].update(
                    launches_by_shape=_launches_by_shape(),
                    encodes=len(encodes), first_encode=encodes[:1],
                    spatial_all_reduces=spatial.calls,
                    spatial_bytes=spatial.bytes,
                    encode_s=spent["encode"],
                    all_reduce_s=spent["all_reduce"],
                    halo_s=spent["halo"])
            marks.append((name, time.time()))
    spatial_mod.gather_halo = real_halo
    out["task_s"] = marks[-1][1] - marks[0][1]
    out["timeline_s"] = {k: t - marks[0][1] for k, t in marks[1:]}
    return out


def _rank_tasks(rank: int, world: int, weights: str, tasks: list):
    """`_rank_task` for each of `tasks`, one after another in one spawn
    (each with a model and a mesh of its own); their outputs in order."""
    import gc

    outs = []
    for task in tasks:
        outs.append(_rank_task(rank, world, weights, task))
        gc.collect()
        torch.cuda.empty_cache()
    return outs


def _rank_run(task, model, images, noises, mesh, pipe, coord, results,
              loops, rows):
    """The timed run of `_rank_task`: results, loop records and kept rows
    of each image this rank ran."""
    if task["kind"] == "prompt_shard":
        for i, (img, nz) in enumerate(zip(images, noises)):
            results.append(_plain(model.generate(img, noise=[nz])))
            loops.append(model.last_engine["loop"])
            rows[i] = _kept_rows(model.last_engine)
        return
    per = task["batch"] // mesh["data"].size()
    for c0 in range(0, len(images), task["batch"]):
        got = pipe.generate_batch(
            images[c0:c0 + task["batch"]], noise=None if noises is None
            else noises[c0:c0 + task["batch"]])
        results += [_plain(r) for r in got]
        for j, res in enumerate(pipe.last_engine):
            loops.append(res["loop"])
            rows[c0 + coord[0] * per + j] = _kept_rows(res)


# A box edge that a threshold tie moves: at most one cell of the 256^2
# logit grid, 4 px of the 1024 frame.
TIE_BOX_PX = 4.0


def _encode_rounding_close(g, w) -> dict:
    """Detections of two runs whose encodes differ by bf16 roundings (the
    spatial axis against one process): counts and categories equal, scores
    within 1e-4 + one bf16 ulp, boxes within 0.5 px or, on a detection
    whose RLE string differs (a threshold tie, checked by
    `_threshold_ties`), within `TIE_BOX_PX`.  Returns the largest
    differences; raises past the bounds."""
    if len(g["boxes"]) != len(w["boxes"]):
        raise AssertionError(f"{len(g['boxes'])} detections against "
                             f"{len(w['boxes'])}")
    if not len(g["boxes"]):
        return dict(max_score_diff=0.0, max_box_diff_px=0.0)
    if not np.array_equal(g["categories"], w["categories"]):
        raise AssertionError("other categories")
    ds = np.abs(g["scores"] - w["scores"])
    db = np.abs(g["boxes"] - w["boxes"]).max(axis=1)
    tie = np.array([a != b for a, b in zip(g["rles"], w["rles"])])
    if (ds > 1e-4 + BF16_ULP * np.abs(w["scores"])).any() or (
            db > np.where(tie, TIE_BOX_PX, 0.5)).any():
        raise AssertionError(f"scores {ds.max()} / boxes {db.max()} px "
                             f"apart (ties {tie.tolist()})")
    return dict(max_score_diff=float(ds.max()),
                max_box_diff_px=float(db.max()))


def _compare_runs(label, got, want, got_rows, want_rows, cfg,
                  encode_roundings=False):
    """Item by item: counts, categories, boxes within 0.5 px, scores within
    1e-4 (`encode_roundings`: `_encode_rounding_close`), RLE strings equal
    or differing only at threshold ties (counted); whether every field is
    equal bit for bit."""
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} results for "
                             f"{len(want)} images")
    ties, exact, close = [], [], []
    for i, (g, w) in enumerate(zip(got, want)):
        if encode_roundings:
            try:
                close.append(_encode_rounding_close(g, w))
            except AssertionError as e:
                raise AssertionError(f"{label} image {i}: {e}") from None
        elif not _same_detections(g, w, exact=False):
            raise AssertionError(f"{label} image {i}: {len(g['boxes'])} "
                                 f"detections against {len(w['boxes'])}")
        exact.append(_same_detections(g, w, exact=True))
        ties.append((0, 0) if g["rles"] == w["rles"] else _threshold_ties(
            cfg, g, w, _on_card(got_rows[i]), _on_card(want_rows[i])))
    out = dict(bit_for_bit=all(exact), items_bit_for_bit=exact,
               rle_tie_pixels=ties)
    if encode_roundings:
        out.update(max_score_diff=max(c["max_score_diff"] for c in close),
                   max_box_diff_px=max(c["max_box_diff_px"] for c in close))
    return out


MAIN_KERNELS = ("layer_norm", "window_attention",
                "flash_mha_decomposed_relpos", "flash_mha", "twoway_tail",
                "mask_head")


def _rank_summary(label, members, want, want_rows, cfg,
                  encode_roundings=False, kernels=MAIN_KERNELS):
    """Each run of the ranks against the single-process results: rank 0's
    results against them (`_compare_runs`), every other rank's equal to
    rank 0's bit for bit, every kernel of `kernels` launched on every rank
    (and K7 where detections reach the survivor pass), host syncs a
    lockstep iteration, collectives and bytes reduced."""
    out = {}
    for r, run in enumerate(members[0]["runs"]):
        name = run["name"]
        rows = {}         # each image's rows, from the rank that ran it
        for rk in members:
            rows.update(rk["runs"][r]["rows"])
        cmp = _compare_runs(f"{label} {name}", run["results"], want[name],
                            rows, want_rows[name], cfg, encode_roundings)
        for other in members[1:]:
            o = other["runs"][r]
            if not all(_same_detections(a, b, exact=True)
                       for a, b in zip(o["results"], run["results"])):
                raise AssertionError(f"{label} {name}: rank "
                                     f"{other['rank']} differs from rank 0")
        loops = [lp for rk in members for lp in rk["runs"][r]["loops"]]
        iters = sum(lp["iterations"] for lp in loops)
        dets = sum(len(g["boxes"]) for g in run["results"])
        for rk in members:
            launches = rk["runs"][r]["launches"]
            need = [k for k in kernels if launches[k] == 0]
            if dets and launches["survivor_rle"] == 0 and any(
                    len(rk["runs"][r]["rows"][i]["summary"])
                    for i in rk["runs"][r]["rows"]):
                need.append("survivor_rle")
            if need:
                raise AssertionError(f"{label} {name} rank {rk['rank']}: "
                                     f"kernels not launched: {need}")
        if any(lp["syncs"] > lp["iterations"] + 1 for lp in loops):
            raise AssertionError(f"{label} {name}: more than one explicit "
                                 f"host sync a lockstep iteration")
        checked = [c for rk in members for c in rk["runs"][r]["sync_checks"]]
        checked_iters = max(sum(c["iterations"] for c in checked), 1)
        out[name] = dict(
            **cmp, detections=[len(g["boxes"]) for g in run["results"]],
            ms_per_image_by_rank=[rk["runs"][r]["ms_per_image"]
                                  for rk in members],
            peak_memory_gib_by_rank=[rk["runs"][r]["peak_memory_gib"]
                                     for rk in members],
            launches_by_rank=[rk["runs"][r]["launches"] for rk in members],
            lockstep_iterations=iters,
            explicit_engine_syncs_per_iteration=sum(
                lp["syncs"] for lp in loops) / max(iters, 1),
            # torch's sync-debug warnings inside the engine loops of every
            # rank; gloo stages each all-reduce of a CUDA tensor through
            # host memory in its own C++ code, which this mode may not see.
            sync_debug_warnings_per_iteration=sum(
                c["warned"] for c in checked) / checked_iters,
            collectives_per_iteration=(sum(
                lp["collectives"] - 2 for lp in loops if lp["collectives"])
                / max(iters, 1)),
            collectives_after_loop=2 if any(lp["collectives"]
                                            for lp in loops) else 0,
            reduced_bytes_per_iteration=(sum(
                lp["reduced_bytes_in_loop"] for lp in loops)
                / max(iters, 1)),
            # An engine call runs a rank's images of a chunk (one image
            # prompt-sharded, batch / data images on the data axis).
            reduced_bytes_after_loop_per_call=(sum(
                lp["reduced_bytes"] - lp["reduced_bytes_in_loop"]
                for lp in loops) / max(len(loops), 1)))
    return out


def _single_runs(model, runs, seed=None):
    """The single-process results of `runs` (name, cfg, images, noises):
    per name the results and each image's kept engine rows, with the
    given noise, or drawn from the generator seeded with `seed`."""
    want, want_rows = {}, {}
    for name, cfg, images, noises in runs:
        model.engine_cfg = cfg
        if seed is not None:
            model.generator.manual_seed(seed)
        res, rows = [], {}
        for i, img in enumerate(images):
            res.append(_plain(model.generate(
                img, noise=None if noises is None else [noises[i]])))
            rows[i] = _kept_rows(model.last_engine)
        want[name], want_rows[name] = res, rows
    return want, want_rows


def phase_multi_device(model, reference_cfg, loaded_cfg):
    """The multi-device paths, one process a rank on this one card over
    gloo (NCCL refuses two ranks on one device, shown below), each rank
    building the full-width model from the weights this process drew:

    - `prompt_shard`: `install_prompt_sharding` at M = 2 (a (1, 2) mesh)
      on the main path's frames (reference thresholds) and on
      crowd_scene(0) loaded (filters off), against this process's
      `generate` with the same noise;
    - `data_shard`: `ShardedPipeline` on the 8 seeded crowd scenes of
      `phase_generate_batch` at the reference thresholds and loaded, the
      generator reset to one seed, against this process's `generate_many`:
      the data axis (2, 1) at batch 4 with 2 ranks (and loaded on the
      first 7 scenes, a partial chunk), and the composed (2, 2) with
      `prompt_axis "model"` and 4 ranks;
    - `spatial_shard` (`phase_spatial_shard`), `spatial_halo` and
      `train_mesh`.

    The 2-rank paths (`prompt_shard`, `data_shard` (2, 1), `spatial_shard`
    (1, 2)) run in one spawn of 2 ranks, one after another, each with a
    model and a mesh of its own; the 4-rank ones (`data_shard` (2, 2),
    `spatial_shard` (2, 2)) likewise in one spawn of 4 (`_rank_tasks`):
    a spawn's start-up (~10 s) is paid once.

    Required: counts and categories equal, boxes within 0.5 px, scores
    within 1e-4, RLE strings equal or differing only at threshold ties
    (counted), every rank's results equal to rank 0's bit for bit, every
    kernel of the path launched on every rank, at most one explicit host
    sync of the engine a lockstep iteration.  Reported: whether each run is
    bit for bit the single process's, ms per image on the host clock by
    rank (with this process's beside it), host syncs per lockstep
    iteration (the engine's explicit count and torch's sync-debug
    warnings), collectives per lockstep iteration, bytes
    reduced a lockstep iteration and after the loop of an engine call,
    peak memory by rank, and each task's seconds in its rank (rank 0's,
    from its model build to its last run).  A rank
    that fails or outlives its time limit fails the phase."""
    import tempfile

    from crowdsam_tpu_torch.parallel.launch import run_ranks
    from crowdsam_tpu_torch.utils.synthetic import (
        FRAME_SIZES,
        crowd_scene,
        synthetic_images,
    )

    card, smi = torch.cuda.get_device_name(0), _smi()
    work = tempfile.mkdtemp(prefix="multi_device_")
    weights = os.path.join(work, "weights.pt")
    save_s = _save_weights(model, weights)
    try:
        frames = synthetic_images(0, N_IMAGES)
        scene = crowd_scene(0)[0]
        gen = torch.Generator().manual_seed(77)
        n = model.engine_cfg.grid_size ** 2
        noises = [torch.rand(n, generator=gen) for _ in range(N_IMAGES + 1)]
        p_runs = [("reference", reference_cfg, frames, noises[:N_IMAGES]),
                  ("loaded", loaded_cfg, [scene], noises[N_IMAGES:])]
        with torch.no_grad():
            t = time.perf_counter()
            p_want = _single_runs(model, p_runs)
            single_ms = (time.perf_counter() - t) * 1e3 / (N_IMAGES + 1)
        scenes = [crowd_scene(40 + i, *FRAME_SIZES[i % len(FRAME_SIZES)])[0]
                  for i in range(8)]
        d_runs = [("reference", reference_cfg, scenes, None),
                  ("loaded", loaded_cfg, scenes, None)]
        with torch.no_grad():
            want, want_rows = _single_runs(model, d_runs, seed=123)
        partial = "loaded, 7 images (partial chunk)"
        want[partial], want_rows[partial] = want["loaded"][:7], want_rows[
            "loaded"]
        # float32 with the fused decode, prompt-sharded: the model of
        # `F32_FUSED` on these weights, in this process and in the ranks.
        f32_runs = [("float32, 2 frames", reference_cfg, frames[:2],
                     noises[:2])]
        with torch.no_grad():
            f32_local = _rank_model(weights, F32_FUSED)
            f32_want = _single_runs(f32_local, f32_runs)
            del f32_local
            torch.cuda.empty_cache()
        s_runs = [("loaded, 2 crowd scenes", loaded_cfg, scenes[:2], None)]
        s_want = ({"loaded, 2 crowd scenes": want["loaded"][:2]},
                  {"loaded, 2 crowd scenes": want_rows["loaded"]})
        tasks = {
            2: [dict(kind="prompt_shard", mesh=(1, 2), runs=p_runs),
                dict(kind="data_shard", mesh=(2, 1), batch=4, seed=123,
                     runs=d_runs + [(partial, loaded_cfg, scenes[:7],
                                     None)]),
                dict(kind="data_shard", mesh=(1, 2), batch=1, runs=p_runs,
                     spatial_axis="model"),
                dict(kind="prompt_shard", mesh=(1, 2), runs=f32_runs,
                     overrides=F32_FUSED)],
            4: [dict(kind="data_shard", mesh=(2, 2), batch=4, seed=123,
                     runs=d_runs, prompt_axis="model"),
                dict(kind="data_shard", mesh=(2, 2), batch=2, runs=s_runs,
                     spatial_axis="model", prompt_axis="model", seed=123)]}
        spawned = {}
        for world, ts in tasks.items():
            t = time.perf_counter()
            ranks = run_ranks(_rank_tasks, world, (weights, ts),
                              join_timeout_s=600.0, threads=None)
            wall = time.perf_counter() - t
            spawned[world] = [dict(
                ranks=[rk[i] for rk in ranks], spawn_wall_s=wall,
                task_s=ranks[0][i]["task_s"]) for i in range(len(ts))]
        one, two = spawned[2], spawned[4]

        def timing(run):
            return dict(spawn_wall_s=run["spawn_wall_s"],
                        task_s=run["task_s"])

        prompt = dict(phase="prompt_shard", ranks=2, mesh=[1, 2],
                      **timing(one[0]),
                      label=SHARING.format(n=2, card=card), nvidia_smi=smi,
                      single_process_ms_per_image=single_ms,
                      **_rank_summary("prompt_shard", one[0]["ranks"],
                                      *p_want, reference_cfg))
        print(json.dumps(prompt), flush=True)
        prompt_f32 = dict(phase="float32 batched",
                          path="prompt_shard M=2 (install_prompt_sharding)",
                          config="configs/crowdhuman.yaml + tpu.compute_dtype "
                                 "float32 (fused decode), the shipped adapter",
                          ranks=2, mesh=[1, 2], **timing(one[3]),
                          label=SHARING.format(n=2, card=card),
                          **_rank_summary("prompt_shard float32",
                                          one[3]["ranks"], *f32_want,
                                          reference_cfg))
        prompt_f32["launches_by_dtype_by_rank"] = [
            {k: rk["runs"][0]["launches_by_dtype"][k]
             for k in ("twoway_tail", "mask_head")}
            for rk in one[3]["ranks"]]
        prompt_f32["items"] = _f32_items_close(
            "prompt_shard float32", one[3]["ranks"][0]["runs"][0]["results"],
            f32_want[0]["float32, 2 frames"])
        print(json.dumps(prompt_f32), flush=True)
        if any(set(v) != {"float32"} for r in prompt_f32[
                "launches_by_dtype_by_rank"] for v in r.values()):
            raise AssertionError(f"prompt_shard float32: not the float32 "
                                 f"arms: {prompt_f32}")
        data = dict(phase="data_shard", nvidia_smi=smi)
        for key, world, run in (
                ("2x1 batch 4", 2, one[1]),
                ("2x2 batch 4, prompt_axis model", 4, two[0])):
            data[key] = dict(
                ranks=world, **timing(run),
                label=SHARING.format(n=world, card=card),
                **_rank_summary(f"data_shard {key}", run["ranks"], want,
                                want_rows, reference_cfg))
        print(json.dumps(data), flush=True)
        spatial = phase_spatial_shard(
            model, {"1x2 batch 1": (one[2], p_runs, p_want),
                    "2x2 batch 2, prompt_axis model": (two[1], s_runs,
                                                       s_want)},
            reference_cfg)
        halo = phase_spatial_halo(model, weights, frames[0], scene,
                                  [noises[0], noises[N_IMAGES]],
                                  reference_cfg, loaded_cfg)
        train_mesh = phase_train_mesh(model, weights, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return dict(prompt_shard=prompt, data_shard=data, spatial_shard=spatial,
                spatial_halo=halo, train_mesh=train_mesh,
                prompt_shard_f32=prompt_f32, weights_save_s=save_s)


def _spatial_details(label, row, model, ranks, runs, mesh, per_image):
    """The spatial runs' own checks and figures, added to `row[name]`:
    each rank's launches of each kernel of `per_image` (its count an
    image), those of K3 and K4 all on band shapes (" of " in their
    shape); the first frame's
    features of rank 0 within 1e-2 relative L2 of this process's encode of
    the same frame; launches by shape, the spatial axis's all-reduces and
    bytes an image, ms an image of the encode, of the all-reduces and of
    the row-halo exchanges (host clock, synchronized around each)."""
    for r, (name, _, images, _) in enumerate(runs):
        per_rank = [rk["runs"][r] for rk in ranks]
        images_a_rank = len(images) // mesh[0]
        for rk, run in zip(ranks, per_rank):
            shapes = run["launches_by_shape"]
            bad = {k: run["launches"][k] for k, n in per_image.items()
                   if run["launches"][k] != n * images_a_rank}
            bad.update({k: v for k in ("flash_mha_decomposed_relpos",
                                       "flash_mha")
                        for sh, v in shapes[f"{k}_by_shape"].items()
                        if " of " not in sh})
            if bad:
                raise AssertionError(
                    f"{label} {name} rank {rk['rank']}: launches {bad} for "
                    f"{images_a_rank} images, shapes {shapes}")
        frames, in_hw, feats = per_rank[0]["first_encode"][0]
        with torch.no_grad():
            whole = model.predictor.encode_batch(frames.cuda(), in_hw)[
                "features"].float().cpu()
        rel = _rel_l2(feats.float(), whole)
        if not rel <= 1e-2:
            raise AssertionError(f"{label} {name}: features {rel} "
                                 f"relative L2 from one process")
        row[name].update(
            features_rel_l2_first_frame=rel,
            launches_by_shape_by_rank=[
                {k: v for k, v in run["launches_by_shape"].items()
                 if k.endswith("_by_shape")} for run in per_rank],
            spatial_all_reduces_per_image_by_rank=[
                run["spatial_all_reduces"] / images_a_rank
                for run in per_rank],
            spatial_bytes_per_image_by_rank=[
                run["spatial_bytes"] / images_a_rank for run in per_rank],
            # host clock, synchronized around each encode, each all-reduce
            # of the spatial axis (inside the encode) and each row-halo
            # exchange (its all-reduce among them)
            encode_ms_per_image_by_rank=[
                run["encode_s"] * 1e3 / images_a_rank for run in per_rank],
            spatial_all_reduce_ms_per_image_by_rank=[
                run["all_reduce_s"] * 1e3 / images_a_rank
                for run in per_rank],
            halo_ms_per_image_by_rank=[
                run["halo_s"] * 1e3 / images_a_rank for run in per_rank])


def phase_spatial_shard(model, spawned, reference_cfg):
    """`ShardedPipeline(spatial_axis="model")` at full width, one process a
    rank on this one card over gloo: a (1, 2) mesh at batch 1 on the main
    path's frames (reference thresholds) and crowd_scene(0) loaded, with
    the noise of `prompt_shard`; a (2, 2) mesh with `prompt_axis "model"`
    at batch 2 on 2 crowd scenes loaded, the generator reset to the seed
    of `data_shard`.  Each rank encodes its band of SAM's ViT ([0, 42) /
    [42, 64) token rows) and of DINOv2 ([0, 37) / [37, 73) patch rows).
    The ranks ran in `phase_multi_device`'s spawns (`spawned`: by layout,
    the ranks' results, the runs and this process's results of them).

    Required, besides what `_rank_summary` requires (detections equal to
    this process's or differing only at threshold ties, scores by bf16
    roundings of the encode, `_encode_rounding_close`; every rank bit for
    bit rank 0, every kernel launched on every rank): K3 4 and K4 24
    launches a rank an image, all on band shapes; the first frame's
    features of rank 0 within 1e-2 relative L2 of this process's encode
    of the same frame.  Reported: the launches by shape, the all-reduces
    and bytes of the spatial axis an image, ms per image, the encode's and
    the all-reduces' share of it (host clock, synchronized around each) and
    peak memory by rank (ranks sharing one card: not multi-card
    figures)."""
    card, smi = torch.cuda.get_device_name(0), _smi()
    out = dict(phase="spatial_shard", nvidia_smi=smi)
    for key, world, mesh in (("1x2 batch 1", 2, (1, 2)),
                             ("2x2 batch 2, prompt_axis model", 4, (2, 2))):
        run, runs, (want, want_rows) = spawned[key]
        row = dict(ranks=world, spawn_wall_s=run["spawn_wall_s"],
                   task_s=run["task_s"],
                   label=SHARING.format(n=world, card=card),
                   **_rank_summary(f"spatial_shard {key}", run["ranks"],
                                   want, want_rows, reference_cfg,
                                   encode_roundings=True))
        _spatial_details(f"spatial_shard {key}", row, model, run["ranks"],
                         runs, mesh, {"window_attention": 20,
                                      "flash_mha_decomposed_relpos": 4,
                                      "flash_mha": 24})
        out[key] = row
    print(json.dumps(out), flush=True)
    return out


def _spatial_layouts(label, model, weights, layouts, runs, cfg,
                     per_image, overrides=(), kernels=MAIN_KERNELS):
    """`ShardedPipeline(spatial_axis="model")` at batch 1 on each (1, M) of
    `layouts`, the ranks sharing this card over gloo and building the
    model of `overrides` from `weights`: against this process's results
    of `runs` (`_rank_summary` with the encode's bf16 roundings, every
    rank bit for bit rank 0) and `_spatial_details`.  Returns the rows by
    layout."""
    from crowdsam_tpu_torch.parallel.launch import run_ranks

    card = torch.cuda.get_device_name(0)
    with torch.no_grad():
        want, want_rows = _single_runs(model, runs)
    out = {}
    for m in layouts:
        key = f"1x{m} batch 1"
        t = time.perf_counter()
        ranks = run_ranks(_rank_task, m, (weights, dict(
            kind="data_shard", mesh=(1, m), batch=1, runs=runs,
            spatial_axis="model", overrides=list(overrides))),
            join_timeout_s=420.0, threads=None)
        row = dict(ranks=m, wall_s=time.perf_counter() - t,
                   label=SHARING.format(n=m, card=card),
                   **_rank_summary(f"{label} {key}", ranks, want, want_rows,
                                   cfg, encode_roundings=True,
                                   kernels=kernels))
        _spatial_details(f"{label} {key}", row, model, ranks, runs, (1, m),
                         per_image)
        out[key] = row
    return out


# The spatial axis past ViT-L's five window rows: the smallest M past them.
HALO_M = 6


def phase_spatial_halo(model, weights, frame, scene, noises, reference_cfg,
                       loaded_cfg):
    """`spatial_halo`: `ShardedPipeline(spatial_axis="model")` at (1, 6) on
    SAM ViT-L at full width, past its five window rows: bands of 11 / 11 /
    11 / 11 / 10 / 10 token rows, each window block first bringing the
    rows of the windows its band touches from their owners; on the first
    main-path frame at the reference thresholds and on crowd_scene(0)
    loaded.  Checks and figures of `_spatial_layouts` (K2 20, K3 4 and K4
    24 launches a rank an image, K3 and K4 on band shapes), and the halo
    rows and bytes a window block from the band layout."""
    from crowdsam_tpu_torch.parallel.spatial import Band, window_bands

    enc = model.sam.image_encoder
    grid = enc.img_size // enc.patch_size
    bounds = window_bands(grid, enc.window_size, HALO_M)
    need = Band(None, bounds).windows(enc.window_size)
    rows = sorted({i for (a, b), (lo, hi) in zip(need, bounds)
                   for i in range(a, b) if not lo <= i < hi})
    runs = [("reference, first frame", reference_cfg, [frame], noises[:1]),
            ("loaded", loaded_cfg, [scene], noises[1:2])]
    out = dict(phase="spatial_halo", nvidia_smi=_smi(),
               bands=[list(b) for b in bounds],
               window_rows_by_rank=[list(n) for n in need],
               halo_rows_per_window_block=len(rows),
               halo_bytes_per_window_block_per_image=len(rows) * grid
               * enc.embed_dim * 2,
               **_spatial_layouts("spatial_halo", model, weights, [HALO_M],
                                  runs, reference_cfg,
                                  {"window_attention": 20,
                                   "flash_mha_decomposed_relpos": 4,
                                   "flash_mha": 24}))
    print(json.dumps(out), flush=True)
    return out


MOBILE_SAM = ["model.sam_arch", "mobile_sam", "model.sam_model", "vit_t"]


def phase_spatial_tiny_vit():
    """`spatial_tiny_vit`: `mobile_sam` (TinyViT-5M) under the spatial axis
    at (1, 2) and (1, 3) on the first main-path frame at the reference
    thresholds: bands of its final 64-row grid, x4 / x2 / x1 / x1 at its
    stages, row halos at every 3x3 convolution and window attention.
    Checks and figures of `_spatial_layouts` (K4 24 launches a rank an
    image on band shapes, K2 and K3 none)."""
    import tempfile

    from crowdsam_tpu_torch.utils.synthetic import synthetic_images

    model, build_s = _arch_model(MOBILE_SAM)
    work = tempfile.mkdtemp(prefix="spatial_tiny_vit_")
    try:
        weights = os.path.join(work, "weights.pt")
        save_s = _save_weights(model, weights)
        gen = torch.Generator().manual_seed(78)
        noise = torch.rand(model.engine_cfg.grid_size ** 2, generator=gen)
        runs = [("reference, first frame", model.engine_cfg,
                 synthetic_images(0, 1), [noise])]
        out = dict(phase="spatial_tiny_vit", nvidia_smi=_smi(),
                   build_s=build_s, weights_save_s=save_s,
                   **_spatial_layouts(
                       "spatial_tiny_vit", model, weights, [2, 3], runs,
                       model.engine_cfg, {"window_attention": 0,
                                          "flash_mha_decomposed_relpos": 0,
                                          "flash_mha": 24},
                       overrides=MOBILE_SAM, kernels=(
                           "layer_norm", "flash_mha", "twoway_tail",
                           "mask_head")))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps(out), flush=True)
    del model
    torch.cuda.empty_cache()
    return out


def _ulps(d: torch.Tensor, w: torch.Tensor) -> float:
    """The largest |d| in bf16 ulps of the reference w (floored at 2^-7 of
    w's rms, so that values near zero do not blow the count up)."""
    w = w.float().abs().clamp_min(BF16_ULP * float(
        w.float().square().mean().sqrt()))
    ulp = torch.exp2(torch.floor(torch.log2(w)) - 7)
    return float((d.float().abs() / ulp).max())


def _block_diffs(outs, whole, lo, hi) -> list:
    """Per block: the largest difference of the band's output from the
    same rows of the whole encode's, absolute and in bf16 ulps."""
    return [dict(block=i, max_abs=float((o.float() - w[:, lo:hi].float())
                                        .abs().max()),
                 max_ulps=_ulps(o - w[:, lo:hi], w[:, lo:hi]))
            for i, (o, w) in enumerate(zip(outs, whole))]


def _band_blocks_rank(rank: int, world: int, weights: str, x):
    """One rank of `band_blocks`: the small model's SAM ViT-B on the
    normalized frame x, whole (each block's input and output kept), then
    its band at M = 2 free-running and then teacher-forced (each block fed
    the whole encode's input rows): per block the band output's largest
    difference from the whole's rows."""
    from crowdsam_tpu_torch.parallel.collectives import Shard
    from crowdsam_tpu_torch.parallel.mesh import axis_group, create_mesh
    from crowdsam_tpu_torch.parallel.spatial import sam_band

    model = _rank_model(weights, SMALL_OVERRIDES)
    enc = model.sam.image_encoder
    mesh = create_mesh((1, 2), device="cuda")
    band = sam_band(enc, Shard(*axis_group(mesh, "model")))
    x = x.cuda()
    ins, outs = [], []

    def record(store):
        return lambda mod, args, out: store.append(out)

    with torch.no_grad():
        hs = [b.register_forward_pre_hook(
            lambda mod, args: ins.append(args[0])) for b in enc.blocks]
        hs += [b.register_forward_hook(record(outs)) for b in enc.blocks]
        whole = enc(x)
        for h in hs:
            h.remove()
        free = []
        hs = [b.register_forward_hook(record(free)) for b in enc.blocks]
        got = enc.forward_band(x, band)
        for h in hs:
            h.remove()
        forced = []
        hs = [b.register_forward_pre_hook(
            lambda mod, args, i=i: (ins[i][:, band.lo:band.hi], args[1]))
            for i, b in enumerate(enc.blocks)]
        hs += [b.register_forward_hook(record(forced)) for b in enc.blocks]
        enc.forward_band(x, band)
        for h in hs:
            h.remove()
    return dict(band=(band.lo, band.hi),
                free=_block_diffs(free, outs, band.lo, band.hi),
                forced=_block_diffs(forced, outs, band.lo, band.hi),
                features_rel_l2=_rel_l2(got.float().cpu(),
                                        whole.float().cpu()),
                features_max_ulps=_ulps((got - whole).cpu(), whole.cpu()))


# A block's own difference (teacher-forced) beyond this many bf16 ulps is
# no rounding: a fault of the band.
BAND_ROUNDING_ULPS = 16


def phase_band_blocks(small):
    """`band_blocks`: the open check of the small card config (a score
    moved by 1.2e-4 under the spatial axis, SAM ViT-B at 256^2, whose
    16-row grid splits into bands of 14 and 2 token rows at M = 2).  Two
    gloo ranks sharing this card build the small model from this
    process's weights and compare each block's band output with the same
    rows of the whole encode, block by block: free-running (the band's
    own chain) and teacher-forced (each block fed the whole encode's
    input rows, so its difference is its own).  Reported: the first block
    where the free-running band differs and by how much, each block's
    difference in bf16 ulps, and the cause: "bf16 rounding" when every
    block's own difference stays within a few ulps
    (`BAND_ROUNDING_ULPS`), else "a fault in the band", which fails the
    phase."""
    import tempfile

    from crowdsam_tpu_torch.parallel.launch import run_ranks
    from crowdsam_tpu_torch.pipeline.predictor import PIXEL_MEAN, PIXEL_STD

    work = tempfile.mkdtemp(prefix="band_blocks_")
    try:
        weights = os.path.join(work, "weights.pt")
        _save_weights(small, weights)
        img = _small_image()
        s = small.sam.img_size
        frame = np.zeros((1, s, s, 3), np.float32)
        frame[0, :img.shape[0], :img.shape[1]] = img
        x = (torch.from_numpy(frame) - torch.tensor(PIXEL_MEAN)) / \
            torch.tensor(PIXEL_STD)
        x[0, img.shape[0]:] = 0
        t = time.perf_counter()
        ranks = run_ranks(_band_blocks_rank, 2, (weights, x),
                          join_timeout_s=300.0, threads=None)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    row = dict(phase="band_blocks", nvidia_smi=_smi(),
               wall_s=time.perf_counter() - t,
               config="small: SAM ViT-B at 256^2, M = 2", ranks={})
    worst = 0.0
    for r in ranks:
        first = next((d for d in r["free"] if d["max_abs"] > 0), None)
        forced = max(d["max_ulps"] for d in r["forced"])
        worst = max(worst, forced)
        row["ranks"][str(r["band"])] = dict(
            first_differing_block=first,
            free_running_max_ulps_by_block=[d["max_ulps"] for d in r["free"]],
            free_running_max_abs_by_block=[d["max_abs"] for d in r["free"]],
            own_max_ulps_by_block=[d["max_ulps"] for d in r["forced"]],
            own_max_abs_by_block=[d["max_abs"] for d in r["forced"]],
            features_rel_l2=r["features_rel_l2"],
            features_max_ulps=r["features_max_ulps"])
    row["cause"] = ("bf16 rounding" if worst <= BAND_ROUNDING_ULPS
                    else "a fault in the band")
    row["own_max_ulps"] = worst
    row["bound_ulps"] = BAND_ROUNDING_ULPS
    print(json.dumps(row), flush=True)
    if worst > BAND_ROUNDING_ULPS:
        raise AssertionError(f"band_blocks: {row}")
    return row


# The trainer's mesh step on the card: (2, 2), 3 head-only and 3
# full-decoder steps.  Bounds: the loss terms as tests/test_torch_train.py
# holds bf16, the gradients as `phase_train` holds K1's against the plain
# LayerNorm.  The leaves' gap is reported against the float32 bound of the
# CPU tests (1e-2 lr steps) but not held to it: an Adam step moves a leaf by
# about lr whatever its gradient's size, so a near-zero gradient component
# that bf16 rounding of other product shapes turns over moves by up to 2 lr
# (for any mesh step whose gradients are not bitwise the one process's).
TRAIN_MESH = (2, 2)
TRAIN_MESH_STEPS = 3
TRAIN_LOSS_TOL = 2e-2          # of the step's total loss
TRAIN_GRAD_TOL = 2e-2          # of the global gradient norm
TRAIN_LEAF_F32_TOL = 1e-2      # lr steps (the CPU tests' float32 bound)


def _dice_on_every_rank(part, losses):
    """Fault: the FG-map dice, computed alike on every rank, counted on
    every data rank."""
    return sum(losses.values()) / part.model.size


def _no_gradient_sum(real):
    """Fault: the gradient all-reduce left out (each rank keeps its own
    share; the loss terms are still summed, so the collectives stay in
    step)."""
    def fn(part, grads, losses):
        _, terms = real(part, {k: torch.zeros_like(v)
                               for k, v in grads.items()}, losses)
        return grads, terms
    return fn


def _sha256(tensors: dict) -> str:
    """One digest of the tensors' bytes, in key order."""
    import hashlib

    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(k.encode())
        h.update(tensors[k].contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _train_mesh_rank(rank: int, world: int, weights: str, task: dict):
    """One rank of `train_mesh`: the full-width model, a (2, 2) mesh, then
    for each run (name, trainer config, cache file, steps, fault) the
    steps of `AdapterTrainer.loss_and_grads(..., mesh=...)` with AdamW,
    from the model's own leaves and `trainer.draw(step)`.  Per run: each
    step's loss terms, host-clock ms (synchronized), all-reduces and bytes
    over `data` and `model`, K1 forward and backward launches; the first
    step's gradients and the leaves after the steps (rank 0 returns them),
    the leaves' SHA-256, peak memory."""
    from crowdsam_tpu_torch.ops import layernorm as ln
    from crowdsam_tpu_torch.parallel.mesh import create_mesh
    from crowdsam_tpu_torch.train import trainer as tr

    model = _rank_model(weights)
    mesh = create_mesh(task["mesh"], device="cuda")
    out = dict(rank=rank, coordinate=mesh.get_coordinate(), runs=[])
    for name, cfg, cache, steps, fault in task["runs"]:
        trainer = tr.AdapterTrainer(cfg, model.predictor)
        trainer.cache = torch.load(cache, map_location="cuda",
                                   weights_only=False)
        params = trainer.trainable_params()
        opt = tr.AdamW(trainer.lr, trainer.weight_decay, trainer.clip_grad)
        state = opt.init(params)
        n_cached = len(trainer.cache["n_boxes"])
        rows, first = [], None
        torch.cuda.reset_peak_memory_stats()
        with patched(tr, "_rank_loss", _dice_on_every_rank
                     if fault == "dice on every rank" else tr._rank_loss), \
                patched(tr, "_sum_step", _no_gradient_sum(tr._sum_step)
                        if fault == "no gradient all-reduce"
                        else tr._sum_step):
            for step in range(steps):
                fwd = ln.layer_norm.launches
                bwd = ln.layer_norm_backward.launches
                torch.cuda.synchronize()
                t = time.perf_counter()
                total, terms, grads = trainer.loss_and_grads(
                    params, step % n_cached, trainer.draw(step), mesh=mesh)
                opt.step(params, grads, state)
                torch.cuda.synchronize()
                part = trainer.last_part
                rows.append(dict(
                    ms=(time.perf_counter() - t) * 1e3,
                    total=float(total),
                    terms={k: float(v) for k, v in terms.items()},
                    prompts=part.prompts,
                    all_reduces=[part.data.calls, part.model.calls],
                    bytes=[part.data.bytes, part.model.bytes],
                    k1_forward=ln.layer_norm.launches - fwd,
                    k1_backward=ln.layer_norm_backward.launches - bwd))
                if first is None:
                    first = {k: v.cpu() for k, v in grads.items()}
        leaves = {k: v.cpu() for k, v in params.items()}
        out["runs"].append(dict(
            name=name, steps=rows, peak_memory_gib=torch.cuda.
            max_memory_allocated() / 2 ** 30,
            grads=first if rank == 0 else None,
            leaves=leaves if rank == 0 else None,
            leaves_sha256=_sha256(leaves)))
    return out


def _train_gaps(one, run, lr: float) -> dict:
    """A mesh run (rank 0) against the one-process steps: the loss terms'
    largest gap over the step's total, the first step's gradients' over
    the global norm, the leaves' in lr steps."""
    loss = max(abs(r["terms"][k] - float(o[1][k])) / abs(float(o[0]))
               for r, o in zip(run["steps"], one["steps"]) for k in r["terms"])
    g_one = one["grads"]
    norm = float(torch.sqrt(sum(g.double().square().sum()
                                for g in g_one.values())))
    grad = max(float((run["grads"][k] - g_one[k]).abs().max())
               for k in g_one) / norm
    steps = lr * len(run["steps"])
    gaps = {k: (run["leaves"][k] - one["leaves"][k]).abs() / steps
            for k in one["leaves"]}
    leaf = max(float(v.max()) for v in gaps.values())
    # Where the leaves part: the worst leaves with the first step's
    # gradients at their worst component.
    worst = sorted(gaps, key=lambda k: -float(gaps[k].max()))[:2]
    where = {}
    for k in worst:
        i = int(gaps[k].argmax())
        where[k] = dict(gap_lr_steps=float(gaps[k].max()),
                        past_f32_bound=int((gaps[k] > TRAIN_LEAF_F32_TOL)
                                           .sum()),
                        components=gaps[k].numel(),
                        grad_one=float(g_one[k].reshape(-1)[i]),
                        grad_mesh=float(run["grads"][k].reshape(-1)[i]))
    update = torch.sqrt(sum((one["leaves"][k] - one["start"][k]).double()
                            .square().sum() for k in one["leaves"]))
    diff = torch.sqrt(sum((run["leaves"][k] - one["leaves"][k]).double()
                          .square().sum() for k in one["leaves"]))
    return dict(loss_gap_over_total=loss, loss_bound=TRAIN_LOSS_TOL,
                grad_gap_over_norm=grad, grad_bound=TRAIN_GRAD_TOL,
                leaf_gap_lr_steps=leaf, leaf_f32_bound=TRAIN_LEAF_F32_TOL,
                leaves_past_f32_bound=sum(
                    int((v > TRAIN_LEAF_F32_TOL).sum())
                    for v in gaps.values()),
                leaf_components=sum(v.numel() for v in gaps.values()),
                leaf_gap_over_update_l2=float(diff / update),
                worst_leaves=where)


def phase_train_mesh(model, weights: str, work: str):
    """`train_mesh`: the trainer's mesh step at full width (SAM ViT-L,
    DINOv2 ViT-L/14, PWD-Net, bf16) on the synthetic 10-shot set, on a
    (2, 2) mesh of gloo ranks sharing this card: 3 head-only steps at the
    config's lr and 3 full-decoder steps at the bench recipe's lr 2e-4,
    each rank building the model from this process's weights, the cache
    computed here once.  Held against this process's one-process steps on
    the same draws (loss terms within 2e-2 of the step's total, first-step
    gradients within 2e-2 of the global norm), every rank's leaves bit for
    bit rank 0's; two faults, the FG dice counted on every rank and the
    gradient all-reduce left out, must break those bounds.  The leaves'
    gap from one process is reported beside the CPU tests' float32 bound
    (see `TRAIN_LEAF_F32_TOL`).  Reported: ms a step a rank, all-reduces
    and bytes a step, K1 forward and backward launches a step, peak memory
    a rank (ranks sharing one card: not multi-card figures)."""
    import copy

    from crowdsam_tpu_torch.config import modify_config
    from crowdsam_tpu_torch.parallel.launch import run_ranks
    from crowdsam_tpu_torch.train import trainer as tr
    from crowdsam_tpu_torch.train.dataset import ArrayDataset

    card, smi = torch.cuda.get_device_name(0), _smi()
    data = ArrayDataset(*_ten_shot())
    head = modify_config(copy.deepcopy(model.config),
                         ["train.steps", str(TRAIN_MESH_STEPS)])
    full = modify_config(copy.deepcopy(head), ["train.full_decoder", "True",
                                               "train.lr", "2e-4"])
    runs, ones = [], {}
    for mode, cfg in (("head-only", head), ("full decoder", full)):
        trainer = tr.AdapterTrainer(cfg, model.predictor)
        trainer.cache_features(data)
        path = os.path.join(work, f"cache {mode}.pt")
        torch.save(trainer.cache, path)
        params = trainer.trainable_params()
        start = {k: v.cpu() for k, v in params.items()}
        opt = tr.AdamW(trainer.lr, trainer.weight_decay, trainer.clip_grad)
        state = opt.init(params)
        steps, first = [], None
        n_cached = len(trainer.cache["n_boxes"])
        for step in range(TRAIN_MESH_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            total, terms, grads = trainer.loss_and_grads(
                params, step % n_cached, trainer.draw(step))
            opt.step(params, grads, state)
            torch.cuda.synchronize()
            steps.append((total, terms, (time.perf_counter() - t) * 1e3))
            first = first or {k: v.cpu() for k, v in grads.items()}
        ones[mode] = dict(steps=steps, grads=first, lr=trainer.lr,
                          start=start,
                          leaves={k: v.cpu() for k, v in params.items()})
        runs.append((mode, cfg, path, TRAIN_MESH_STEPS, None))
        for fault in ("dice on every rank", "no gradient all-reduce"):
            runs.append((f"{mode}, fault: {fault}", cfg, path,
                         TRAIN_MESH_STEPS, fault))
    world = TRAIN_MESH[0] * TRAIN_MESH[1]
    t = time.perf_counter()
    ranks = run_ranks(_train_mesh_rank, world, (weights, dict(
        mesh=TRAIN_MESH, runs=runs)), join_timeout_s=420.0, threads=None)
    row = dict(phase="train_mesh", mesh=list(TRAIN_MESH), ranks=world,
               wall_s=time.perf_counter() - t, nvidia_smi=smi,
               label=SHARING.format(n=world, card=card), runs={})
    failed = []
    for r, (name, _, _, _, fault) in enumerate(runs):
        mode = name.split(",")[0]
        one = ones[mode]
        run = ranks[0]["runs"][r]
        gaps = _train_gaps(one, run, one["lr"])
        same = all(rk["runs"][r]["leaves_sha256"] == run["leaves_sha256"]
                   for rk in ranks)
        steps = run["steps"]
        row["runs"][name] = dict(
            **gaps, every_rank_leaves_equal_rank0=same,
            ms_per_step_by_rank=[[st["ms"] for st in rk["runs"][r]["steps"]]
                                 for rk in ranks],
            one_process_ms_per_step=[st[2] for st in one["steps"]],
            all_reduces_per_step=steps[0]["all_reduces"],
            bytes_per_step=steps[0]["bytes"],
            prompts_by_rank=[rk["runs"][r]["steps"][0]["prompts"]
                             for rk in ranks],
            k1_forward_per_step=[st["k1_forward"] for st in steps],
            k1_backward_per_step=[st["k1_backward"] for st in steps],
            peak_memory_gib_by_rank=[rk["runs"][r]["peak_memory_gib"]
                                     for rk in ranks],
            loss_terms_last_step=steps[-1]["terms"])
        within = (gaps["loss_gap_over_total"] <= TRAIN_LOSS_TOL
                  and gaps["grad_gap_over_norm"] <= TRAIN_GRAD_TOL)
        if fault is None and not (within and same):
            failed.append(f"{name}: off the one-process step")
        if fault is not None and within:
            failed.append(f"{name}: the fault does not break the bounds")
        if fault is None and (steps[0]["k1_forward"] == 0 or (
                mode == "full decoder" and steps[0]["k1_backward"] == 0)):
            failed.append(f"{name}: K1 not launched")
    print(json.dumps(row), flush=True)
    if failed:
        raise AssertionError(f"train_mesh: {failed}")
    return row


def _nccl_pair_rank(rank: int, world: int):
    """One all-reduce on cuda:0 from each of two NCCL ranks."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    try:
        x = torch.ones(4, device="cuda")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        return f"no error: {x.tolist()}"
    except Exception as e:           # the finding is the error itself
        return f"{type(e).__name__}: {str(e).splitlines()[0][:300]}"


def phase_nccl():
    """The collectives on a one-rank NCCL group, on bf16, int32 and bool
    CUDA tensors, exact against what they must give (this shows that the
    NCCL path builds and launches on the card; it is not a multi-card
    check); then one try of two NCCL ranks on this one card, its error
    printed on one line (why the multi-rank phases run gloo)."""
    import datetime
    import tempfile

    import torch.distributed as dist

    from crowdsam_tpu_torch.parallel import collectives as col
    from crowdsam_tpu_torch.parallel.launch import run_ranks

    work = tempfile.mkdtemp(prefix="nccl_")
    row = {"phase": "nccl_world1", "cases": {}}
    try:
        dist.init_process_group(
            "nccl", init_method=f"file://{work}/store", rank=0,
            world_size=1, timeout=datetime.timedelta(seconds=60))
        shard = col.Shard(dist.group.WORLD, 0, 1)
        gen = torch.Generator(device="cuda").manual_seed(3)
        for dtype in (torch.bfloat16, torch.int32, torch.bool):
            x = torch.randn((16, 4096, 16), generator=gen, device="cuda")
            x = (x > 0) if dtype == torch.bool else (
                (x * 100).to(dtype) if dtype == torch.int32 else x.to(dtype))
            mine = torch.arange(16, device="cuda") % 3 != 0
            gathered = col.gather_rows(x, shard)
            masked = col.masked_psum(x, mine, shard)
            want_masked = torch.where(mine[:, None, None], x,
                                      torch.zeros((), dtype=dtype,
                                                  device="cuda"))
            case = dict(
                gather_exact=torch.equal(gathered[0], x),
                masked_exact=torch.equal(masked, want_masked))
            if dtype == torch.bool:
                case["or_exact"] = torch.equal(col.or_reduce(x, shard), x)
            if not all(case.values()):
                raise AssertionError(f"nccl_world1 {dtype}: {case}")
            case["ms_gather"] = time_ms(lambda: col.gather_rows(x, shard), 10)
            row["cases"][str(dtype)] = case
        row["all_reduces"], row["bytes"] = shard.calls, shard.bytes
        dist.destroy_process_group()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # NCCL's own warning (on the ranks' standard error) names the cause.
    os.environ.setdefault("NCCL_DEBUG", "WARN")
    try:
        res = run_ranks(_nccl_pair_rank, 2, backend="nccl",
                        join_timeout_s=90.0)
        row["nccl_two_ranks_one_card"] = res
    except (RuntimeError, TimeoutError) as e:
        lines = [ln for ln in str(e).splitlines() if ln.strip()]
        row["nccl_two_ranks_one_card"] = " | ".join(lines[-2:])[:400]
    print(json.dumps(row), flush=True)
    print(f"nccl, two ranks on one card: {row['nccl_two_ranks_one_card']}",
          flush=True)
    return row



def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; nothing to run")
        return 2
    from crowdsam_tpu_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = t_start = time.time()
    draws = start_draws()
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
        torch.cuda.empty_cache()
        # SAM ViT-H's shapes, K2/K3 at 64 and K4 timed just before them.
        k2_80 = phase_window(gen, hd=80)
        k3_80 = phase_global(gen, hd=80)
        # The rect encode's shapes.
        k2_rect = {g: phase_window(gen, grid=g) for g in RECT_K2_GRIDS}
        k3_rect = {g: phase_global(gen, hw=g) for g in RECT_K3_GRIDS}
        # ViT-H's rect encode of a grid 64 tall (phase `vit_h`).
        k3_rect80 = {g: phase_global(gen, hd=80, hw=g)
                     for g in RECT_K3_GRIDS_80}
        k4_rect = {}
        for s in RECT_K4_TOKENS:
            k4_rect[s] = _k4_case(gen, s)
            print(json.dumps({"phase": "K4 rect", **k4_rect[s]}), flush=True)
        torch.cuda.empty_cache()
        # The spatial axis's query bands (M = 2).
        k3_band = {b: phase_global_band(gen, band=b)
                   for b in ((0, 42), (42, 64))}
        k3_band80 = phase_global_band(gen, hd=80)
        k3_band80_odd = phase_global_band(gen, hd=80, band=ODD_K3_BAND)
        k3_band_fold = phase_global_band(gen, fold=True)
        k4_band = phase_dino_band(gen)
        # Past the window rows (M = 6) and TinyViT's DINOv2 bands (M = 3).
        k2_halo = {g: phase_window(gen, grid=g, label=f"K2 halo {g[0]}x"
                                   f"{g[1]}") for g in HALO_K2_GRIDS}
        k3_band6 = {b: phase_global_band(gen, band=b)
                    for b in HALO_K3_BANDS}
        k4_band6 = phase_dino_band(gen, HALO_K4_BANDS)
        k4_band3 = phase_dino_band(gen, TINY_K4_BANDS)
        torch.cuda.empty_cache()
        # The float32 arms of K2-K4 and K1's float32 forward.
        k_f32 = phase_f32_arms(gen)
        ln_f32 = phase_layernorm_f32(gen)
    ln_bwd_rows = phase_layernorm_backward(gen)
    torch.cuda.empty_cache()

    from crowdsam_tpu_torch.config import modify_config
    from crowdsam_tpu_torch.pipeline.crowdsam import CrowdSAM
    from crowdsam_tpu_torch.utils.synthetic import (
        full_width_config,
        synthetic_images,
    )

    phase_numpy_init(draws["main"])
    t0 = time.time()
    with _no_default_init():
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
        k5_images = phase_twoway_tail_images(
            model, synthetic_images(20) + synthetic_images(21))
        torch.cuda.empty_cache()
    export_rows = phase_export(model, frame)
    torch.cuda.empty_cache()
    with torch.no_grad():
        k56_shards = phase_decode_prompt_shards(
            model, frame, synthetic_images(20), k6_probe)
        torch.cuda.empty_cache()
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
    launches, loaded_launches, batch, multi = phase_end_to_end(model)
    phase_nccl()
    with torch.no_grad():
        phase_modes(model, model.engine_cfg)
        rect = phase_rect(model, model.engine_cfg)
    phase_small_reference(small)
    phase_band_blocks(small)
    del small
    torch.cuda.empty_cache()
    with torch.no_grad():
        phase_small_cases()
    train = phase_train(model)
    del model
    torch.cuda.empty_cache()
    adapted = phase_msgpack_adapter(frame)
    phase_loaded_reference(adapted)
    with torch.no_grad():
        phase_amg(adapted.sam)
        # float32 on the card: the encoders, the unfused decode, the
        # trainer and the AMG through the float32 arms of K1-K4.
        f32_model, f32_path, f32_unfused = phase_f32_path(adapted)
    del adapted
    torch.cuda.empty_cache()
    train_f32 = phase_train_f32(f32_model)
    with torch.no_grad():
        phase_amg_f32(f32_model.sam)
        # float32 with the fused decode: the float32 arms of K5 and K6.
        with _no_default_init():
            small_f32 = CrowdSAM(modify_config(
                _small_config(), ["tpu.compute_dtype", "float32"]),
                device="cuda")
        k5_f32, k5_f32_outs = phase_k5_f32(f32_model, small_f32)
        k6_f32 = phase_k6_f32(k5_f32_outs,
                              k6_probe["sass_per_gelu"]["erf"])
        del k5_f32_outs, small_f32, f32_model
        torch.cuda.empty_cache()
        f32_fused_model, f32_fused = phase_f32_fused_path(f32_unfused)
        del f32_unfused
        f32_batched = phase_f32_batched(f32_fused_model)
        del f32_fused_model
    torch.cuda.empty_cache()
    phase_cli()
    torch.cuda.empty_cache()
    probe = phase_deviation_probe()
    torch.cuda.empty_cache()
    vit_h_shapes = phase_vit_h(draws["vit_h"])
    torch.cuda.empty_cache()
    with torch.no_grad():
        phase_vit_h_f32(draws["vit_h"])
    phase_small_vit_h(draws["vit_h"])
    del draws
    phase_sam_hq()
    phase_mobile_sam()
    tiny = phase_spatial_tiny_vit()
    with torch.no_grad():
        trainfree = phase_trainfree()
        phase_crop_layers()
    finish_train_f32(train_f32)

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
             library_device_ms=ln["library_device_ms"],
             ms_op_median=ln["ms_op_median"],
             ms_direct_launch_median=ln["ms_direct_launch_median"],
             ms_custom_op_median=ln["ms_custom_op_median"],
             launches_export={r["case"]: r["k1_launches_per_call"]
                              for r in export_rows},
             launches_by_shape=dict(K1_SHAPES["main path"])),
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
             "crowdsam_tpu/models/attention.py:163", k2, RELPOS_EXTRA),
            ("flash_mha_decomposed_relpos", src_attn,
             "crowdsam_tpu/models/attention.py:126", k3,
             RELPOS_EXTRA + ("folded_form",)),
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
    # K5's image axis: one call over B images x 32 prompts.
    table[-2]["by_images"] = k5_images["by_images"]
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
    # The serving head's mask downscaling (widths 4 and 16): launches in one
    # call of the exported serving program.
    serving = next(r for r in export_rows
                   if r["case"] == "serving single-mask")
    for shape, d in (("16384x4", 4), ("4096x16", 16)):
        row = next(r for r in ln_rows if r["shape"] == shape)
        table.append(dict(
            name="layer_norm", route="cuda",
            source="crowdsam_tpu_torch/csrc/layernorm.cu",
            replaces="crowdsam_tpu/ops/layernorm.py:34",
            launches=serving["k1_launches_by_width"].get(d, 0),
            launches_in="export, serving single-mask, one call",
            max_abs_err=row["max_abs_err"], **{k: row[k] for k in keys},
            device_ms=row["device_ms"],
            library_device_ms=row["library_device_ms"]))
    # K1 at SAM's blocks (4096x1024) on the main path; the decoder's norm4
    # on keys and its upscaling LayerNorm in the unfused decode of one
    # crowd scene (the fused decode runs neither).
    for shape, key, note in (
            ("4096x1024", "main path",
             f"end_to_end, {N_IMAGES} frames, at 4096x1024"),
            ("131072x256", "unfused decode",
             "fused_vs_unfused, the unfused decode of one crowd scene"),
            ("524288x64", "unfused decode",
             "fused_vs_unfused, the unfused decode of one crowd scene")):
        row = next(r for r in ln_rows if r["shape"] == shape)
        table.append(dict(
            name="layer_norm", route="cuda",
            source="crowdsam_tpu_torch/csrc/layernorm.cu",
            replaces="crowdsam_tpu/ops/layernorm.py:34",
            launches=K1_SHAPES[key].get(shape, 0), launches_in=note,
            max_abs_err=row["max_abs_err"], **{k: row[k] for k in keys},
            device_ms=row["device_ms"],
            library_device_ms=row["library_device_ms"]))
    # The head-dim-80 / width-1280 rows: launches on the vit_h path.
    ln80 = next(r for r in ln_rows if r["shape"] == "4096x1280")
    table.insert(1, dict(
        name="layer_norm", route="cuda",
        source="crowdsam_tpu_torch/csrc/layernorm.cu",
        replaces="crowdsam_tpu/ops/layernorm.py:34",
        launches=vit_h_shapes["layer_norm_by_width"].get(1280, 0),
        launches_in=f"vit_h, {N_IMAGES} frames, width 1280",
        max_abs_err=ln80["max_abs_err"], **{k: ln80[k] for k in keys},
        device_ms=ln80["device_ms"],
        library_device_ms=ln80["library_device_ms"]))
    for name, rep, row, extra in (
            ("window_attention", "crowdsam_tpu/models/attention.py:163",
             k2_80, RELPOS_EXTRA),
            ("flash_mha_decomposed_relpos",
             "crowdsam_tpu/models/attention.py:126", k3_80,
             RELPOS_EXTRA + ("folded_form",))):
        at = next(i for i, r in enumerate(table) if r["name"] == name)
        table.insert(at + 1, dict(
            name=name, route="cuda", source=src_attn, replaces=rep,
            launches=vit_h_shapes[f"{name}_by_head_dim"].get(80, 0),
            launches_in=f"vit_h, {N_IMAGES} frames, head dim 80",
            max_abs_err=row["max_abs_err"], **{k: row[k] for k in keys},
            device_ms=row["device_ms"], **{k: row[k] for k in extra}))
    # The rect encode's shapes (launches on the rect_encode phase's three
    # frames) and the train-free pass's K4 (launches on its frame).
    rect_shapes = rect["launches_by_shape_rect"]
    for name, rep, rows, key, extra in (
            ("window_attention", "crowdsam_tpu/models/attention.py:163",
             k2_rect, "window_attention_by_shape", RELPOS_EXTRA),
            ("flash_mha_decomposed_relpos",
             "crowdsam_tpu/models/attention.py:126", k3_rect,
             "flash_mha_decomposed_relpos_by_shape",
             RELPOS_EXTRA + ("form", "folded_form"))):
        for (h, w), row in rows.items():
            table.append(dict(
                name=name, route="cuda", source=src_attn, replaces=rep,
                launches=rect_shapes[key].get(f"{h}x{w}", 0),
                launches_in=f"rect_encode, {N_IMAGES} frames, grid {h}x{w}",
                max_abs_err=row["max_abs_err"],
                **{k: row[k] for k in keys}, device_ms=row["device_ms"],
                **{k: row.get(k) for k in extra}))
    # ViT-H's rect encode of the frames 64 tall (phase vit_h): K3 at head
    # dim 80 in the columns form.
    vit_h_rect = vit_h_shapes["rect"]["flash_mha_decomposed_relpos_by_shape"]
    for (h, w), row in k3_rect80.items():
        table.append(dict(
            name="flash_mha_decomposed_relpos", route="cuda",
            source=src_attn, replaces="crowdsam_tpu/models/attention.py:126",
            launches=vit_h_rect.get(f"{h}x{w}", 0),
            launches_in=f"vit_h rect_encode, frames 64 tall, grid {h}x{w}",
            max_abs_err=row["max_abs_err"], **{k: row[k] for k in keys},
            device_ms=row["device_ms"],
            **{k: row.get(k) for k in RELPOS_EXTRA + ("form", "folded_form")}))
    src_k4 = "crowdsam_tpu_torch/csrc/flash_sm90.cu"
    for s_tok, row in k4_rect.items():
        table.append(dict(
            name="flash_mha", route="cuda", source=src_k4,
            replaces="crowdsam_tpu/models/attention.py:86",
            launches=rect_shapes["flash_mha_by_shape"].get(
                f"{s_tok} tokens", 0),
            launches_in=f"rect_encode, {N_IMAGES} frames, {s_tok} tokens",
            max_abs_err=row["max_abs_err"], **{k: row[k] for k in keys},
            device_ms=row["device_ms"],
            library_device_ms=row["library_device_ms"]))
    table.append(dict(
        name="flash_mha", route="cuda", source=src_k4,
        replaces="crowdsam_tpu/models/attention.py:86",
        launches=trainfree["launches_per_image"]["flash_mha"],
        launches_in="trainfree, 1 frame (encode + sim map)",
        max_abs_err=k4["max_abs_err"], **{k: k4[k] for k in keys},
        device_ms=k4["device_ms"],
        library_device_ms=k4["library_device_ms"]))
    # The batched pipeline's launches (phase generate_batch, loaded, B = 8,
    # the counts set to 0 just before it) on the main-path rows, and the
    # multi-device paths' (rank 0 of each, loaded, counts set to 0 in the
    # rank just before its run).
    multi_paths = {
        "prompt_shard M=2": multi["prompt_shard"],
        "data_shard 2x1": multi["data_shard"]["2x1 batch 4"],
        "data_shard 2x2 prompt_axis": multi["data_shard"][
            "2x2 batch 4, prompt_axis model"]}
    for r in table:
        if r.get("launches_in") in (None, "end_to_end_loaded"):
            r["launches_generate_batch_loaded_b8"] = batch["loaded"][8][
                "launches"][r["name"]]
            # The deviation probe's parity run on crowd_scene(0).
            r["launches_deviation_probe_parity"] = probe["parity_launches"][
                r["name"]]
            r["launches_multi_device_loaded_rank0"] = {
                path: row["loaded"]["launches_by_rank"][0][r["name"]]
                for path, row in multi_paths.items()}
    # The spatial axis's query bands: launches by band shape on each rank
    # of spatial_shard's (1, 2) mesh at the reference thresholds.
    sp = multi["spatial_shard"]["1x2 batch 1"]["reference"]
    sp_shapes = sp["launches_by_shape_by_rank"]
    band_keys = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms", "library_device_ms", "shape", "band",
                 "max_abs_err", "same_rows_of_whole_launch_exact",
                 "same_rows_of_whole_launch_max_abs_diff")
    for rank, ((lo, hi), row) in enumerate(k3_band.items()):
        table.append(dict(
            name="flash_mha_decomposed_relpos", route="cuda",
            source=src_attn, replaces="crowdsam_tpu/models/attention.py:126",
            launches=sp_shapes[rank]["flash_mha_decomposed_relpos_by_shape"]
            .get(f"{hi - lo}x64 of 64x64", 0),
            launches_in=f"spatial_shard 1x2, rank {rank}, {N_IMAGES} frames",
            **{k: row[k] for k in band_keys}))
    for row, note in ((k3_band80, "head dim 80 (vit_h)"),
                      (k3_band80_odd, "head dim 80 (vit_h), an odd band"),
                      (k3_band_fold, "folded form")):
        table.append(dict(
            name="flash_mha_decomposed_relpos", route="cuda",
            source=src_attn, replaces="crowdsam_tpu/models/attention.py:126",
            launches=0, launches_in=f"{note}: no run of this script reaches "
                                    f"it under the spatial axis",
            **{k: row[k] for k in band_keys}))
    for rank, (row, (lo, hi)) in enumerate(zip(k4_band, K4_BANDS)):
        table.append(dict(
            name="flash_mha", route="cuda", source=src_k4,
            replaces="crowdsam_tpu/models/attention.py:86",
            launches=sp_shapes[rank]["flash_mha_by_shape"].get(
                f"{hi - lo} of {K4_BANDS[-1][1]} tokens", 0),
            launches_in=f"spatial_shard 1x2, rank {rank}, {N_IMAGES} frames",
            **{k: row[k] for k in band_keys}))
    # Past the window rows: K2 on the windows a band touches, K3 and K4 on
    # the bands of spatial_halo's (1, 6) mesh (launches over its six ranks
    # on the first frame); K4 on TinyViT's DINOv2 bands at (1, 3).
    halo = multi["spatial_halo"]["1x6 batch 1"]["reference, first frame"]
    tiny3 = tiny["1x3 batch 1"]["reference, first frame"]

    def by_rank(run, key, shape):
        return [r[key].get(shape, 0) for r in run["launches_by_shape_by_rank"]]

    for (gh, gw), row in k2_halo.items():
        n = by_rank(halo, "window_attention_by_shape", f"{gh}x{gw}")
        table.append(dict(
            name="window_attention", route="cuda", source=src_attn,
            replaces="crowdsam_tpu/models/attention.py:163", launches=sum(n),
            launches_by_rank=n,
            launches_in="spatial_halo 1x6, six ranks, first frame",
            max_abs_err=row["max_abs_err"], **{k: row[k] for k in keys},
            device_ms=row["device_ms"], grid=f"{gh}x{gw}",
            **{k: row[k] for k in RELPOS_EXTRA}))
    for (lo, hi), row in k3_band6.items():
        n = by_rank(halo, "flash_mha_decomposed_relpos_by_shape",
                    f"{hi - lo}x64 of 64x64")
        table.append(dict(
            name="flash_mha_decomposed_relpos", route="cuda",
            source=src_attn, replaces="crowdsam_tpu/models/attention.py:126",
            launches=sum(n), launches_by_rank=n,
            launches_in="spatial_halo 1x6, six ranks, first frame",
            **{k: row[k] for k in band_keys}))
    for bands, rows, run, label in (
            (HALO_K4_BANDS, k4_band6, halo, "spatial_halo 1x6"),
            (TINY_K4_BANDS, k4_band3, tiny3, "spatial_tiny_vit 1x3")):
        for (lo, hi), row in zip(bands, rows):
            n = by_rank(run, "flash_mha_by_shape",
                        f"{hi - lo} of {K4_BANDS[-1][1]} tokens")
            table.append(dict(
                name="flash_mha", route="cuda", source=src_k4,
                replaces="crowdsam_tpu/models/attention.py:86",
                launches=sum(n), launches_by_rank=n,
                launches_in=f"{label}, every rank, first frame",
                **{k: row[k] for k in band_keys}))
    # K5 and K6 at a prompt shard's counts (32 / M prompts).
    for r in table:
        if r["name"] in ("twoway_tail", "mask_head") and r.get(
                "launches_in") is None:
            key = "k5" if r["name"] == "twoway_tail" else "k6"
            r["by_prompts"] = {
                p: {f: row[key].get(f) for f in (
                    "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                    "max_abs_err")}
                for p, row in k56_shards.items()}
    # The float32 arms (`csrc/attention_f32.cu`) and K1's float32 forward:
    # launches on the float32 path's three frames (phase `float32 path`, the
    # counts set to 0 just before it); its model is SAM ViT-L and DINOv2,
    # so head dim 80, the rect grids and the bands are not on it.
    src_f32 = "crowdsam_tpu_torch/csrc/attention_f32.cu"
    f32_note = f"float32 path, {N_IMAGES} frames"
    f32_extra = ("device_ms", "library_device_ms", "sdpa_backend",
                 "mean_abs_err", "plain_max_abs_err", "err_over_tol",
                 "instantiation")
    for name, arm, rep, cases, by in (
            ("window_attention", "K2", "crowdsam_tpu/models/attention.py:163",
             [(f"{g[0]}x{g[1]}", hd == 64) for g, hd in F32_K2],
             "window_attention_by_shape"),
            ("flash_mha_decomposed_relpos", "K3",
             "crowdsam_tpu/models/attention.py:126",
             [(f"{g[0]}x{g[1]}" if (lo, hi) == (0, g[0]) else
               f"{hi - lo}x{g[1]} of {g[0]}x{g[1]}", hd == 64)
              for g, hd, (lo, hi) in F32_K3],
             "flash_mha_decomposed_relpos_by_shape"),
            ("flash_mha", "K4", "crowdsam_tpu/models/attention.py:86",
             [(f"{s_tok} tokens" if (lo, hi) == (0, s_tok) else
               f"{hi - lo} of {s_tok} tokens", True)
              for s_tok, (lo, hi) in F32_K4], "flash_mha_by_shape")):
        for (key, on_path), row in zip(cases, k_f32[arm]):
            n = f32_path[by].get(key, 0) if on_path else 0
            table.append(dict(
                name=name, dtype="float32", route="cuda", source=src_f32,
                replaces=rep, launches=n,
                launches_in=f32_note if n else
                f"{f32_note}: not on it (ViT-L's square encode)",
                max_abs_err=row["max_abs_err"], **{k: row[k] for k in keys},
                **{k: row[k] for k in f32_extra}))
    for row in ln_f32:
        n = f32_path["layer_norm_by_dtype_shape"].get(
            f"float32 {row['shape']}", 0)
        table.append(dict(
            name="layer_norm", dtype="float32", route="cuda",
            source="crowdsam_tpu_torch/csrc/layernorm.cu",
            replaces="crowdsam_tpu/ops/layernorm.py:34", launches=n,
            launches_in=f32_note if n else f"{f32_note}: not on it (vit_h)",
            max_abs_err=row["max_abs_err"], **{k: row[k] for k in keys},
            device_ms=row["device_ms"],
            library_device_ms=row["library_device_ms"]))
    # The float32 arms of K5 and K6 (`csrc/decode_tail_f32.cu`,
    # `csrc/mask_head_f32.cu`): launches on the float32 fused path's three
    # frames (phase `float32 fused path`, the counts set to 0 just before
    # it), on `generate_batch` at B = 2 (`float32 batched`) and on rank 0
    # of the float32 prompt shard (M = 2, `multi_device`'s spawn).
    f32_shard = multi["prompt_shard_f32"]["float32, 2 frames"]
    for name, src, rep, rows, paths in (
            ("twoway_tail", "crowdsam_tpu_torch/csrc/decode_tail_f32.cu",
             "crowdsam_tpu/models/decode_tail_kernel.py:359", k5_f32,
             {"main path": "float32 fused path, 3 frames",
              "image axis": "float32 batched, generate_batch B=2, 2 frames",
              "prompt shard": "float32 prompt_shard M=2, rank 0, 2 frames"}),
            ("mask_head", "crowdsam_tpu_torch/csrc/mask_head_f32.cu",
             "crowdsam_tpu/models/mask_head_kernel.py:165", k6_f32,
             {"main path, 32x4096, emit_exp": "float32 fused path, 3 frames",
              "prompt shard": "float32 prompt_shard M=2, rank 0, 2 frames"})):
        for row in rows:
            where = next((v for k, v in paths.items()
                          if row["shape"].startswith(k)), None)
            n = 0
            if where is not None and where.startswith("float32 fused"):
                n = f32_fused["launches"][name]
            elif where is not None and where.startswith("float32 batched"):
                n = f32_batched["launches"][name]
            elif where is not None:
                n = f32_shard["launches_by_rank"][0][name]
            table.append(dict(
                name=name, dtype="float32", route="cuda", source=src,
                replaces=rep, launches=n,
                launches_in=where or "no run of this script: the arm's "
                                     "phase alone",
                max_abs_err=row["max_abs_err"],
                **{k: row.get(k) for k in keys}, device_ms=row["device_ms"],
                replaced_ms=row["replaced_ms"], replaced=row["replaced"],
                mean_abs_err={o: v["mean_abs_err"]
                              for o, v in row["outputs"].items()},
                err_over_tol=max(v["err_over_tol"]
                                 for v in row["outputs"].values())))
    print(json.dumps({"smoke_wall_s": time.time() - t_start}), flush=True)
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


def _wall_timed(fn):
    """`fn` printing its wall time as a JSON line when it returns or
    fails."""
    import functools

    @functools.wraps(fn)
    def run(*a, **kw):
        t = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            print(json.dumps({"phase_wall_s": {
                fn.__name__: time.perf_counter() - t}}), flush=True)
    return run


for _name in [n for n in list(globals()) if n.startswith("phase_")]:
    globals()[_name] = _wall_timed(globals()[_name])


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == TRAIN_F32_REFERENCE:
        sys.exit(_train_f32_reference(sys.argv[2]))
    sys.exit(main())
