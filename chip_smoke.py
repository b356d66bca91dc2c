"""Smoke run of the PyTorch/CUDA port (`crowdsam_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from `crowdsam_tpu_torch/csrc/` (nvcc, sm_90a, into
the gitignored `build/kernels/`), then:

1. holds every kernel against its plain PyTorch version at the main path's
   shapes in bf16, with a tolerance of its own, and shows that the same
   tolerance rejects the plain version with a known fault (a dropped key
   tile, swapped rel-pos tables); times kernel, plain version and the
   nearest single PyTorch library call (one JSON line per phase);
2. runs `CrowdSAM.generate` at full width -- SAM ViT-L + DINOv2 ViT-L/14 +
   PWD-Net, bf16, seeded random weights, `tpu.fused_decode false`,
   `test.output_rles false` -- on seeded synthetic frames, with every
   kernel's launch count set to 0 just before and read just after; every
   kernel must have launched.  The same model then gives the encode's share
   of the time, the device's idle share of one frame (busy and wall time
   from the same profiled window), and a loaded pass on seeded crowd scenes
   with the pred-IoU and stability filters off, so that the survivor pass
   (cleanup, re-NMS, boxes) runs at full width on real detections;
3. checks the outputs: finite boxes and scores of the expected shapes inside
   the image, and, on a small configuration with head dim 64, the card's
   bf16 kernel path against the plain float32 path on the CPU, detections
   included.

Prints the kernel table as one JSON line, the card's name and power limit,
and last `{"ok": true, "device": {...}}`.  Exits non-zero, printing no
result, when CUDA is absent or any phase fails.
"""

from __future__ import annotations

import dataclasses
import json
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


def bound(nbytes: float, flops: float, flop_rate: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name, got, want, atol, faults=()):
    """|got - want| <= atol + BF16_ULP |want| everywhere, and every plain
    version with a known fault (label, tensor) breaks that bound somewhere.
    Returns the figures of the comparison; raises when either fails."""
    got, want = got.float(), want.float()
    tol = atol + BF16_ULP * want.abs()
    err = (got - want).abs()
    out = {
        "max_abs_err": float(err.max()),
        "out_rms": float(want.square().mean().sqrt()),
        "out_max_abs": float(want.abs().max()),
        "tol": f"{atol:g}+2^-7*|y|",
        "err_over_tol": float((err / tol).max()),
        "fault_err_over_tol": {
            label: float(((f.float() - want).abs() / tol).max())
            for label, f in faults},
    }
    bad = [k for k, r in out["fault_err_over_tol"].items() if r <= 1.0]
    if not bool(torch.isfinite(got).all()) or out["err_over_tol"] > 1.0:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version: {out}")
    if bad:
        raise AssertionError(f"{name}: the tolerance does not see the "
                             f"faults {bad}: {out}")
    return out


def _attention_plain(q, k, v, scale, bias=None, drop=None):
    """softmax(scale q.k + bias) v in f32, keys in `drop` masked: the plain
    attention with a known fault (phase checks only)."""
    logits = (q.float() @ k.float().transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias
    if drop is not None:
        logits[..., drop] = float("-inf")
    return torch.softmax(logits, dim=-1) @ v.float()


def _relpos_bias(q, rh, rw, hw):
    from crowdsam_tpu_torch.models.attention import _rel_bias_terms

    h, w = hw
    fh, fw = _rel_bias_terms(q.float(), rh.float(), rw.float(), hw)
    lead = q.shape[:-2]
    return (fh.reshape(*lead, h, w, h, 1)
            + fw.reshape(*lead, h, w, 1, w)).reshape(*lead, h * w, h * w)


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
        b_ms, by = bound(2 * n * d * 2 + 2 * d * 4, 8.0 * n * d,
                         F32_FLOP_PER_S)
        rows.append(dict(shape=f"{n}x{d}", **cmp, ms=t_k, plain_ms=t_p,
                         library_ms=t_l, bound_ms=b_ms, bound_by=by))
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
    bias = _relpos_bias(q, rh, rw, (ws, ws))

    def as_grid(o):                     # (nw, heads, n, hd) -> (1, Hp, Wp, C)
        return window_unpartition(o.permute(0, 2, 1, 3).reshape(-1, n, dim),
                                  ws, grid, grid)

    # Outputs of rms ~0.18, up to ~3: atol ~8% of the rms.  The kernel's
    # error (bf16 probabilities into PV, bf16 fh/fw) reaches ~0.6 of this
    # bound, a dropped tile or swapped tables ~50x it.
    cmp = compare("window_attention", got, want, 1.5e-2, faults=(
        ("last key tile (keys 192-195) dropped",
         as_grid(_attention_plain(q, k, v, scale, bias, slice(192, n)))),
        ("rel-pos tables swapped",
         window_attention_plain(qkv, rw, rh, heads, scale, ws)),
    ))
    t_k = time_ms(lambda: window_attention(qkv, rh, rw, heads, scale, ws), 20)
    t_p = time_ms(lambda: window_attention_plain(qkv, rh, rw, heads, scale,
                                                 ws), 5)
    # Library yardstick: SDPA over the same windows with the rel-pos bias
    # materialized beforehand.
    bias16 = bias.to(torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    t_l = time_ms(lambda: sdpa(q, k, v, attn_mask=bias16, scale=scale), 20)
    nw = (grid // ws) ** 2
    flops = nw * heads * (4 * n * n * hd + 2 * 2 * n * ws * hd)
    nbytes = qkv.numel() * 2 + grid * grid * dim * 2 + 2 * rh.numel() * 4
    b_ms, by = bound(nbytes, flops, BF16_FLOP_PER_S)
    row = dict(shape=f"{nw}x{heads}x{n}x{hd}", **cmp, ms=t_k, plain_ms=t_p,
               library_ms=t_l, bound_ms=b_ms, bound_by=by)
    print(json.dumps({"phase": "K2 window_attention", **row}), flush=True)
    return row


def phase_global(gen):
    from crowdsam_tpu_torch.models.attention import (
        flash_mha_decomposed_relpos,
        relpos_attention_plain,
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
    bias = _relpos_bias(q, rh, rw, (g, g))
    # Outputs of rms ~0.05, up to ~1 where the bias makes a row peaky: the
    # ulp term covers the large ones, atol (~12% of the rms) the rest.  The
    # kernel's error reaches ~0.6 of this bound, the faults ~50x it.
    cmp = compare("flash_mha_decomposed_relpos", got, want, 6e-3, faults=(
        ("last key tile (keys 4032-4095) dropped",
         _attention_plain(q, k, v, scale, bias, slice(s - 64, s))),
        ("rel-pos tables swapped",
         relpos_attention_plain(q, k, v, scale, rw, rh, (g, g))),
    ))
    del bias
    t_k = time_ms(lambda: flash_mha_decomposed_relpos(q, k, v, scale, rh, rw,
                                                      (g, g)), 10)
    t_p = time_ms(lambda: relpos_attention_plain(q, k, v, scale, rh, rw,
                                                 (g, g)), 3)
    bias16 = _relpos_bias(q, rh, rw, (g, g)).to(torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    t_l = time_ms(lambda: sdpa(q, k, v, attn_mask=bias16, scale=scale), 10)
    flops = heads * (4 * s * s * hd + 2 * 2 * s * g * hd)
    nbytes = qkv.numel() * 2 + s * dim * 2 + 2 * rh.numel() * 4
    b_ms, by = bound(nbytes, flops, BF16_FLOP_PER_S)
    row = dict(shape=f"{heads}x{s}x{hd}", **cmp, ms=t_k, plain_ms=t_p,
               library_ms=t_l, bound_ms=b_ms, bound_by=by)
    print(json.dumps({"phase": "K3 flash_mha_decomposed_relpos", **row}),
          flush=True)
    return row


def phase_dino(gen):
    from crowdsam_tpu_torch.models.attention import flash_mha, flash_mha_plain

    s, heads, hd = 1 + 73 * 73, 16, 64
    dim = heads * hd
    qkv = torch.randn((1, s, 3 * dim), generator=gen, device="cuda").to(
        torch.bfloat16)
    q, k, v = qkv.reshape(1, s, 3, heads, hd).permute(2, 0, 3, 1, 4)
    scale = hd ** -0.5
    want = flash_mha_plain(q, k, v, scale, s)
    got = flash_mha(q, k, v, scale, valid_len=s)
    tail = 64 * ((s - 1) // 64)
    # Softmax over ~5330/e effective keys: outputs of rms ~0.023, atol ~9%
    # of it.  The kernel's error reaches ~0.3 of this bound, a dropped key
    # tile ~20x it.
    cmp = compare("flash_mha", got, want, 2e-3, faults=(
        (f"last key tile (keys {tail}-{s - 1}) dropped",
         _attention_plain(q, k, v, scale, drop=slice(tail, s))),
        ("first key tile (keys 0-63) dropped",
         _attention_plain(q, k, v, scale, drop=slice(0, 64))),
    ))
    t_k = time_ms(lambda: flash_mha(q, k, v, scale, valid_len=s), 10)
    t_p = time_ms(lambda: flash_mha_plain(q, k, v, scale, s), 3)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    t_l = time_ms(lambda: sdpa(q, k, v, scale=scale), 10)
    b_ms, by = bound(qkv.numel() * 2 + s * dim * 2, heads * 4 * s * s * hd,
                     BF16_FLOP_PER_S)
    row = dict(shape=f"{heads}x{s}x{hd}", **cmp, ms=t_k, plain_ms=t_p,
               library_ms=t_l, bound_ms=b_ms, bound_by=by)
    print(json.dumps({"phase": "K4 flash_mha", **row}), flush=True)
    return row


# --------------------------------------------------------------------------
# end to end
# --------------------------------------------------------------------------

def _counters():
    from crowdsam_tpu_torch.models import attention
    from crowdsam_tpu_torch.ops import layernorm

    return {
        "layer_norm": layernorm.layer_norm,
        "window_attention": attention.window_attention,
        "flash_mha_decomposed_relpos": attention.flash_mha_decomposed_relpos,
        "flash_mha": attention.flash_mha,
    }


def _timed_generate(model, img):
    """Detections of one frame, checked, and the host-clock ms of the call."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    data = model.generate(img)
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
    return data, ms


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
    busy, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return wall, busy / 1e3, {k[:80]: {"ms": v[0], "calls": v[1]}
                              for k, v in top}


def phase_end_to_end():
    from crowdsam_tpu_torch.pipeline.crowdsam import CrowdSAM
    from crowdsam_tpu_torch.utils.synthetic import (
        FRAME_SIZES,
        crowd_scene,
        full_width_config,
        synthetic_images,
    )

    t0 = time.time()
    model = CrowdSAM(full_width_config(), device="cuda")
    torch.cuda.synchronize()
    log(f"model built in {time.time() - t0:.1f} s")
    images = synthetic_images(0, N_IMAGES + 1)
    model.generate(images[-1])          # warm-up (cuBLAS / allocator)
    torch.cuda.synchronize()
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
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
                  "fused_decode false, output_rles false",
        "image_hw": [list(i.shape[:2]) for i in images[:N_IMAGES]],
        "ms_per_image": times,
        "ms_per_image_mean": float(np.mean(times)),
        "encode_ms_per_image": encode,
        "detections_per_image": [len(d["boxes"]) for d, _ in runs],
        "peak_memory_gib": peak,
        "launches": launches,
    }), flush=True)
    print(json.dumps({
        "phase": "device_profile", "image_hw": list(images[0].shape[:2]),
        "wall_ms": wall, "device_busy_ms": busy,
        "device_idle_share": 1.0 - busy / wall, "kernels_ms": top,
    }), flush=True)
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")

    # Random weights leave no detection at the reference thresholds; with
    # the pred-IoU and stability filters off the same model keeps some, and
    # the survivor pass runs at full width on them.
    model.engine_cfg = dataclasses.replace(
        model.engine_cfg, pred_iou_thresh=0.0, stability_score_thresh=0.0)
    scenes = [crowd_scene(20 + i, *hw)[0]
              for i, hw in enumerate(FRAME_SIZES[:N_IMAGES])]
    loaded, survivors = [], []
    for img in scenes:
        loaded.append(_timed_generate(model, img))
        # Rows of the post-NMS slab that enter the survivor pass.
        survivors.append(int((model.last_engine["summary"][:, 0] > 0.5)
                             .sum()))
    dets = [len(d["boxes"]) for d, _ in loaded]
    print(json.dumps({
        "phase": "end_to_end_loaded",
        "config": "as end_to_end, pred_iou_thresh 0, "
                  "stability_score_thresh 0; crowd scenes",
        "image_hw": [list(i.shape[:2]) for i in scenes],
        "ms_per_image": [ms for _, ms in loaded],
        "ms_per_image_mean": float(np.mean([ms for _, ms in loaded])),
        "detections_per_image": dets,
        "survivors_per_image": survivors,
    }), flush=True)
    if min(dets) == 0:
        raise AssertionError(f"loaded pass: a frame without detections "
                             f"{dets}")
    return launches


def phase_small_reference():
    """A small configuration with head dim 64 (SAM ViT-B at 256^2, DINOv2
    ViT-S/14): the card's bf16 kernel path against the plain float32 path
    on the CPU, same weights."""
    from crowdsam_tpu_torch.config import modify_config
    from crowdsam_tpu_torch.pipeline.crowdsam import CrowdSAM
    from crowdsam_tpu_torch.utils.synthetic import (
        full_width_config,
        synthetic_images,
    )

    # The IoU and stability filters off, so that random weights leave
    # detections for the survivor pass.
    cfg = modify_config(full_width_config(), [
        "model.sam_model", "vit_b", "model.image_size", "256",
        "model.dino_model", "dinov2_vits14", "test.max_size", "256",
        "test.grid_size", "48", "test.max_prompts", "64",
        "test.pred_iou_thresh", "0.0", "test.stability_score_thresh", "0.0",
    ])
    gpu = CrowdSAM(cfg, device="cuda")
    cpu_cfg = modify_config(cfg, ["tpu.compute_dtype", "float32"])
    cpu = CrowdSAM(cpu_cfg, device="cpu")
    cpu.sam.load_state_dict({k: v.float().cpu() for k, v in
                             gpu.sam.state_dict().items()})
    cpu.dino.load_state_dict({k: v.float().cpu() for k, v in
                              gpu.dino.state_dict().items()})
    img = synthetic_images(1, 1)[0][:171, :256]
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


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; nothing to run")
        return 2
    from crowdsam_tpu_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    _build.build_all(ptxas_verbose=True)
    log(f"kernels built in {time.time() - t0:.1f} s")
    for name, text in _build.BUILD_LOGS.items():
        log(f"--- ptxas {name}.cu\n{text}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    ln_rows = phase_layernorm(gen)
    k2 = phase_window(gen)
    k3 = phase_global(gen)
    k4 = phase_dino(gen)
    torch.cuda.empty_cache()
    launches = phase_end_to_end()
    phase_small_reference()

    ln = next(r for r in ln_rows if r["shape"] == "5330x1024")
    src_attn = "crowdsam_tpu_torch/csrc/attention.cu"
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    table = [
        dict(name="layer_norm", route="cuda",
             source="crowdsam_tpu_torch/csrc/layernorm.cu",
             replaces="crowdsam_tpu/ops/layernorm.py:34",
             launches=launches["layer_norm"],
             max_abs_err=max(r["max_abs_err"] for r in ln_rows),
             **{k: ln[k] for k in keys}),
    ]
    for name, rep, row in (
            ("window_attention", "crowdsam_tpu/models/attention.py:163", k2),
            ("flash_mha_decomposed_relpos",
             "crowdsam_tpu/models/attention.py:126", k3),
            ("flash_mha", "crowdsam_tpu/models/attention.py:86", k4)):
        table.append(dict(name=name, route="cuda", source=src_attn,
                          replaces=rep, launches=launches[name],
                          max_abs_err=row["max_abs_err"],
                          **{k: row[k] for k in keys}))
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
