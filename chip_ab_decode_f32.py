"""A/B of the float32 decode arms (K5 f32,
`crowdsam_tpu_torch/csrc/decode_tail_f32.cu`, and K6 f32,
`crowdsam_tpu_torch/csrc/mask_head_f32.cu`) against a parent build, on one
card.

    python3 chip_ab_decode_f32.py PARENT_DIR

PARENT_DIR holds the parent commit's `crowdsam_tpu_torch/csrc/` and
`crowdsam_tpu_torch/models/` (for example `git archive <rev>
crowdsam_tpu_torch/csrc crowdsam_tpu_torch/models | tar -x -C PARENT_DIR`
into a directory that `.gitignore` lists).  The arms' C entry points may
take other arguments in the parent, so the parent arm runs through the
parent's own wrappers: its `decode_tail_kernel.py` and
`mask_head_kernel.py` are loaded from PARENT_DIR with their `_build`
pointed at the parent's libraries, which nvcc builds beside this
checkout's.  Then times, in turns (parent, change, change, parent):

1. the kernels alone, device time from torch.profiler, at every float32
   shape of chip_smoke.py's phases `K5 float32` (`_f32_k5_cases`: the span
   of a call's launches) and `K6 float32` (the kernel), with the largest
   difference between the two arms' outputs;
2. what they run in: the float32 fused path (`configs/crowdhuman.yaml` +
   `tpu.compute_dtype float32`, full width, the shipped adapter) on the
   three synthetic frames, the decode's device span of each frame (the
   union of the K5 and K6 kernels of one `generate`) and the host ms of
   `generate` (twice in turns).

Prints one JSON line a comparison, the wall time, then the card's name and
power limit.  Needs one card; the weights are drawn from their seeds
(`chip_smoke.start_draws`).
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs

TURNS = ("parent", "change", "change", "parent")
LIBS = ("decode_tail_f32", "mask_head_f32")
MODULES = ("decode_tail_kernel", "mask_head_kernel")


class ParentBuild:
    """`_build` for the parent's wrappers: its functions come from the
    parent's libraries; everything else is this checkout's `_build`."""

    def __init__(self, libs):
        from crowdsam_tpu_torch.kernels import _build

        self._build, self._libs, self._funcs = _build, libs, {}

    def function(self, lib_name, fn_name, argtypes, restype=ctypes.c_int):
        fn = self._funcs.get((lib_name, fn_name))
        if fn is None:
            fn = getattr(self._libs[lib_name], fn_name)
            fn.argtypes, fn.restype = list(argtypes), restype
            self._funcs[(lib_name, fn_name)] = fn
        return fn

    def __getattr__(self, name):
        return getattr(self._build, name)


def load_parent(parent_dir: str) -> dict:
    """The parent's wrapper modules, on libraries built from its sources
    (one nvcc a source, in parallel)."""
    from crowdsam_tpu_torch.kernels import _build

    root = Path(parent_dir) / "crowdsam_tpu_torch"
    out_dir = _build.BUILD_DIR.parent / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for lib in LIBS:
        out = out_dir / f"lib{lib}_parent.so"
        procs[lib] = (out, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(root / "csrc"),
             "-o", str(out), str(root / "csrc" / f"{lib}.cu")]))
    libs = {}
    for lib, (out, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"the parent's {lib}.cu did not build")
        libs[lib] = ctypes.CDLL(str(out))
    shim = ParentBuild(libs)
    mods = {}
    for name in MODULES:
        spec = importlib.util.spec_from_file_location(
            f"parent_{name}", root / "models" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mod._build = shim
        mods[name] = mod
    return mods


class Arms:
    """Switches the wrappers that `fused_decode` calls between the
    parent's and this checkout's."""

    def __init__(self, parent: dict):
        from crowdsam_tpu_torch.models import decode_tail_kernel as dtk
        from crowdsam_tpu_torch.models import fused_decode as fd
        from crowdsam_tpu_torch.models import mask_head_kernel as mhk

        self.fd = fd
        self.tail = {"parent": parent["decode_tail_kernel"].twoway_tail,
                     "change": dtk.twoway_tail}
        self.head = {"parent": parent["mask_head_kernel"].mask_head,
                     "change": mhk.mask_head}

    def use(self, arm: str) -> None:
        self.fd.twoway_tail = self.tail[arm]
        self.fd.mask_head = self.head[arm]


def _turns(label, calls, measure):
    """`measure(call)` of each arm's call in turns, and the largest
    difference between the arms' outputs."""
    x, y = calls["parent"](), calls["change"]()
    x, y = (x,) if torch.is_tensor(x) else x, (y,) if torch.is_tensor(y) else y
    diff = max(float((a - b).abs().max()) for a, b in zip(x, y))
    del x, y
    out = {"parent": [], "change": []}
    for arm in TURNS:
        out[arm].append(measure(calls[arm]))
    print(json.dumps({"ab": label, "parent_vs_change_max_abs_diff": diff,
                      **out, "parent_min": min(out["parent"]),
                      "change_max": max(out["change"]),
                      "change_below_every_parent":
                          max(out["change"]) < min(out["parent"])}),
          flush=True)


def kernel_turns(arms, model, small):
    """K5 f32 at `_f32_k5_cases`' shapes, then K6 f32 at
    `phase_k6_f32`'s, on the change's keys2 and tokens."""
    from crowdsam_tpu_torch.models import fused_decode as fd

    outs = {}
    for label, mdl, shared, tokens, img, dino in cs._f32_k5_cases(model,
                                                                   small):
        args = cs._tail_args(shared, tokens)
        calls = {arm: (lambda f=arms.tail[arm]: f(*args, img=img))
                 for arm in ("parent", "change")}
        _turns(f"K5 float32 {label}", calls,
               lambda c: cs.device_span_ms(c, 10))
        outs[label] = (mdl, shared, calls["change"]())
        torch.cuda.empty_cache()
    for label, k5_label, p, emit in (
            ("main path, 32x4096, emit_exp", "main path, 32x7, M=4096", 32,
             True),
            ("main path, 32x4096", "main path, 32x7, M=4096", 32, False),
            ("small, 32x256, emit_exp", "small, 32x7, M=256", 32, True),
            ("prompt shard M=2, 16x4096, emit_exp",
             "main path, 32x7, M=4096", 16, True)):
        mdl, shared, (keys2, tok) = outs[k5_label]
        dec = mdl.sam.mask_decoder
        keys2, tok = keys2[:p].contiguous(), tok[:p].contiguous()
        hyper = fd._hyper_in(dec, tok[:, 1:1 + dec.num_mask_tokens, :])
        if mdl.config["model"].get("sam_adapter_checkpoint", "") == "":
            hyper = hyper * 1024.0
        hyper = hyper.contiguous()
        weights = shared["mask_head"]
        calls = {arm: (lambda f=arms.head[arm]: f(keys2, hyper, weights,
                                                  emit_exp=emit))
                 for arm in ("parent", "change")}
        _turns(f"K6 float32 {label}", calls,
               lambda c: cs.device_ms(c, 20, "mask_head_f32"))


def _decode_span_ms(model, img, noise) -> float:
    """The union of the K5 and K6 kernels' device intervals over one
    `generate` (after a warm-up), from torch.profiler."""
    kinds = ("tok_stage", "tok_qkv", "tok_mlp", "t2i_merge", "row_phase",
             "mask_head_f32")
    spans = [(ev.time_range.start, ev.time_range.start + ev.device_time_total)
             for ev in cs._cuda_events(
                 lambda: model.generate(img, noise=[noise]), 1)
             if cs._kernel_name(ev.name).startswith(kinds)]
    return cs._union_us(spans) / 1e3


def path_turns(arms, model, frames, noises):
    """The float32 fused path's decode device span and `generate` host ms
    of each frame, in turns twice."""
    for arm in ("parent", "change"):
        arms.use(arm)
        for img, nz in zip(frames, noises):
            cs._timed_generate(model, img, nz)
    dev = {"parent": [[] for _ in frames], "change": [[] for _ in frames]}
    host = {"parent": [[] for _ in frames], "change": [[] for _ in frames]}
    for arm in TURNS * 2:
        arms.use(arm)
        for i, (img, nz) in enumerate(zip(frames, noises)):
            dev[arm][i].append(_decode_span_ms(model, img, nz))
            host[arm][i].append(cs._timed_generate(model, img, nz)[1])
    arms.use("change")
    return {"ab": "float32 fused path", "frames": [list(f.shape[:2])
                                                   for f in frames],
            "decode_device_span_ms": dev, "generate_host_ms": host,
            **{f"{arm}_decode_median": [float(np.median(d))
                                        for d in dev[arm]]
               for arm in ("parent", "change")},
            **{f"{arm}_generate_median": [float(np.median(d))
                                          for d in host[arm]]
               for arm in ("parent", "change")}}


def main() -> int:
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print("usage: python3 chip_ab_decode_f32.py PARENT_DIR (needs a "
              "CUDA device)", file=sys.stderr)
        return 2
    from crowdsam_tpu_torch.config import modify_config
    from crowdsam_tpu_torch.kernels import _build
    from crowdsam_tpu_torch.pipeline.crowdsam import CrowdSAM
    from crowdsam_tpu_torch.utils.synthetic import (
        full_width_config,
        synthetic_images,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    draws = cs.start_draws()
    parent = load_parent(sys.argv[1])
    _build.build_all()
    arms = Arms(parent)
    draws["main"].get()
    with cs._no_default_init():
        model = CrowdSAM(modify_config(full_width_config(), cs.F32_FUSED),
                         device="cuda")
        small = CrowdSAM(modify_config(
            cs._small_config(), ["tpu.compute_dtype", "float32"]),
            device="cuda")
    with torch.no_grad():
        kernel_turns(arms, model, small)
    del small
    torch.cuda.empty_cache()
    frames = synthetic_images(0, cs.N_IMAGES)
    noises = [torch.rand(model.engine_cfg.grid_size ** 2,
                         generator=torch.Generator().manual_seed(40 + i))
              for i in range(len(frames))]
    with torch.no_grad():
        print(json.dumps(path_turns(arms, model, frames, noises)),
              flush=True)
    print(json.dumps({"wall_s": time.time() - t0}), flush=True)
    print(cs._smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
