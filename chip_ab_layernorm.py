"""A/B of K1, the LayerNorm kernels (`crowdsam_tpu_torch/csrc/layernorm.cu`,
forward and backward), against a parent build of the same source, on one
card.

    python3 chip_ab_layernorm.py PARENT_DIR

PARENT_DIR holds the parent commit's `crowdsam_tpu_torch/csrc/` (for
example `git archive <rev> crowdsam_tpu_torch/csrc | tar -x -C PARENT_DIR`
into a directory that `.gitignore` lists).  Builds its `layernorm.cu` with
nvcc beside this checkout's, then times, in turns (parent, change, change,
parent):

1. the kernels alone, device time from torch.profiler: the forward at the
   main path's shapes (SAM's and DINOv2's blocks, SAM ViT-H's, the neck,
   the decoder's norm4 on keys, the unfused decoder's upscaling LayerNorm
   at 32 and 64 prompts, the serving head's widths 4 and 16) beside
   `F.layer_norm`, and the backward at the training step's (bf16) and at
   DINOv2's width in float32 beside `aten::native_layer_norm_backward`,
   with the largest difference between the two arms' outputs;
2. what they run in: the device span of the encode of the three synthetic
   frames (twice in turns), the host ms of a full-decoder training step
   (`loss_and_grads`, medians of 5, twice in turns) with K1's device ms in
   one step (the sum of its kernels) and the two arms' gradients, and the
   host ms of the loaded automatic mask generator at 16 points a side on a
   crowd scene (twice in turns).

The parent's forward entry points take the arguments this checkout's do:
the wrappers call either library.  Its backward took its partials in two
buffers and a second launch: the parent arm calls it as its own wrapper
did (the raw stream handle in both arms).  Prints one JSON line a
comparison, the wall time, then the card's name and power limit.  Needs
one card; the weights are drawn from their seeds (`chip_smoke.start_draws`).
"""

from __future__ import annotations

import copy
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs

TURNS = ("parent", "change", "change", "parent")
# (rows, width): the forward's shapes, bf16.
FORWARD = ((5330, 1024), (4096, 1024), (4096, 1280), (4096, 256),
           (131072, 256), (524288, 64), (1048576, 64), (16384, 4),
           (4096, 16))
# (rows, width, dtype): the backward's.
BACKWARD = ((983040, 64, torch.bfloat16), (245760, 256, torch.bfloat16),
            (420, 256, torch.bfloat16), (5330, 1024, torch.float32))


class Arms:
    """Switches K1's wrappers between the parent library and this
    checkout's: the forward entry points in `_build`'s table, the backward
    wrapper in `ops.layernorm`."""

    def __init__(self, parent_lib: str):
        from crowdsam_tpu_torch.kernels import _build
        from crowdsam_tpu_torch.ops import layernorm as ln

        self._build, self._ln = _build, ln
        lib = ctypes.CDLL(parent_lib)
        self.fns = {}
        for name, argtypes in (("ln_forward", ln._ARGTYPES),
                               ("ln_forward_stats", ln._STATS_ARGTYPES)):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
            self.fns[name] = {"parent": fn, "change": _build.function(
                "layernorm", name, argtypes)}
        bwd = lib.ln_backward
        bwd.argtypes = [ctypes.c_void_p] * 10 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        bwd.restype = ctypes.c_int
        blocks = lib.ln_backward_blocks
        blocks.argtypes, blocks.restype = [ctypes.c_longlong], ctypes.c_int

        def parent_backward(dy, x, weight, mean, rstd):
            w = weight.float().contiguous()
            d = x.shape[-1]
            rows = x.numel() // d
            parts = torch.empty((2, max(blocks(rows), 1), d),
                                dtype=torch.float32, device=x.device)
            dx = torch.empty_like(x)
            dwb = torch.empty((2, d), dtype=torch.float32, device=x.device)
            _build.check(bwd(
                x.data_ptr(), dy.data_ptr(), w.data_ptr(), mean.data_ptr(),
                rstd.data_ptr(), dx.data_ptr(), parts[0].data_ptr(),
                parts[1].data_ptr(), dwb[0].data_ptr(), dwb[1].data_ptr(),
                rows, d, ln._DTYPES[x.dtype], ln._raw_stream(x.device)),
                "parent ln_backward")
            return dx, dwb[0], dwb[1]

        self.backward = {"parent": parent_backward,
                         "change": ln.layer_norm_backward}

    def use(self, arm: str) -> None:
        for name, fns in self.fns.items():
            self._build._FUNCS[("layernorm", name)] = fns[arm]
        self._ln.layer_norm_backward = self.backward[arm]


def build_parent(parent_dir: str) -> str:
    from crowdsam_tpu_torch.kernels import _build

    csrc = Path(parent_dir) / "crowdsam_tpu_torch" / "csrc"
    out = _build.BUILD_DIR.parent / "ab" / "liblayernorm_parent.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc),
                    "-o", str(out), str(csrc / "layernorm.cu")], check=True)
    return str(out)


def _max_diff(a, b) -> float:
    if isinstance(a, torch.Tensor):
        a, b = (a,), (b,)
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(a, b))


def kernel_turns(arms, label, fn, lib):
    """K1's kernels that `fn` launches (names containing `ln_`) through
    either arm, and `lib` (the PyTorch call), in turns."""
    arms.use("parent")
    a = fn()
    arms.use("change")
    b = fn()
    diff = _max_diff(a, b)
    out = {"parent": [], "change": [], "library": []}
    for arm in TURNS:
        arms.use(arm)
        out[arm].append(cs.device_ms(fn, 20, "ln_"))
        out["library"].append(cs.device_ms(lib, 20))
    arms.use("change")
    print(json.dumps({"ab": label, "parent_vs_change_max_abs_diff": diff,
                      **out, "parent_min": min(out["parent"]),
                      "change_min": min(out["change"]),
                      "library_min": min(out["library"])}), flush=True)


def forward_case(gen, n, d):
    from crowdsam_tpu_torch.ops import layernorm as ln

    x = torch.randn((n, d), generator=gen, device="cuda").to(torch.bfloat16)
    w = 1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
    b = 0.1 * torch.randn(d, generator=gen, device="cuda")
    wb, bb = w.to(torch.bfloat16), b.to(torch.bfloat16)
    return (lambda: ln.layer_norm(x, w, b, 1e-6),
            lambda: torch.nn.functional.layer_norm(x, (d,), wb, bb, 1e-6))


def backward_case(gen, n, d, dtype):
    from crowdsam_tpu_torch.ops import layernorm as ln

    x = torch.randn((n, d), generator=gen, device="cuda").to(dtype)
    w = 1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
    b = 0.1 * torch.randn(d, generator=gen, device="cuda")
    g = torch.randn((n, d), generator=gen, device="cuda").to(dtype)
    _, mean, rstd = ln._forward(x, w, b, 1e-6, stats=True)
    wl, bl = w.to(dtype), b.to(dtype)
    _, mean2, rstd2 = torch.native_layer_norm(x, [d], wl, bl, 1e-6)
    return (lambda: ln.layer_norm_backward(g, x, w, mean, rstd),
            lambda: torch.ops.aten.native_layer_norm_backward(
                g, x, [d], mean2, rstd2, wl, bl, [True, True, True]))


def encode_turns(arms, model, frames):
    """The device span of one encode of each frame (`_encode_device_ms`)
    in turns, twice."""
    for img in frames:
        model.generate(img)
    dev = {"parent": [[] for _ in frames], "change": [[] for _ in frames]}
    for arm in TURNS * 2:
        arms.use(arm)
        for i, img in enumerate(frames):
            dev[arm][i].append(cs._encode_device_ms(model, img))
    arms.use("change")
    return {"ab": "main encode", "frames": [list(f.shape[:2])
                                            for f in frames],
            "encode_device_ms": dev,
            **{f"{arm}_median": [float(np.median(d)) for d in dev[arm]]
               for arm in ("parent", "change")}}


def train_turns(arms, model):
    """Host ms of one full-decoder training step (`loss_and_grads` at the
    smoke's recipe, synchronized, median of 5 a turn) and K1's device ms
    in one step, in turns twice; the two arms' gradients of one step, their
    largest difference over the gradient norm (as the smoke's `train`
    holds K1 against the plain LayerNorm)."""
    from crowdsam_tpu_torch.config import modify_config
    from crowdsam_tpu_torch.train.dataset import ArrayDataset
    from crowdsam_tpu_torch.train.trainer import AdapterTrainer
    from crowdsam_tpu_torch.utils.fixtures import ten_shot_arrays

    data = ArrayDataset(*ten_shot_arrays(0))
    cfg = modify_config(copy.deepcopy(model.config), [
        "train.steps", "20", "train.full_decoder", "True", "train.lr",
        "2e-4"])
    trainer = AdapterTrainer(cfg, model.predictor)
    trainer.cache_features(data)
    params = trainer.trainable_params()
    draws = trainer.draw(0)

    def step():
        return trainer.loss_and_grads(params, 0, draws)[2]

    out = {"parent": [], "change": []}
    k1 = {"parent": [], "change": []}
    for arm in ("parent", "change"):
        arms.use(arm)
        step()
    for arm in TURNS * 2:
        arms.use(arm)
        ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            step()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        out[arm].append(float(np.median(ms)))
        # The sum of K1's kernels over a step (one kernel name serves
        # several shapes: a median a name would not do).
        k1[arm].append(sum(ev.device_time_total for ev in
                           cs._cuda_events(step, 2, "ln_")) / 2 / 1e3)
    arms.use("parent")
    g_parent = step()
    arms.use("change")
    g_change = step()
    norm = float(torch.sqrt(sum(g.double().square().sum()
                                for g in g_parent.values())))
    diff = max(float((g_parent[k].double() - g_change[k].double()).abs()
                     .max()) for k in g_parent) / norm
    return {"ab": "train full-decoder step", "host_ms_median": out,
            "k1_device_ms": k1,
            "gradients_max_abs_diff_over_norm_parent_vs_change": diff}


def amg_turns(arms, sam):
    """Host ms of the loaded automatic mask generator (16 points a side,
    filters off, cleanup 100 px) on crowd_scene(0), in turns twice, also
    without its small-region cleanup (host work on each record's mask,
    timed synchronized as the smoke's `amg` times it), and each arm's
    records (their count moves with the bf16 last bits)."""
    from crowdsam_tpu_torch.pipeline.amg_generator import (
        SamAutomaticMaskGenerator,
    )
    from crowdsam_tpu_torch.utils.bench_fixture import crowd_scene

    img = crowd_scene(0)[0]
    gen = SamAutomaticMaskGenerator(
        sam, points_per_batch=64, output_mode="coco_rle", device="cuda",
        points_per_side=16, pred_iou_thresh=0.0, stability_score_thresh=0.0,
        min_mask_region_area=100)
    cleanup = [0.0]
    real = gen.postprocess_small_regions

    def timed_cleanup(*a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real(*a)
        torch.cuda.synchronize()
        cleanup[0] += (time.perf_counter() - t) * 1e3
        return out

    gen.postprocess_small_regions = timed_cleanup
    gen.generate(img)
    out = {"parent": [], "change": []}
    rest = {"parent": [], "change": []}
    records = {}
    for arm in TURNS * 2:
        arms.use(arm)
        cleanup[0] = 0.0
        torch.cuda.synchronize()
        t = time.perf_counter()
        records[arm] = len(gen.generate(img))
        torch.cuda.synchronize()
        out[arm].append((time.perf_counter() - t) * 1e3)
        rest[arm].append(out[arm][-1] - cleanup[0])
    arms.use("change")
    return {"ab": "amg loaded, 16 points a side", "host_ms": out,
            "host_ms_without_cleanup": rest, "records": records}


def main() -> int:
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print("usage: python3 chip_ab_layernorm.py PARENT_DIR (needs a CUDA "
              "device)", file=sys.stderr)
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
    parent_lib = build_parent(sys.argv[1])
    _build.build_all()
    arms = Arms(parent_lib)
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        for n, d in FORWARD:
            kernel_turns(arms, f"K1 forward {n}x{d}", *forward_case(gen, n, d))
    for n, d, dtype in BACKWARD:
        kernel_turns(arms, f"K1 backward {n}x{d} "
                     f"{str(dtype).replace('torch.', '')}",
                     *backward_case(gen, n, d, dtype))
    torch.cuda.empty_cache()
    frames = synthetic_images(0, cs.N_IMAGES)
    draws["main"].get()
    with cs._no_default_init():
        model = CrowdSAM(full_width_config(), device="cuda")
    with torch.no_grad():
        print(json.dumps(encode_turns(arms, model, frames)), flush=True)
    print(json.dumps(train_turns(arms, model)), flush=True)
    del model
    torch.cuda.empty_cache()
    with cs._no_default_init():
        adapted = CrowdSAM(modify_config(full_width_config(), [
            "model.sam_adapter_checkpoint",
            "./adapter_weights/10_shot.msgpack"]), device="cuda")
    with torch.no_grad():
        print(json.dumps(amg_turns(arms, adapted.sam)), flush=True)
    print(json.dumps({"wall_s": time.time() - t0}), flush=True)
    print(cs._smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
