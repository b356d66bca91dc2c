"""A/B of the float32 attention arm (K2/K3/K4 f32,
`crowdsam_tpu_torch/csrc/attention_f32.cu`) against a parent build of the
same source, on one card.

    python3 chip_ab_attention_f32.py PARENT_DIR

PARENT_DIR holds the parent commit's `crowdsam_tpu_torch/csrc/` (for
example `git archive <rev> crowdsam_tpu_torch/csrc | tar -x -C PARENT_DIR`
into a directory that `.gitignore` lists).  Builds its `attention_f32.cu`
with nvcc beside this checkout's (the C entry point `attention_f32_forward`
takes the same arguments in both, so the wrappers call either library),
then times, in turns (parent, change, change, parent):

1. the kernel alone, device time from torch.profiler, at every float32
   shape of chip_smoke.py (`F32_K2`, `F32_K3`, `F32_K4`: the float32
   path's shapes, its rect grids and query bands), with the largest
   difference between the two arms' outputs;
2. what it runs in: the device span of the float32 path's encode
   (`configs/crowdhuman.yaml` + `tpu.compute_dtype float32`, full width,
   the shipped adapter) of the three synthetic frames, and the host ms of
   `generate` on each (twice in turns).

Prints one JSON line a comparison, the wall time, then the card's name and
power limit.  Needs one card; the weights are drawn from their seeds
(`chip_smoke.start_draws`).
"""

from __future__ import annotations

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
ENTRY = ("attention_f32", "attention_f32_forward")


class Arms:
    """Switches the float32 arm's entry point in `_build`'s table between
    the parent library and this checkout's."""

    def __init__(self, parent_lib: str):
        from crowdsam_tpu_torch.kernels import _build
        from crowdsam_tpu_torch.models import attention as att

        self._build = _build
        fn = ctypes.CDLL(parent_lib).attention_f32_forward
        fn.argtypes, fn.restype = list(att._F32_ARGTYPES), ctypes.c_int
        self.fns = {"parent": fn,
                    "change": _build.function(*ENTRY, att._F32_ARGTYPES)}

    def use(self, arm: str) -> None:
        self._build._FUNCS[ENTRY] = self.fns[arm]


def build_parent(parent_dir: str) -> str:
    from crowdsam_tpu_torch.kernels import _build

    csrc = Path(parent_dir) / "crowdsam_tpu_torch" / "csrc"
    out = _build.BUILD_DIR.parent / "ab" / "libattention_f32_parent.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc),
                    "-o", str(out), str(csrc / "attention_f32.cu")],
                   check=True)
    return str(out)


def kernel_turns(arms, gen, arm_name, case):
    """The arm at one shape through either library, in turns."""
    a, call, shape, _ = cs._f32_arm_inputs(gen, arm_name, case)
    arms.use("parent")
    x = call()
    arms.use("change")
    y = call()
    diff = float((x - y).abs().max())
    del x, y
    iters = 10 if arm_name != "K2" else 20
    out = {"parent": [], "change": []}
    for arm in TURNS:
        arms.use(arm)
        out[arm].append(cs.device_ms(call, iters, "attn_f32"))
    arms.use("change")
    print(json.dumps({"ab": f"{arm_name} float32 {shape}",
                      "parent_vs_change_max_abs_diff": diff, **out,
                      "parent_min": min(out["parent"]),
                      "change_min": min(out["change"]),
                      "change_slower_in_a_turn":
                          max(out["change"]) >= min(out["parent"])}),
          flush=True)


def path_turns(arms, model, frames, noises):
    """The float32 path's encode device span and `generate` host ms of each
    frame, in turns twice."""
    for arm in ("parent", "change"):
        arms.use(arm)
        for img, nz in zip(frames, noises):
            cs._timed_generate(model, img, nz)
    dev = {"parent": [[] for _ in frames], "change": [[] for _ in frames]}
    host = {"parent": [[] for _ in frames], "change": [[] for _ in frames]}
    for arm in TURNS * 2:
        arms.use(arm)
        for i, (img, nz) in enumerate(zip(frames, noises)):
            dev[arm][i].append(cs._encode_device_ms(model, img))
            host[arm][i].append(cs._timed_generate(model, img, nz)[1])
    arms.use("change")
    return {"ab": "float32 path", "frames": [list(f.shape[:2])
                                             for f in frames],
            "encode_device_ms": dev, "generate_host_ms": host,
            **{f"{arm}_encode_median": [float(np.median(d))
                                        for d in dev[arm]]
               for arm in ("parent", "change")},
            **{f"{arm}_generate_median": [float(np.median(d))
                                          for d in host[arm]]
               for arm in ("parent", "change")}}


def main() -> int:
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print("usage: python3 chip_ab_attention_f32.py PARENT_DIR (needs a "
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
    parent_lib = build_parent(sys.argv[1])
    _build.build_all()
    arms = Arms(parent_lib)
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        for arm_name, cases in (("K4", cs.F32_K4), ("K3", cs.F32_K3),
                                ("K2", cs.F32_K2)):
            for case in cases:
                kernel_turns(arms, gen, arm_name, case)
                torch.cuda.empty_cache()
    frames = synthetic_images(0, cs.N_IMAGES)
    draws["main"].get()
    with cs._no_default_init():
        model = CrowdSAM(modify_config(full_width_config(), cs.F32_PATH),
                         device="cuda")
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
