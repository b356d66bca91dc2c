"""A/B of the rel-pos attention kernels K2 and K3
(`crowdsam_tpu_torch/csrc/attention.cu`) against a parent build of the same
source, on one card.

    python3 chip_ab_relpos.py PARENT_DIR

PARENT_DIR holds the parent commit's `crowdsam_tpu_torch/csrc/` and, where
the kernels' entry point took other terms, its
`crowdsam_tpu_torch/models/attention.py` (for example `git archive <rev>
crowdsam_tpu_torch/csrc crowdsam_tpu_torch/models/attention.py | tar -x -C
PARENT_DIR` into a directory that `.gitignore` lists).  Builds that source
with nvcc beside this checkout's, then times, in turns (parent, change,
change, parent), the device time torch.profiler reads:

1. the kernels alone at the main path's shapes: K2 at head dims 80 and 64
   on the 70x70 grid, K3 on SAM's 64x64 grid at head dims 64 and 80, on
   the grids 64 tall of a portrait frame's rect encode (64x48, 64x44;
   64x48 at head dim 80) and on a band of 21 rows from row 21 at head dim
   80, with SDPA on a prebuilt bias in the same turns, and the largest
   difference between the two arms' outputs;
2. the encodes they run in: the main model's square and rect encodes of
   the three synthetic frames (device span of one encode, and the host ms
   of `generate` in the same turns), and SAM ViT-H's encode (with K2's and
   K3's device ms on its first frame).

The parent arm calls the parent library through the same wrappers, with
the parent's `_kernel_terms` (the terms K3's entry point takes besides q,
k and v) where PARENT_DIR holds its `models/attention.py`.  Prints one JSON
line a comparison, then the card's name and power limit.  Needs one card;
the weights are drawn from their seeds (`chip_smoke.start_draws`).
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


class Arms:
    """Switches K2's and K3's wrappers between the parent library (and the
    parent's K3 terms, `parent_terms`) and this checkout's."""

    def __init__(self, parent_lib: str, parent_terms=None):
        from crowdsam_tpu_torch.kernels import _build
        from crowdsam_tpu_torch.models import attention

        self._build, self._attn = _build, attention
        lib = ctypes.CDLL(parent_lib)
        self.fns = {}
        for name, argtypes in (("relpos_window_forward",
                                attention._WINDOW_ARGTYPES),
                               ("relpos_global_forward",
                                attention._GLOBAL_ARGTYPES)):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
            self.fns[name] = {"parent": fn, "change": _build.function(
                "attention", name, argtypes)}
        self.terms = {"parent": parent_terms or attention._kernel_terms,
                      "change": attention._kernel_terms}

    def use(self, arm: str) -> None:
        for name, fns in self.fns.items():
            self._build._FUNCS[("attention", name)] = fns[arm]
        self._attn._kernel_terms = self.terms[arm]


def parent_terms(parent_dir: str):
    """The parent's `_kernel_terms`, from PARENT_DIR's
    `crowdsam_tpu_torch/models/attention.py` (None where it has none)."""
    import importlib.util

    path = (Path(parent_dir) / "crowdsam_tpu_torch" / "models"
            / "attention.py")
    if not path.exists():
        return None
    spec = importlib.util.spec_from_file_location("parent_attention", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module     # its dataclasses look it up
    spec.loader.exec_module(module)
    return module._kernel_terms


def build_parent(parent_dir: str) -> str:
    from crowdsam_tpu_torch.kernels import _build

    src = Path(parent_dir) / "crowdsam_tpu_torch" / "csrc" / "attention.cu"
    out = _build.BUILD_DIR.parent / "ab" / "libattention_parent.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True)
    return str(out)


def kernel_turns(arms, label, fn, lib, match):
    """The kernels `fn` launches (their names containing `match`) through
    either arm, and `lib` (SDPA), in turns."""
    arms.use("parent")
    a = fn()
    arms.use("change")
    b = fn()
    diff = float((a.float() - b.float()).abs().max())
    out = {"parent": [], "change": [], "sdpa": []}
    for arm in TURNS:
        arms.use(arm)
        out[arm].append(cs.device_ms(fn, 20, match))
        out["sdpa"].append(cs.device_ms(lib, 20))
    arms.use("change")
    print(json.dumps({"ab": label, "parent_vs_change_max_abs_diff": diff,
                      **out, "parent_min": min(out["parent"]),
                      "change_min": min(out["change"]),
                      "sdpa_min": min(out["sdpa"])}), flush=True)


def window_case(gen, hd):
    from crowdsam_tpu_torch.models import attention as A
    from crowdsam_tpu_torch.models.image_encoder import _rel_pos_table

    ws, heads, grid = 14, 16, 70
    dim, n = heads * hd, ws * ws
    qkv = torch.randn((1, grid, grid, 3 * dim), generator=gen,
                      device="cuda").to(torch.bfloat16)
    rh, rw = (_rel_pos_table(0.1 * torch.randn((2 * ws - 1, hd), generator=gen,
                                               device="cuda"), ws)
              for _ in range(2))
    scale = hd ** -0.5
    q, k, v = A.window_partition(qkv, ws).reshape(-1, n, 3, heads,
                                                  hd).permute(2, 0, 3, 1, 4)
    bias = cs._relpos_bias(q.float(), rh, rw, (ws, ws)).to(torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return (lambda: A.window_attention(qkv, rh, rw, heads, scale, ws),
            lambda: sdpa(q, k, v, attn_mask=bias, scale=scale))


def global_case(gen, hd, hw, band=None):
    """K3 and SDPA on a prebuilt bias at head dim `hd` on an hh x ww grid;
    `band` (lo, hi): the queries of grid rows [lo, hi) only."""
    from crowdsam_tpu_torch.models import attention as A
    from crowdsam_tpu_torch.models.image_encoder import _rel_pos_table

    g, heads = 64, 16
    hh, ww = hw
    s, dim = hh * ww, heads * hd
    lo, hi = band or (0, hh)
    qkv = torch.randn((1, s, 3 * dim), generator=gen, device="cuda").to(
        torch.bfloat16)
    q, k, v = qkv.reshape(1, s, 3, heads, hd).permute(2, 0, 3, 1, 4)
    q = q[:, :, lo * ww:hi * ww]
    rh = _rel_pos_table(0.1 * torch.randn((2 * g - 1, hd), generator=gen,
                                          device="cuda"), hh)
    rw = _rel_pos_table(0.1 * torch.randn((2 * g - 1, hd), generator=gen,
                                          device="cuda"), ww)
    scale = hd ** -0.5
    bias = cs._relpos_bias(q.float(), rh, rw, hw, row0=lo).to(torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return (lambda: A.flash_mha_decomposed_relpos(q, k, v, scale, rh, rw, hw,
                                                  lo),
            lambda: sdpa(q, k, v, attn_mask=bias, scale=scale))


def encode_turns(arms, label, model, frames, generate=True):
    """The device span of one encode of each frame (`_encode_device_ms`) in
    turns, twice; the host ms of `generate` in one round of turns."""
    for img in frames:
        model.generate(img)
    dev = {"parent": [[] for _ in frames], "change": [[] for _ in frames]}
    for arm in TURNS * 2:
        arms.use(arm)
        for i, img in enumerate(frames):
            dev[arm][i].append(cs._encode_device_ms(model, img))
    row = {"ab": label, "frames": [list(f.shape[:2]) for f in frames],
           "encode_device_ms": dev,
           **{f"{arm}_median": [float(np.median(d)) for d in dev[arm]]
              for arm in ("parent", "change")}}
    if generate:
        ms = {"parent": [], "change": []}
        for arm in TURNS:
            arms.use(arm)
            ms[arm].append([cs._timed_generate(model, img)[1]
                            for img in frames])
        row["generate_ms"] = ms
    arms.use("change")
    return row


def main() -> int:
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print("usage: python3 chip_ab_relpos.py PARENT_DIR (needs a CUDA "
              "device)", file=sys.stderr)
        return 2
    from crowdsam_tpu_torch.kernels import _build
    from crowdsam_tpu_torch.pipeline.crowdsam import CrowdSAM
    from crowdsam_tpu_torch.utils import init
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
    arms = Arms(parent_lib, parent_terms(sys.argv[1]))
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        for hd in (80, 64):
            kernel_turns(arms, f"K2 hd{hd} 25x16x196", *window_case(gen, hd),
                         "window_attn_relpos")
        for hd, hw in ((64, (64, 64)), (64, (64, 48)), (64, (64, 44)),
                       (80, (64, 64)), (80, (64, 48))):
            kernel_turns(arms, f"K3 hd{hd} {hw[0]}x{hw[1]}",
                         *global_case(gen, hd, hw), "flash_attn_relpos")
        kernel_turns(arms, f"K3 hd80 rows {cs.ODD_K3_BAND} of 64x64",
                     *global_case(gen, 80, (64, 64), cs.ODD_K3_BAND),
                     "flash_attn_relpos")
        frames = synthetic_images(0, cs.N_IMAGES)
        draws["main"].get()
        with cs._no_default_init():
            model = CrowdSAM(full_width_config(), device="cuda")
        for rect in (False, True):
            model.predictor.rect_encode = rect
            print(json.dumps(encode_turns(
                arms, f"main {'rect' if rect else 'square'} encode", model,
                frames)), flush=True)
        del model
        torch.cuda.empty_cache()
        held = {cs.VIT_H_KEY: draws["vit_h"].get()}
        with cs.patched(init, "sam_state_dict",
                        cs._held(init.sam_state_dict, held)):
            vit_h, _ = cs._arch_model(["model.sam_model", "vit_h",
                                       "model.sam_adapter_checkpoint",
                                       cs.ADAPTER])
        row = encode_turns(arms, "vit_h encode", vit_h, frames,
                           generate=False)
        h, w = frames[0].shape[:2]
        vit_h.crop_image(frames[0], [0, 0, w, h])
        row["k2_k3_device_ms_frame0"] = {}
        for arm in ("parent", "change"):
            arms.use(arm)
            row["k2_k3_device_ms_frame0"][arm] = {
                k: v for k, v in cs.device_split(
                    lambda: vit_h.predictor.set_image_presized(vit_h.image),
                    3).items() if "relpos" in k}
        arms.use("change")
        print(json.dumps(row), flush=True)
    print(json.dumps({"wall_s": time.time() - t0}), flush=True)
    print(cs._smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
