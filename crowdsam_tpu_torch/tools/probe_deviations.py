"""Measure every documented deviation of the EPS engine at the trained
operating point:

    python -m crowdsam_tpu_torch.tools.probe_deviations [n_scenes]
        [--device DEVICE]

Counterpart of the JAX package's `tools/probe_deviations_trained.py`.  On
full-size (683x1024) crowd scenes (`utils/synthetic.crowd_scene`, 4 by
default) at the thresholds of `configs/crowdhuman.yaml`, with random
encoders and the committed trained decoder of the recipe in
`BENCH_TRAIN_RECIPE` (default "train.hard_neg_frac=0.5,
train.neg_hinge_weight=16"; the run refuses to train one), it runs:

- the engine (`CrowdSAM.generate`), each scene on noise from `draw_noise()`;
- the deviation probe (`utils/deviation_probe.py`) on the same noise in
  every variant of `VARIANTS`: parity mode (all documented deviations in
  effect), each deviation switched to the reference's semantics alone, the
  two candidate cleanups, and every deviation switched at once (the joint
  bound).

Each pair is scored both ways (A's detections as the ground truth of B and
the reverse) with the CrowdHuman evaluator at 0.5 IoU.  The JSON report
on stdout has the JAX driver's keys and pair names, so
`tools/analyze_probe_pairs.py` reads it.  Runs on CUDA unless `--device`
names another device; with neither and no CUDA it raises.

`run_probe(model, scenes, noises)` is the measurement alone, on any
CrowdSAM of this package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from crowdsam_tpu_torch.utils.deviation_probe import (
    ALL_PARTS,
    DeviationProbe,
)

DEFAULT_RECIPE = "train.hard_neg_frac=0.5,train.neg_hinge_weight=16"

VARIANTS = {
    "parity": frozenset(),
    "exact_cleanup": frozenset({"cleanup"}),     # PARITY #1
    "exact_upfilter": frozenset({"upfilter"}),   # PARITY #3
    "exact_occupy": frozenset({"occupy"}),       # PARITY #6
    "exact_padcrop": frozenset({"padcrop"}),     # PARITY #7
    "exact_coords": frozenset({"coords"}),
    # Candidate cheaper cleanup fixes, scored against exact_cleanup:
    "cand_cleanup512": frozenset({"cleanup512"}),
    "cand_fullarea": frozenset({"cleanup_fullarea"}),
    "exact_all": ALL_PARTS,
}


def _to_coco_dt(image_id, boxes, scores, min_wh=4.0):
    out = []
    for b, s in zip(np.asarray(boxes, np.float64),
                    np.asarray(scores, np.float64)):
        out.append({
            "image_id": int(image_id),
            "bbox": [float(b[0]), float(b[1]),
                     max(float(b[2] - b[0]), min_wh),
                     max(float(b[3] - b[1]), min_wh)],
            "score": float(s),
            "category_id": 1,
        })
    return out


def _write_coco(path, images, annots, with_scores):
    annots = [dict(a) for a in annots]
    for i, a in enumerate(annots):
        a["id"] = i + 1
        if not with_scores:
            a.pop("score", None)
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": annots,
                   "categories": [{"id": 1, "name": "person"}]}, f)


def _cross_ap(tmpdir, tag, images_meta, dt_a, dt_b):
    from crowdsam_tpu_torch.evallib.crowdhuman import (
        evaluate_predictions_on_crowdhuman,
    )

    out = {}
    for name, gt, dt in ((f"{tag}:a_gt", dt_a, dt_b),
                         (f"{tag}:b_gt", dt_b, dt_a)):
        gt_path = os.path.join(tmpdir, f"gt_{name.replace(':', '_')}.json")
        dt_path = os.path.join(tmpdir, f"dt_{name.replace(':', '_')}.json")
        _write_coco(gt_path, images_meta, gt, with_scores=False)
        _write_coco(dt_path, images_meta, dt, with_scores=True)
        ap, mr, recall, _, _ = evaluate_predictions_on_crowdhuman(
            gt_path, dt_path)
        out[name] = {"ap": round(ap, 4), "recall": round(recall, 4)}
    return out


def cross_ap_report(images_meta: List[dict], dt: Dict[str, list]) -> dict:
    """The driver's pairs among the variants in `dt` (and "engine"), each
    scored both ways."""
    names = [n for n in VARIANTS if n in dt]
    with tempfile.TemporaryDirectory() as tmpdir:
        def pair(tag, a, b):
            return _cross_ap(tmpdir, tag, images_meta, dt[a], dt[b])

        # Self-AP ceiling: identical detection sets do NOT score 1.0 under
        # greedy score-descending matching (a high-scoring overlap can
        # claim another's GT); every bound below reads against this.
        report = {"ceiling_parity_vs_self": pair("self", "parity", "parity"),
                  "floor_engine_vs_parity": pair("floor", "engine", "parity")}
        # Attribution: parity against each single exact part.
        for name in names:
            if name in ("parity", "exact_all") or name.startswith("cand_"):
                continue
            report[f"parity_vs_{name}"] = pair(name, "parity", name)
        # Candidate cleanups against the exact semantics.
        for name in names:
            if name.startswith("cand_"):
                report[f"exact_cleanup_vs_{name}"] = pair(
                    f"x{name}", "exact_cleanup", name)
        # Joint bound: engine (and parity) against full reference semantics.
        report["parity_vs_exact_all"] = pair("pex", "parity", "exact_all")
        report["engine_vs_exact_all"] = pair("eex", "engine", "exact_all")
    return report


def run_probe(model, scenes: Sequence[np.ndarray], noises: Sequence,
              variants: Optional[dict] = None, fixture: Optional[dict] = None,
              seconds: Optional[dict] = None, log=None) -> dict:
    """The engine and every probe variant on `scenes` (HWC uint8 images),
    scene t on the candidate-order noise `noises[t]`, scored by cross-AP.
    `variants`: a part of VARIANTS (all by default; "parity",
    "exact_cleanup" and "exact_all" are needed for the pairs;
    "cand_cleanup512" needs an img_size above 512).  Returns the report
    (the JAX driver's keys); `seconds`, where given, gets the wall seconds
    of the engine and of each variant over all scenes; `log(str)` gets a
    line a variant."""
    variants = VARIANTS if variants is None else variants
    log = log or (lambda s: None)
    images_meta = [{"id": t, "file_name": f"im{t}.jpg",
                    "height": img.shape[0], "width": img.shape[1]}
                   for t, img in enumerate(scenes)]
    dt = {k: [] for k in list(variants) + ["engine"]}
    counts = {"engine": []}
    t0 = time.perf_counter()
    for t, img in enumerate(scenes):
        d = model.generate(img, noise=[noises[t]])
        dt["engine"] += _to_coco_dt(t, d["boxes"], d["scores"])
        counts["engine"].append(len(d["boxes"]))
    if seconds is not None:
        seconds["engine"] = time.perf_counter() - t0
    log(f"engine: {counts['engine']}")

    probe = DeviationProbe(model)
    consumed, diag = {}, {}
    for name, parts in variants.items():
        t0 = time.perf_counter()
        consumed[name], counts[name] = [], []
        diag[name] = {"n_changed": [], "n_dropped_renms": []}
        for t, img in enumerate(scenes):
            d = probe.generate(img, noises[t], parts=parts)
            dt[name] += _to_coco_dt(t, d["boxes"], d["scores"])
            counts[name].append(len(d["boxes"]))
            consumed[name].append(int(d["num_consumed"]))
            diag[name]["n_changed"].append(int(d["n_changed"]))
            diag[name]["n_dropped_renms"].append(int(d["n_dropped_renms"]))
        dt_s = time.perf_counter() - t0
        if seconds is not None:
            seconds[name] = dt_s
        log(f"{name}: n={counts[name]} changed={diag[name]['n_changed']} "
            f"renms_drop={diag[name]['n_dropped_renms']} ({dt_s:.1f}s)")

    return {
        "scenes": len(scenes),
        "fixture": fixture or {},
        "detections": counts,
        "consumed": consumed,
        "diag": diag,
        "cross_ap": cross_ap_report(images_meta, dt),
        # The detections of every variant (COCO dt records), for matched-
        # pair analyses offline (tools/analyze_probe_pairs.py).
        "dt": dt,
    }


def build_model(device=None, recipe: Optional[str] = None):
    """`configs/crowdhuman.yaml` with the checkpoints blanked and the
    committed trained decoder of `recipe` installed; refuses to train.
    Returns (model, the fixture's metadata)."""
    from crowdsam_tpu_torch.config import load_config, modify_config
    from crowdsam_tpu_torch.pipeline.crowdsam import CrowdSAM
    from crowdsam_tpu_torch.utils.bench_fixture import train_or_load_decoder

    if recipe is None:
        recipe = os.environ.get("BENCH_TRAIN_RECIPE", DEFAULT_RECIPE)
    cfg = modify_config(load_config("configs/crowdhuman.yaml"), [
        "model.sam_checkpoint", "", "model.dino_checkpoint", "",
        "model.sam_adapter_checkpoint", "",
    ])
    model = CrowdSAM(cfg, device=device)
    meta = train_or_load_decoder(model, steps=800, lr=2e-4, recipe=recipe,
                                 train=False)
    if meta.get("trained_cache") not in ("committed", "hit"):
        raise RuntimeError(f"refusing to train at probe time: {meta}")
    return model, meta


def main(argv=None) -> int:
    from crowdsam_tpu_torch.utils.synthetic import crowd_scene

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("n_scenes", nargs="?", type=int, default=4)
    parser.add_argument("--device", default=None,
                        help="device to run on (default: cuda)")
    args = parser.parse_args(argv)

    def log(s):
        print(f"# {s}", file=sys.stderr, flush=True)

    model, meta = build_model(args.device)
    log(f"fixture: {meta}")
    scenes = [crowd_scene(t)[0] for t in range(args.n_scenes)]
    noises = [model.draw_noise().numpy() for _ in scenes]
    report = run_probe(model, scenes, noises, fixture=meta, log=log)
    print(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
