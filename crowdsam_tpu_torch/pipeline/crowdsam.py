"""CrowdSAM: whole image -> person detections.

Counterpart of the JAX package's `pipeline/crowdsam.py` for the `crowdsam`
arch (SAM + DINOv2 + PWD-Net) with `test.output_rles: false`: per crop, the host resize, the dual-backbone
encode, the foreground map, the EPS engine and the box survivor pass; then
the inter-crop NMS.  `generate(image)` returns a MaskData with boxes,
scores, categories, points and stability scores; `rles` holds None per
detection, as the JAX package's box-only output does.

Runs on CUDA unless `device` names another device; with no device given
and no CUDA present it raises.  Without checkpoints the weights are random,
drawn from a `torch.Generator` seeded with `environ.seed`; a torch
checkpoint of the reference (same state-dict keys) loads as it is.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from crowdsam_tpu_torch.config import dtype_from_str, resolve_device
from crowdsam_tpu_torch.models.build import init_random_, sam_model_registry
from crowdsam_tpu_torch.models.common import cast_compute_params
from crowdsam_tpu_torch.models.dinov2 import dino_model_registry
from crowdsam_tpu_torch.ops.amg import MaskData, generate_crop_boxes
from crowdsam_tpu_torch.ops.nms import nms_indices
from crowdsam_tpu_torch.ops.resize import resize_linear
from crowdsam_tpu_torch.ops.transforms import resize_image
from crowdsam_tpu_torch.pipeline.engine import (
    EngineConfig,
    run_eps_engine,
    survivor_core,
)
from crowdsam_tpu_torch.pipeline.predictor import SamPredictor

_DINO_DIMS = {"dinov2_vitl14": 1024, "dinov2_vits14": 384}


def _unsupported(config: Dict[str, Any]) -> Optional[str]:
    """The first option this package does not run yet, named with the
    work that will bring it, or None."""
    m, t, tpu = config["model"], config["test"], config.get("tpu", {})
    if m.get("sam_arch", "crowdsam") != "crowdsam":
        return f"model.sam_arch {m['sam_arch']!r} (other archs: later slice)"
    if m.get("trainfree", False):
        return "model.trainfree (train-free branch: later slice)"
    if t.get("output_rles", True):
        return ("test.output_rles true (survivor RLE kernel K7: later "
                "slice); set test.output_rles false")
    if tpu.get("rect_encode", False):
        return "tpu.rect_encode (later slice)"
    if tpu.get("fullres_cleanup", False):
        return "tpu.fullres_cleanup (later slice)"
    if tpu.get("accumulate_occupy", False) or t.get("fuse_simmap", False):
        return ("tpu.accumulate_occupy / test.fuse_simmap (opt-in modes: "
                "later slice)")
    if t.get("mask_selection", "max_iou") != "max_iou":
        return f"test.mask_selection {t['mask_selection']!r} (later slice)"
    if int(tpu.get("mesh_data", 1)) > 1 or int(tpu.get("mesh_model", 1)) > 1:
        return "tpu.mesh_data / tpu.mesh_model > 1 (multi-device: later slice)"
    return None


def _uncrop_boxes_np(boxes, crop_box, downscale):
    x0, y0 = crop_box[0], crop_box[1]
    return boxes / downscale + np.asarray([x0, y0, x0, y0], dtype=np.float64)


def _uncrop_points_np(points, crop_box, downscale):
    x0, y0 = crop_box[0], crop_box[1]
    return points / downscale + np.asarray([x0, y0], dtype=np.float64)


class CrowdSAM:
    def __init__(self, config: Dict[str, Any], device=None, logger=None):
        self.device = resolve_device(device)
        self.config = config
        self.logger = logger or logging.getLogger("crowdsam_tpu_torch")
        why = _unsupported(config)
        if why is not None:
            raise NotImplementedError(why)
        mcfg, tcfg = config["model"], config["test"]
        tpucfg = config.get("tpu", {})
        dtype = dtype_from_str(tpucfg.get("compute_dtype", "bfloat16"))
        seed = int(config["environ"].get("seed", 42))
        self.n_class = int(mcfg.get("n_class", 1))

        build_kw = dict(
            n_class=self.n_class,
            dino_dim=_DINO_DIMS.get(mcfg.get("dino_model", "dinov2_vitl14"),
                                    1024))
        if mcfg.get("image_size"):
            build_kw["image_size"] = int(mcfg["image_size"])
        sam = sam_model_registry[mcfg.get("sam_model", "vit_l")](**build_kw)
        dino = dino_model_registry[mcfg.get("dino_model", "dinov2_vitl14")]()
        for module, s in ((sam, seed), (dino, seed + 1)):
            module.to(self.device)
            init_random_(module, torch.Generator(self.device).manual_seed(s))
        self._load(sam, mcfg.get("sam_checkpoint"), "SAM checkpoint")
        self._load(dino, mcfg.get("dino_checkpoint"), "DINOv2 checkpoint")
        self._load(sam.mask_decoder, mcfg.get("sam_adapter_checkpoint"),
                   "adapter checkpoint")
        self.sam = cast_compute_params(sam, dtype)
        self.dino = cast_compute_params(dino, dtype)
        self.predictor = SamPredictor(self.sam, self.dino, self.device)

        self.max_size = tcfg["max_size"]
        self.crop_n_layers = tcfg["crop_n_layers"]
        self.crop_nms_thresh = tcfg["crop_nms_thresh"]
        self.crop_overlap_ratio = tcfg["crop_overlap_ratio"]
        if tcfg.get("apply_box_offsets"):
            self.logger.warning("test.apply_box_offsets: True is ignored "
                                "(the branch is dead in the reference too)")
        self.engine_cfg = EngineConfig(
            grid_size=tcfg["grid_size"],
            points_per_batch=tcfg["points_per_batch"],
            max_prompts=tcfg["max_prompts"],
            n_class=self.n_class,
            img_size=sam.img_size,
            low_res=sam.img_size // 4,
            mask_threshold=sam.mask_threshold,
            pos_sim_thresh=tcfg["pos_sim_thresh"],
            filter_thresh=tcfg["filter_thresh"],
            pred_iou_thresh=tcfg["pred_iou_thresh"],
            stability_score_thresh=tcfg["stability_score_thresh"],
            stability_score_offset=tcfg["stability_score_offset"],
            box_nms_thresh=tcfg["box_nms_thresh"],
            crop_nms_thresh=tcfg["crop_nms_thresh"],
            min_mask_region_area=tcfg["min_mask_region_area"],
            cc_max_iters=tpucfg.get("cc_max_iters", 192),
            fused_decode=bool(tpucfg.get("fused_decode", True)),
        )
        # Candidate-order noise, drawn on the CPU so that every device
        # sees the same order for a seed.
        self.generator = torch.Generator().manual_seed(seed)

    def _load(self, module: torch.nn.Module, path: Optional[str],
              what: str) -> None:
        """Overlay a torch checkpoint non-strictly (as the reference loads
        its checkpoints); a missing file leaves the random weights."""
        if not path:
            return
        if not os.path.exists(path):
            self.logger.warning("%s %s not found; using random init", what,
                                path)
            return
        if not path.endswith((".pth", ".pt")):
            raise NotImplementedError(
                f"{what} {path}: only torch checkpoints load here "
                "(msgpack adapters: later slice)")
        sd = torch.load(path, map_location=self.device, weights_only=True)
        module.load_state_dict(sd.get("state_dict", sd), strict=False)

    # ---------------------------------------------------------------- api
    def crop_image(self, image: np.ndarray, crop_box) -> None:
        x0, y0, x1, y1 = crop_box
        self.orig_image = image
        self.image, self.downscale = resize_image(image[y0:y1, x0:x1, :],
                                                  self.max_size)

    def sim_map(self, fg_logits: torch.Tensor) -> torch.Tensor:
        """(1, n_class, 256, 256) logits -> (grid, grid) foreground
        probability: linear resize, sigmoid, max over classes."""
        g = self.engine_cfg.grid_size
        x = resize_linear(fg_logits, (g, g), axes=(-2, -1))
        return torch.sigmoid(x[0]).max(dim=0).values

    def draw_noise(self) -> torch.Tensor:
        return torch.rand(self.engine_cfg.grid_size ** 2,
                          generator=self.generator)

    @torch.no_grad()
    def generate(self, image: np.ndarray,
                 noise: Optional[Sequence] = None) -> MaskData:
        """HWC uint8 image -> MaskData.  `noise`: optional per-crop
        candidate-order vectors (grid^2 uniforms each); drawn from the
        model's generator when absent."""
        image = np.asarray(image, dtype=np.uint8)
        crop_boxes, _ = generate_crop_boxes(
            image.shape[:2], self.crop_n_layers, self.crop_overlap_ratio)
        data = MaskData()
        for i, crop_box in enumerate(crop_boxes):
            nz = self.draw_noise() if noise is None else torch.tensor(
                np.asarray(noise[i]), dtype=torch.float32)
            crop_data = self._process_crop(image, crop_box, nz)
            if crop_data is not None:
                data.cat(crop_data)
        if len(crop_boxes) > 1 and "crop_boxes" in data and len(
                data["boxes"]) > 0:
            cb = data["crop_boxes"]
            areas = ((cb[:, 2] - cb[:, 0]) * (cb[:, 3] - cb[:, 1])).astype(
                np.float64)
            keep = nms_indices(
                torch.as_tensor(data["boxes"], dtype=torch.float32),
                torch.as_tensor(1.0 / areas, dtype=torch.float32),
                torch.zeros(len(data["boxes"]), dtype=torch.int64),
                self.crop_nms_thresh)
            data.filter(keep)
            del data["crop_boxes"]
        if len(list(data.keys())) > 0:
            del data["iou_preds"]
        else:
            data["boxes"] = np.zeros((0, 4))
            data["scores"] = np.zeros((0, 4))
        if "rles" not in data:
            data["rles"] = []
        data.to_numpy()
        return data

    def _process_crop(self, image: np.ndarray, crop_box,
                      noise: torch.Tensor) -> Optional[MaskData]:
        self.crop_image(image, crop_box)
        self.predictor.set_image_presized(self.image)
        orig_h, orig_w = self.orig_image.shape[:2]
        in_h, in_w = self.image.shape[:2]
        cfg = self.engine_cfg
        self.fg_sim = self.sim_map(self.predictor.predict_fg_map())
        r = cfg.grid_size / max(in_h, in_w)
        feat_hw = (int(in_h * r), int(in_w * r))
        res = run_eps_engine(
            self.sam, cfg, self.predictor.get_image_embedding(),
            self.predictor.dense_pe, self.predictor.dino_proj_256,
            self.fg_sim, feat_hw, (in_h, in_w), crop_box, (orig_h, orig_w),
            self.downscale, noise)
        self.last_engine = res
        return self._finalize_crop(res, crop_box, (orig_h, orig_w),
                                   self.downscale)

    def _finalize_crop(self, res, crop_box, orig_hw,
                       downscale) -> Optional[MaskData]:
        cfg = self.engine_cfg
        summary = res["summary"].cpu().numpy()
        idx = np.nonzero(summary[:, 0] > 0.5)[0]
        if len(idx) == 0:
            return None
        sp = survivor_core(cfg, res["logits"][torch.as_tensor(
            idx, device=res["logits"].device)]).cpu().numpy()
        sel = np.nonzero(sp[:, 0] > 0.5)[0]
        if len(sel) == 0:
            return None
        idx_final = idx[sel]
        boxes_lr = np.where(sp[sel, 1:2] > 0.5, sp[sel, 2:6],
                            summary[idx_final, 6:10])
        boxes_in = boxes_lr * (cfg.img_size / cfg.low_res)
        data = MaskData(
            iou_preds=summary[idx_final, 1],
            scores=summary[idx_final, 2],
            categories=summary[idx_final, 3].astype(np.int32),
            stability_score=summary[idx_final, 4],
            points=_uncrop_points_np(summary[idx_final, 10:12], crop_box,
                                     downscale),
        )
        data["rles"] = [None] * len(sel)
        data["boxes"] = _uncrop_boxes_np(boxes_in, crop_box, downscale)
        data["rles_info"] = [crop_box, list(orig_hw)]
        data["crop_boxes"] = np.asarray([crop_box] * len(sel))
        data["fboxes"] = data["boxes"]
        return data
