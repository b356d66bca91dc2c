"""CrowdSAM: whole image -> person detections.

Counterpart of the JAX package's `pipeline/crowdsam.py`: per crop, the host
resize, the dual-backbone encode, the foreground map and the EPS engine
(`_dispatch_crop`), then the survivor pass and the host tail
(`_finalize_crop`); then the inter-crop NMS.  `model.sam_arch` picks the
arch as the JAX package does: `crowdsam` (SAM + DINOv2 + the PWD-Net
adapter, the main path), vanilla `sam` (the same model without loading the
adapter), `sam_hq` (the HQ decoder, `model.sam_model` with an `hq` prefix
stripped; unfused decode) and `mobile_sam` (the `mobile` prefix stripped;
TinyViT for `vit_t`).  `generate(image)` returns a MaskData with boxes,
scores, categories, points and stability scores; with `test.output_rles`
(the default) `rles` holds one COCO RLE dict per detection and nonempty
masks give their boxes at full resolution (the survivor kernel K7 and the
host codec), without it None per detection and the low-res boxes, as the
JAX package does.  `generate_many(images)` runs `generate` over a list of
images and records the time of each.

`model.trainfree` runs the train-free branch: its foreground map is the
cosine of DINOv2's tokens of the frame stretched to the square DINOv2 input
(PIL BILINEAR, ImageNet normalization) against a reference feature, the
mean over axis 0 of `ref["f"]` in the pickle `model.ref_feature` (zeros and
a warning when the file is missing, as in the JAX package), and the engine
runs on the DINOv2 grid (73 at img_size 1024) in place of
`test.grid_size`.  The opt-in modes `test.mask_selection`,
`tpu.accumulate_occupy`, `test.fuse_simmap`, `tpu.fullres_cleanup` and
`tpu.rect_encode` are wired into the engine and the predictor as the JAX
package wires them.  `tpu.compute_dtype float32` runs on the card through
the float32 arms of the kernels (K1-K4 in the encoders, K5 and K6 in the
fused decode), with the fused decode or without it, in full float32
(`models/common.exact_float32`), as on the CPU.

Runs on CUDA unless `device` names another device; with no device given
and no CUDA present it raises.  Without checkpoints the weights are the JAX
package's random ones, drawn with numpy in its leaf order
(`utils/init.py`): SAM from seed 0 (its parts 0-3), DINOv2 from
`environ.seed`; a torch
checkpoint of the reference (same state-dict keys) loads as it is, and a
flax msgpack adapter (the JAX package's mask-decoder tree, as the trained
adapters under `adapter_weights/` are saved) goes through
`utils/weights.mask_decoder_state_dict` first.
"""

from __future__ import annotations

import logging
import os
import pickle
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from crowdsam_tpu_torch.config import dtype_from_str, resolve_device
from crowdsam_tpu_torch.models.build import sam_model_registry
from crowdsam_tpu_torch.models.common import (
    cast_compute_params,
    float32_entry,
)
from crowdsam_tpu_torch.models.dinov2 import DINO_DIMS, dino_model_registry
from crowdsam_tpu_torch.models.mask_decoder import MaskDecoder
from crowdsam_tpu_torch.models.mask_decoder_hq import MaskDecoderHQ
from crowdsam_tpu_torch.ops.amg import MaskData, generate_crop_boxes
from crowdsam_tpu_torch.ops.nms import nms_indices
from crowdsam_tpu_torch.ops.resize import resize_linear
from crowdsam_tpu_torch.ops.rle import (
    encode_changes_coco,
    encode_masks_coco,
    svals_from_cand,
    unpack_cand10,
)
from crowdsam_tpu_torch.ops.transforms import resize_image, stretch_bilinear
from crowdsam_tpu_torch.pipeline.engine import (
    MASK_SELECTIONS,
    EngineConfig,
    run_eps_engine,
    survivor_core,
)
from crowdsam_tpu_torch.pipeline.predictor import SamPredictor
from crowdsam_tpu_torch.utils import init, msgpack_io
from crowdsam_tpu_torch.utils.weights import mask_decoder_state_dict

SAM_ARCHS = ("crowdsam", "sam", "sam_hq", "mobile_sam")


def sam_model_name(mcfg: Dict[str, Any]) -> str:
    """`model.sam_model` with the arch's prefix stripped, as the JAX
    package strips it: `hq` for `sam_hq`, `mobile` for `mobile_sam`, unless
    the name already starts with `vit`."""
    name = mcfg.get("sam_model", "vit_l")
    arch = mcfg.get("sam_arch", "crowdsam")
    if arch == "sam_hq" and not name.startswith("vit"):
        name = name[2:].lstrip("_")
    if arch == "mobile_sam" and not name.startswith("vit"):
        name = name[6:].lstrip("_")
    return name


def _unsupported(config: Dict[str, Any]) -> Optional[str]:
    """The first option this package does not run, named with the reason
    or the work that will bring it, or None."""
    m, t, tpu = config["model"], config["test"], config.get("tpu", {})
    if m.get("sam_arch", "crowdsam") not in SAM_ARCHS:
        return f"model.sam_arch {m['sam_arch']!r} (not an arch: {SAM_ARCHS})"
    sam_model = sam_model_name(m)
    if sam_model not in sam_model_registry:
        return (f"model.sam_model {m.get('sam_model')!r} (not in the "
                f"registry: {sorted(sam_model_registry)})")
    dino_model = m.get("dino_model", "dinov2_vitl14")
    if dino_model not in dino_model_registry:
        return (f"model.dino_model {dino_model!r} (not in the registry: "
                f"{sorted(dino_model_registry)})")
    if t.get("mask_selection", "max_iou") not in MASK_SELECTIONS:
        return (f"test.mask_selection {t['mask_selection']!r} (not one of "
                f"{MASK_SELECTIONS})")
    if int(tpu.get("mesh_data", 1)) > 1 or int(tpu.get("mesh_model", 1)) > 1:
        return ("tpu.mesh_data / tpu.mesh_model > 1: multi-device runs "
                "through parallel.eval_shard.ShardedPipeline(mesh=...) and "
                "parallel.prompt_shard.install_prompt_sharding; the JAX "
                "CrowdSAM does not read tpu.mesh_*")
    return None


def _float_leaves(tree):
    """A msgpack tree with its floating tensors in float32 (a bf16 leaf
    widens exactly), as the weight bridge reads them through numpy."""
    if isinstance(tree, dict):
        return {k: _float_leaves(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.float()
    return tree


def _load_drawn(module: torch.nn.Module, sd) -> None:
    """Load a drawn JAX-layout state dict.  The JAX trees have no 5th
    hypernetwork MLP (kept here for the reference's keys, never run): it
    is set to zero."""
    missing, unexpected = module.load_state_dict(sd, strict=False)
    unused = "mask_decoder.output_hypernetworks_mlps.4."
    if unexpected or any(not k.startswith(unused) for k in missing):
        raise RuntimeError(f"drawn weights do not fit the module: missing "
                           f"{missing}, unexpected {unexpected}")
    with torch.no_grad():
        for name, t in module.state_dict(keep_vars=True).items():
            if name.startswith(unused):
                t.zero_()


def _uncrop_boxes_np(boxes, crop_box, downscale):
    x0, y0 = crop_box[0], crop_box[1]
    return boxes / downscale + np.asarray([x0, y0, x0, y0], dtype=np.float64)


def _uncrop_points_np(points, crop_box, downscale):
    x0, y0 = crop_box[0], crop_box[1]
    return points / downscale + np.asarray([x0, y0], dtype=np.float64)


def _load(module: torch.nn.Module, path: Optional[str], what: str,
          device, logger) -> None:
    """Overlay a checkpoint non-strictly (as the reference loads its
    checkpoints); a missing file leaves the random weights.  A torch
    checkpoint loads as it is; a flax msgpack tree (`.msgpack`, `.flax`)
    only as the adapter, the JAX package's mask-decoder tree mapped to this
    package's keys."""
    if not path:
        return
    if not os.path.exists(path):
        logger.warning("%s %s not found; using random init", what, path)
        return
    if path.endswith((".msgpack", ".flax")):
        if not isinstance(module, (MaskDecoder, MaskDecoderHQ)):
            raise NotImplementedError(
                f"{what} {path}: msgpack trees load only as the adapter "
                "(the mask decoder) here")
        tree = _float_leaves(msgpack_io.load(path))
        module.load_state_dict(mask_decoder_state_dict(tree), strict=False)
        return
    if not path.endswith((".pth", ".pt")):
        raise NotImplementedError(
            f"{what} {path}: only torch checkpoints and msgpack adapters "
            "load here")
    sd = torch.load(path, map_location=device, weights_only=True)
    module.load_state_dict(sd.get("state_dict", sd), strict=False)


def build_models(config: Dict[str, Any], device, dino_seed=None,
                 load_adapter: bool = True, logger=None):
    """(Sam, DINOv2) of a config on `device`, Linear/Conv weights in the
    compute dtype.  Without checkpoints the weights are the JAX package's
    random ones: SAM from seed 0, DINOv2 from `dino_seed` (default
    `environ.seed`); the SAM and DINOv2 checkpoints, then (with
    `load_adapter`, and not for the vanilla `sam` arch) the adapter,
    overlay them.  `sam_hq` builds the HQ decoder (the adapter's tree then
    loads into its shared leaves, as the JAX package overlays it)."""
    logger = logger or logging.getLogger("crowdsam_tpu_torch")
    mcfg = config["model"]
    dtype = dtype_from_str(config.get("tpu", {}).get("compute_dtype",
                                                     "bfloat16"))
    if dino_seed is None:
        dino_seed = int(config["environ"].get("seed", 42))
    n_class = int(mcfg.get("n_class", 1))
    arch = mcfg.get("sam_arch", "crowdsam")
    sam_model = sam_model_name(mcfg)
    dino_model = mcfg.get("dino_model", "dinov2_vitl14")
    hq = arch == "sam_hq"
    build_kw = dict(n_class=n_class, dino_dim=DINO_DIMS[dino_model], hq=hq)
    if mcfg.get("image_size"):
        build_kw["image_size"] = int(mcfg["image_size"])
    sam = sam_model_registry[sam_model](**build_kw)
    dino = dino_model_registry[dino_model]()
    _load_drawn(sam, init.sam_state_dict(
        sam_model, 0, build_kw.get("image_size"), n_class,
        build_kw["dino_dim"], hq and init.has_hq(sam_model)))
    _load_drawn(dino, init.dino_state_dict(dino_model, dino_seed))
    sam.to(device)
    dino.to(device)
    _load(sam, mcfg.get("sam_checkpoint"), "SAM checkpoint", device, logger)
    _load(dino, mcfg.get("dino_checkpoint"), "DINOv2 checkpoint", device,
          logger)
    if load_adapter and arch != "sam":
        _load(sam.mask_decoder, mcfg.get("sam_adapter_checkpoint"),
              "adapter checkpoint", device, logger)
    return cast_compute_params(sam, dtype), cast_compute_params(dino, dtype)


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
        self.compute_dtype = dtype_from_str(tpucfg.get("compute_dtype",
                                                       "bfloat16"))
        seed = int(config["environ"].get("seed", 42))
        self.n_class = int(mcfg.get("n_class", 1))
        self.train_free = bool(mcfg.get("trainfree", False))

        self.sam, self.dino = build_models(config, self.device,
                                           logger=self.logger)
        self.predictor = SamPredictor(
            self.sam, self.dino, self.device,
            rect_encode=bool(tpucfg.get("rect_encode", False)),
            logger=self.logger)
        if self.train_free:
            self.ref_feature = self._load_ref_feature(mcfg.get("ref_feature"))
            # Read as the JAX package reads it; neither package uses it.
            self.alpha = mcfg.get("score_fusion", 0.25)

        self.max_size = tcfg["max_size"]
        self.crop_n_layers = tcfg["crop_n_layers"]
        self.crop_nms_thresh = tcfg["crop_nms_thresh"]
        self.crop_overlap_ratio = tcfg["crop_overlap_ratio"]
        self.output_rles = bool(tcfg.get("output_rles", True))
        if tcfg.get("apply_box_offsets"):
            self.logger.warning("test.apply_box_offsets: True is ignored "
                                "(the branch is dead in the reference too)")
        self.engine_cfg = EngineConfig(
            grid_size=(self.predictor.dino_grid if self.train_free
                       else tcfg["grid_size"]),
            points_per_batch=tcfg["points_per_batch"],
            max_prompts=tcfg["max_prompts"],
            n_class=self.n_class,
            img_size=self.sam.img_size,
            low_res=self.sam.img_size // 4,
            mask_threshold=self.sam.mask_threshold,
            pos_sim_thresh=tcfg["pos_sim_thresh"],
            filter_thresh=tcfg["filter_thresh"],
            pred_iou_thresh=tcfg["pred_iou_thresh"],
            stability_score_thresh=tcfg["stability_score_thresh"],
            stability_score_offset=tcfg["stability_score_offset"],
            box_nms_thresh=tcfg["box_nms_thresh"],
            crop_nms_thresh=tcfg["crop_nms_thresh"],
            min_mask_region_area=tcfg["min_mask_region_area"],
            mask_selection=tcfg.get("mask_selection", "max_iou"),
            accumulate_occupy=bool(tpucfg.get("accumulate_occupy", False)),
            fuse_simmap=bool(tcfg.get("fuse_simmap", False)),
            cc_max_iters=tpucfg.get("cc_max_iters", 192),
            fused_decode=bool(tpucfg.get("fused_decode", True)),
            fullres_cleanup=bool(tpucfg.get("fullres_cleanup", False)),
        )
        if self.engine_cfg.fullres_cleanup and not (
                self.output_rles and self.engine_cfg.min_mask_region_area > 0):
            self.logger.warning(
                "tpu.fullres_cleanup is set but %s; the exact full-res "
                "cleanup path only runs with output RLEs and a positive "
                "min_mask_region_area -- falling back to the approximate "
                "low-res cleanup (documented deviation)",
                "output_rles is off" if not self.output_rles
                else "min_mask_region_area == 0")
        # Candidate-order noise, drawn on the CPU so that every device
        # sees the same order for a seed.
        self.generator = torch.Generator().manual_seed(seed)
        # The decode engine `generate` calls, with run_eps_engine's
        # signature (`parallel.prompt_shard.install_prompt_sharding`
        # replaces it).
        self.engine = run_eps_engine

    def _load_ref_feature(self, path: Optional[str]) -> torch.Tensor:
        """The train-free reference feature (C,): the mean over axis 0 of
        `ref["f"]` in the pickle at `path` (read as data with numpy), or
        zeros and a warning when the file is missing."""
        if path and os.path.exists(path):
            with open(path, "rb") as f:
                ref = pickle.load(f)
            feat = np.asarray(ref["f"]).mean(axis=0).astype(np.float32)
            return torch.from_numpy(feat).to(self.device)
        self.logger.warning("trainfree ref_feature missing; using zeros")
        return torch.zeros((self.dino.embed_dim,), device=self.device)

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
    @float32_entry(lambda self: self.compute_dtype)
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
            nz = None if noise is None else torch.tensor(
                np.asarray(noise[i]), dtype=torch.float32)
            crop_data = self._finalize_crop(
                *self._dispatch_crop(image, crop_box, nz))
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
            # `rles_info` holds two entries a crop, not one a detection:
            # it stays out of the row filter (the JAX package filters it
            # and raises past 2 x crops detections).
            info = data["rles_info"]
            del data["rles_info"]
            data.filter(keep)
            data["rles_info"] = info
            del data["crop_boxes"]
        return _wrap_up(data)

    def generate_many(self, images: Sequence[np.ndarray],
                      times_out: Optional[list] = None) -> List[MaskData]:
        """`generate` over a list of images, in order, drawing the noise
        from the model's generator as `generate` does.

        `times_out`: optional list; the wall-clock seconds of each image
        are appended (they sum to the loop's total).  Image k's host tail
        is not overlapped with image k+1's dispatch: on the H100 that made
        both slower, since each is thousands of small ops from Python."""
        results = []
        for image in images:
            t = time.perf_counter()
            results.append(self.generate(image))
            if times_out is not None:
                times_out.append(time.perf_counter() - t)
        return results

    def _dispatch_crop(self, image: np.ndarray, crop_box,
                       noise: Optional[torch.Tensor]):
        """Device work of one crop: resize, encode, FG map, EPS engine.
        Returns the engine's result and the crop's bookkeeping for
        `_finalize_crop`; `noise` is drawn from the generator when None."""
        if noise is None:
            noise = self.draw_noise()
        self.crop_image(image, crop_box)
        self.predictor.set_image_presized(self.image)
        orig_h, orig_w = self.orig_image.shape[:2]
        in_h, in_w = self.image.shape[:2]
        cfg = self.engine_cfg
        if self.train_free:
            d, g = self.predictor.dino_input, self.predictor.dino_grid
            self.fg_sim = self.predictor.trainfree_sim(
                stretch_bilinear(self.image, (d, d)), self.ref_feature)
            feat_hw = (g, g)
        else:
            self.fg_sim = self.sim_map(self.predictor.predict_fg_map())
            r = cfg.grid_size / max(in_h, in_w)
            feat_hw = (int(in_h * r), int(in_w * r))
        res = self.engine(
            self.sam, cfg, self.predictor.get_image_embedding(),
            self.predictor.dense_pe, self.predictor.decode_extras(),
            self.fg_sim, feat_hw, (in_h, in_w), crop_box, (orig_h, orig_w),
            self.downscale, noise)
        self.last_engine = res
        meta = dict(crop_box=crop_box, orig_hw=(orig_h, orig_w),
                    in_hw=(in_h, in_w), downscale=self.downscale)
        return res, meta

    def _finalize_crop(self, res, meta) -> Optional[MaskData]:
        """Host tail of one crop: the survivor pass over the kept slab rows,
        then `_crop_data`, from the engine's result `res` and the crop's
        `meta`."""
        summary = res["summary"].cpu().numpy()
        idx = np.nonzero(summary[:, 0] > 0.5)[0]
        if len(idx) == 0:
            return None
        dev = res["logits"].device
        logits = res["logits"][torch.as_tensor(idx, device=dev)]
        if self.output_rles:
            sp = survivor_core(self.engine_cfg, logits, torch.tensor(
                meta["in_hw"], dtype=torch.int32, device=dev),
                with_masks=True)
            sp_summary = sp["summary"].cpu().numpy()
        else:
            sp = None
            sp_summary = survivor_core(self.engine_cfg, logits).cpu().numpy()
        return self._crop_data(summary, idx, sp, sp_summary, meta)

    def _crop_data(self, summary: np.ndarray, idx: np.ndarray, sp,
                   sp_summary: np.ndarray, meta) -> Optional[MaskData]:
        """The crop's detections from the engine's summary, its kept rows
        `idx` and the survivor pass over them (`sp`, its outputs with
        masks, else None; `sp_summary` its summary on the host): boxes
        (full-res for nonempty masks with `output_rles`) and the RLE
        strings."""
        cfg = self.engine_cfg
        crop_box, downscale = meta["crop_box"], meta["downscale"]
        in_h, in_w = meta["in_hw"]
        sel = np.nonzero(sp_summary[:, 0] > 0.5)[0]
        if len(sel) == 0:
            return None
        idx_final = idx[sel]
        # Changed masks take the boxes of the cleaned masks.
        boxes_lr = np.where(sp_summary[sel, 1:2] > 0.5, sp_summary[sel, 2:6],
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
        if self.output_rles:
            data["rles"] = self._rles(sp, sel, in_h, in_w)
            nonempty = sp_summary[sel, 11] > 0.5
            boxes_in = np.where(nonempty[:, None],
                                sp_summary[sel, 6:10].astype(np.float64),
                                boxes_in)
        else:
            data["rles"] = [None] * len(sel)
        data["boxes"] = _uncrop_boxes_np(boxes_in, crop_box, downscale)
        data["rles_info"] = [crop_box, list(meta["orig_hw"])]
        data["crop_boxes"] = np.asarray([crop_box] * len(sel))
        data["fboxes"] = data["boxes"]
        return data

    @staticmethod
    def _rles(sp, sel, in_h: int, in_w: int) -> list:
        """COCO RLE dicts of the survivors `sel`: from K7's change rows, or
        for a mask with a column of more changes than its slots from its
        packed bitmap (only those rows leave the device)."""
        dev = sp["cand"].device
        sel_t = torch.as_tensor(sel, device=dev)
        cand = unpack_cand10(sp["cand"][sel_t].cpu().numpy())
        ncol = sp["n_col"][sel_t].cpu().numpy()
        overflow = np.nonzero(sp["overflow"][sel_t].cpu().numpy())[0]
        ov_rles = {}
        if len(overflow):
            packed = sp["packed"][torch.as_tensor(sel[overflow], device=dev)]
            full = np.unpackbits(packed.cpu().numpy(), axis=-1)[
                :, :in_h, :in_w].astype(bool)
            ov_rles = dict(zip(overflow.tolist(), encode_masks_coco(full)))
        return [ov_rles[i] if i in ov_rles else encode_changes_coco(
                    svals_from_cand(cand[i], ncol[i], in_h), in_h * in_w,
                    (in_h, in_w))
                for i in range(len(sel))]


def _wrap_up(data: MaskData) -> MaskData:
    """The fields of an image's result as the JAX package leaves them: no
    `iou_preds`, the (0, 4) empty arrays when nothing was detected, an
    `rles` list, numpy arrays."""
    if len(list(data.keys())) > 0:
        del data["iou_preds"]
    else:
        data["boxes"] = np.zeros((0, 4))
        data["scores"] = np.zeros((0, 4))
    if "rles" not in data:
        data["rles"] = []
    data.to_numpy()
    return data
