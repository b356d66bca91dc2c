"""Deviation probe: the EPS loop as the reference runs it, over the model's
own modules, with any documented deviation switched to the reference's
exact semantics.

Counterpart of the JAX package's `utils/deviation_probe.py`.  The engine
quantizes several steps of the reference loop (reference
`crowdsam/model.py:192-443`) to the decoder's low-res frame; PARITY.md
documents each.  A "part" names one of them:

  "cleanup"  -- PARITY #1: small-region cleanup at 256^2 with a rescaled
                threshold (reference: at image resolution)
  "upfilter" -- PARITY #3: in-loop stability score and NMS boxes at 256^2
                (reference: on the masks upsampled to the image frame)
  "occupy"   -- PARITY #6: occupy pruning on a 256^2 bitmap over the padded
                frame (reference: a full-resolution image-frame lookup)
  "padcrop"  -- PARITY #7: pad-region logits counted in the in-loop
                stability (the reference crops to the input frame first)
  "coords"   -- the grid-to-pixel expression: the reference divides by the
                float32 ratio where the engine multiplies by its inverse

`CANDIDATE_PARTS` are two replacements of the cleanup that are not the
reference's semantics: "cleanup512" cleans at 512^2, "cleanup_fullarea"
keeps the 256^2 regions but measures each region's area on the full-res
binarization under its nearest-upsampled footprint.

`DeviationProbe(model).generate(image, noise, parts)` runs one whole-image
crop.  Each prompt batch is one PyTorch step on the model's device: the
prompt encoder and the unfused `MaskDecoder` with multimask output, the
fused-IoU selection, the stability score (NaN where the union is empty,
as the reference's int / int), the boxes, the filters and the occupancy
bitmap.  One `.cpu()` a batch brings its summary and bitmap to the host;
the selected logits stay on the device until after the NMS.  The host
loop, the NMS, the `max_keep` cap, the cleanup at its resolution (scipy
labelling) and the final boxes are numpy, as in the JAX probe, so the
same inputs give the same numbers and the same stable sorts.

Parity mode decodes the engine's batches with the engine's decoder (the
unfused one) and keeps its quantizations, so it finds the engine's
detections, up to one order: the re-NMS after the cleanup visits tied
survivors in detection order here (and in the JAX probe) but by falling
score in the engine's survivor pass (and the JAX engine's), so two
overlapping cleaned masks may keep the other one; `renms_order="score"`
takes the engine's order.

Not on a production path: `tools/probe_deviations.py` scores each variant
against the engine by cross-AP with the CrowdHuman evaluator.
"""

from __future__ import annotations

import numpy as np
import torch

from crowdsam_tpu_torch.models.common import exact_float32
from crowdsam_tpu_torch.ops.amg import batched_mask_to_box
from crowdsam_tpu_torch.ops.resize import resize_linear

ALL_PARTS = frozenset({"coords", "upfilter", "padcrop", "occupy", "cleanup"})
CANDIDATE_PARTS = frozenset({"cleanup512", "cleanup_fullarea"})


def _np_nms(boxes: np.ndarray, scores: np.ndarray, thresh: float) -> np.ndarray:
    """Greedy NMS keep-mask, torchvision semantics (suppress iff IoU
    strictly > thresh with an earlier kept box), index-stable ties.  Each
    kept box suppresses all later ones at once, in the same float32
    arithmetic as a pair at a time."""
    n = len(boxes)
    order = np.argsort(-scores.astype(np.float32), kind="stable")
    b = boxes.astype(np.float32)[order]
    area = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(
        b[:, 3] - b[:, 1], 0, None)
    alive = np.ones(n, dtype=bool)
    for i in range(n):
        if not alive[i]:
            continue
        lt = np.maximum(b[i, :2], b[i + 1:, :2])
        rb = np.minimum(b[i, 2:], b[i + 1:, 2:])
        wh = np.clip(rb - lt, 0, None)
        inter = wh[:, 0] * wh[:, 1]
        iou = inter / (area[i] + area[i + 1:] - inter + 1e-6)
        alive[i + 1:] &= ~(iou > thresh)
    keep = np.empty(n, dtype=bool)
    keep[order] = alive
    return keep


def _label(mask: np.ndarray, correct_holes: bool):
    """8-connected labels of the mask's regions (of its holes with
    `correct_holes`) and their count."""
    from scipy import ndimage

    working = np.logical_xor(correct_holes, mask)
    return ndimage.label(working, structure=np.ones((3, 3), dtype=bool))


def _drop_small(mask, labels, sizes, area_thresh, correct_holes):
    """Reference amg.py:267-291 from the labels and their sizes: holes
    below the area filled, or islands below it removed (the largest kept
    where all are); (mask, changed)."""
    small = [i + 1 for i, s in enumerate(sizes) if s < area_thresh]
    if not small:
        return mask, False
    fill = [0] + small
    if not correct_holes:
        fill = [i for i in range(len(sizes) + 1) if i not in fill]
        if not fill:
            fill = [int(np.argmax(sizes)) + 1]
    return np.isin(labels, fill), True


def _np_remove_small_regions(mask: np.ndarray, area_thresh: float, mode: str):
    """Reference amg.py:267-291 semantics with scipy 8-connected labeling."""
    from scipy import ndimage

    correct_holes = mode == "holes"
    labels, n = _label(mask, correct_holes)
    sizes = ndimage.sum_labels(
        np.ones_like(labels), labels, np.arange(1, n + 1))
    return _drop_small(mask, labels, sizes, area_thresh, correct_holes)


def _np_remove_small_regions_fullarea(mask, full_binm, area_thresh, mode, f):
    """remove_small_regions with low-res region TOPOLOGY but each region's
    size measured on the full-res binarization under the region's
    nearest-upsampled footprint (the "cleanup_fullarea" candidate)."""
    from scipy import ndimage

    correct_holes = mode == "holes"
    labels, n = _label(mask, correct_holes)
    if n == 0:
        return mask, False
    labels_up = np.repeat(np.repeat(labels, f, axis=0), f, axis=1)
    src = np.logical_xor(correct_holes, full_binm)
    sizes = ndimage.sum_labels(
        src.astype(np.float64), labels_up, np.arange(1, n + 1))
    return _drop_small(mask, labels, sizes, area_thresh, correct_holes)


def _np_mask_to_box(masks: np.ndarray) -> np.ndarray:
    """(B,H,W) bool -> (B,4) xyxy inclusive edges float32, zeros when
    empty."""
    h, w = masks.shape[1:]
    rows, cols = masks.any(axis=2), masks.any(axis=1)
    box = np.stack([cols.argmax(1), rows.argmax(1),
                    w - 1 - cols[:, ::-1].argmax(1),
                    h - 1 - rows[:, ::-1].argmax(1)], axis=1)
    return np.where(rows.any(1)[:, None], box, 0).astype(np.float32)


def _upsample(logits: torch.Tensor, q: int) -> torch.Tensor:
    """(n, R, R) -> (n, q, q) float32, jax.image.resize "linear"."""
    with exact_float32():
        return resize_linear(logits.float(), (q, q), axes=(-2, -1))


class DeviationProbe:
    """Reference-shaped dynamic EPS loop over `model`'s modules (a
    CrowdSAM of this package) with any subset of ALL_PARTS switched to the
    reference's semantics, or one of CANDIDATE_PARTS."""

    SLAB = 160  # the most NMS survivors a run may have

    def __init__(self, model):
        if getattr(model.predictor, "is_hq", False):
            raise ValueError("the deviation probe does not run the HQ "
                             "decoder")
        self.model = model

    # ------------------------------------------------------------ device
    def _step(self, parts: frozenset, in_hw, features, dense_pe, dino_proj,
              coords: np.ndarray, n_valid: int):
        """One prompt batch of K prompts (`coords` in the prompt frame, the
        first `n_valid` real).  Returns (the per-prompt iou, cat, stab,
        boxes and keep on the host, the batch's occupancy bitmap on the
        host, the selected logits (K, R, R) float32 on the device)."""
        model = self.model
        cfg = model.engine_cfg
        K, R, S = cfg.points_per_batch, cfg.low_res, cfg.img_size
        in_h, in_w = in_hw
        upf, padc = "upfilter" in parts, "padcrop" in parts
        occ_img = "occupy" in parts
        rh, rw = -(-in_h * R // S), -(-in_w * R // S)  # low-res valid band
        thr, off = cfg.mask_threshold, cfg.stability_score_offset
        dev = features.device
        sam = model.sam

        pts = torch.from_numpy(coords).to(dev)
        sparse, dense = sam.prompt_encoder(points=(
            pts[:, None, :], torch.ones((K, 1), dtype=torch.int64,
                                        device=dev)))
        masks, iou_pred, cls = sam.mask_decoder(
            features, dense_pe, sparse, dense, True,
            dino_feats_proj=dino_proj)
        masks, cls = masks.float(), cls.float()
        # IoU fusion quirk (model.py:351) + max_iou selection (:318-331).
        cat = cls.argmax(dim=-1)
        iou_fused = (iou_pred.float().clamp(min=0.0)
                     * torch.sigmoid(cls.max(dim=-1).values))
        ind = iou_fused.argmax(dim=-1)
        ar = torch.arange(K, device=dev)
        m_sel, iou_sel, cat_sel = masks[ar, ind], iou_fused[ar, ind], \
            cat[ar, ind]
        del masks

        if upf:
            logits_f = _upsample(m_sel, S)
            if padc:
                logits_f = logits_f[:, :in_h, :in_w]
        else:
            logits_f = m_sel[:, :rh, :rw] if padc else m_sel
        inter = (logits_f > thr + off).sum(dim=(-1, -2)).float()
        union = (logits_f > thr - off).sum(dim=(-1, -2)).float()
        stab = inter / union  # 0/0 -> nan, like the reference int/int
        boxes = batched_mask_to_box(logits_f > thr).float()

        keep = ar < n_valid
        if cfg.pred_iou_thresh > 0.0:
            keep &= iou_sel > cfg.pred_iou_thresh
        if cfg.stability_score_thresh > 0.0:
            keep &= stab >= cfg.stability_score_thresh
        # Near-crop-edge filter: with the single whole-image crop the
        # reference's test (near the crop AND not near the image) is
        # identically False (crowdsam/utils.py:213-223).
        hot = keep & (iou_sel > cfg.filter_thresh)
        if occ_img:
            occ_src = (logits_f if upf else _upsample(m_sel, S))[
                :, :in_h, :in_w]
        else:
            occ_src = m_sel
        occ_new = ((occ_src > thr) & hot[:, None, None]).any(dim=0)
        del logits_f, occ_src
        summary = torch.stack([
            iou_sel, cat_sel.float(), stab, *boxes.unbind(-1),
            keep.float()], dim=1).contiguous()
        # One transfer: the summary's bytes, then the bitmap's.
        blob = torch.cat([summary.view(torch.uint8).flatten(),
                          occ_new.flatten().to(torch.uint8)]).cpu().numpy()
        nb = summary.numel() * 4
        f = blob[:nb].view(np.float32).reshape(K, 8)
        host = {"iou": f[:, 0], "cat": f[:, 1].astype(np.int64),
                "stab": f[:, 2], "boxes": f[:, 3:7],
                "keep": f[:, 7] > 0.5}
        occ = blob[nb:].reshape(occ_new.shape).astype(bool)
        return host, occ, m_sel

    def _corr_box(self, logits: torch.Tensor, removed: np.ndarray,
                  filled: np.ndarray, in_hw, q: int):
        """The engine's survivor semantics: the full-res binarization with
        the resolution-q cleanup corrections applied by nearest upsample,
        cropped to the input frame.  Returns (boxes (n, 4), nonempty (n,))
        on the host."""
        cfg = self.model.engine_cfg
        S, f = cfg.img_size, cfg.img_size // q
        dev = logits.device

        def kron(b):
            t = torch.from_numpy(b).to(dev)
            return t.repeat_interleave(f, dim=1).repeat_interleave(f, dim=2)

        up = _upsample(logits, S) > cfg.mask_threshold
        full = ((up & ~kron(removed)) | kron(filled))[:, :in_hw[0],
                                                      :in_hw[1]]
        return (batched_mask_to_box(full).float().cpu().numpy(),
                full.any(dim=2).any(dim=1).cpu().numpy())

    def _binm(self, logits: torch.Tensor, q: int, crop=None) -> np.ndarray:
        """The resolution-q binarization of `logits` on the host, cropped
        to `crop` (h, w) where given."""
        cfg = self.model.engine_cfg
        up = logits if q == cfg.low_res else _upsample(logits, q)
        up = up > cfg.mask_threshold
        if crop is not None:
            up = up[:, :crop[0], :crop[1]]
        return up.cpu().numpy()

    # ------------------------------------------------------------ main loop
    @torch.no_grad()
    def generate(self, image: np.ndarray, noise, parts=frozenset(),
                 renms_order: str = "detection") -> dict:
        """One whole-image crop through the reference-shaped loop with
        `parts` exact.  `noise`: the candidate-order vector (grid_size**2
        uniforms) the engine consumed for the same image
        (`CrowdSAM.generate(image, noise=[noise])`).  Returns dict(boxes
        [original frame xyxy], scores, categories, stability, num_consumed,
        n_prenms, n_changed, n_dropped_renms).

        `renms_order`: the order in which the re-NMS after the cleanup
        visits the survivors among equal preferences (unchanged masks
        first).  "detection" (the JAX probe's): the order the loop found
        them in.  "score": by falling score, as the engine's survivor pass
        takes them (the JAX engine's too), so that parity mode and the
        engine keep the same one of two overlapping cleaned masks."""
        if renms_order not in ("detection", "score"):
            raise ValueError(f"renms_order {renms_order!r}: 'detection' or "
                             "'score'")
        parts = frozenset(parts)
        unknown = parts - (ALL_PARTS | CANDIDATE_PARTS)
        if unknown:
            raise ValueError(f"unknown probe parts {sorted(unknown)}")
        if len(parts & ({"cleanup"} | CANDIDATE_PARTS)) > 1:
            raise ValueError("cleanup modes are mutually exclusive: "
                             f"{sorted(parts)}")
        model = self.model
        cfg = model.engine_cfg
        if model.crop_n_layers != 0 or cfg.fuse_simmap:
            raise ValueError("the probe covers the single-crop, "
                             "fuse_simmap=False config")
        S = cfg.img_size
        if "cleanup512" in parts and (S <= 512 or S % 512):
            raise ValueError(f"cleanup512 needs an img_size above 512 and a "
                             f"multiple of it, not {S}")
        N = cfg.grid_size ** 2
        rand = np.asarray(noise, np.float32).reshape(-1)
        if rand.shape != (N,):
            raise ValueError(f"noise of {rand.size} values; the grid has {N}")
        with exact_float32(model.compute_dtype):
            return self._generate(np.asarray(image, np.uint8), rand, parts,
                                  renms_order)

    def _generate(self, img: np.ndarray, rand: np.ndarray,
                  parts: frozenset, renms_order: str) -> dict:
        model = self.model
        cfg = model.engine_cfg
        orig_h, orig_w = img.shape[:2]
        model.crop_image(img, [0, 0, orig_w, orig_h])
        pred = model.predictor
        pred.set_image_presized(model.image)
        downscale = model.downscale
        in_h, in_w = model.image.shape[:2]
        sim = model.sim_map(pred.predict_fg_map()).float().cpu().numpy()

        G, K, R, S = (cfg.grid_size, cfg.points_per_batch, cfg.low_res,
                      cfg.img_size)
        rr = G / max(in_h, in_w)
        feat_h, feat_w = int(in_h * rr), int(in_w * rr)

        # Candidates in the order of the engine's noise (the reference's
        # np.random.shuffle is a documented deviation).
        rows = np.repeat(np.arange(G), G)
        cols = np.tile(np.arange(G), G)
        cand = (sim.reshape(-1) > cfg.pos_sim_thresh) \
            & (rows < feat_h) & (cols < feat_w)
        order = np.argsort(np.where(cand, rand, 2.0), kind="stable")
        rows, cols, alive = rows[order], cols[order], cand[order]
        if "coords" in parts:
            # Reference expression (model.py:219-223): divide by f32 ratio.
            px = (cols.astype(np.float32)
                  / np.float32(feat_w / in_w)).astype(np.int32)
            py = (rows.astype(np.float32)
                  / np.float32(feat_h / in_h)).astype(np.int32)
        else:
            # Engine expression: floor(col * (in_w / feat_w)) in f32.
            px = np.floor(cols.astype(np.float32)
                          * (np.float32(in_w) / np.float32(feat_w))
                          ).astype(np.int32)
            py = np.floor(rows.astype(np.float32)
                          * (np.float32(in_h) / np.float32(feat_h))
                          ).astype(np.int32)
        points = np.stack([px, py], axis=1)[alive]

        # Prompt-frame transform (ResizeLongestSide.apply_coords in f32).
        scale = np.float32(S) / np.float32(max(in_h, in_w))
        new_h = np.floor(np.float32(in_h) * scale + np.float32(0.5))
        new_w = np.floor(np.float32(in_w) * scale + np.float32(0.5))
        factor = np.asarray([new_w / np.float32(in_w),
                             new_h / np.float32(in_h)], np.float32)

        features = pred.get_image_embedding()
        dense_pe = pred.dense_pe
        dino_proj = pred.dino_proj_256
        if dino_proj is None:
            dino_proj = torch.zeros((R, R, 256), device=features.device)

        occ_img = "occupy" in parts
        occupy = np.zeros((in_h, in_w) if occ_img else (R, R), dtype=bool)
        lr_scale = np.float32(R / S)
        dets = dict(iou=[], cat=[], stab=[], box=[], ref=[])
        m_handles = []
        consumed = 0
        while len(points) > 0 and consumed < cfg.max_prompts:
            bs = min(K, len(points))
            batch = points[:bs]
            points = points[bs:]
            pad = np.zeros((K, 2), np.float32)
            pad[:bs] = batch.astype(np.float32) * factor
            f, occ_new, m_sel = self._step(parts, (in_h, in_w), features,
                                           dense_pe, dino_proj, pad, bs)
            m_handles.append(m_sel)
            for i in np.nonzero(f["keep"][:bs])[0]:
                dets["iou"].append(f["iou"][i])
                dets["cat"].append(f["cat"][i])
                dets["stab"].append(f["stab"][i])
                dets["box"].append(f["boxes"][i])
                dets["ref"].append((len(m_handles) - 1, i))

            # Occupy update -- OVERWRITE each batch (model.py:246 quirk) --
            # then prune the remaining candidates (:238-239).
            occupy = (occupy | occ_new) if cfg.accumulate_occupy else occ_new
            if len(points):
                if occ_img:
                    oy = np.clip(points[:, 1], 0, in_h - 1)
                    ox = np.clip(points[:, 0], 0, in_w - 1)
                else:
                    oy = np.clip((points[:, 1].astype(np.float32) * lr_scale)
                                 .astype(np.int32), 0, R - 1)
                    ox = np.clip((points[:, 0].astype(np.float32) * lr_scale)
                                 .astype(np.int32), 0, R - 1)
                points = points[~occupy[oy, ox]]
            consumed += bs

        empty = dict(num_consumed=consumed, n_prenms=0, n_changed=0,
                     n_dropped_renms=0,
                     boxes=np.zeros((0, 4)), scores=np.zeros(0),
                     categories=np.zeros(0, np.int64), stability=np.zeros(0))
        if not dets["iou"]:
            return empty
        iou = np.asarray(dets["iou"])
        cat = np.asarray(dets["cat"], np.int64)
        stab = np.asarray(dets["stab"])
        box = np.stack(dets["box"])
        ref = dets["ref"]
        n_prenms = len(iou)

        # Box NMS over all detections (model.py:257-263).
        keep = _np_nms(box, iou, cfg.box_nms_thresh)
        if parts != ALL_PARTS:
            # Engine survivor cap: top max_keep by score.  Dropped for the
            # full-exact semantics.
            sc = np.where(keep, iou, -np.inf)
            top = np.argsort(-sc, kind="stable")[: cfg.max_keep]
            keep = np.zeros_like(keep)
            keep[top[np.isfinite(sc[top])]] = True
        sel = np.nonzero(keep)[0]
        iou, cat, stab, box = (a[sel] for a in (iou, cat, stab, box))
        ref = [ref[i] for i in sel]
        n = len(sel)
        if n > self.SLAB:
            # Truncating would bias the metric, so fail loudly.
            raise ValueError(f"{n} NMS survivors exceed probe slab "
                             f"{self.SLAB}")

        # The survivors' low-res logits, gathered on the device.
        logits = torch.stack([m_handles[bi][ri] for bi, ri in ref])
        del m_handles

        upf = "upfilter" in parts
        box_img = box if upf else box * np.float32(S / R)

        # Small-region postprocess (model.py:394-443) at resolution q:
        # S for the exact reference semantics, 512 for the "cleanup512"
        # candidate, low_res otherwise ("cleanup_fullarea" keeps low_res
        # topology but measures region areas on the full-res mask).
        exact_cleanup = "cleanup" in parts
        fullarea = "cleanup_fullarea" in parts
        q = S if exact_cleanup else (512 if "cleanup512" in parts else R)
        binm = self._binm(logits, q, (in_h, in_w) if q == S else None)
        if cfg.min_mask_region_area > 0:
            area = cfg.min_mask_region_area * (q / S) ** 2
            if fullarea:
                full_binm = self._binm(logits, S)
                f = S // R

                def _clean(m, i):
                    m1, c1 = _np_remove_small_regions_fullarea(
                        m, full_binm[i], cfg.min_mask_region_area,
                        "holes", f)
                    m2, c2 = _np_remove_small_regions_fullarea(
                        m1, full_binm[i], cfg.min_mask_region_area,
                        "islands", f)
                    return m2, c1 or c2
            else:
                def _clean(m, i):
                    m1, c1 = _np_remove_small_regions(m, area, "holes")
                    m2, c2 = _np_remove_small_regions(m1, area, "islands")
                    return m2, c1 or c2
            cleaned, changed = [], []
            for i, m in enumerate(binm):
                m2, c = _clean(m, i)
                cleaned.append(m2)
                changed.append(c)
            cleaned = np.stack(cleaned)
            changed = np.asarray(changed)
            new_boxes = _np_mask_to_box(cleaned)
            thresh2 = max(cfg.box_nms_thresh, cfg.crop_nms_thresh)
            order = (np.arange(n) if renms_order == "detection"
                     else np.argsort(-iou, kind="stable"))
            keep2 = np.zeros(n, dtype=bool)
            keep2[order] = _np_nms(new_boxes[order],
                                   (~changed[order]).astype(np.float32),
                                   thresh2)
            sel2 = np.nonzero(keep2)[0]
        else:
            cleaned = binm
            changed = np.zeros(n, dtype=bool)
            new_boxes = np.zeros((n, 4), np.float32)
            sel2 = np.arange(n)
        n_changed = int(changed.sum())
        n_dropped_renms = n - len(sel2)
        if len(sel2) == 0:
            empty.update(n_prenms=n_prenms, n_changed=n_changed,
                         n_dropped_renms=n_dropped_renms)
            return empty

        # Final boxes.
        final_m = np.where(changed[:, None, None], cleaned, binm)
        if exact_cleanup:
            if upf:
                # Full reference semantics: unchanged masks keep the
                # in-loop image-frame box (model.py:435-440).
                boxes_final = np.where(changed[:, None], new_boxes, box_img)
            else:
                # Engine semantics at image resolution: recompute from the
                # final mask, falling back to the scaled in-loop box.
                mb = _np_mask_to_box(final_m)
                nonempty = final_m.any(axis=(1, 2))
                boxes_final = np.where(nonempty[:, None], mb, box_img)
        else:
            # Engine semantics: full-res boxes from the corrected upsampled
            # mask (the survivor pass), the resolution-q box scaled up
            # where it is empty.
            fr, nonempty = self._corr_box(
                logits, binm & ~final_m, ~binm & final_m, (in_h, in_w), q)
            chg_boxes = np.where(changed[:, None],
                                 new_boxes * np.float32(S / q), box_img)
            boxes_final = np.where(nonempty[:, None], fr, chg_boxes)

        iou, cat, stab = (a[sel2] for a in (iou, cat, stab))
        boxes_final = boxes_final[sel2]
        return dict(
            num_consumed=consumed,
            n_prenms=n_prenms,
            n_changed=n_changed,
            n_dropped_renms=n_dropped_renms,
            boxes=boxes_final.astype(np.float64) / downscale,
            scores=iou,  # fuse_simmap=False path (model.py:273-289)
            categories=cat,
            stability=stab,
        )
