"""Efficient Prompt Sampler (EPS) decode engine and the survivor pass.

Counterpart of the JAX package's `pipeline/engine.py`.  With
`fused_decode` (the default) each batch goes through
`models/fused_decode.py` and the whole loop works on packed masks
(`ops/packed.py`): shared decoder tensors and the packed-flat DINO map once
per image, the occupancy bitmap in packed-flat order, packed slab logits,
and `unpack_spatial` only for the rows kept after NMS.  Without it the
plain `MaskDecoder` decodes each batch into spatial masks.  The HQ decoder
(`sam_hq`) always decodes unfused, as the JAX engine does, whatever
`fused_decode` says (so K5 and K6 do not run there).

- Candidates are the foreground-map cells above `pos_sim_thresh` inside the
  valid region, in the order of a STABLE argsort of a noise vector (every
  non-candidate cell ties at 2.0).  The noise is an input: the JAX engine
  draws it with `jax.random.uniform`, and the tests hand the same vector to
  both packages.
- Each iteration takes the first `points_per_batch` alive candidates
  (`nonzero(size=K, fill_value=N)`), decodes them, fuses the IoU as
  clamp(iou) * sigmoid(class) (a reference quirk), picks one of each
  prompt's masks (`mask_selection`: the largest fused IoU, or the largest
  or smallest area above the threshold, counted alike on packed and
  spatial masks; ties take the first mask), filters on predicted IoU,
  stability and crop edges, writes a fixed slab of `max_iters x K` rows
  (logits stored in bf16, as the JAX slab), and prunes the candidates under
  the occupy mask, which each batch OVERWRITES (a reference quirk), or ORs
  into the running mask with `accumulate_occupy`.  The loop stops on the
  JAX `cond`: `it < max_iters and consumed < max_prompts and any(alive)`.
- Then greedy box NMS over the slab, the top `max_keep` rows by score
  (stable sort), and a per-detection summary.  The score is the fused IoU,
  or with `fuse_simmap` sqrt(clip(iou, 0)) * sqrt(clip(m + 0.5, 0, 1)),
  m the mean of the sim map (resized linearly to R x R) over the mask's
  unpacked survivor logits above the threshold.
- `survivor_core`: small-region cleanup (holes, then islands) at the
  decoder resolution with the area threshold scaled by (low_res/img_size)^2,
  boxes of the cleaned masks, and NMS that prefers unchanged masks; with
  `with_masks` (`test.output_rles: true`) also the full-resolution mask
  tail through `ops/survivor_kernel.survivor_rle` (K7): the cleanup as
  low-res edits, the packed bitmap, the full-res box and the per-column
  RLE change rows.  The JAX engine runs the pass speculatively in tiers
  inside its program, and off the TPU extracts the change rows with an
  8-slot XLA path; the results for the survivors are the same when it runs
  once over them through K7 (24 slots), as here.  With `fullres_cleanup`
  (and masks, and a positive area) the cleanup runs instead on the
  upsampled img_size^2 masks with the unscaled area, and K7 is not
  launched: the upsample, the cleanup, the boxes, the re-NMS on full-res
  boxes, the packed bitmap and the change rows are PyTorch ops, as the JAX
  package's XLA chain is there.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import torch

from crowdsam_tpu_torch.models.fused_decode import (
    fused_decode,
    precompute_decode_shared,
)
from crowdsam_tpu_torch.models.mask_decoder_hq import MaskDecoderHQ
from crowdsam_tpu_torch.ops.amg import (
    batched_mask_to_box,
    calculate_stability_score,
)
from crowdsam_tpu_torch.ops.boxes import is_box_near_crop_edge
from crowdsam_tpu_torch.ops.connected import remove_small_regions
from crowdsam_tpu_torch.ops.nms import nms_mask
from crowdsam_tpu_torch.ops.packed import (
    pack_spatial,
    packed_coord_maps,
    packed_flat_index,
    packed_mask_to_box,
    unpack_spatial,
)
from crowdsam_tpu_torch.ops.resize import resize_linear
from crowdsam_tpu_torch.ops.survivor_kernel import (
    mask_tail,
    survivor_rle,
    upsample_plain,
)

MASK_SELECTIONS = ("max_iou", "max_area", "min_area")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    grid_size: int = 192
    points_per_batch: int = 32
    max_prompts: int = 500
    n_class: int = 1
    img_size: int = 1024          # SAM input frame (padded square)
    low_res: int = 256            # decoder mask resolution
    mask_threshold: float = 0.0
    pos_sim_thresh: float = 0.5
    filter_thresh: float = 0.7
    pred_iou_thresh: float = 0.1
    stability_score_thresh: float = 0.8
    stability_score_offset: float = 1.0
    box_nms_thresh: float = 0.65
    crop_nms_thresh: float = 0.7
    min_mask_region_area: float = 100.0
    mask_selection: str = "max_iou"
    accumulate_occupy: bool = False
    fuse_simmap: bool = False
    max_keep: int = 320           # post-NMS survivor slab
    cc_max_iters: int = 192
    fused_decode: bool = True     # hoisted/low-rank decoder, packed masks
    # The cleanup on the img_size^2 masks with the unscaled area (the
    # reference's semantics); needs the masks (`test.output_rles`) and a
    # positive area, else the low-res cleanup runs.
    fullres_cleanup: bool = False

    @property
    def max_iters(self) -> int:
        return -(-self.max_prompts // self.points_per_batch)

    @property
    def slab(self) -> int:
        return self.max_iters * self.points_per_batch


def select_mask(cfg: EngineConfig, masks: torch.Tensor,
                iou_fused: torch.Tensor) -> torch.Tensor:
    """Index (K,) of each prompt's mask.  masks: (K, M, R, R) logits, or
    packed (K, M, BH*BH, 16) (a permutation of the same pixels, so areas
    are the same); iou_fused (K, M).  Ties take the first mask."""
    if cfg.mask_selection == "max_iou":
        return iou_fused.argmax(dim=-1)
    area = (masks > cfg.mask_threshold).sum(dim=(-1, -2))
    if cfg.mask_selection == "max_area":
        return area.argmax(dim=-1)
    if cfg.mask_selection == "min_area":
        return area.argmin(dim=-1)
    raise NotImplementedError(f"mask_selection {cfg.mask_selection!r}")


@torch.no_grad()
def run_eps_engine(sam, cfg: EngineConfig, features: torch.Tensor,
                   dense_pe: torch.Tensor, dino_feats_proj: torch.Tensor,
                   sim_map: torch.Tensor, feat_hw: Sequence[float],
                   input_hw: Sequence[float], crop_box: Sequence[float],
                   orig_hw: Sequence[float], downscale: float,
                   noise: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One image's decode.

    features (1, g, g, 256); dense_pe (g, g, 256); dino_feats_proj (R, R, C)
    (for the HQ decoder, {hq_features, dino_raw}: `decode_extras`);
    sim_map (G, G) foreground probability; feat_hw the valid part of sim_map;
    input_hw the resized image inside the img_size frame; crop_box, orig_hw,
    downscale the uncrop bookkeeping of the edge filter; noise (G*G,)
    uniform [0, 1) candidate-order keys.

    Returns the top `max_keep` slab rows: logits (M, R, R) bf16, summary
    (M, 12) [valid, iou, score, category, stability, consumed, box(4),
    point(2)], and `pre_nms` {iou, valid, boxes} of the whole slab."""
    dev = features.device
    G, K, R = cfg.grid_size, cfg.points_per_batch, cfg.low_res
    N, SLAB = G * G, cfg.slab
    pe, dec = sam.prompt_encoder, sam.mask_decoder
    is_hq = isinstance(dec, MaskDecoderHQ)
    fused = cfg.fused_decode and not is_hq
    BH = R // 4                   # packed base grid (the feature grid)
    if fused:
        dec_shared = precompute_decode_shared(
            dec, pe.no_mask_embed.weight, features, dense_pe)
        # (R*R, C) packed-flat DINO map
        dino_packed = pack_spatial(dino_feats_proj.movedim(-1, 0)).reshape(
            dino_feats_proj.shape[-1], -1).T.contiguous()
        xmap, ymap = packed_coord_maps(BH, BH, device=dev)

    def f32(v):
        return torch.as_tensor(v, dtype=torch.float32, device=dev)

    feat_h, feat_w = f32(feat_hw[0]), f32(feat_hw[1])
    in_h, in_w = f32(input_hw[0]), f32(input_hw[1])
    crop = f32(crop_box)
    orig_box = f32([0, 0, orig_hw[1], orig_hw[0]])
    down = f32(downscale)

    # ---- candidates in noise order
    rows = torch.arange(G, device=dev).repeat_interleave(G)
    cols = torch.arange(G, device=dev).repeat(G)
    valid_cell = (rows < feat_h) & (cols < feat_w)
    cand = (sim_map.reshape(-1) > cfg.pos_sim_thresh) & valid_cell
    key = torch.where(cand, noise.to(device=dev, dtype=torch.float32),
                      f32(2.0))
    order = torch.argsort(key, stable=True)
    rows, cols, alive = rows[order], cols[order], cand[order].clone()
    px = torch.floor(cols.float() * (in_w / feat_w)).to(torch.int64)
    py = torch.floor(rows.float() * (in_h / feat_h)).to(torch.int64)
    pts = torch.stack([px, py], dim=-1)
    lr_scale = R / cfg.img_size
    occ_py = (py.float() * lr_scale).to(torch.int64).clamp(0, R - 1)
    occ_px = (px.float() * lr_scale).to(torch.int64).clamp(0, R - 1)
    if fused:                     # the occupancy bitmap is packed-flat
        occ_idx = packed_flat_index(occ_py, occ_px, BH)
    else:
        occ_idx = occ_py * R + occ_px
    # ResizeLongestSide.apply_coords into the prompt frame.
    scale = f32(cfg.img_size) / torch.maximum(in_h, in_w)
    coord_factor = torch.stack([torch.floor(in_w * scale + 0.5) / in_w,
                                torch.floor(in_h * scale + 0.5) / in_h])

    # ---- slab
    slab_logits = torch.zeros((SLAB, BH * BH, 16) if fused else (SLAB, R, R),
                              dtype=torch.bfloat16, device=dev)
    slab_iou = torch.full((SLAB,), float("-inf"), device=dev)
    slab_cat = torch.zeros((SLAB,), dtype=torch.int64, device=dev)
    slab_stab = torch.zeros((SLAB,), device=dev)
    slab_boxes = torch.zeros((SLAB, 4), device=dev)
    slab_points = torch.zeros((SLAB, 2), device=dev)
    slab_valid = torch.zeros((SLAB,), dtype=torch.bool, device=dev)
    ar = torch.arange(K, device=dev)
    labels = torch.ones((K, 1), dtype=torch.int64, device=dev)
    occupy = torch.zeros((R * R,), dtype=torch.bool, device=dev)

    it = consumed = 0
    while it < cfg.max_iters and consumed < cfg.max_prompts and bool(
            alive.any()):
        idx = torch.nonzero(alive).flatten()[:K]
        sel = torch.full((K,), N, dtype=torch.int64, device=dev)
        sel[: idx.shape[0]] = idx
        alive[idx] = False
        consumed += int(idx.shape[0])
        sel_ok = sel < N
        coords = pts[sel.clamp(max=N - 1)].float()

        sparse, dense = pe(points=((coords * coord_factor)[:, None, :],
                                   labels))
        if fused:                 # masks (K, 4, BH*BH, 16) packed
            masks, iou_pred, cls_scores = fused_decode(
                dec, dec_shared, sparse, True, dino_feats_proj=dino_packed,
                packed_masks=True)
        elif is_hq:               # masks (K, 3, R, R): SAM masks 1-3
            masks, iou_pred, cls_scores = dec(
                features, dense_pe, sparse, dense, True,
                hq_features=dino_feats_proj["hq_features"],
                dino_feats_256=dino_feats_proj["dino_raw"])
        else:                     # masks (K, 4, R, R)
            masks, iou_pred, cls_scores = dec(
                features, dense_pe, sparse, dense, True,
                dino_feats_proj=dino_feats_proj)
        iou_fused = (iou_pred.clamp(min=0.0)
                     * torch.sigmoid(cls_scores.max(dim=-1).values))
        categories = cls_scores.argmax(dim=-1)
        ind = select_mask(cfg, masks, iou_fused)
        m_sel, iou_sel = masks[ar, ind], iou_fused[ar, ind]
        cat_sel = categories[ar, ind]

        keep = sel_ok.clone()
        if cfg.pred_iou_thresh > 0.0:
            keep &= iou_sel > cfg.pred_iou_thresh
        stab = calculate_stability_score(m_sel, cfg.mask_threshold,
                                         cfg.stability_score_offset).float()
        if cfg.stability_score_thresh > 0.0:
            keep &= stab >= cfg.stability_score_thresh
        binm = m_sel > cfg.mask_threshold
        if fused:
            boxes_lr = packed_mask_to_box(binm, xmap, ymap, BH, BH).float()
        else:
            boxes_lr = batched_mask_to_box(binm).float()
        keep &= ~is_box_near_crop_edge(boxes_lr * (cfg.img_size / R), crop,
                                       orig_box, down)

        hot = binm & (keep & (iou_sel > cfg.filter_thresh))[:, None, None]
        occ_new = hot.any(dim=0).reshape(-1)
        # Overwritten each batch (the reference quirk) unless accumulated.
        occupy = (occupy | occ_new) if cfg.accumulate_occupy else occ_new
        alive &= ~occupy[occ_idx]

        rs = slice(it * K, (it + 1) * K)
        slab_logits[rs] = m_sel.to(torch.bfloat16)
        slab_iou[rs] = torch.where(keep, iou_sel, f32(float("-inf")))
        slab_cat[rs] = cat_sel
        slab_stab[rs] = stab
        slab_boxes[rs] = boxes_lr
        slab_points[rs] = coords
        slab_valid[rs] = keep
        it += 1

    # ---- NMS over the slab, top max_keep by score
    keep_nms = nms_mask(slab_boxes, slab_iou, cfg.box_nms_thresh, slab_valid)
    score_key = torch.where(keep_nms, slab_iou, f32(float("-inf")))
    top = torch.argsort(-score_key, stable=True)[: cfg.max_keep]
    logits = slab_logits[top]
    if fused:
        logits = unpack_spatial(logits, BH, BH)
    iou, valid = slab_iou[top], keep_nms[top]
    m = top.shape[0]
    if cfg.fuse_simmap:
        masks = (logits.float() > cfg.mask_threshold) & valid[:, None, None]
        sim_lr = resize_linear(sim_map.float(), (R, R), axes=(-2, -1))
        msum = masks.sum(dim=(1, 2))
        mean_sim = torch.where(
            msum > 0, (masks * sim_lr).sum(dim=(1, 2)) / msum.clamp(min=1),
            f32(0.0))
        scores = (iou.clamp(min=0.0).sqrt()
                  * (mean_sim + 0.5).clamp(0.0, 1.0).sqrt())
    else:
        scores = iou
    summary = torch.cat([
        valid[:, None].float(), iou[:, None], scores[:, None],
        slab_cat[top][:, None].float(), slab_stab[top][:, None],
        torch.full((m, 1), float(consumed), device=dev),
        slab_boxes[top], slab_points[top],
    ], dim=1)
    return {
        "logits": logits,
        "summary": summary,
        "num_consumed": consumed,
        "pre_nms": {"iou": slab_iou, "valid": slab_valid,
                    "boxes": slab_boxes},
    }


@torch.no_grad()
def survivor_core(cfg: EngineConfig, logits: torch.Tensor, in_hw=None,
                  with_masks: bool = False):
    """Survivor pass over (k, R, R) survivor logits.

    Box only (`with_masks` false): (k, 6) [keep, changed, low-res box(4)],
    the first columns of the JAX survivor summary.  With `with_masks` and
    in_hw (2,) int32, the resized image inside the S = img_size frame: a
    dict of the JAX survivor pass's (k, 12) summary [keep, changed, low-res
    box(4), full-res box(4), n_changes, nonempty], K7's packed (k, S, S/8),
    cand (k, 8, S) and n_col (k, S), and overflow (k,) bool: a column holds
    more change rows than `cand` keeps, so the RLE needs `packed`.  With
    `fullres_cleanup` and a positive area, the same outputs from the
    full-resolution cleanup (`_fullres_survivors`)."""
    k = logits.shape[0]
    dev = logits.device
    thresh = max(cfg.box_nms_thresh, cfg.crop_nms_thresh)
    if with_masks and cfg.fullres_cleanup and cfg.min_mask_region_area > 0:
        return _fullres_survivors(cfg, logits, in_hw, thresh)
    binm = logits.float() > cfg.mask_threshold
    valid = torch.ones((k,), dtype=torch.bool, device=dev)
    if cfg.min_mask_region_area > 0:
        area = cfg.min_mask_region_area * (cfg.low_res / cfg.img_size) ** 2
        m1, ch1 = remove_small_regions(binm, area, "holes", cfg.cc_max_iters)
        m2, ch2 = remove_small_regions(m1, area, "islands", cfg.cc_max_iters)
        unchanged = ~(ch1 | ch2)
        new_boxes = batched_mask_to_box(m2).float()
        keep = nms_mask(new_boxes, unchanged.float(), thresh, valid)
        changed = ~unchanged
    else:
        m2 = binm
        new_boxes = batched_mask_to_box(binm).float()
        keep = valid
        changed = torch.zeros((k,), dtype=torch.bool, device=dev)
    head = torch.cat([keep[:, None].float(), changed[:, None].float(),
                      new_boxes], dim=1)
    if not with_masks:
        return head
    # The cleanup as low-res edits: +1 where it filled a hole, -1 where it
    # removed an island.
    edit = (~binm & m2).to(torch.int8) - (binm & ~m2).to(torch.int8)
    out = survivor_rle(logits, edit, in_hw, thresh=cfg.mask_threshold)
    ksum = out.pop("summary")
    out["summary"] = torch.cat([
        head, ksum[:, :4].float(), ksum[:, 5:6].float(),
        ksum[:, 4:5].float()], dim=1)
    out["overflow"] = ksum[:, 6] > 0
    return out


def _fullres_survivors(cfg: EngineConfig, logits: torch.Tensor, in_hw,
                       thresh: float):
    """`survivor_core` with masks under `fullres_cleanup`: the JAX
    package's XLA chain in PyTorch ops.  The logits are upsampled to S =
    img_size (`jax.image.resize` linear), thresholded and cropped to the
    valid region; holes, then islands, below the unscaled
    min_mask_region_area are removed at S^2; the re-NMS prefers unchanged
    masks on full-res boxes; the low-res box columns hold the full-res
    boxes scaled by R / S.  The packed bitmap and the change rows come from
    the cleaned masks (`mask_tail`)."""
    k = logits.shape[0]
    s = cfg.img_size
    full = upsample_plain(logits) > cfg.mask_threshold
    hw = torch.as_tensor(in_hw, dtype=torch.int64, device=logits.device)
    ys = torch.arange(s, device=logits.device)
    full &= (ys[:, None] < hw[0]) & (ys[None, :] < hw[1])
    f1, ch1 = remove_small_regions(full, cfg.min_mask_region_area, "holes",
                                   cfg.cc_max_iters)
    full, ch2 = remove_small_regions(f1, cfg.min_mask_region_area,
                                     "islands", cfg.cc_max_iters)
    unchanged = ~(ch1 | ch2)
    fr_boxes = batched_mask_to_box(full).float()
    keep = nms_mask(fr_boxes, unchanged.float(), thresh,
                    torch.ones((k,), dtype=torch.bool, device=full.device))
    out = mask_tail(full, hw[None].expand(k, 2))
    ksum = out.pop("summary")
    out["summary"] = torch.cat([
        keep[:, None].float(), (~unchanged)[:, None].float(),
        fr_boxes * (cfg.low_res / s), ksum[:, :4].float(),
        ksum[:, 5:6].float(), ksum[:, 4:5].float()], dim=1)
    out["overflow"] = ksum[:, 6] > 0
    return out
