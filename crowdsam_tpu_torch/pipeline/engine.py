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

Batched (`run_eps_engine_batch`, `survivor_core_batch`; the JAX package's
`jax.vmap` of the engine and `make_survivor_pass_batched`): B images run
one lockstep loop, each with its own candidate order, alive set,
occupancy, consumed count and slab, one host sync an iteration, and the
prompts of every running image in one decode; then one survivor pass over
the flattened survivors.  The single-image functions are these with B = 1.

Prompt-sharded (`shard`, a `parallel.collectives.Shard` of M ranks; the
JAX engine's `shard_axis` / `shard_num` under `shard_map`): every rank
holds the same inputs and selects the same K candidates of each running
image, so `alive` and `consumed` stay replicated; rank r decodes only the
prompts [r K/M, (r+1) K/M) of each and writes them to a slab of
`max_iters x K/M` rows.  The occupancy is OR-reduced over the ranks once a
lockstep iteration (one all-reduce, whatever `accumulate_occupy` says).
After the loop the per-row scalars are gathered in iteration-major order
(row it K + r K/M + j of the whole slab is rank r's row it K/M + j), the
NMS and the top `max_keep` run replicated, and the top rows' logits are
assembled from their owners by a masked sum: two all-reduces.  The result
equals the single-rank engine's on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
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
from crowdsam_tpu_torch.parallel.collectives import (
    Shard,
    gather_rows,
    masked_psum,
    or_reduce,
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


def check_shard(cfg: EngineConfig, m: int):
    """Raise unless a prompt batch of `cfg` divides over `m` ranks."""
    if cfg.points_per_batch % m:
        raise ValueError(
            f"points_per_batch {cfg.points_per_batch} does not divide over "
            f"{m} prompt shards: every rank decodes the same number of "
            "prompts a batch")


@torch.no_grad()
def run_eps_engine(sam, cfg: EngineConfig, features: torch.Tensor,
                   dense_pe: torch.Tensor, dino_feats_proj: torch.Tensor,
                   sim_map: torch.Tensor, feat_hw: Sequence[float],
                   input_hw: Sequence[float], crop_box: Sequence[float],
                   orig_hw: Sequence[float], downscale: float,
                   noise: torch.Tensor,
                   shard: Optional[Shard] = None) -> Dict[str, torch.Tensor]:
    """One image's decode: `run_eps_engine_batch` with B = 1.

    features (1, g, g, 256); dense_pe (g, g, 256); dino_feats_proj (R, R, C)
    (for the HQ decoder, {hq_features, dino_raw}: `decode_extras`);
    sim_map (G, G) foreground probability; feat_hw the valid part of sim_map;
    input_hw the resized image inside the img_size frame; crop_box, orig_hw,
    downscale the uncrop bookkeeping of the edge filter; noise (G*G,)
    uniform [0, 1) candidate-order keys.

    Returns the top `max_keep` slab rows: logits (M, R, R) bf16, summary
    (M, 12) [valid, iou, score, category, stability, consumed, box(4),
    point(2)], `num_consumed`, `pre_nms` {iou, valid, boxes} of the whole
    slab and `loop` {iterations, syncs, collectives, reduced_bytes,
    reduced_bytes_in_loop}.
    `shard`: decode this rank's share of every batch (the module's note).
    """
    extras = (dino_feats_proj if isinstance(dino_feats_proj, dict)
              else dino_feats_proj[None])
    return run_eps_engine_batch(
        sam, cfg, features, dense_pe, extras, sim_map[None], [feat_hw],
        [input_hw], [crop_box], [orig_hw], [downscale], noise[None],
        shard=shard)[0]


@torch.no_grad()
def run_eps_engine_batch(sam, cfg: EngineConfig, features: torch.Tensor,
                         dense_pe: torch.Tensor, decode_extras,
                         sim_map: torch.Tensor, feat_hw, input_hw, crop_box,
                         orig_hw, downscale, noise: torch.Tensor,
                         shard: Optional[Shard] = None) -> list:
    """B images' decode in lockstep (the JAX package's `jax.vmap` of the
    engine): one list entry a image, each what `run_eps_engine` returns.

    features (B, g, g, 256); dense_pe (g, g, 256); decode_extras (B, R, R,
    C) (the HQ decoder: B = 1 and its dict); sim_map (B, G, G); feat_hw,
    input_hw, orig_hw (B, 2), crop_box (B, 4), downscale (B,) (sequences or
    tensors); noise (B, G*G).

    Every image keeps its own candidate order, alive set, occupancy,
    consumed count and slab.  Each iteration reads on the host which images
    still run (`it < max_iters`, consumed < max_prompts and a candidate
    alive): that one host sync a lockstep iteration is the loop's only one,
    so a batch of any B takes one a lockstep iteration, and one more that
    finds no image running unless the loop stops at max_iters.  The
    running images each send their next K alive candidates, chosen on the
    device by a rank of the running sum of `alive`; their B' x K prompts go
    through one decode (with `fused_decode` one K5 and one K6 call); an
    image that stopped sends nothing and keeps its state.  Then the slab
    NMS and the top `max_keep` a image.

    `shard`: each running image's K prompts are split over the shard's M
    ranks (the module's note); K must divide over M.  `loop` then also
    counts the all-reduces (one a lockstep iteration, two after the loop)
    and the bytes they reduced, in the loop and in all."""
    if shard is not None:
        check_shard(cfg, shard.size)
    calls0, bytes0 = ((shard.calls, shard.bytes) if shard is not None
                      else (0, 0))
    st = _eps_loop(sam, cfg, features, dense_pe, decode_extras, sim_map,
                   feat_hw, input_hw, crop_box, orig_hw, downscale, noise,
                   shard)
    consumed = st.pop("consumed").tolist()
    loop = {"iterations": st.pop("iterations"), "syncs": st.pop("syncs")}
    packed = cfg.fused_decode and not isinstance(sam.mask_decoder,
                                                 MaskDecoderHQ)
    n_img = features.shape[0]
    if shard is not None:
        loop["reduced_bytes_in_loop"] = shard.bytes - bytes0
        _gather_scalars(cfg, st, shard)
    picks = [_eps_top(cfg, {k: v[b] for k, v in st.items()})
             for b in range(n_img)]
    if shard is None:
        rows = [st["logits"][b][top] for b, (_, top) in enumerate(picks)]
        loop.update(collectives=0, reduced_bytes=0, reduced_bytes_in_loop=0)
    else:
        rows = _top_rows(cfg, st["logits"], [top for _, top in picks],
                         shard)
        loop.update(collectives=shard.calls - calls0,
                    reduced_bytes=shard.bytes - bytes0)
    out = []
    for b in range(n_img):
        res = _eps_finish(cfg, {k: v[b] for k, v in st.items()},
                          *picks[b], rows[b], sim_map[b], consumed[b],
                          packed)
        res["loop"] = loop
        out.append(res)
    return out


# The per-row scalars of the slab, gathered over the prompt shards as one
# int32 buffer: (name, columns); floats travel as their bits.
_SCALARS = (("iou", 1), ("cat", 1), ("stab", 1), ("boxes", 4),
            ("points", 2), ("valid", 1))


def _gather_scalars(cfg: EngineConfig, st: Dict, shard: Shard) -> None:
    """Replace each rank's (B, max_iters K/M) per-row scalars in `st` by
    the whole slab's (B, max_iters K) in iteration-major order, in one
    all-reduce (the JAX engine's all-gather of iou, cat, stab, boxes,
    points and valid)."""
    cols = []
    for name, _ in _SCALARS:
        v = st[name]
        v = v[..., None] if v.dim() == 2 else v
        if v.dtype == torch.float32:
            cols.append(v.contiguous().view(torch.int32))
        else:
            cols.append(v.to(torch.int32))
    local = torch.cat(cols, dim=-1)                 # (B, iters KL, W)
    n_img, w = local.shape[0], local.shape[-1]
    kl = cfg.points_per_batch // shard.size
    full = gather_rows(local, shard)                # (M, B, iters KL, W)
    full = full.reshape(shard.size, n_img, cfg.max_iters, kl, w)
    full = full.permute(1, 2, 0, 3, 4).reshape(n_img, cfg.slab, w)
    c = 0
    for name, n in _SCALARS:
        part = full[..., c:c + n].contiguous()
        c += n
        if st[name].dtype == torch.float32:
            part = part.view(torch.float32)
        else:
            part = part.to(st[name].dtype)
        st[name] = part[..., 0] if st[name].dim() == 2 else part


def _top_rows(cfg: EngineConfig, logits: torch.Tensor, tops: list,
              shard: Shard) -> torch.Tensor:
    """The slab logits of each image's top rows (whole-slab indices
    `tops`, one (T,) a image) from the ranks that decoded them: each rank
    gives the rows it owns and zeros elsewhere, one masked sum for all
    images (the JAX engine's masked psum)."""
    k = cfg.points_per_batch
    kl = k // shard.size
    top = torch.stack(tops)                         # (B, T)
    rem = top % k
    owner = rem // kl
    local = (top // k) * kl + rem % kl
    rows = logits[torch.arange(top.shape[0], device=top.device)[:, None],
                  local]
    return masked_psum(rows, owner == shard.rank, shard)


def _to_device(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A CPU tensor on `dev`; to the card from pinned memory without
    waiting (a plain copy to the card synchronizes the host with it)."""
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def _eps_loop(sam, cfg: EngineConfig, features, dense_pe, decode_extras,
              sim_map, feat_hw, input_hw, crop_box, orig_hw, downscale,
              noise, shard: Optional[Shard] = None
              ) -> Dict[str, torch.Tensor]:
    """The lockstep while-loop of `run_eps_engine_batch`: the slabs (B,
    SLAB, ...), the consumed counts (B,) and the loop's counts.  With
    `shard` the slabs hold this rank's max_iters x K/M rows."""
    dev = features.device
    n_img = features.shape[0]
    G, K, R = cfg.grid_size, cfg.points_per_batch, cfg.low_res
    # This rank's prompts of each batch: [k0, k0 + KL) of the K selected.
    KL = K if shard is None else K // shard.size
    k0 = 0 if shard is None else shard.rank * KL
    N, SLAB = G * G, cfg.max_iters * KL
    pe, dec = sam.prompt_encoder, sam.mask_decoder
    is_hq = isinstance(dec, MaskDecoderHQ)
    fused = cfg.fused_decode and not is_hq
    one = n_img == 1              # one image: the unbatched decode operands
    if is_hq and not one:
        raise NotImplementedError(
            "the HQ decoder decodes one image at a time (the JAX package's "
            "batched path fails on it too)")
    BH = R // 4                   # packed base grid (the feature grid)
    if fused:
        dec_shared = precompute_decode_shared(
            dec, pe.no_mask_embed.weight, features, dense_pe)
        # (B, R*R, C) packed-flat DINO maps
        dino_packed = torch.stack([
            pack_spatial(d.movedim(-1, 0)).reshape(d.shape[-1], -1).T
            for d in decode_extras]).contiguous()
        xmap, ymap = packed_coord_maps(BH, BH, device=dev)

    # The per-image bookkeeping and the noise reach the device in copies
    # that do not wait for it (no host sync before the loop).
    host = np.concatenate([
        np.asarray(v, np.float32).reshape(n_img, -1) for v in (
            feat_hw, input_hw, crop_box, orig_hw, downscale,
            [cfg.img_size] * n_img)], axis=1)
    book = _to_device(torch.from_numpy(host), dev)
    feat_h, feat_w, in_h, in_w = (book[:, i:i + 1] for i in range(4))
    crop = book[:, 4:8]
    zero = torch.zeros_like(book[:, 0])
    orig_box = torch.stack([zero, zero, book[:, 9], book[:, 8]], dim=1)
    down, img_size = book[:, 10], book[:, 11:12]

    # ---- candidates in noise order, one row a image
    rows = torch.arange(G, device=dev).repeat_interleave(G)
    cols = torch.arange(G, device=dev).repeat(G)
    valid_cell = (rows < feat_h) & (cols < feat_w)     # (B, N)
    cand = (sim_map.reshape(n_img, N) > cfg.pos_sim_thresh) & valid_cell
    noise = _to_device(noise.to(torch.float32), dev).reshape(n_img, N)
    key = torch.where(cand, noise, 2.0)
    order = torch.argsort(key, dim=1, stable=True)
    rows, cols, alive = rows[order], cols[order], cand.gather(1, order)
    px = torch.floor(cols.float() * (in_w / feat_w)).to(torch.int64)
    py = torch.floor(rows.float() * (in_h / feat_h)).to(torch.int64)
    pts = torch.stack([px, py], dim=-1)                 # (B, N, 2)
    lr_scale = R / cfg.img_size
    occ_py = (py.float() * lr_scale).to(torch.int64).clamp(0, R - 1)
    occ_px = (px.float() * lr_scale).to(torch.int64).clamp(0, R - 1)
    if fused:                     # the occupancy bitmap is packed-flat
        occ_idx = packed_flat_index(occ_py, occ_px, BH)
    else:
        occ_idx = occ_py * R + occ_px
    # ResizeLongestSide.apply_coords into the prompt frame.
    scale = img_size / torch.maximum(in_h, in_w)
    coord_factor = torch.cat([torch.floor(in_w * scale + 0.5) / in_w,
                              torch.floor(in_h * scale + 0.5) / in_h], dim=1)

    # ---- slabs
    mshape = (BH * BH, 16) if fused else (R, R)
    slab_logits = torch.zeros((n_img, SLAB) + mshape, dtype=torch.bfloat16,
                              device=dev)
    slab_iou = torch.full((n_img, SLAB), float("-inf"), device=dev)
    slab_cat = torch.zeros((n_img, SLAB), dtype=torch.int64, device=dev)
    slab_stab = torch.zeros((n_img, SLAB), device=dev)
    slab_boxes = torch.zeros((n_img, SLAB, 4), device=dev)
    slab_points = torch.zeros((n_img, SLAB, 2), device=dev)
    slab_valid = torch.zeros((n_img, SLAB), dtype=torch.bool, device=dev)
    ar = torch.arange(n_img * KL, device=dev)
    labels = torch.ones((n_img * KL, 1), dtype=torch.int64, device=dev)
    occupy = torch.zeros((n_img, R * R), dtype=torch.bool, device=dev)
    consumed = torch.zeros((n_img,), dtype=torch.int64, device=dev)
    all_imgs = torch.arange(n_img, device=dev)
    cand_idx = torch.arange(N, device=dev)

    it = syncs = 0
    while it < cfg.max_iters:
        # The loop's one host sync: which images still run.
        running = ((consumed < cfg.max_prompts) & alive.any(dim=1)).cpu()
        syncs += 1
        act = torch.nonzero(running).flatten()
        n_act = int(act.shape[0])
        if n_act == 0:
            break
        if n_act == n_img:
            ia, act_d = slice(None), all_imgs
        else:
            ia = act_d = _to_device(act, dev)
        p_cnt = n_act * KL
        # Each running image's next K alive candidates (N pads a short
        # batch), by the rank of each candidate among the alive ones; this
        # rank decodes KL of them (all K unsharded).
        al = alive[ia]
        rank = torch.cumsum(al, dim=1) - 1
        take = al & (rank < K)
        sel = torch.full((n_act, K + 1), N, dtype=torch.int64, device=dev)
        sel.scatter_(1, torch.where(take, rank, K),
                     cand_idx.expand(n_act, N))
        sel = sel[:, k0:k0 + KL]
        al = al & ~take
        consumed[ia] = consumed[ia] + take.sum(dim=1)
        sel_ok = (sel < N).reshape(p_cnt)
        coords = pts[ia].gather(
            1, sel.clamp(max=N - 1)[..., None].expand(n_act, KL, 2)).float()

        sparse, dense = pe(points=(
            (coords * coord_factor[ia][:, None, :]).reshape(p_cnt, 1, 2),
            labels[:p_cnt]))
        if fused:                 # masks (P, 4, BH*BH, 16) packed
            if one:
                masks, iou_pred, cls_scores = fused_decode(
                    dec, dec_shared, sparse, True,
                    dino_feats_proj=dino_packed[0], packed_masks=True)
            else:
                img = act_d.to(torch.int32)[:, None].expand(
                    n_act, KL).reshape(p_cnt)
                masks, iou_pred, cls_scores = fused_decode(
                    dec, dec_shared, sparse, True,
                    dino_feats_proj=dino_packed[ia], packed_masks=True,
                    img=img)
        elif is_hq:               # masks (K, 3, R, R): SAM masks 1-3
            masks, iou_pred, cls_scores = dec(
                features, dense_pe, sparse, dense, True,
                hq_features=decode_extras["hq_features"],
                dino_feats_256=decode_extras["dino_raw"])
        elif one:                 # masks (K, 4, R, R)
            masks, iou_pred, cls_scores = dec(
                features, dense_pe, sparse, dense, True,
                dino_feats_proj=decode_extras[0])
        else:                     # each prompt with its image's features
            feats = features[ia][:, None].expand(
                n_act, KL, *features.shape[1:]).reshape(
                    p_cnt, *features.shape[1:])
            masks, iou_pred, cls_scores = dec(
                feats, dense_pe, sparse, dense, True,
                dino_feats_proj=decode_extras[ia])
        iou_fused = (iou_pred.clamp(min=0.0)
                     * torch.sigmoid(cls_scores.max(dim=-1).values))
        categories = cls_scores.argmax(dim=-1)
        ind = select_mask(cfg, masks, iou_fused)
        pa = ar[:p_cnt]
        m_sel, iou_sel = masks[pa, ind], iou_fused[pa, ind]
        cat_sel = categories[pa, ind]

        keep = sel_ok
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
        keep &= ~is_box_near_crop_edge(
            (boxes_lr * (cfg.img_size / R)).reshape(n_act, KL, 4),
            crop[ia][:, None], orig_box[ia][:, None],
            down[ia][:, None, None]).reshape(p_cnt)

        hot = binm & (keep & (iou_sel > cfg.filter_thresh))[:, None, None]
        occ_new = hot.reshape(n_act, KL, -1).any(dim=1)
        if shard is not None:     # the OR over every rank's prompts
            occ_new = or_reduce(occ_new, shard)
        # Overwritten each batch (the reference quirk) unless accumulated.
        occ = (occupy[ia] | occ_new) if cfg.accumulate_occupy else occ_new
        occupy[ia] = occ
        alive[ia] = al & ~occ.gather(1, occ_idx[ia])

        rs = slice(it * KL, (it + 1) * KL)
        slab_logits[ia, rs] = m_sel.to(torch.bfloat16).reshape(
            n_act, KL, *mshape)
        slab_iou[ia, rs] = torch.where(keep, iou_sel,
                                       float("-inf")).reshape(n_act, KL)
        slab_cat[ia, rs] = cat_sel.reshape(n_act, KL)
        slab_stab[ia, rs] = stab.reshape(n_act, KL)
        slab_boxes[ia, rs] = boxes_lr.reshape(n_act, KL, 4)
        slab_points[ia, rs] = coords
        slab_valid[ia, rs] = keep.reshape(n_act, KL)
        it += 1
    return {"logits": slab_logits, "iou": slab_iou, "cat": slab_cat,
            "stab": slab_stab, "boxes": slab_boxes, "points": slab_points,
            "valid": slab_valid, "consumed": consumed, "iterations": it,
            "syncs": syncs}


def _eps_top(cfg: EngineConfig, slab: Dict[str, torch.Tensor]):
    """One image's slab NMS (keep mask over the slab) and its top
    `max_keep` rows by score (stable sort)."""
    slab_iou = slab["iou"]
    keep_nms = nms_mask(slab["boxes"], slab_iou, cfg.box_nms_thresh,
                        slab["valid"])
    score_key = torch.where(keep_nms, slab_iou, torch.tensor(
        float("-inf"), device=slab_iou.device))
    return keep_nms, torch.argsort(-score_key, stable=True)[: cfg.max_keep]


def _eps_finish(cfg: EngineConfig, slab: Dict[str, torch.Tensor],
                keep_nms: torch.Tensor, top: torch.Tensor,
                logits: torch.Tensor, sim_map: torch.Tensor, consumed: int,
                packed: bool) -> Dict:
    """One image's result (`run_eps_engine`'s) from its slab, its NMS keep
    mask and top rows (`_eps_top`) and those rows' slab logits: the
    per-detection summary; `packed`: the slab logits are packed (the
    fused decode)."""
    dev = slab["iou"].device
    R = cfg.low_res
    slab_iou, slab_valid, slab_boxes = slab["iou"], slab["valid"], \
        slab["boxes"]
    if packed:
        logits = unpack_spatial(logits, R // 4, R // 4)
    iou, valid = slab_iou[top], keep_nms[top]
    m = top.shape[0]
    if cfg.fuse_simmap:
        masks = (logits.float() > cfg.mask_threshold) & valid[:, None, None]
        sim_lr = resize_linear(sim_map.float(), (R, R), axes=(-2, -1))
        msum = masks.sum(dim=(1, 2))
        mean_sim = torch.where(
            msum > 0, (masks * sim_lr).sum(dim=(1, 2)) / msum.clamp(min=1),
            torch.tensor(0.0, device=dev))
        scores = (iou.clamp(min=0.0).sqrt()
                  * (mean_sim + 0.5).clamp(0.0, 1.0).sqrt())
    else:
        scores = iou
    summary = torch.cat([
        valid[:, None].float(), iou[:, None], scores[:, None],
        slab["cat"][top][:, None].float(), slab["stab"][top][:, None],
        torch.full((m, 1), float(consumed), device=dev),
        slab["boxes"][top], slab["points"][top],
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
    """Survivor pass over (k, R, R) survivor logits (`survivor_core_batch`
    with one image).

    Box only (`with_masks` false): (k, 6) [keep, changed, low-res box(4)],
    the first columns of the JAX survivor summary.  With `with_masks` and
    in_hw (2,) int32, the resized image inside the S = img_size frame: a
    dict of the JAX survivor pass's (k, 12) summary [keep, changed, low-res
    box(4), full-res box(4), n_changes, nonempty], K7's packed (k, S, S/8),
    cand (k, 8, S) and n_col (k, S), and overflow (k,) bool: a column holds
    more change rows than `cand` keeps, so the RLE needs `packed`.  With
    `fullres_cleanup` and a positive area, the same outputs from the
    full-resolution cleanup (`_fullres_survivors`)."""
    hw = None if in_hw is None else torch.as_tensor(
        in_hw, dtype=torch.int32, device=logits.device)[None]
    return survivor_core_batch(cfg, logits[None], [logits.shape[0]], hw,
                               with_masks)[0]


@torch.no_grad()
def survivor_core_batch(cfg: EngineConfig, logits: torch.Tensor,
                        ns: Sequence[int], in_hws=None,
                        with_masks: bool = False) -> list:
    """The survivor pass of B images at once (the JAX package's
    `make_survivor_pass_batched`): logits (B, k, R, R), of which image b's
    first ns[b] rows are its survivors; in_hws (B, 2) int32.

    The rows are flattened to (B k, R, R): the small-region cleanup runs
    once over all of them, the re-NMS per image over its valid rows, and
    with masks one K7 call covers every mask with its own image's in_hw
    (the edits of padding rows are -1: empty masks).  With
    `fullres_cleanup` (masks and a positive area) each image's rows go
    through `_fullres_survivors` instead, without K7.

    Returns one entry a image: `survivor_core`'s result over its ns[b]
    rows, or None for an image without survivors."""
    n_img, k = logits.shape[:2]
    dev = logits.device
    thresh = max(cfg.box_nms_thresh, cfg.crop_nms_thresh)
    if with_masks and cfg.fullres_cleanup and cfg.min_mask_region_area > 0:
        return [_fullres_survivors(cfg, logits[b, :n], in_hws[b], thresh)
                if n else None for b, n in enumerate(ns)]
    flat = logits.reshape(n_img * k, *logits.shape[2:])
    valid_b = torch.arange(k, device=dev)[None, :] < torch.as_tensor(
        list(ns), device=dev)[:, None]
    valid = valid_b.reshape(-1)
    binm = (flat.float() > cfg.mask_threshold) & valid[:, None, None]
    if cfg.min_mask_region_area > 0:
        area = cfg.min_mask_region_area * (cfg.low_res / cfg.img_size) ** 2
        m1, ch1 = remove_small_regions(binm, area, "holes", cfg.cc_max_iters)
        m2, ch2 = remove_small_regions(m1, area, "islands", cfg.cc_max_iters)
        unchanged = ~(ch1 | ch2)
        new_boxes = batched_mask_to_box(m2).float()
        keep = torch.cat([
            nms_mask(new_boxes[b * k:(b + 1) * k],
                     unchanged[b * k:(b + 1) * k].float(), thresh, valid_b[b])
            for b in range(n_img)])
        changed = ~unchanged & valid
    else:
        m2 = binm
        new_boxes = batched_mask_to_box(binm).float()
        keep = valid
        changed = torch.zeros((n_img * k,), dtype=torch.bool, device=dev)
    head = torch.cat([keep[:, None].float(), changed[:, None].float(),
                      new_boxes], dim=1)
    if not with_masks:
        out = head
    else:
        # The cleanup as low-res edits: +1 where it filled a hole, -1 where
        # it removed an island; -1 everywhere on a padding row.
        edit = (~binm & m2).to(torch.int8) - (binm & ~m2).to(torch.int8)
        edit = torch.where(valid[:, None, None], edit,
                           torch.tensor(-1, dtype=torch.int8, device=dev))
        hw = torch.as_tensor(in_hws, dtype=torch.int32, device=dev)[
            :, None].expand(n_img, k, 2).reshape(n_img * k, 2).contiguous()
        out = survivor_rle(flat, edit, hw, thresh=cfg.mask_threshold)
        ksum = out.pop("summary")
        out["summary"] = torch.cat([
            head, ksum[:, :4].float(), ksum[:, 5:6].float(),
            ksum[:, 4:5].float()], dim=1)
        out["overflow"] = ksum[:, 6] > 0

    def rows(b):
        r = slice(b * k, b * k + ns[b])
        return out[r] if not with_masks else {n: v[r] for n, v in out.items()}

    return [rows(b) if n else None for b, n in enumerate(ns)]


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
