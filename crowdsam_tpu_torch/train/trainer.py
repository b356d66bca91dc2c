"""The 10-shot PWD-Net adapter trainer.

Counterpart of the JAX package's `train/trainer.py` (reference
`tools/train.py`):

- `cache_features`: one dual-backbone encode per shot (under
  `torch.no_grad()`, through the encoder kernels on the card) and the
  targets: with the head-only adapter the box-prompt decodes of the model
  itself, with `train.full_decoder` the boxes as filled low-res rectangles;
  boxes padded to a multiple of 8.
- the step, in the JAX order: positive prompts at a Gumbel-argmax interior
  pixel of a random target, negatives as the top-k of Gumbel noise over the
  valid background (hard negatives from the current FG map first); the
  DINO projection, the FG map and its linear resize to the low-res frame;
  prompts mapped low-res frame -> image -> input frame; prompt encoder, the
  unfused mask decoder with the projected DINO map, fused IoU, and
  `adapter_loss`.
- gradients only for the trainable leaves (the PWD-Net heads
  `parallel_iou_head`, `point_classifier`, `dino_proj`; with `full=True`
  the whole decoder but its unused 5th hypernetwork MLP, which the JAX tree
  does not have), kept as float32 master copies while the model computes
  in its compute dtype (flax's f32 parameters with bf16 compute); every
  other parameter is frozen.  In full-decoder training the LayerNorms of
  the two-way transformer and the upscaling run K1 forward and backward on
  the card; no other kernel is on the step's path.
- the optimizer of `optax.chain(clip_by_global_norm(0.1), adamw(lr,
  weight_decay=wd))`.
- dropout stays off, as in the reference, which never puts SAM in train
  mode.
- on a (data, model) mesh (`loss_and_grads(..., mesh=...)`, the JAX
  `_build_step(cache, mesh=mesh)`): the step's prompts split over `data`
  (`split_rows`, uneven where they do not divide, as GSPMD pads) and
  decoded against the replicated image embedding; the resized DINO
  projection split by rows over `model`, each rank pooling its rows under
  the softmax weights of the whole masks and the partial pools summed
  over `model` (`collectives.sum_partials`); each rank's loss its share of
  every prompt mean, the FG-map dice (computed whole on every rank) only
  at data coordinate 0, all scaled by 1/M; the gradients then summed over
  `model` and over `data`, so every rank holds the step's gradients and
  updates its leaves alike.  Only `all_reduce` crosses ranks.

The random draws of a step (`pos_idx`, the positives' and negatives'
Gumbel noise) are an input: `jax.random` cannot be replayed here, so tests
hand in JAX's draws; otherwise they come from a CPU `torch.Generator`
seeded by (train.seed, step), so a resumed run draws what an uninterrupted
one does.  Checkpoints (msgpack) hold `{step, adapter, opt_state: {count,
mu, nu}}` with the decoder's state-dict names.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import math
import os
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.func import functional_call

from crowdsam_tpu_torch.models.common import compute_dtype, float32_entry
from crowdsam_tpu_torch.parallel.collectives import Shard
from crowdsam_tpu_torch.parallel.mesh import axis_group
from crowdsam_tpu_torch.parallel.spatial import Band, split_rows
from crowdsam_tpu_torch.ops.resize import resize_linear
from crowdsam_tpu_torch.train.losses import adapter_loss
from crowdsam_tpu_torch.utils import msgpack_io
from crowdsam_tpu_torch.utils.weights import mask_decoder_tree

ADAPTER_KEYS = ("parallel_iou_head", "point_classifier", "dino_proj")
Draws = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _unused(decoder: nn.Module) -> str:
    return f"output_hypernetworks_mlps.{decoder.num_mask_tokens}."


def split_adapter_params(params: Dict[str, torch.Tensor], full: bool = False,
                         unused: str = "output_hypernetworks_mlps.4."):
    """Decoder state dict -> (trainable, frozen) dicts.  `full`: every
    leaf is trainable but those under `unused` (the 5th hypernetwork MLP,
    never run)."""
    def trainable(name):
        if full:
            return not name.startswith(unused)
        return name.split(".", 1)[0] in ADAPTER_KEYS

    adapter = {k: v for k, v in params.items() if trainable(k)}
    frozen = {k: v for k, v in params.items() if not trainable(k)}
    return adapter, frozen


def merge_params(adapter: Dict[str, Any], frozen: Dict[str, Any]):
    out = dict(frozen)
    out.update(adapter)
    return out


class AdamW:
    """optax.chain(clip_by_global_norm(clip), adamw(lr, b1, b2, eps,
    weight_decay)) over a dict of float32 tensors: the gradients scaled by
    clip / |g| when the global norm |g| reaches `clip` (no epsilon), Adam's
    bias-corrected moments, update = -lr (adam + wd p) on every leaf."""

    def __init__(self, lr: float, weight_decay: float, clip: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.wd, self.clip = lr, weight_decay, clip
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        dev = next(iter(params.values())).device
        return {"count": torch.zeros((), dtype=torch.int32, device=dev),
                "mu": {k: torch.zeros_like(v) for k, v in params.items()},
                "nu": {k: torch.zeros_like(v) for k, v in params.items()}}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor], state: Dict[str, Any]) -> None:
        """Update `params` and `state` in place."""
        norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
        clipped = norm >= self.clip
        count = state["count"] + 1
        f32 = torch.float32
        c1 = 1 - torch.tensor(self.b1, dtype=f32) ** count.float()
        c2 = 1 - torch.tensor(self.b2, dtype=f32) ** count.float()
        for k, p in params.items():
            g = torch.where(clipped, grads[k] / norm * self.clip, grads[k])
            mu = state["mu"][k].mul_(self.b1).add_((1 - self.b1) * g)
            nu = state["nu"][k].mul_(self.b2).add_((1 - self.b2) * g.square())
            upd = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            p.add_(-self.lr * (upd + self.wd * p))
        state["count"] = count


@contextlib.contextmanager
def _no_param_grads(*modules: nn.Module):
    """Every parameter of `modules` frozen (requires_grad False) inside."""
    saved = [(p, p.requires_grad) for m in modules for p in m.parameters()]
    for p, _ in saved:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, flag in saved:
            p.requires_grad_(flag)


@dataclasses.dataclass(frozen=True)
class MeshPart:
    """One rank's share of a mesh step: its prompts [lo, hi) of the step's
    positives-then-negatives, the `data` and `model` axes' shards, and its
    band of the resized DINO projection's rows over `model`."""
    prompts: Tuple[int, int]
    data: Shard
    model: Shard
    pool: Band

    @classmethod
    def of(cls, mesh, n_prompts: int, rows: int) -> "MeshPart":
        data = Shard(*axis_group(mesh, "data"))
        model = Shard(*axis_group(mesh, "model"))
        return cls(split_rows(n_prompts, data.size)[data.rank], data, model,
                   Band(model, split_rows(rows, model.size)))


class _Step(nn.Module):
    """The differentiable part of a training step, over the model's `sam`
    so that `functional_call` can give the decoder the trainer's
    parameters."""

    def __init__(self, trainer: "AdapterTrainer"):
        super().__init__()
        self.sam = trainer.sam
        object.__setattr__(self, "trainer", trainer)

    def forward(self, shot: int, draws: Draws,
                part: Optional[MeshPart] = None):
        return self.trainer._losses(self.sam, shot, draws, part)


def _rank_loss(part: MeshPart, losses: Dict[str, torch.Tensor]):
    """A rank's loss in the mesh step: its shares of the prompt terms and,
    at data coordinate 0 only, the FG-map dice (computed alike on every
    rank), over M (each of the M ranks of `model` counts what it computes
    alike, see `sum_partials`)."""
    return sum(v for k, v in losses.items()
               if k != "dice_loss" or not part.data.rank) / part.model.size


def _sum_step(part: MeshPart, grads: Dict[str, torch.Tensor],
              losses: Dict[str, torch.Tensor]):
    """The step's gradients and loss terms from every rank's shares: the
    gradients in one f32 buffer summed over `model`, then over `data`; the
    loss terms (the dice only at data coordinate 0) summed over `data`."""
    flat = torch.cat([g.reshape(-1) for g in grads.values()])
    part.data.all_reduce(part.model.all_reduce(flat))
    out = dict(zip(grads, (f.view_as(g).clone() for f, g in zip(
        flat.split([g.numel() for g in grads.values()]), grads.values()))))
    names = list(losses)
    terms = torch.stack([
        torch.zeros_like(v) if k == "dice_loss" and part.data.rank
        else v.float() for k, v in losses.items()])
    part.data.all_reduce(terms)
    return out, {k: terms[i].to(losses[k].dtype)
                 for i, k in enumerate(names)}


class AdapterTrainer:
    def __init__(self, config: Dict[str, Any], predictor, logger=None):
        """predictor: a `SamPredictor` with DINOv2 attached."""
        self.config = config
        self.predictor = predictor
        self.sam = predictor.model
        self.device = predictor.device
        self.logger = logger or logging.getLogger("crowdsam_tpu_torch")
        tr = config["train"]
        self.n_shot = tr["n_shot"]
        self.steps = tr["steps"]
        self.pos_sample = tr["samples_per_batch"]
        self.neg_sample = int(tr["neg_factor"] * self.pos_sample)
        self.lr = tr["lr"]
        self.weight_decay = tr["weight_decay"]
        self.seed = tr.get("seed", 1)
        self.full_decoder = bool(tr.get("full_decoder", False))
        self.hard_neg_frac = float(tr.get("hard_neg_frac", 0.0))
        self.neg_hinge_weight = float(tr.get("neg_hinge_weight", 0.0))
        self.neg_hinge_margin = float(tr.get("neg_hinge_margin", 0.05))
        self.clip_grad = 0.1
        self.low_res = self.sam.img_size // 4
        self.cache: Optional[Dict[str, Any]] = None
        self.params: Dict[str, torch.Tensor] = {}
        self.last_part: Optional[MeshPart] = None
        self._step_module = _Step(self)

    # ------------------------------------------------------------- cache
    @float32_entry(lambda self: compute_dtype(self.sam))
    def cache_features(self, dataset) -> Dict[str, Any]:
        """Encode each of the first n_shot images once; the targets of its
        boxes (padded to a multiple of 8).  A float32 model encodes in full
        float32 (on the card through the float32 arms of K1-K4)."""
        n = min(self.n_shot, len(dataset))
        items = [dataset[i] for i in range(n)]
        box_lists, hws = [], []
        for img, nboxes in items:
            h, w = img.shape[:2]
            box_lists.append(np.asarray(nboxes) * np.array([w, h, w, h]))
            hws.append((h, w))
        maxb = int(np.ceil(max(len(b) for b in box_lists) / 8) * 8)
        feats, dinos, masks, counts = [], [], [], []
        r = self.low_res
        for i, (img, _) in enumerate(items):
            boxes = box_lists[i]
            self.predictor.set_image(img)
            tb = self.predictor.transform.apply_boxes(
                boxes, self.predictor.original_size)
            padded = np.zeros((maxb, 4), dtype=np.float32)
            padded[:len(boxes)] = tb
            if self.full_decoder:
                m = np.zeros((maxb, r, r), bool)
                for bi, bx in enumerate(tb / 4.0):
                    x0, y0 = np.floor(bx[:2]).astype(int)
                    x1, y1 = np.ceil(bx[2:]).astype(int)
                    m[bi, max(y0, 0): y1 + 1, max(x0, 0): x1 + 1] = True
            else:
                _, _, _, low = self.predictor.predict_batch(
                    boxes=torch.from_numpy(padded), multimask_output=False,
                    return_full_masks=False)
                m = (low[:, 0] > self.sam.mask_threshold).cpu().numpy()
            m[len(boxes):] = False
            feats.append(self.predictor.features[0])
            dinos.append(self.predictor.dino_feats[0])
            masks.append(m)
            counts.append(len(boxes))
            self.logger.info("cached shot %d: %d boxes", i, len(boxes))
        self.predictor.reset_image()
        dev = self.device
        target = torch.from_numpy(np.stack(masks)).to(dev)
        self.cache = {
            "features": torch.stack(feats),
            "dino_feats": torch.stack(dinos),
            "target_masks": target,
            "fg_mask": target.any(dim=1),
            "n_boxes": counts,
            "img_hw": torch.tensor(hws, dtype=torch.float32),
            "dense_pe": self.sam.prompt_encoder.get_dense_pe().detach(),
        }
        return self.cache

    # ------------------------------------------------------------- draws
    def draw(self, step: int) -> Draws:
        """The step's draws from a CPU generator seeded by (seed, step):
        (pos_idx (P,), positives' Gumbel noise (P, R^2), negatives' (R^2,))."""
        shot = step % len(self.cache["n_boxes"])
        gen = torch.Generator().manual_seed(
            int(self.seed) * 1_000_003 + int(step))
        r2 = self.low_res ** 2

        def gumbel(shape):
            u = torch.rand(shape, generator=gen).clamp_min(
                torch.finfo(torch.float32).tiny)
            return -torch.log(-torch.log(u))

        pos_idx = torch.randint(0, self.cache["n_boxes"][shot],
                                (self.pos_sample,), generator=gen)
        return pos_idx, gumbel((self.pos_sample, r2)), gumbel((r2,))

    # ------------------------------------------------------------- step
    def _losses(self, sam, shot: int, draws: Draws,
                part: Optional[MeshPart] = None) -> Dict[str, torch.Tensor]:
        """The loss terms of one step on cached shot `shot`; with `part`
        this rank's shares of them (`MeshPart`, `loss_and_grads`)."""
        c, dev = self.cache, self.device
        dec = sam.mask_decoder
        r = self.low_res
        pos_n, neg_n = self.pos_sample, self.neg_sample
        pos_idx, g_pos, g_neg = (d.to(dev) for d in draws)
        features = c["features"][shot][None]
        tmasks = c["target_masks"][shot][pos_idx.long()]      # (P, R, R)
        fg = c["fg_mask"][shot]
        h, w = (c["img_hw"][shot][0].to(dev), c["img_hw"][shot][1].to(dev))

        flat = torch.where(tmasks.reshape(pos_n, -1), g_pos.float(),
                           torch.tensor(-math.inf, device=dev))
        pidx = flat.argmax(dim=-1)
        pos_pts = torch.stack([pidx % r, pidx // r], dim=-1).float()

        proj = dec.project_dino(c["dino_feats"][shot][None])[0]
        cls_map = dec.classify_points(proj[None])[0]
        cls_map = resize_linear(cls_map.float(), (r, r)).permute(2, 0, 1)

        scale = torch.minimum(r / h, r / w)
        ri = torch.arange(r, device=dev)[:, None]
        ci = torch.arange(r, device=dev)[None, :]
        valid = (ri < (scale * h).int()) & (ci < (scale * w).int())
        ok = (~fg & valid).reshape(-1)
        gn = g_neg.float()
        neg_inf = torch.tensor(-math.inf, device=dev)
        n_hard = int(round(self.hard_neg_frac * neg_n))
        if n_hard > 0:
            fg_conf = cls_map.detach().max(dim=0).values.reshape(-1)
            hidx = torch.where(ok, fg_conf + gn, neg_inf).topk(n_hard).indices
            uidx = torch.where(ok, gn, neg_inf).topk(neg_n - n_hard).indices
            nidx = torch.cat([hidx, uidx])
        else:
            nidx = torch.where(ok, gn, neg_inf).topk(neg_n).indices
        neg_pts = torch.stack([nidx % r, nidx // r], dim=-1).float()

        pts = torch.cat([pos_pts, neg_pts], dim=0) / scale
        in_scale = sam.img_size / torch.maximum(h, w)
        new_h = torch.floor(h * in_scale + 0.5)
        new_w = torch.floor(w * in_scale + 0.5)
        pts = pts * torch.stack([new_w / w, new_h / h])
        proj_r = resize_linear(proj, (r, r))
        num_pos, totals, band = pos_n, None, None
        if part is not None:
            lo, hi = part.prompts
            pts = pts[lo:hi]
            tmasks = tmasks[lo:min(hi, pos_n)]
            num_pos, totals = max(min(hi, pos_n) - lo, 0), (pos_n, neg_n)
            band = part.pool
            proj_r = proj_r[band.lo:band.hi]
        labels = torch.ones((len(pts), 1), dtype=torch.int64, device=dev)
        sparse, dense = sam.prompt_encoder(points=(pts[:, None, :], labels))
        masks, iou_pred, cls_scores = dec(
            features, c["dense_pe"], sparse, dense, True,
            dino_feats_proj=proj_r, dino_band=band)
        fused_iou = iou_pred * torch.sigmoid(cls_scores[..., 0])
        return adapter_loss(
            masks, fused_iou, cls_map, tmasks.float(), fg.float(),
            valid.float(), num_pos=num_pos, mask_loss=self.full_decoder,
            neg_hinge_weight=self.neg_hinge_weight,
            neg_hinge_margin=self.neg_hinge_margin, totals=totals)

    def trainable_params(self) -> Dict[str, torch.Tensor]:
        """Float32 copies of the trainable decoder leaves."""
        dec = self.sam.mask_decoder
        adapter, _ = split_adapter_params(
            dict(dec.named_parameters()), self.full_decoder, _unused(dec))
        return {k: v.detach().float().clone() for k, v in adapter.items()}

    @float32_entry(lambda self: compute_dtype(self.sam))
    def loss_and_grads(self, params: Dict[str, torch.Tensor], shot: int,
                       draws: Draws, mesh=None):
        """(total, loss terms, {name: f32 gradient}) of one step, the
        decoder's trainable leaves taken from `params` (f32 masters, cast
        to the leaves' compute dtype inside the graph).

        `mesh` (`parallel/mesh.create_mesh`, axes `data` and `model`; every
        rank of it calls this with the same arguments): the mesh step (see
        the module's docstring).  Every rank returns the step's total, loss
        terms and gradients, the same on each; `self.last_part` holds its
        `MeshPart`, whose shards count the step's all-reduces and bytes."""
        dec = self.sam.mask_decoder
        dtypes = {k: v.dtype for k, v in dec.named_parameters()}
        masters = {k: v.detach().requires_grad_() for k, v in params.items()}
        part = None
        if mesh is not None:
            part = MeshPart.of(mesh, self.pos_sample + self.neg_sample,
                               self.low_res)
            self.last_part = part
        with _no_param_grads(self.sam, self.predictor.dino_model), \
                torch.enable_grad():
            losses = functional_call(
                self._step_module,
                {f"sam.mask_decoder.{k}": v.to(dtypes[k])
                 for k, v in masters.items()}, (shot, draws, part))
            total = (sum(losses.values()) if part is None
                     else _rank_loss(part, losses))
            grads = torch.autograd.grad(total, list(masters.values()),
                                        allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g.float()
                 for (k, v), g in zip(masters.items(), grads)}
        losses = {k: v.detach() for k, v in losses.items()}
        if part is not None:
            grads, losses = _sum_step(part, grads, losses)
            total = sum(losses.values())
        return total.detach(), losses, grads

    def decoder_tree(self) -> dict:
        """The decoder as the JAX package saves one: the trained leaves
        (f32) over the model's others."""
        sd = dict(self.sam.mask_decoder.state_dict())
        sd.update(self.params)
        return mask_decoder_tree(sd)

    def install(self, params: Dict[str, torch.Tensor]) -> None:
        """Copy trained leaves into the model's decoder (its dtypes)."""
        dec_params = dict(self.sam.mask_decoder.named_parameters())
        with torch.no_grad():
            for k, v in params.items():
                dec_params[k].copy_(v)

    # ------------------------------------------------------------- train
    def train(self, dataset, checkpoint_dir: Optional[str] = None,
              checkpoint_every: int = 500, resume: bool = True,
              losses_out: Optional[Dict[str, float]] = None,
              draws: Optional[Callable[[int], Draws]] = None,
              on_step: Optional[Callable[[int, Dict[str, torch.Tensor]],
                                         None]] = None,
              stop_after: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """Run the loop, install the trained leaves into the model's decoder
        (so `generate` serves them) and return them (f32).

        `checkpoint_dir`: every `checkpoint_every` steps the trainable
        leaves and the optimizer state go to `trainer_state.msgpack` there,
        and with `resume` a run starts from the file.  `losses_out`: the
        last step's loss terms.  `draws(step)`: the step's draws (default
        `self.draw`).  `on_step(step, loss terms)`: called after each
        step's update.  `stop_after`: end after this step count (a run cut
        short, as by a lost machine)."""
        if self.cache is None:
            self.cache_features(dataset)
        n_cached = len(self.cache["n_boxes"])
        params = self.trainable_params()
        opt = AdamW(self.lr, self.weight_decay, self.clip_grad)
        state = opt.init(params)
        start = 0
        ckpt = (os.path.join(checkpoint_dir, "trainer_state.msgpack")
                if checkpoint_dir else None)
        if resume and ckpt and os.path.exists(ckpt):
            saved = msgpack_io.load(ckpt)
            start = int(saved["step"])
            for k in params:
                params[k] = saved["adapter"][k].to(self.device)
                for m in ("mu", "nu"):
                    state[m][k] = saved["opt_state"][m][k].to(self.device)
            state["count"] = saved["opt_state"]["count"].to(self.device)
            self.logger.info("resumed from %s at step %d", ckpt, start)
        draws = draws or self.draw
        end = self.steps if stop_after is None else min(self.steps,
                                                        stop_after)
        losses = {}
        t0 = time.time()
        for step in range(start, end):
            _, losses, grads = self.loss_and_grads(params, step % n_cached,
                                                   draws(step))
            opt.step(params, grads, state)
            if on_step is not None:
                on_step(step, losses)
            if step % 100 == 0:
                rate = (step - start + 1) / max(time.time() - t0, 1e-9)
                self.logger.info(
                    "step: %d/%d %s (%.1f it/s)", step, self.steps,
                    " ".join(f"{k}: {float(v):.3f}"
                             for k, v in losses.items()), rate)
            if ckpt and (step + 1) % checkpoint_every == 0:
                msgpack_io.save(ckpt, {
                    "step": np.asarray(step + 1),
                    "adapter": params,
                    "opt_state": state,
                })
        if losses_out is not None and losses:
            losses_out.update({k: float(v) for k, v in losses.items()})
        self.params = params
        self.install(params)
        return params
