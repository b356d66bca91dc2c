"""Batched and data-parallel inference: `ShardedPipeline.generate_batch`.

Counterpart of the JAX package's `parallel/eval_shard.py`.  B images go
through one batched encode (`SamPredictor.encode_batch`: SAM ViT and
DINOv2 over the batch, the square frame always, as the JAX batched path
ignores `tpu.rect_encode`), one lockstep EPS decode loop
(`engine.run_eps_engine_batch`: each K5 and K6 call takes the prompts of
every image still running) and one survivor pass
(`engine.survivor_core_batch`: one K7 call over the survivors of all
images), then the host tail of each image (`CrowdSAM._crop_data`).

With a mesh (`parallel/mesh.create_mesh`, one process a rank) each chunk
of B images is split over the `data` axis: the rank at data coordinate d
runs images [d B/D, (d+1) B/D) of the chunk through the same three
stages, and the per-image results are gathered over `data`
(`all_gather_object`), so every rank returns every image's result in
order, as the JAX `generate_batch` does.  With `prompt_axis` the ranks of
that axis also split each image's prompt batches (`pipeline/engine.py`,
the composed layout).  With `spatial_axis` the ranks of that axis (of a
data coordinate) split each encode by token rows (`parallel/spatial.py`):
each computes a band of the image encoder (SAM ViT: whole window rows up
to the grid's window rows, token rows with row halos past them; TinyViT:
rows of its final grid with row halos at every stage) and of DINOv2, and
every one ends with the whole features; the engine and the survivor pass
then run on every rank of the axis (each on its prompt share when
`prompt_axis` is the same axis or another), as in the JAX package, whose
engine runs under a `shard_map` over `data` only.  The spatial axis may be
the prompt axis.

The noise of each real image is drawn from the model's generator in order,
as `CrowdSAM.generate_many` draws it, on every rank, and each rank uses
its own images' vectors; so at any mesh shape `generate_batch` equals
`generate_many` item by item on the same generator state.  A partial
chunk runs the images it has (the JAX package pads it with repeats of its
last image, for a static shape; the results are the same); a rank given
no image of it skips the encode and the engine and joins the gather.
What the JAX `ShardedPipeline` refuses or cannot run is refused here with
the reason: crop layers, the train-free branch and the HQ decoder
(`sam_hq`); and the spatial axis without a mesh, or wider than the
encoder's token rows (a rank with no band).  A float32 model runs on CUDA
with either decode (the float32 arms of the kernels, K5 and K6 among them).
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from crowdsam_tpu_torch.models.common import float32_entry
from crowdsam_tpu_torch.ops.amg import MaskData, generate_crop_boxes
from crowdsam_tpu_torch.ops.transforms import resize_image
from crowdsam_tpu_torch.parallel.collectives import Shard
from crowdsam_tpu_torch.parallel.mesh import axis_group, check_device
from crowdsam_tpu_torch.parallel.prompt_shard import axis_shard
from crowdsam_tpu_torch.parallel.spatial import dino_band, sam_band
from crowdsam_tpu_torch.pipeline.crowdsam import _wrap_up
from crowdsam_tpu_torch.pipeline.engine import (
    run_eps_engine_batch,
    survivor_core_batch,
)


def refusal(model, mesh=None, spatial_axis=None, prompt_axis=None
            ) -> Optional[str]:
    """Why the batched path does not run `model` (or these mesh options),
    or None."""
    if spatial_axis and mesh is None:
        return "spatial_axis needs a mesh with that axis"
    if prompt_axis and mesh is None:
        return "prompt_axis needs a mesh with that axis"
    if model.crop_n_layers != 0:
        return ("the batched path requires test.crop_n_layers 0 (the JAX "
                "package's ShardedPipeline asserts it)")
    if model.train_free:
        return ("the batched path requires the trained arch, not "
                "model.trainfree (the JAX package's ShardedPipeline asserts "
                "it)")
    if model.predictor.is_hq:
        return ("the batched path does not run the HQ decoder (sam_hq): the "
                "JAX package's ShardedPipeline fails on it")
    return None


class ShardedPipeline:
    """Wraps a `CrowdSAM` with a batched `generate_batch` of `batch` images
    a chunk, on the model's device; with `mesh`, a chunk's images split
    over its `data` axis (each image's encode by rows over `spatial_axis`,
    and its prompts over `prompt_axis`)."""

    def __init__(self, model, mesh=None, batch: int = 4,
                 spatial_axis: Optional[str] = None,
                 prompt_axis: Optional[str] = None):
        why = refusal(model, mesh, spatial_axis, prompt_axis)
        if why is not None:
            raise NotImplementedError(why)
        if batch < 1:
            raise ValueError(f"batch {batch} (at least 1)")
        self.model = model
        self.batch = batch
        self.data = None          # (group, this rank's index, size)
        self.shard = None         # this rank's prompt shard
        self.spatial = None       # this rank's shard of the spatial axis
        if mesh is not None:
            check_device(mesh, model.device)
            self.data = axis_group(mesh, "data")
            if batch % self.data[2]:
                raise ValueError(f"batch {batch} does not divide over the "
                                 f"data axis ({self.data[2]} ranks)")
            if prompt_axis:
                self.shard = axis_shard(model, mesh, prompt_axis)
            if spatial_axis:
                self.spatial = Shard(*axis_group(mesh, spatial_axis))
                # The band layouts, checked now: every rank needs a band.
                p = model.predictor
                sam_band(p.model.image_encoder, self.spatial)
                dino_band(p.dino_grid, self.spatial)
        self.last_engine = None

    @torch.no_grad()
    @float32_entry(lambda self: self.model.compute_dtype)
    def generate_batch(self, images: List[np.ndarray],
                       noise: Optional[Sequence] = None,
                       times_out: Optional[list] = None) -> List[MaskData]:
        """HWC uint8 images -> one MaskData each, as `CrowdSAM.generate`
        gives it (on every rank, with a mesh).  `noise`: optional
        candidate-order vectors, one (grid^2,) a image; drawn from the
        model's generator when absent.  `times_out`: optional list; each
        image gets its chunk's wall-clock seconds divided by the chunk's
        images (they sum to the total)."""
        images = [np.asarray(im, dtype=np.uint8) for im in images]
        if noise is not None and len(noise) != len(images):
            raise ValueError(f"{len(noise)} noise vectors for {len(images)} "
                             "images")
        out: List[MaskData] = []
        for c0 in range(0, len(images), self.batch):
            t = time.perf_counter()
            chunk = images[c0:c0 + self.batch]
            nz = ([self.model.draw_noise() for _ in chunk] if noise is None
                  else [torch.tensor(np.asarray(v, dtype=np.float32))
                        for v in noise[c0:c0 + len(chunk)]])
            if self.data is None:
                out.extend(self._chunk(chunk, nz))
            else:
                out.extend(self._data_chunk(chunk, nz))
            if times_out is not None:
                per = (time.perf_counter() - t) / len(chunk)
                times_out.extend([per] * len(chunk))
        return out

    def _data_chunk(self, chunk: List[np.ndarray], nz) -> List[MaskData]:
        """This rank's share of a chunk over the data axis, then every
        share gathered in image order."""
        group, d, size = self.data
        per = self.batch // size
        lo, hi = d * per, min((d + 1) * per, len(chunk))
        if lo < hi:
            mine = self._chunk(chunk[lo:hi], nz[lo:hi])
        else:
            mine, self.last_engine = [], []
        shares = [None] * size
        dist.all_gather_object(shares, mine, group=group)
        return [r for share in shares for r in share]

    def _chunk(self, chunk: List[np.ndarray], nz) -> List[MaskData]:
        """Images of a chunk with their noise vectors, through the three
        stages on this rank."""
        model = self.model
        cfg = model.engine_cfg
        dev = model.device
        s, n = cfg.img_size, len(chunk)
        frames = np.zeros((n, s, s, 3), dtype=np.uint8)
        metas = []
        for i, img in enumerate(chunk):
            (crop_box,), _ = generate_crop_boxes(
                img.shape[:2], 0, model.crop_overlap_ratio)
            resized, downscale = resize_image(img, model.max_size)
            ih, iw = resized.shape[:2]
            frames[i, :ih, :iw] = resized
            metas.append(dict(crop_box=crop_box, orig_hw=img.shape[:2],
                              in_hw=(ih, iw), downscale=downscale))
        nz = torch.stack(list(nz))
        in_hw = [m["in_hw"] for m in metas]

        enc = model.predictor.encode_batch(
            torch.from_numpy(frames).to(dev), in_hw, spatial=self.spatial)
        sims = torch.stack([model.sim_map(enc["fg_logits"][i:i + 1])
                            for i in range(n)])
        g = cfg.grid_size
        feat_hw = [(int(h * g / max(h, w)), int(w * g / max(h, w)))
                   for h, w in in_hw]
        res = run_eps_engine_batch(
            model.sam, cfg, enc["features"], enc["dense_pe"],
            enc["dino_proj_256"], sims, feat_hw, in_hw,
            [m["crop_box"] for m in metas], [m["orig_hw"] for m in metas],
            [m["downscale"] for m in metas], nz, shard=self.shard)
        self.last_engine = res

        # One survivor pass over every image's kept rows, padded to the
        # largest count.
        summaries = torch.stack([r["summary"] for r in res]).cpu().numpy()
        idxs = [np.nonzero(sm[:, 0] > 0.5)[0] for sm in summaries]
        ns = [len(ix) for ix in idxs]
        sps = [None] * n
        if max(ns) > 0:
            k = max(ns)
            logits = torch.stack([
                r["logits"][torch.as_tensor(
                    np.pad(ix, (0, k - len(ix))), device=dev)]
                for r, ix in zip(res, idxs)])
            hw = torch.tensor(in_hw, dtype=torch.int32, device=dev)
            sps = survivor_core_batch(cfg, logits, ns, hw, model.output_rles)
        sp_sums = _summaries_on_host(sps, model.output_rles)
        results = []
        for i in range(n):
            data = MaskData()
            if ns[i]:
                crop_data = model._crop_data(
                    summaries[i], idxs[i], sps[i] if model.output_rles
                    else None, sp_sums[i], metas[i])
                if crop_data is not None:
                    data.cat(crop_data)
            results.append(_wrap_up(data))
        return results


def _summaries_on_host(sps, with_masks: bool) -> list:
    """Each image's survivor summary as numpy (None where it has no
    survivors), in one transfer."""
    parts = [None if sp is None else (sp["summary"] if with_masks else sp)
             for sp in sps]
    present = [p for p in parts if p is not None]
    if not present:
        return parts
    flat = iter(np.split(torch.cat(present).cpu().numpy(),
                         np.cumsum([len(p) for p in present])[:-1]))
    return [None if p is None else next(flat) for p in parts]
