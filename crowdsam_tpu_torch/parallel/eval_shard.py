"""Batched inference on one device: `ShardedPipeline.generate_batch`.

Counterpart of the JAX package's `parallel/eval_shard.py` with `mesh=None`:
B images go through one batched encode (`SamPredictor.encode_batch`: SAM
ViT and DINOv2 over the batch, the square frame always, as the JAX batched
path ignores `tpu.rect_encode`), one lockstep EPS decode loop
(`engine.run_eps_engine_batch`: each K5 and K6 call takes the prompts of
every image still running) and one survivor pass
(`engine.survivor_core_batch`: one K7 call over the survivors of all
images), then the host tail of each image (`CrowdSAM._crop_data`).

The noise of each real image is drawn from the model's generator in order,
as `CrowdSAM.generate_many` draws it, so `generate_batch` equals
`generate_many` item by item on the same generator state.  A partial chunk
runs the images it has (the JAX package pads it with repeats of its last
image, for a static shape; the results are the same).  What the JAX
`ShardedPipeline` refuses or cannot run is refused here with the reason:
crop layers, the train-free branch, the HQ decoder (`sam_hq`) and any
mesh, spatial or prompt axis (multi-device is later work).
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from crowdsam_tpu_torch.ops.amg import MaskData, generate_crop_boxes
from crowdsam_tpu_torch.ops.transforms import resize_image
from crowdsam_tpu_torch.pipeline.crowdsam import _wrap_up
from crowdsam_tpu_torch.pipeline.engine import (
    run_eps_engine_batch,
    survivor_core_batch,
)


def refusal(model, mesh=None, spatial_axis=None, prompt_axis=None
            ) -> Optional[str]:
    """Why the batched path does not run `model` (or these mesh options),
    or None."""
    if mesh is not None or spatial_axis or prompt_axis:
        return ("mesh, spatial_axis and prompt_axis are not supported "
                "(multi-device: M15 part 2)")
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
    a chunk, on the model's device."""

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
        self.last_engine = None

    @torch.no_grad()
    def generate_batch(self, images: List[np.ndarray],
                       noise: Optional[Sequence] = None,
                       times_out: Optional[list] = None) -> List[MaskData]:
        """HWC uint8 images -> one MaskData each, as `CrowdSAM.generate`
        gives it.  `noise`: optional candidate-order vectors, one (grid^2,)
        a image; drawn from the model's generator when absent.
        `times_out`: optional list; each image gets its chunk's wall-clock
        seconds divided by the chunk's images (they sum to the total)."""
        images = [np.asarray(im, dtype=np.uint8) for im in images]
        if noise is not None and len(noise) != len(images):
            raise ValueError(f"{len(noise)} noise vectors for {len(images)} "
                             "images")
        out: List[MaskData] = []
        for c0 in range(0, len(images), self.batch):
            t = time.perf_counter()
            chunk = images[c0:c0 + self.batch]
            out.extend(self._chunk(chunk, None if noise is None
                                   else noise[c0:c0 + len(chunk)]))
            if times_out is not None:
                per = (time.perf_counter() - t) / len(chunk)
                times_out.extend([per] * len(chunk))
        return out

    def _chunk(self, chunk: List[np.ndarray], noise) -> List[MaskData]:
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
        nz = torch.stack([
            model.draw_noise() if noise is None else torch.tensor(
                np.asarray(noise[i], dtype=np.float32))
            for i in range(n)])
        in_hw = [m["in_hw"] for m in metas]

        enc = model.predictor.encode_batch(
            torch.from_numpy(frames).to(dev), in_hw)
        sims = torch.stack([model.sim_map(enc["fg_logits"][i:i + 1])
                            for i in range(n)])
        g = cfg.grid_size
        feat_hw = [(int(h * g / max(h, w)), int(w * g / max(h, w)))
                   for h, w in in_hw]
        res = run_eps_engine_batch(
            model.sam, cfg, enc["features"], enc["dense_pe"],
            enc["dino_proj_256"], sims, feat_hw, in_hw,
            [m["crop_box"] for m in metas], [m["orig_hw"] for m in metas],
            [m["downscale"] for m in metas], nz)
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
