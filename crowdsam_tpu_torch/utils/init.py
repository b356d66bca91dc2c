"""The JAX package's random weights, drawn with numpy.

Without checkpoints the JAX package fills its parameter trees with
`utils/init.fast_random_init`: the leaves of the flattened flax tree, in
flax's (sorted) order, each from one `np.random.default_rng(seed)` stream,
by leaf name -- `bias` 0, `weight` (LayerNorm scale) 1, `*_gamma`
(LayerScale) 1e-5, `pos_embed` N(0, 0.02), the positional Fourier matrix
and the token/prompt embeddings N(0, 1), everything else N(0, 0.02).  SAM
takes seed s for the image encoder, s + 1 for the prompt encoder, s + 2 for
the mask decoder and s + 3 for `dino_proj` (`models/build.init_sam_params`);
DINOv2 takes its own seed.

This module replays the same draws.  The order and shapes of the leaves
come from `init_manifest.json`, the `(path, shape)` list of every module of
every arch of this package's registries at its default size (n_class 1;
under `sam_hq`, the HQ decoder of each ViT arch at dino_dim 1024, whose
tree holds `dino_proj` itself: `init_sam_params(hq=True)` draws no seed + 3
projection), written from `jax.eval_shape` where JAX runs; the shapes that
depend on the configuration (the positional embedding and the global
blocks' rel-pos tables by image size, TinyViT's attention-bias tables by
the windows that image size gives, the point classifier's last layer by
class count, the HQ decoder's `dino_proj` by dino_dim) are set here.  The
result is a JAX-layout tree of float32 numpy arrays, which `utils/weights`
maps to this package's state dicts.

The manifest's `checksums` hold, for the main configuration's draws and the
tiny test ones, each module's (leaves, elements, sum, sum of squares) in
float64, written where the JAX package's draws were made: numpy's
generator gives the same draws on any machine, so a run elsewhere can hold
its weights to them (`checksum`).
"""

from __future__ import annotations

import functools
import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from crowdsam_tpu_torch.models.tiny_vit import tiny_vit_shapes
from crowdsam_tpu_torch.utils.weights import (
    dino_state_dict_from_jax,
    sam_state_dict_from_jax,
)

MANIFEST = Path(__file__).with_name("init_manifest.json")
_UNIT = ("pe_gaussian", "point_embeddings", "not_a_point_embed",
         "no_mask_embed", "iou_token", "mask_tokens")
Entries = List[Tuple[str, Tuple[int, ...]]]


@functools.lru_cache(maxsize=1)
def manifest() -> dict:
    with open(MANIFEST) as f:
        return json.load(f)


def draw(entries: Entries, seed: int, scale: float = 0.02
         ) -> Dict[str, np.ndarray]:
    """{path: leaf} in the entries' order from one numpy stream, by the
    rule of `fast_random_init`."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, shape in entries:
        name = path.rsplit("/", 1)[-1]
        if name == "bias":
            val = np.zeros(shape, np.float32)
        elif name == "weight":
            val = np.ones(shape, np.float32)
        elif name.endswith("_gamma"):
            val = np.full(shape, 1e-5, np.float32)
        elif name == "pos_embed":
            val = rng.normal(0, 0.02, shape).astype(np.float32)
        elif name in _UNIT:
            val = rng.normal(0, 1.0, shape).astype(np.float32)
        else:
            val = rng.normal(0, scale, shape).astype(np.float32)
        out[path] = val
    return out


@functools.lru_cache(maxsize=16)
def _drawn(entries: Tuple[Tuple[str, Tuple[int, ...]], ...], seed: int
           ) -> Dict[str, np.ndarray]:
    """`draw` of one module, kept for the process's next tree that holds
    the same module from the same seed (the HQ decoder's or another class
    count's SAM shares its image encoder's draw).  Read only."""
    return draw(list(entries), seed)


def unflatten(flat: Dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        *parents, name = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return tree


def has_hq(arch: str) -> bool:
    """Whether `arch` has an HQ decoder (TinyViT's `vit_t` has none)."""
    return arch in manifest()["sam_hq"]


def sam_entries(arch: str, image_size: Optional[int] = None,
                n_class: int = 1, hq: bool = False,
                dino_dim: int = 1024) -> Dict[str, Entries]:
    """{module: [(path, shape), ...]} of a SAM arch at `image_size` (the
    arch's default when None) and `n_class`; with `hq` (an arch that has
    one) the HQ decoder's, its `dino_proj` from `dino_dim`."""
    m = manifest()["sam"][arch]
    g0 = m["image_size"] // 16
    g = (image_size or m["image_size"]) // 16
    biases = dict(tiny_vit_shapes(g * 16)) if arch == "vit_t" else {}
    enc = []
    for path, shape in m["image_encoder"]:
        shape = tuple(shape)
        if path == "pos_embed":
            shape = (1, g, g, shape[-1])
        elif path.endswith(("rel_pos_h", "rel_pos_w")) and \
                shape[0] == 2 * g0 - 1:               # a global block
            shape = (2 * g - 1, shape[1])
        shape = biases.get(path, shape)
        enc.append((path, shape))
    hq = hq and has_hq(arch)
    dec_src = manifest()["sam_hq"][arch] if hq else m["mask_decoder"]
    dec = []
    last = max(p for p, _ in dec_src if p.startswith("point_classifier/"))
    last = last.rsplit("/", 1)[0]
    for path, shape in dec_src:
        shape = tuple(shape)
        if path.rsplit("/", 1)[0] == last:
            shape = shape[:-1] + (n_class,)
        elif path == "dino_proj/kernel":
            shape = (dino_dim, shape[1])
        dec.append((path, shape))
    return {"image_encoder": enc,
            "prompt_encoder": [(p, tuple(s)) for p, s in m["prompt_encoder"]],
            "mask_decoder": dec}


def sam_params(arch: str, seed: int = 0, image_size: Optional[int] = None,
               n_class: int = 1, dino_dim: int = 1024,
               hq: bool = False) -> dict:
    """The tree of `init_sam_params`: image encoder with `seed`, prompt
    encoder `seed + 1`, decoder `seed + 2`, and (not for an HQ decoder,
    whose tree holds it) `dino_proj` `seed + 3` (N(0, 0.02) kernel, zero
    bias)."""
    entries = sam_entries(arch, image_size, n_class, hq, dino_dim)
    tree = {name: unflatten(_drawn(tuple(entries[name]), seed + k))
            for k, name in enumerate(("image_encoder", "prompt_encoder",
                                      "mask_decoder"))}
    if hq and has_hq(arch):
        return tree
    rng = np.random.default_rng(seed + 3)
    tree["mask_decoder"]["dino_proj"] = {            # decoder width 256
        "kernel": rng.normal(0, 0.02, (dino_dim, 256)).astype(np.float32),
        "bias": np.zeros((256,), np.float32),
    }
    return tree


def dino_params(arch: str, seed: int) -> dict:
    return unflatten(draw([(p, tuple(s)) for p, s in
                           manifest()["dino"][arch]], seed))


def checksum(leaves) -> Tuple[int, float, float]:
    """(elements, sum, sum of squares) of tensors or arrays, in float64."""
    n, total, sq = 0, 0.0, 0.0
    for t in leaves:
        a = (t.detach().cpu().double().numpy() if isinstance(t, torch.Tensor)
             else np.asarray(t, dtype=np.float64))
        n += a.size
        total += float(a.sum())
        sq += float(np.square(a).sum())
    return n, total, sq


def sam_checksums(sd: Dict[str, torch.Tensor]) -> Dict[str, tuple]:
    """`checksum` of a drawn `Sam` state dict by the manifest's modules."""
    groups = {"image_encoder": [], "prompt_encoder": [], "mask_decoder": [],
              "dino_proj": []}
    for k, v in sd.items():
        name = ("dino_proj" if k.startswith("mask_decoder.dino_proj.")
                else k.split(".", 1)[0])
        groups[name].append(v)
    return {k: checksum(v) for k, v in groups.items()}


@functools.lru_cache(maxsize=4)
def sam_state_dict(arch: str, seed: int = 0, image_size: Optional[int] = None,
                   n_class: int = 1, dino_dim: int = 1024, hq: bool = False
                   ) -> Dict[str, torch.Tensor]:
    """`sam_params` mapped to the `Sam` state dict (CPU float32).  Kept
    for the process's next model of the same arch: a full ViT-L draw takes
    seconds on the host."""
    return sam_state_dict_from_jax(sam_params(arch, seed, image_size,
                                              n_class, dino_dim, hq))


@functools.lru_cache(maxsize=4)
def dino_state_dict(arch: str, seed: int) -> Dict[str, torch.Tensor]:
    return dino_state_dict_from_jax(dino_params(arch, seed))
