"""SAM model registry, builders and the seeded random initialization.

Counterpart of the JAX package's `models/build.py`: `vit_h` (width 1280,
head dim 80; `default`, and `build_sam`), `vit_l` (the main path), `vit_b`,
`vit_tiny` (a small test configuration) and `vit_t` (MobileSAM's TinyViT),
each with the PWD-Net decoder, or with `hq=True` the HQ-SAM decoder
(`models/mask_decoder_hq.py`, the `sam_hq` arch; `vit_t` has none and
builds the PWD-Net decoder with the JAX package's warning).
No pretrained weights ship with the repository, so a model without a
checkpoint takes `init_random_`: biases 0, LayerNorm weights 1, LayerScale
1e-5, the positional Fourier matrix and the token/prompt embeddings N(0, 1),
everything else N(0, 0.02) -- the distributions of the JAX package's
`utils/init.fast_random_init` -- drawn from a seeded `torch.Generator`.
"""

from __future__ import annotations

import warnings
from typing import Tuple

import torch
import torch.nn as nn

from crowdsam_tpu_torch.models.common import LayerNorm
from crowdsam_tpu_torch.models.dinov2 import LayerScale
from crowdsam_tpu_torch.models.image_encoder import ImageEncoderViT
from crowdsam_tpu_torch.models.mask_decoder import MaskDecoder
from crowdsam_tpu_torch.models.mask_decoder_hq import MaskDecoderHQ
from crowdsam_tpu_torch.models.prompt_encoder import PromptEncoder
from crowdsam_tpu_torch.models.sam import Sam
from crowdsam_tpu_torch.models.tiny_vit import TinyViT

_UNIT_SCALE = ("positional_encoding_gaussian_matrix", "point_embeddings",
               "not_a_point_embed", "no_mask_embed", "iou_token",
               "mask_tokens")


def _prompt_encoder(image_size: int) -> PromptEncoder:
    grid = image_size // 16
    return PromptEncoder(embed_dim=256, image_embedding_size=(grid, grid),
                         input_image_size=(image_size, image_size))


def _build_sam(embed_dim: int, depth: int, num_heads: int,
               global_attn_indexes: Tuple[int, ...], n_class: int = 1,
               image_size: int = 1024, dino_dim: int = 1024,
               hq: bool = False) -> Sam:
    if hq:
        decoder = MaskDecoderHQ(transformer_dim=256, n_class=n_class,
                                vit_dim=embed_dim, dino_dim=dino_dim)
    else:
        decoder = MaskDecoder(transformer_dim=256, n_class=n_class,
                              dino_dim=dino_dim)
    return Sam(
        ImageEncoderViT(img_size=image_size, patch_size=16,
                        embed_dim=embed_dim, depth=depth,
                        num_heads=num_heads, out_chans=256,
                        window_size=14,
                        global_attn_indexes=tuple(global_attn_indexes)),
        _prompt_encoder(image_size), decoder)


def build_sam_vit_l(n_class: int = 1, **kw) -> Sam:
    return _build_sam(1024, 24, 16, (5, 11, 17, 23), n_class, **kw)


def build_sam_vit_b(n_class: int = 1, **kw) -> Sam:
    return _build_sam(768, 12, 12, (2, 5, 8, 11), n_class, **kw)


def build_sam_vit_tiny(n_class: int = 1, **kw) -> Sam:
    """Small test configuration (not MobileSAM's TinyViT)."""
    kw.setdefault("image_size", 256)
    return _build_sam(64, 2, 2, (1,), n_class, **kw)


def build_sam_vit_h(n_class: int = 1, **kw) -> Sam:
    """SAM ViT-H: width 1280, 32 blocks, 16 heads (head dim 80), global
    blocks 7, 15, 23 and 31."""
    return _build_sam(1280, 32, 16, (7, 15, 23, 31), n_class, **kw)


def build_sam_vit_t(n_class: int = 1, image_size: int = 1024,
                    dino_dim: int = 1024, hq: bool = False) -> Sam:
    """MobileSAM: the TinyViT-5M encoder with SAM's prompt encoder and the
    PWD-Net decoder (the JAX package's choice, so that the whole pipeline
    runs on this encoder).  There is no HQ decoder for it: `hq` is ignored
    with the JAX package's warning."""
    if hq:
        warnings.warn(
            "build_sam_vit_t has no HQ decoder variant; hq=True is ignored "
            "and the standard PWD-Net MaskDecoder is built instead "
            "(sam_arch: sam_hq is incompatible with a vit_t/mobile "
            "sam_model)", stacklevel=2)
    return Sam(TinyViT(img_size=image_size), _prompt_encoder(image_size),
               MaskDecoder(transformer_dim=256, n_class=n_class,
                           dino_dim=dino_dim))


build_sam = build_sam_vit_h

# `CrowdSAM` refuses a name outside this registry.
sam_model_registry = {
    "default": build_sam_vit_h,
    "vit_h": build_sam_vit_h,
    "vit_l": build_sam_vit_l,
    "vit_b": build_sam_vit_b,
    "vit_t": build_sam_vit_t,
    "vit_tiny": build_sam_vit_tiny,
}


@torch.no_grad()
def init_random_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter and persistent buffer in place from `generator`
    (which must live on the parameters' device)."""
    owners = {}
    for mname, m in model.named_modules():
        for pname, _ in m.named_parameters(recurse=False):
            owners[f"{mname}.{pname}" if mname else pname] = m
    saved = model.state_dict(keep_vars=True).keys()
    for name, t in list(model.named_parameters()) + [
            (n, b) for n, b in model.named_buffers() if n in saved]:
        leaf = name.rsplit(".", 1)[-1]
        owner = owners.get(name)
        if leaf == "bias":
            t.zero_()
        elif isinstance(owner, LayerNorm) and leaf == "weight":
            t.fill_(1.0)
        elif isinstance(owner, LayerScale):
            t.fill_(1e-5)
        else:
            std = 1.0 if any(u in name for u in _UNIT_SCALE) else 0.02
            t.copy_(torch.randn(t.shape, generator=generator,
                                device=t.device) * std)
    return model
