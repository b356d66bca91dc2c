"""SAM model registry, builders and the seeded random initialization.

Counterpart of the JAX package's `models/build.py` for the `crowdsam` arch
(PWD-Net decoder): `vit_l` on the main path, `vit_b` (head dim 64 at a
small width) for `chip_smoke.py`'s reference check, `vit_tiny` for the CPU
tests.
No pretrained weights ship with the repository, so a model without a
checkpoint takes `init_random_`: biases 0, LayerNorm weights 1, LayerScale
1e-5, the positional Fourier matrix and the token/prompt embeddings N(0, 1),
everything else N(0, 0.02) -- the distributions of the JAX package's
`utils/init.fast_random_init` -- drawn from a seeded `torch.Generator`.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from crowdsam_tpu_torch.models.common import LayerNorm
from crowdsam_tpu_torch.models.dinov2 import LayerScale
from crowdsam_tpu_torch.models.image_encoder import ImageEncoderViT
from crowdsam_tpu_torch.models.mask_decoder import MaskDecoder
from crowdsam_tpu_torch.models.prompt_encoder import PromptEncoder
from crowdsam_tpu_torch.models.sam import Sam

_UNIT_SCALE = ("positional_encoding_gaussian_matrix", "point_embeddings",
               "not_a_point_embed", "no_mask_embed", "iou_token",
               "mask_tokens")


def _build_sam(embed_dim: int, depth: int, num_heads: int,
               global_attn_indexes: Tuple[int, ...], n_class: int = 1,
               image_size: int = 1024, dino_dim: int = 1024) -> Sam:
    prompt_dim = 256
    grid = image_size // 16
    return Sam(
        ImageEncoderViT(img_size=image_size, patch_size=16,
                        embed_dim=embed_dim, depth=depth,
                        num_heads=num_heads, out_chans=prompt_dim,
                        window_size=14,
                        global_attn_indexes=tuple(global_attn_indexes)),
        PromptEncoder(embed_dim=prompt_dim, image_embedding_size=(grid, grid),
                      input_image_size=(image_size, image_size)),
        MaskDecoder(transformer_dim=prompt_dim, n_class=n_class,
                    dino_dim=dino_dim),
    )


def build_sam_vit_l(n_class: int = 1, **kw) -> Sam:
    return _build_sam(1024, 24, 16, (5, 11, 17, 23), n_class, **kw)


def build_sam_vit_b(n_class: int = 1, **kw) -> Sam:
    return _build_sam(768, 12, 12, (2, 5, 8, 11), n_class, **kw)


def build_sam_vit_tiny(n_class: int = 1, **kw) -> Sam:
    """Small test configuration (not MobileSAM's TinyViT)."""
    kw.setdefault("image_size", 256)
    return _build_sam(64, 2, 2, (1,), n_class, **kw)


sam_model_registry = {
    "vit_l": build_sam_vit_l,
    "vit_b": build_sam_vit_b,
    "vit_tiny": build_sam_vit_tiny,
}


@torch.no_grad()
def init_random_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter and buffer in place from `generator` (which must
    live on the parameters' device)."""
    owners = {}
    for mname, m in model.named_modules():
        for pname, _ in m.named_parameters(recurse=False):
            owners[f"{mname}.{pname}" if mname else pname] = m
    for name, t in list(model.named_parameters()) + list(
            model.named_buffers()):
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
