"""The weight bridge: a port state dict -> the JAX package's torch
converters -> the bridge gives back identical tensors and loads strictly;
and JAX-initialized parameter trees load into the port."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crowdsam_tpu.models.build import build_sam_vit_tiny as jax_build_tiny
from crowdsam_tpu.models.dinov2 import DinoVisionTransformer as JaxDino
from crowdsam_tpu.utils.checkpoint import (
    _strip_prefix,
    convert_dinov2,
    convert_image_encoder,
    convert_mask_decoder,
    convert_prompt_encoder,
    jax_tree_to_numpy,
)
from crowdsam_tpu.utils.init import fast_random_init

from crowdsam_tpu_torch.models.build import build_sam_vit_tiny, init_random_
from crowdsam_tpu_torch.models.dinov2 import DinoVisionTransformer
from crowdsam_tpu_torch.utils.weights import (
    dino_state_dict_from_jax,
    sam_state_dict_from_jax,
)

DINO_KW = dict(patch_size=14, embed_dim=64, depth=2, num_heads=1)


def _numpy_sd(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def _assert_same(sd_a, sd_b):
    assert sd_a.keys() == sd_b.keys()
    for k in sd_a:
        torch.testing.assert_close(sd_a[k], sd_b[k], rtol=0, atol=0,
                                   msg=lambda m, k=k: f"{k}: {m}")


def test_sam_round_trip_through_jax_converters():
    sam = init_random_(build_sam_vit_tiny(dino_dim=64),
                       torch.Generator().manual_seed(0))
    sd = _numpy_sd(sam)
    tree = {
        "image_encoder": convert_image_encoder(
            _strip_prefix(sd, "image_encoder."), depth=2),
        "prompt_encoder": convert_prompt_encoder(
            _strip_prefix(sd, "prompt_encoder.")),
        "mask_decoder": convert_mask_decoder(
            _strip_prefix(sd, "mask_decoder.")),
    }
    back = sam_state_dict_from_jax(tree)
    _assert_same(back, sam.state_dict())
    fresh = build_sam_vit_tiny(dino_dim=64)
    fresh.load_state_dict(back, strict=True)


def test_dino_round_trip_through_jax_converter():
    dino = init_random_(DinoVisionTransformer(**DINO_KW),
                        torch.Generator().manual_seed(1))
    back = dino_state_dict_from_jax(convert_dinov2(_numpy_sd(dino), depth=2))
    _assert_same(back, dino.state_dict())
    DinoVisionTransformer(**DINO_KW).load_state_dict(back, strict=True)


def test_jax_initialized_trees_load():
    jsam = jax_build_tiny(dtype=jnp.float32, seed=3, dino_dim=64)
    sam = build_sam_vit_tiny(dino_dim=64)
    missing, unexpected = sam.load_state_dict(
        sam_state_dict_from_jax(jax_tree_to_numpy(jsam.params)), strict=False)
    assert not unexpected
    # flax never creates the unused 5th hypernetwork MLP.
    assert {k.split(".layers.")[0] for k in missing} == {
        "mask_decoder.output_hypernetworks_mlps.4"}
    np.testing.assert_array_equal(
        sam.image_encoder.blocks[0].attn.qkv.weight.detach().numpy(),
        np.asarray(jsam.params["image_encoder"]["blocks_0"]["attn"]["qkv"]
                   ["kernel"]).T)
    jdino = JaxDino(**DINO_KW, dtype=jnp.float32)
    dparams = fast_random_init(jdino, jnp.zeros((1, 28, 28, 3)), seed=4)
    DinoVisionTransformer(**DINO_KW).load_state_dict(
        dino_state_dict_from_jax(jax_tree_to_numpy(dparams)), strict=True)


@pytest.mark.parametrize("seed", [0, 1])
def test_random_init_distributions(seed):
    """The seeded init mirrors the JAX package's fast_random_init: zero
    biases, unit LayerNorm weights, LayerScale 1e-5, unit-scale embeddings,
    0.02 elsewhere; the same seed gives the same weights."""
    a = init_random_(build_sam_vit_tiny(), torch.Generator().manual_seed(seed))
    b = init_random_(build_sam_vit_tiny(), torch.Generator().manual_seed(seed))
    _assert_same(a.state_dict(), b.state_dict())
    enc, pe = a.image_encoder, a.prompt_encoder
    assert float(enc.blocks[0].attn.qkv.bias.detach().abs().max()) == 0.0
    assert float(enc.blocks[0].norm1.weight.detach().min()) == 1.0
    assert 0.01 < float(enc.blocks[0].attn.qkv.weight.detach().std()) < 0.03
    assert 0.5 < float(pe.pe_layer.positional_encoding_gaussian_matrix.std())
    d = init_random_(DinoVisionTransformer(**DINO_KW),
                     torch.Generator().manual_seed(seed))
    assert torch.all(d.blocks[0].ls1.gamma == 1e-5)
