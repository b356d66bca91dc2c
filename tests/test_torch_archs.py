"""The archs beside the main path against the JAX package on the CPU, same
weights (JAX random init -> weight bridge), float32: a SAM image encoder
shaped like ViT-H (head dim 80) with its `return_interm`, the HQ decoder and
its `compute_hq_features`, MobileSAM's TinyViT, DINOv2 ViT-B/14 at reduced
depth (`test_torch_arch_pipeline.py` holds `generate` of each arch).

Tolerances as in `test_torch_models.py`: 2e-3 abs for whole encoders and
decoders (float32 through a dozen layers, the sums in another order), 1e-4
for a single stack."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crowdsam_tpu.models.dinov2 import dino_model_registry as jax_dinos
from crowdsam_tpu.models.image_encoder import ImageEncoderViT as JaxEncoder
from crowdsam_tpu.models.mask_decoder_hq import MaskDecoderHQ as JaxHQ
from crowdsam_tpu.models.tiny_vit import TinyViT as JaxTinyViT
from crowdsam_tpu.utils.checkpoint import jax_tree_to_numpy
from crowdsam_tpu.utils.init import fast_random_init

from crowdsam_tpu_torch.models.dinov2 import DinoVisionTransformer
from crowdsam_tpu_torch.models.image_encoder import ImageEncoderViT
from crowdsam_tpu_torch.models.mask_decoder_hq import MaskDecoderHQ
from crowdsam_tpu_torch.models.tiny_vit import TinyViT
from crowdsam_tpu_torch.utils.weights import (
    dino_state_dict_from_jax,
    image_encoder_state_dict,
    mask_decoder_state_dict,
    mask_decoder_tree,
    tiny_vit_state_dict,
)

ENCODER_TOL = dict(atol=2e-3, rtol=0)
MODULE_TOL = dict(atol=1e-4, rtol=1e-4)
# A SAM encoder shaped like ViT-H at a small width: 160 wide, 2 heads (head
# dim 80), 2 blocks of which the second is global, a 256^2 image.
VIT_H_SMALL = dict(embed_dim=160, depth=2, num_heads=2,
                   global_attn_indexes=(1,))


def _rng(seed):
    return np.random.default_rng(seed)


def _np_tree(module, *args, seed=0, **kw):
    return jax_tree_to_numpy(fast_random_init(module, *args, seed=seed, **kw))


@pytest.mark.parametrize("interm", [False, True])
def test_head_dim_80_encoder_matches_jax(interm):
    jenc = JaxEncoder(img_size=256, **VIT_H_SMALL)
    x = _rng(0).normal(0, 1, (1, 256, 256, 3)).astype(np.float32)
    params = _np_tree(jenc, jnp.zeros((1, 256, 256, 3)))
    # fast_random_init leaves the rel-pos tables at N(0, 0.02): make them
    # matter at the tolerance.
    for blk in (v for k, v in params.items() if k.startswith("blocks_")):
        for t in ("rel_pos_h", "rel_pos_w"):
            blk["attn"][t] = _rng(1).normal(0, 0.5, blk["attn"][t].shape
                                            ).astype(np.float32)
    enc = ImageEncoderViT(img_size=256, **VIT_H_SMALL).eval()
    enc.load_state_dict(image_encoder_state_dict(params), strict=True)
    assert enc.blocks[0].attn.rel_pos_h.shape[-1] == 80
    want = jenc.apply({"params": params}, jnp.asarray(x),
                      return_interm=interm)
    with torch.no_grad():
        got = enc(torch.from_numpy(x), return_interm=interm)
    if not interm:
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **ENCODER_TOL)


@pytest.fixture(scope="module")
def hq_pair():
    """The JAX HQ decoder (vit_dim 160, dino_dim 64) with every leaf drawn,
    and the port's on the same tree."""
    h = 16
    jdec = JaxHQ(vit_dim=160, dino_dim=64)
    params = _np_tree(
        jdec, jnp.zeros((1, h, h, 256)), jnp.zeros((h, h, 256)),
        jnp.zeros((1, 2, 256)), jnp.zeros((1, h, h, 256)),
        jnp.zeros((4 * h, 4 * h, 64)), jnp.zeros((1, h, h, 160)),
        method=jdec.init_all, seed=3)
    dec = MaskDecoderHQ(vit_dim=160, dino_dim=64).eval()
    missing, unexpected = dec.load_state_dict(
        mask_decoder_state_dict(params), strict=False)
    assert not unexpected
    assert {k.split(".layers.")[0] for k in missing} == {
        "output_hypernetworks_mlps.4"}
    return jdec, params, dec


def test_compute_hq_features_matches_jax(hq_pair):
    jdec, params, dec = hq_pair
    rng = _rng(4)
    emb = rng.normal(0, 1, (1, 16, 16, 256)).astype(np.float32)
    interm = rng.normal(0, 1, (1, 16, 16, 160)).astype(np.float32)
    want = jdec.apply({"params": params}, jnp.asarray(emb),
                      jnp.asarray(interm), method=jdec.compute_hq_features)
    with torch.no_grad():
        got = dec.compute_hq_features(torch.from_numpy(emb),
                                      torch.from_numpy(interm))
    assert got.shape == (1, 64, 64, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODULE_TOL)


@pytest.mark.parametrize("multi", [True, False])
def test_mask_decoder_hq_matches_jax(hq_pair, multi):
    """HQ token and fusion, SAM masks 1-3 (multimask) or mask 0 plus the
    HQ mask, and the PWD-Net heads pooling the raw DINO map."""
    jdec, params, dec = hq_pair
    rng = _rng(5)
    args = [rng.normal(0, 1, s).astype(np.float32) for s in (
        (1, 16, 16, 256), (16, 16, 256), (3, 2, 256), (3, 16, 16, 256))]
    hq = rng.normal(0, 1, (1, 64, 64, 32)).astype(np.float32)
    dino = rng.normal(0, 1, (64, 64, 64)).astype(np.float32)
    want = jdec.apply({"params": params}, *map(jnp.asarray, args), multi,
                      hq_features=jnp.asarray(hq),
                      dino_feats_256=jnp.asarray(dino))
    with torch.no_grad():
        got = dec(*map(torch.from_numpy, args), multi,
                  hq_features=torch.from_numpy(hq),
                  dino_feats_256=torch.from_numpy(dino))
    k = 3 if multi else 1
    assert got[0].shape == (3, k, 64, 64) and got[2].shape == (3, k, 1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **ENCODER_TOL)


def test_mask_decoder_tree_round_trips_the_hq_leaves(hq_pair):
    """The port's HQ decoder state dict -> the JAX tree -> back: every
    leaf equal, so a decoder the port holds saves as the JAX package's."""
    _, params, dec = hq_pair
    tree = mask_decoder_tree(dec.state_dict())
    for key in ("hf_token", "hf_mlp", "compress_vit_0", "embed_enc_1",
                "embed_mf_3"):
        assert key in tree
    back = mask_decoder_state_dict(tree)
    for key, value in back.items():
        assert torch.equal(value, dec.state_dict()[key].float()), key


@pytest.mark.parametrize("image_size", [128])
def test_tiny_vit_matches_jax(image_size):
    """MobileSAM's TinyViT at 128^2: stages 1 and 3 pad their grids to the
    window, stage 2 cuts its window of 14 to the 8x8 grid (smaller bias
    tables); `test_torch_arch_pipeline.py` runs it at 256^2."""
    jvit = JaxTinyViT(img_size=image_size)
    x = _rng(6).normal(0, 1, (1, image_size, image_size, 3)).astype(
        np.float32)
    params = _np_tree(jvit, jnp.zeros((1, image_size, image_size, 3)))
    for name, blk in params.items():      # make the bias tables matter
        if "attn" in blk:
            t = blk["attn"]["attention_biases"]
            blk["attn"]["attention_biases"] = _rng(7).normal(
                0, 1.0, t.shape).astype(np.float32)
    vit = TinyViT(img_size=image_size).eval()
    vit.load_state_dict(tiny_vit_state_dict(params), strict=True)
    want = jvit.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = vit(torch.from_numpy(x))
    assert got.shape == (1, image_size // 16, image_size // 16, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ENCODER_TOL)


def test_tiny_vit_folds_a_reference_conv_bn_checkpoint():
    """A reference checkpoint's Conv2d_BN (conv weight + BatchNorm) loads
    into the port's folded conv as the JAX converter folds it."""
    from crowdsam_tpu.utils.checkpoint import _conv_bn

    from crowdsam_tpu_torch.models.tiny_vit import ConvBN

    rng = _rng(8)
    sd = {"c.weight": rng.normal(0, 1, (6, 4, 3, 3)),
          "bn.weight": rng.uniform(0.5, 2, 6), "bn.bias": rng.normal(0, 1, 6),
          "bn.running_mean": rng.normal(0, 1, 6),
          "bn.running_var": rng.uniform(0.5, 2, 6)}
    sd = {k: v.astype(np.float32) for k, v in sd.items()}
    want = _conv_bn({f"x.{k}": v for k, v in sd.items()}, "x")
    m = ConvBN(4, 6, 3)
    m.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}
                      | {"bn.num_batches_tracked": torch.tensor(3)})
    np.testing.assert_allclose(m.c.weight.detach().numpy().transpose(
        2, 3, 1, 0), want["kernel"], **MODULE_TOL)
    np.testing.assert_allclose(m.c.bias.detach().numpy(), want["bias"],
                               **MODULE_TOL)


def test_dinov2_vitb14_matches_jax():
    """DINOv2 ViT-B/14 (768 wide, 12 heads of 64) cut to 2 blocks."""
    from crowdsam_tpu.models.dinov2 import DinoVisionTransformer as JaxDino

    kw = dict(patch_size=14, embed_dim=768, depth=2, num_heads=12)
    jdino = JaxDino(**kw, dtype=jnp.float32)
    params = _np_tree(jdino, jnp.zeros((1, 28, 28, 3)), seed=9)
    dino = DinoVisionTransformer(**kw).eval()
    dino.load_state_dict(dino_state_dict_from_jax(params), strict=True)
    x = _rng(10).normal(0, 1, (1, 98, 98, 3)).astype(np.float32)
    want = jdino.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = dino(torch.from_numpy(x))
    for key in ("x_norm_clstoken", "x_norm_patchtokens"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   **ENCODER_TOL)
    assert jax_dinos["dinov2_vitb14"]().embed_dim == 768
