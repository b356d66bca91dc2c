"""K5's plain version (`models/decode_tail_kernel.twoway_tail_plain`) at the
shapes the kernel's batched token side can get wrong, on the CPU, against
the JAX package's Pallas kernel in interpret mode on the same weights and
numpy-seeded inputs: one prompt, prompt counts whose 8-row token blocks do
not fill a 64-row tile, and 5 and 8 tokens.  Plus the properties that the
kernel's decomposition relies on: prompts do not interact (the kernel
stacks 8 prompts into one tile of rows), and the MLP's 2048-deep second
product may be summed over eight 256-wide partials (the kernel's K-split).

Tolerances: the JAX package's own bound for its tail kernel against its
XLA path, as in `tests/test_torch_fused_decode.py`: |err| / max(|y|, 1)
with a median below 0.02 and a maximum below 0.12 (image tensor) or 0.06
(tokens); both sides round to bf16 after every stage, at slightly different
places.  Prompt independence: a prompt alone against the same prompt in a
batch of nine, within the kernel's own bound (2e-2 + 2^-7 |y|, as
`chip_smoke.py` holds the kernel): the batched products sum in another f32
order, so a value may round one bf16 step apart before a LayerNorm, while a
prompt that read another's rows would be off by the outputs' own scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crowdsam_tpu.models import decode_tail_kernel as jax_tail
from crowdsam_tpu.models import fused_decode as jax_fused
from crowdsam_tpu.models.build import sam_model_registry as jax_registry
from crowdsam_tpu.utils.checkpoint import jax_tree_to_numpy

from crowdsam_tpu_torch.models import decode_tail_kernel
from crowdsam_tpu_torch.models.build import sam_model_registry
from crowdsam_tpu_torch.models.common import cast_compute_params
from crowdsam_tpu_torch.models.fused_decode import precompute_decode_shared
from crowdsam_tpu_torch.utils.weights import sam_state_dict_from_jax

H = 16                      # vit_tiny: 256 / 16 -> M = 256 image rows
BF = torch.bfloat16


@pytest.fixture(scope="module")
def models():
    jsam = jax_registry["vit_tiny"](n_class=1, dtype=jnp.bfloat16)
    sam = sam_model_registry["vit_tiny"](n_class=1, dino_dim=1024)
    sam.load_state_dict(sam_state_dict_from_jax(jax_tree_to_numpy(
        jsam.params)), strict=False)
    cast_compute_params(sam.eval(), BF)
    rng = np.random.default_rng(23)
    feats = rng.normal(0, 1, (1, H, H, 256)).astype(np.float32)
    pe = rng.normal(0, 1, (H, H, 256)).astype(np.float32)
    return jsam, sam, feats, pe


def _shared(sam, feats, pe):
    return precompute_decode_shared(
        sam.mask_decoder, sam.prompt_encoder.no_mask_embed.weight,
        torch.from_numpy(feats).to(BF), torch.from_numpy(pe),
        kernel_route=True)


def _tokens(p, t, seed):
    """(P, T, 256) bf16 tokens from a numpy seed (as numpy f32)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (p, t, 256)).astype(np.float32)
    return np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def _args(shared, tokens):
    return (shared["keys0"], shared["q1i_flat"], shared["k1_flat"],
            shared["v1_flat"], torch.from_numpy(tokens).to(BF),
            shared["tail"])


def _assert_close(got, want, max_tol, name):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
    assert np.isfinite(got).all(), name
    assert np.median(rel) < 0.02, (name, float(np.median(rel)))
    assert rel.max() < max_tol, (name, float(rel.max()))


@pytest.mark.parametrize("p,t", [(1, 7), (9, 7), (2, 5), (2, 8)])
def test_twoway_tail_plain_matches_pallas_at_token_side_shapes(
        models, monkeypatch, p, t):
    jsam, sam, feats, pe = models
    monkeypatch.setenv("CROWDSAM_FORCE_TAIL_KERNEL", "1")
    shared_j = jax_fused.precompute_decode_shared(
        jsam.params["mask_decoder"],
        jsam.params["prompt_encoder"]["no_mask_embed"],
        jnp.asarray(feats).astype(jnp.bfloat16), jnp.asarray(pe),
        num_heads=8, dtype=jnp.bfloat16)
    tokens = _tokens(p, t, 100 + 10 * p + t)
    keys2_j, tok_j = jax_tail.twoway_tail_pallas(
        shared_j["keys0"], shared_j["q1i_flat"], shared_j["k1_flat"],
        shared_j["v1_flat"], jnp.asarray(tokens).astype(jnp.bfloat16),
        shared_j["tail"], num_heads=8, interpret=True)
    keys2, tok = decode_tail_kernel.twoway_tail(
        *_args(_shared(sam, feats, pe), tokens))
    assert keys2.shape == (p, H * H, 256) and tok.shape == (p, t, 256)
    _assert_close(keys2, keys2_j, 0.12, "keys2")
    _assert_close(tok, tok_j, 0.06, "tokens")


def test_prompts_do_not_interact(models):
    """Each prompt of a batch of nine (one full 64-row token tile and one
    prompt more) gives what it gives alone."""
    _, sam, feats, pe = models
    shared = _shared(sam, feats, pe)
    tokens = _tokens(9, 7, 7)
    keys2, tok = decode_tail_kernel.twoway_tail_plain(*_args(shared, tokens))
    for i in (0, 7, 8):
        k1, t1 = decode_tail_kernel.twoway_tail_plain(
            *_args(shared, tokens[i:i + 1]))
        for got, want in ((k1[0], keys2[i]), (t1[0], tok[i])):
            err = (got.float() - want.float()).abs()
            assert (err <= 2e-2 + 2.0 ** -7 * want.float().abs()).all()


def test_mlp_k_split_partials_sum_to_the_product(models):
    """The MLP's second product over the 2048 hidden columns equals the sum,
    in rank order, of the eight partials of 256 columns that the kernel's
    eight cluster blocks compute (f32, the kernel's accumulation type)."""
    _, sam, feats, pe = models
    params = _shared(sam, feats, pe)["tail"]
    rng = np.random.default_rng(5)
    for name in ("mlp2l0_w", "mlp2_w"):
        w = params[name].float()
        assert w.shape == (256, decode_tail_kernel.MLP_DIM)
        h = torch.from_numpy(rng.normal(0, 1, (64, w.shape[1])).astype(
            np.float32)).relu().to(BF).float()
        whole = h @ w.T
        parts = torch.zeros_like(whole)
        for r in range(8):
            sl = slice(256 * r, 256 * (r + 1))
            parts += h[:, sl] @ w[:, sl].T
        np.testing.assert_allclose(parts.numpy(), whole.numpy(), rtol=1e-5,
                                   atol=1e-4)
