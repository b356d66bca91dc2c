"""The spatial axis of the port's batched pipeline (`parallel/spatial.py`,
`ShardedPipeline(spatial_axis=...)`) on the CPU.

The query-band forms of K3's and K4's plain versions against the rows of
the whole call; the band layouts; then ranks spawned with gloo (one launch
for the file, importing only the port): `gather_bands` of unequal bands
bit for bit on every dtype, the band encode of two frames against the
whole encode (float32, within 1e-5 relative L2), and
`ShardedPipeline(spatial_axis="model")` on (1, 2) and (2, 2) meshes, with
and without `prompt_axis="model"`, three images at batch 2 (the last chunk
partial, so on (2, 2) the ranks at data coordinate 1 get no image of it).
Each layout is held against the JAX `ShardedPipeline(...,
spatial_axis="model")` on the same mesh shape -- on (1, 2) without and on
(2, 2) with `prompt_axis="model"`; the JAX package's own tests pin its
prompt-sharded engine equal to the unsharded one -- with
`test_torch_eval_shard._assert_close` (counts, categories, boxes within
0.5 px, scores within 1e-4, RLE strings equal), and against the port's
`mesh=None` path; every rank's results equal rank 0's bit for bit, and the
spatial axis's all-reduces are counted: one a global block of SAM's ViT,
one for its neck, one a DINOv2 block and one for its tokens, an encode of
a chunk, with the bytes they reduce."""

import numpy as np
import pytest
import torch
from test_torch_eval_shard import _assert_close, _images, _jax_batch_noise
from test_torch_modes import build_pair
from test_torch_pipeline import _one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_pipeline import TINY_RLES

from torch_ranks import fake_group, spatial_rank

from crowdsam_tpu.parallel.eval_shard import ShardedPipeline as JaxPipeline
from crowdsam_tpu.parallel.mesh import create_mesh as jax_create_mesh

from crowdsam_tpu_torch.config import load_config, modify_config
from crowdsam_tpu_torch.models.attention import (
    flash_mha,
    flash_mha_decomposed_relpos,
    flash_mha_plain,
    relpos_attention_plain,
)
from crowdsam_tpu_torch.parallel.eval_shard import ShardedPipeline
from crowdsam_tpu_torch.parallel.launch import run_ranks
from crowdsam_tpu_torch.parallel.mesh import create_mesh
from crowdsam_tpu_torch.parallel.spatial import (
    Band,
    split_rows,
    window_bands,
)
from crowdsam_tpu_torch.pipeline.crowdsam import CrowdSAM

# (mesh shape, batch, prompt axis), all with spatial_axis "model".
LAYOUTS = [((1, 2), 2, None), ((1, 2), 2, "model"), ((2, 2), 2, None),
           ((2, 2), 2, "model")]
# The JAX layout each mesh shape is held against.
JAX_PROMPT_AXIS = {(1, 2): None, (2, 2): "model"}


def _qkv(seed, lead, s, hd):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=lead + (s, hd)).astype(
        np.float32)) for _ in range(3)]


@pytest.mark.parametrize("hw,window,parts", [((16, 16), 14, 2),
                                             ((21, 10), 7, 3)])
def test_k3_band_plain_equals_full_rows(hw, window, parts):
    """Each window-aligned band of query rows against every key: the rows
    of the whole call, through the plain version and through the wrapper
    (a CPU tensor takes the plain version)."""
    h, w = hw
    q, k, v = _qkv(1, (1, 2), h * w, 32)
    rng = np.random.default_rng(2)
    rh, rw = (torch.from_numpy(0.1 * rng.normal(size=(n, n, 32)).astype(
        np.float32)) for n in hw)
    scale = 32 ** -0.5
    full = relpos_attention_plain(q, k, v, scale, rh, rw, hw)
    for lo, hi in window_bands(h, window, parts):
        rows = slice(lo * w, hi * w)
        for fn in (relpos_attention_plain, flash_mha_decomposed_relpos):
            got = fn(q[..., rows, :], k, v, scale, rh, rw, hw, lo)
            assert got.shape == (1, 2, (hi - lo) * w, 32)
            torch.testing.assert_close(got, full[..., rows, :], rtol=1e-6,
                                       atol=1e-6)


@pytest.mark.parametrize("valid", [None, 300])
def test_k4_band_plain_equals_full_rows(valid):
    """DINOv2's token bands (the cls token with the first) of an 18x18
    patch grid, against every key (and with keys from 300 on masked)."""
    s = 1 + 18 * 18
    q, k, v = _qkv(3, (2, 3), s, 64)
    full = flash_mha_plain(q, k, v, 0.125, valid)
    band = Band(None, split_rows(18, 2)).with_cls(18)
    assert band.bounds == ((0, 163), (163, 325))
    for lo, hi in band.bounds:
        for fn in (flash_mha_plain, flash_mha):
            got = fn(q[..., lo:hi, :], k, v, 0.125, valid)
            torch.testing.assert_close(got, full[..., lo:hi, :], rtol=1e-6,
                                       atol=1e-6)


def test_band_layouts():
    """SAM's 64-row grid in whole 14-row windows of the 70-row pad, DINOv2's
    73 patch rows (cls with the first), the tiny configs' 16 and 18."""
    assert window_bands(64, 14, 2) == ((0, 42), (42, 64))
    assert window_bands(64, 14, 4) == ((0, 28), (28, 42), (42, 56),
                                       (56, 64))
    assert window_bands(16, 14, 2) == ((0, 14), (14, 16))
    assert split_rows(73, 2) == ((0, 37), (37, 73))
    assert Band(None, split_rows(73, 2)).with_cls(73).bounds == (
        (0, 2702), (2702, 5330))
    assert split_rows(18, 2) == ((0, 9), (9, 18))
    with pytest.raises(ValueError, match="window rows"):
        window_bands(16, 14, 3)
    with pytest.raises(ValueError, match="bands"):
        split_rows(2, 3)


def test_spatial_axis_wider_than_the_windows_is_refused():
    """vit_tiny's 16-row grid has two window rows: a spatial axis of 4
    ranks has no band for two of them (read from the mesh's shape alone,
    on a process group formed in this process)."""
    pm = CrowdSAM(modify_config(load_config(None), list(TINY_RLES)),
                  device="cpu")
    with fake_group(4):
        with pytest.raises(ValueError, match="window rows"):
            ShardedPipeline(pm, mesh=create_mesh((1, 4), device="cpu"),
                            batch=2, spatial_axis="model")


# ---------------------------------------------------------------------------
# ranks spawned with gloo
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def spatial_jax():
    """The images, the noise JAX draws for them, the JAX spatial runs on
    each mesh shape, the port's `mesh=None` run and model at batch 2, and
    the two frames of the encode check."""
    jm, pm = build_pair(list(TINY_RLES))
    images = _images(90)
    noise = _jax_batch_noise(jm, len(images))
    key, want = jm._key, {}
    for shape, prompt_axis in JAX_PROMPT_AXIS.items():
        jm._key = key
        want[shape] = JaxPipeline(
            jm, mesh=jax_create_mesh(shape), batch=2, spatial_axis="model",
            prompt_axis=prompt_axis).generate_batch(images)
    one = ShardedPipeline(pm, batch=2).generate_batch(images, noise=noise)
    s = pm.sam.img_size
    frames = np.zeros((2, s, s, 3), dtype=np.uint8)
    in_hw = [im.shape[:2] for im in images[:2]]
    for i, im in enumerate(images[:2]):
        frames[i, :im.shape[0], :im.shape[1]] = im
    return images, noise, want, one, pm, frames, in_hw


@pytest.fixture(scope="module")
def spatial_ranks(spatial_jax, tmp_path_factory):
    images, noise, _, _, _, frames, in_hw = spatial_jax
    return run_ranks(spatial_rank, 4, (
        list(TINY_RLES), images, noise, frames, in_hw, LAYOUTS),
        join_timeout_s=240.0,
        workdir=str(tmp_path_factory.mktemp("ranks")))


def test_gather_bands_bit_for_bit(spatial_ranks):
    """Bands of 3 and 5 rows of every dtype, special floats among them."""
    for r in spatial_ranks[:2]:
        for dtype, (got, want) in r["gather"].items():
            assert got.dtype == want.dtype and got.shape == want.shape
            assert torch.equal(got.view(torch.uint8),
                               want.view(torch.uint8)), dtype


def _spatial_bytes(pm, n):
    """Bytes the spatial axis reduces for an encode of n images (float32):
    K and V of SAM's grid a global block, the neck's map, K and V of
    DINOv2's tokens a block, its normed tokens."""
    enc, dino = pm.sam.image_encoder, pm.predictor.dino_model
    g, tokens = enc.img_size // enc.patch_size, 1 + pm.predictor.dino_grid ** 2
    n_global = sum(blk.attn.window == 0 for blk in enc.blocks)
    return 4 * n * (n_global * g * g * 2 * enc.embed_dim + g * g * 256
                    + len(dino.blocks) * tokens * 2 * dino.embed_dim
                    + tokens * dino.embed_dim)


def test_spatial_encode_matches_whole_encode(spatial_jax, spatial_ranks):
    """`encode_batch` with the spatial shard on two frames against the
    whole encode: features, DINOv2 tokens, their projection and the FG
    logits within 1e-5 relative L2, both ranks bit for bit alike; one
    all-reduce a global block, one for the neck, one a DINOv2 block and
    one for its tokens."""
    _, _, _, _, pm, frames, in_hw = spatial_jax
    with torch.no_grad():
        want = pm.predictor.encode_batch(torch.from_numpy(frames), in_hw)
    (got, counts), (other, _) = (r["encode"] for r in spatial_ranks[:2])
    for key in ("features", "dino_feats", "dino_proj_256", "fg_logits"):
        w = want[key].float().numpy()
        assert got[key].shape == w.shape, key
        rel = np.linalg.norm(got[key] - w) / np.linalg.norm(w)
        assert rel <= 1e-5, (key, rel)
        np.testing.assert_array_equal(got[key], other[key])
    enc = pm.sam.image_encoder
    n_global = sum(blk.attn.window == 0 for blk in enc.blocks)
    calls = n_global + 1 + len(pm.predictor.dino_model.blocks) + 1
    assert counts == (calls, _spatial_bytes(pm, 2))


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda lay: "x".join(
    map(str, lay[0])) + ("-prompt" if lay[2] else ""))
def test_spatial_axis_matches_jax_and_one_device(spatial_jax, spatial_ranks,
                                                 layout):
    """Every rank of the mesh returns every image's result in order, equal
    to the JAX spatial run on the mesh's shape and to the port's
    `mesh=None` path; every other rank's bit for bit rank 0's.  A chunk's
    encode makes the encode's all-reduces on every rank of a data
    coordinate that holds images of it, none on one that holds none."""
    shape, batch, _ = layout
    _, _, want, one, pm, _, _ = spatial_jax
    members = spatial_ranks[:shape[0] * shape[1]]
    got, _ = members[0][layout]
    _assert_close(got, want[shape])
    _assert_close(got, one)
    assert sum(len(g["boxes"]) for g in got) > 0
    n_img = len(one)
    per = batch // shape[0]
    calls = (sum(blk.attn.window == 0 for blk in pm.sam.image_encoder.blocks)
             + 1 + len(pm.predictor.dino_model.blocks) + 1)
    for rank, r in enumerate(members):
        if rank:
            _assert_close(r[layout][0], got, exact=True)
        d = rank // shape[1]
        for c, count in enumerate(r[layout][1]):
            mine = max(min(per, n_img - c * batch - d * per), 0)
            assert count == ((calls, _spatial_bytes(pm, mine)) if mine
                             else (0, 0)), (rank, c)
