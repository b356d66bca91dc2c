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
MOBILE = ["model.sam_arch", "mobile_sam", "model.sam_model", "mobilevit_t",
          "model.image_size", "256"]
# Past vit_tiny's two window rows, and TinyViT: (arch, mesh shape, batch).
HALO_LAYOUTS = [("vit", (1, 3), 2), ("vit", (1, 4), 2),
                ("mobile", (1, 2), 2)]
# The JAX spatial run each arch is held against: at (1, 3) the JAX package
# refuses vit_tiny's frame (see `_halo_jax`), so both vit_tiny layouts are
# held against its (1, 4) run.
JAX_HALO = {"vit": (1, 4), "mobile": (1, 2)}
# The band encodes: (arch, M); vit_tiny at M = 8 has bands of 2 rows.
HALO_ENCODES = [("vit", 3), ("vit", 4), ("vit", 8), ("mobile", 2),
                ("mobile", 3)]


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
    """SAM's 64-row grid in whole 14-row windows of the 70-row pad up to
    its five window rows, `split_rows` of the token rows past them, and
    the rows of the windows each band touches; DINOv2's 73 patch rows
    (cls with the first), the tiny configs' 16 and 18."""
    assert window_bands(64, 14, 2) == ((0, 42), (42, 64))
    assert window_bands(64, 14, 4) == ((0, 28), (28, 42), (42, 56),
                                       (56, 64))
    assert window_bands(64, 14, 5) == ((0, 14), (14, 28), (28, 42),
                                       (42, 56), (56, 64))
    assert window_bands(64, 14, 6) == split_rows(64, 6) == (
        (0, 11), (11, 22), (22, 33), (33, 44), (44, 54), (54, 64))
    assert Band(None, window_bands(64, 14, 6)).windows(14) == (
        (0, 14), (0, 28), (14, 42), (28, 56), (42, 56), (42, 64))
    assert Band(None, window_bands(64, 14, 2)).windows(14) == (
        (0, 42), (42, 64))
    assert window_bands(16, 14, 2) == ((0, 14), (14, 16))
    assert window_bands(16, 14, 3) == ((0, 6), (6, 11), (11, 16))
    assert window_bands(16, 14, 8) == tuple((2 * i, 2 * i + 2)
                                            for i in range(8))
    assert Band(None, window_bands(16, 14, 3)).windows(14) == (
        (0, 14), (0, 14), (0, 16))
    # TinyViT at 1024: the final grid's band at each stage's resolution.
    band = Band(None, split_rows(64, 3))
    assert band.scaled(4).bounds == ((0, 88), (88, 172), (172, 256))
    assert band.scaled(2).windows(7) == ((0, 49), (42, 91), (84, 128))
    assert split_rows(73, 2) == ((0, 37), (37, 73))
    assert Band(None, split_rows(73, 2)).with_cls(73).bounds == (
        (0, 2702), (2702, 5330))
    assert split_rows(18, 2) == ((0, 9), (9, 18))
    with pytest.raises(ValueError, match="bands"):
        window_bands(16, 14, 17)
    with pytest.raises(ValueError, match="bands"):
        split_rows(2, 3)


def test_spatial_axis_wider_than_the_windows_is_refused():
    """Past the window rows the bands are token rows, but vit_tiny's
    16-row grid has no band for a 17th rank (read from the mesh's shape
    alone, on a process group formed in this process); 4 ranks, past its
    two window rows, have bands."""
    pm = CrowdSAM(modify_config(load_config(None), list(TINY_RLES)),
                  device="cpu")
    with fake_group(17):
        with pytest.raises(ValueError, match="16 rows do not split"):
            ShardedPipeline(pm, mesh=create_mesh((1, 17), device="cpu"),
                            batch=2, spatial_axis="model")
        pipe = ShardedPipeline(pm, mesh=create_mesh((1, 4), device="cpu"),
                               batch=2, spatial_axis="model")
        assert pipe.spatial.size == 4


# ---------------------------------------------------------------------------
# ranks spawned with gloo
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def spatial_jax():
    """The images, the noise JAX draws for them, the JAX spatial runs on
    each mesh shape, the port's `mesh=None` run and model at batch 2, and
    the two frames of the encode check; under "halo" the same for the
    layouts past the window rows and on TinyViT (`HALO_LAYOUTS`)."""
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
    jm._key = key
    return images, noise, want, one, pm, frames, in_hw, _halo_jax(
        jm, pm, images, noise)


def _halo_jax(jm, pm, images, noise) -> dict:
    """Per arch ("vit": vit_tiny, "mobile": mobile_sam) the port's model
    and its `mesh=None` run, the noise JAX draws, the JAX spatial run on
    the mesh shape each port layout is held against (each from the key
    `noise` was drawn from), and what the JAX package raises at (1, 3) on
    vit_tiny (its 256 frame rows do not divide over 3 devices)."""
    jmm, pmm = build_pair(list(TINY_RLES) + MOBILE)
    mobile_noise = _jax_batch_noise(jmm, len(images))
    out = {"vit": (pm, noise, {}), "mobile": (pmm, mobile_noise, {})}
    for arch, shape in JAX_HALO.items():
        jmodel = jm if arch == "vit" else jmm
        key = jmodel._key
        out[arch][2][shape] = JaxPipeline(
            jmodel, mesh=jax_create_mesh(shape), batch=2,
            spatial_axis="model").generate_batch(images)
        jmodel._key = key
    out["one"] = {arch: ShardedPipeline(out[arch][0], batch=2).generate_batch(
        images, noise=out[arch][1]) for arch in ("vit", "mobile")}
    with pytest.raises(ValueError, match="divisible by 3") as e:
        JaxPipeline(jm, mesh=jax_create_mesh((1, 3)), batch=2,
                    spatial_axis="model").generate_batch(images[:2])
    out["jax_1x3"] = str(e.value)
    return out


@pytest.fixture(scope="module")
def spatial_ranks(spatial_jax, tmp_path_factory):
    images, noise, _, _, _, frames, in_hw, halo = spatial_jax
    return run_ranks(spatial_rank, 8, (
        list(TINY_RLES), images, noise, frames, in_hw, LAYOUTS, dict(
            mobile_opts=list(TINY_RLES) + MOBILE,
            mobile_noises=halo["mobile"][1], encodes=_encode_frames(),
            layouts=HALO_LAYOUTS)),
        join_timeout_s=300.0,
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
    _, _, _, _, pm, frames, in_hw, _ = spatial_jax
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


def _encode_frames() -> dict:
    """A normalized-looking frame (seeded normals) for each band encode."""
    rng = np.random.default_rng(11)
    frames = {arch: rng.normal(size=(1, 256, 256, 3)).astype(np.float32)
              for arch in ("vit", "mobile")}
    return {case: frames[case[0]] for case in HALO_ENCODES}


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
    _, _, want, one, pm, _, _, _ = spatial_jax
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


# ---------------------------------------------------------------------------
# past the window rows, and TinyViT: row halos
# ---------------------------------------------------------------------------

def test_gather_halo_bit_for_bit(spatial_ranks):
    """Bands of 3, 2 and 7 rows of 12 of every dtype, special floats among
    them, widened to the 8-row windows they touch ([0, 8) spans all three
    ranks): the rows of the whole, bit for bit; one all-reduce of the
    halo's 8 rows [0, 8), not the whole extent."""
    for r in spatial_ranks[:3]:
        for dtype, (got, want, counts) in r["halo"]["gather_halo"].items():
            assert got.dtype == want.dtype and got.shape == want.shape
            assert torch.equal(got.view(torch.uint8),
                               want.view(torch.uint8)), dtype
            assert counts == (1, 2 * 8 * 3 * got.element_size()), dtype
    assert all(r["halo"]["gather_halo"] is None for r in spatial_ranks[3:])


def _halo_rows(bounds, need) -> int:
    """The rows an exchange reduces: those some rank needs and does not
    hold."""
    return len({i for (a, b), (lo, hi) in zip(need, bounds)
                for i in range(a, b) if not lo <= i < hi})


def _windows(bounds, window, grid):
    return tuple((lo // window * window, min(-(-hi // window) * window,
                                             grid)) for lo, hi in bounds)


def _around(bounds, stride, grid):
    """The input rows a 3x3 convolution (padding 1) reads for each band of
    its output."""
    return tuple((max(lo * stride - 1, 0), min((hi - 1) * stride + 2, grid))
                 for lo, hi in bounds)


def _vit_expected(enc, m):
    """SAM ViT's band encode at M ranks (float32, one frame): the
    all-reduces and bytes, and each rank's padded window rows at each
    window block's qkv."""
    grid, ws, c = enc.img_size // enc.patch_size, enc.window_size, \
        enc.embed_dim
    bounds = window_bands(grid, ws, m)
    need = _windows(bounds, ws, grid)
    halo = _halo_rows(bounds, need)
    n_win = sum(blk.attn.window > 0 for blk in enc.blocks)
    n_global = len(enc.blocks) - n_win
    calls = (n_win if halo else 0) + n_global + 1
    nbytes = 4 * (n_win * halo * grid * c + n_global * grid * grid * 2 * c
                  + grid * grid * 256)
    rows = [-(-(b - a) // ws) * ws for a, b in need]
    return calls, nbytes, {r: [(1, rows[r], -(-grid // ws) * ws, c)] * n_win
                           for r in range(m)}


def _tiny_vit_expected(enc, m):
    """TinyViT's band encode at M ranks (float32, one frame): the
    all-reduces and bytes of its exchanges, stage by stage as the module's
    docstring lists them, and each rank's shapes at the hooked calls (the
    1x1 convolution before a 3x3 one: band and halo rows; a window
    attention's qkv: its windows)."""
    from crowdsam_tpu_torch.models import tiny_vit

    final = enc.img_size // 16
    bands = [tuple((lo * f, hi * f) for lo, hi in split_rows(final, m))
             for f in enc.stage_factors]
    calls, nbytes = 0, 0
    seen = {r: [] for r in range(m)}

    def exchange(bounds, need, width, ch):
        nonlocal calls, nbytes
        halo = _halo_rows(bounds, need)
        calls += bool(halo)
        nbytes += 4 * halo * width * ch

    for s, layer in enumerate(enc.layers):
        b = bands[s]
        grid = b[-1][1]
        for blk in layer.blocks:
            if isinstance(blk, tiny_vit.MBConv):
                need = _around(b, 1, grid)
                ch = blk.conv1.c.in_channels
                exchange(b, need, grid, ch)
                for r, (lo, hi) in enumerate(need):
                    seen[r].append((1, hi - lo, grid, ch))
            else:
                ws, ch = blk.window, blk.local_conv.c.in_channels
                need = _windows(b, ws, grid)
                exchange(b, need, grid, ch)
                for r, (lo, hi) in enumerate(need):
                    n = -(-(hi - lo) // ws) * (-(-grid // ws))
                    seen[r].append((n, ws * ws, ch))
                exchange(b, _around(b, 1, grid), grid, ch)
        if layer.downsample is not None:
            stride = layer.downsample.conv2.c.stride[0]
            need = _around(bands[s + 1], stride, grid)
            ch = layer.downsample.conv1.c.in_channels
            exchange(b, need, grid, ch)
            for r, (lo, hi) in enumerate(need):
                seen[r].append((1, hi - lo, grid, ch))
    return calls + 1, nbytes + 4 * final * final * 256, seen


@pytest.mark.parametrize("case", HALO_ENCODES,
                         ids=lambda c: f"{c[0]}-M{c[1]}")
def test_halo_encode_matches_whole_encode(spatial_jax, spatial_ranks,
                                          case):
    """The band encode (`forward_band`) of one frame on a (1, M) mesh:
    within 1e-5 relative L2 of the whole encode (float32), every rank bit
    for bit alike, the all-reduces and bytes counted (each exchange
    reduces only its halo's rows), and the rows that reach each rank's
    window attentions and halo'd convolutions no more than its band, the
    windows it touches and its halo (ranks outside the mesh skip it)."""
    arch, m = case
    model = spatial_jax[7][arch][0]
    enc = model.sam.image_encoder
    with torch.no_grad():
        want = enc(torch.from_numpy(_encode_frames()[case])).numpy()
    calls, nbytes, seen = (_vit_expected if arch == "vit"
                           else _tiny_vit_expected)(enc, m)
    first = spatial_ranks[0]["halo"][case][0]
    assert first.shape == want.shape
    assert np.linalg.norm(first - want) / np.linalg.norm(want) <= 1e-5
    for r, rank in enumerate(spatial_ranks[:m]):
        got, n_calls, n_bytes, shapes = rank["halo"][case]
        np.testing.assert_array_equal(got, first)
        assert (n_calls, n_bytes) == (calls, nbytes), r
        assert [sh for _, sh in shapes] == seen[r], r
    assert all(case not in r["halo"] for r in spatial_ranks[m:])


@pytest.mark.parametrize("layout", HALO_LAYOUTS,
                         ids=lambda lay: f"{lay[0]}-{lay[1][0]}x{lay[1][1]}")
def test_halo_axis_matches_jax_and_one_device(spatial_jax, spatial_ranks,
                                              layout):
    """`ShardedPipeline(spatial_axis="model")` past vit_tiny's window rows
    and on TinyViT: every rank of the mesh returns every image's result,
    equal to the JAX spatial run (`JAX_HALO`) and to the port's
    `mesh=None` path, every other rank's bit for bit rank 0's; a chunk's
    encode makes the band encode's all-reduces and DINOv2's."""
    arch, shape, batch = layout
    halo = spatial_jax[7]
    pm, _, want = halo[arch]
    got, _ = spatial_ranks[0]["halo"][layout]
    _assert_close(got, want[JAX_HALO[arch]])
    _assert_close(got, halo["one"][arch])
    assert sum(len(g["boxes"]) for g in got) > 0
    enc, dino = pm.sam.image_encoder, pm.predictor.dino_model
    calls, nbytes, _ = (_vit_expected if arch == "vit"
                        else _tiny_vit_expected)(enc, shape[1])
    tokens = 1 + pm.predictor.dino_grid ** 2
    calls += len(dino.blocks) + 1
    per_image = nbytes + 4 * (len(dino.blocks) * tokens * 2 * dino.embed_dim
                              + tokens * dino.embed_dim)
    n_img = len(got)
    for rank, r in enumerate(spatial_ranks[:shape[1]]):
        if rank:
            _assert_close(r["halo"][layout][0], got, exact=True)
        for c, count in enumerate(r["halo"][layout][1]):
            mine = min(batch, n_img - c * batch)
            assert count == (calls, per_image * mine), (rank, c)


def test_jax_refuses_vit_tiny_frame_rows_over_three(spatial_jax):
    """Why the (1, 3) layout is held against the JAX (1, 4) run: the JAX
    package asks its 256 frame rows to divide over the axis."""
    assert "divisible by 3" in spatial_jax[7]["jax_1x3"]
