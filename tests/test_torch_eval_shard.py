"""The port's batched pipeline (`parallel/eval_shard.ShardedPipeline`) on
the CPU: with no mesh against the JAX package's `ShardedPipeline` on the
same weights with the noise JAX draws from its key, against the port's own
`generate_many`, its refusals pinned beside the JAX path's, and the
image-axis forms of K5's plain version, the pooled head and the encode
against their per-image forms; with a mesh (ranks spawned with gloo,
importing only the port) the data axis (2, 1) and the composed (2, 2)
with the prompt axis, a partial chunk among them, against the JAX
`ShardedPipeline` on the same layouts (its 8 virtual CPU devices) and
against the port's `mesh=None` path, with the tolerances below (a rank
encodes B/D images where the one-device path encodes B, and a composed
rank decodes K/M prompts a batch: float32 products of other shapes).

Tolerances.  Against JAX (the tiny configs of `test_torch_pipeline.py`,
float32): the same detection count and categories, boxes within 0.5 px,
scores within 1e-4, RLE strings equal.  Against `generate_many`: at B = 1
equal bit for bit (the same operations on the same operands); at B > 1
the same counts, boxes within 0.5 px and scores within 1e-4, since the
encoders' products over B images sum in another order; RLE strings equal
or differing only at threshold ties: pixels where the two runs' upsampled
logits lie on both sides of the threshold (within the runs' largest
difference of that mask's logits of it: the upsample is a convex
combination), or whose cell's low-res cleanup edit differs between the
runs (the cleanup's input differing only at such ties).
The plain K5 with the image axis is one single-image computation a present
image, so it equals them bit for bit; the plain fused decode gathers each
prompt's image-side heads and the pooled head multiplies each group by
its own map, equal within 1e-5; the batched encode within 1e-4 of the
per-image encode (float32, other product shapes)."""

import jax
import numpy as np
import pytest
import torch
from test_torch_modes import build_pair
from test_torch_pipeline import _one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_pipeline import TINY, TINY_RLES, _image

from torch_ranks import data_shard_rank, fake_group

from crowdsam_tpu.parallel.eval_shard import ShardedPipeline as JaxPipeline
from crowdsam_tpu.parallel.mesh import create_mesh as jax_create_mesh

from crowdsam_tpu_torch.config import load_config, modify_config
from crowdsam_tpu_torch.models import decode_tail_kernel
from crowdsam_tpu_torch.models.fused_decode import (
    _pooled_from_exp,
    fused_decode,
    precompute_decode_shared,
)
from crowdsam_tpu_torch.ops.connected import remove_small_regions
from crowdsam_tpu_torch.ops.rle import coco_decode_rle
from crowdsam_tpu_torch.ops.survivor_kernel import upsample_plain
from crowdsam_tpu_torch.parallel.eval_shard import ShardedPipeline
from crowdsam_tpu_torch.parallel.launch import run_ranks
from crowdsam_tpu_torch.parallel.mesh import create_mesh
from crowdsam_tpu_torch.pipeline.crowdsam import CrowdSAM
from crowdsam_tpu_torch.pipeline.engine import survivor_core

SHAPES = [(200, 256, 3), (256, 192, 3), (256, 256, 3)]
# Each mode of the engine at least once, three JAX compiles in all.
CASES = {
    "fused-rles": list(TINY_RLES),
    "unfused-boxes-accumulate-max_area": list(TINY) + [
        "tpu.fused_decode", "false", "tpu.accumulate_occupy", "true",
        "test.mask_selection", "max_area", "test.filter_thresh", "0.0"],
    "fused-rles-fullres": list(TINY_RLES) + ["tpu.fullres_cleanup", "true"],
}


def _images(seed=30):
    return [_image(seed + i, s) for i, s in enumerate(SHAPES)]


def _jax_batch_noise(jm, n):
    """The vectors JAX's `generate_batch` draws for n real images (one
    split of the model's key each, engine.py's uniform), without
    advancing the key."""
    key, out = jm._key, []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.uniform(
            sub, (jm.engine_cfg.grid_size ** 2,))))
    return out


def _survivor_rows(cfg, res, in_hw):
    """The slab logits of an image's detections, in output order: the
    engine's valid rows that the survivor pass keeps."""
    idx = torch.nonzero(res["summary"][:, 0] > 0.5).flatten()
    sp = survivor_core(cfg, res["logits"][idx],
                       torch.tensor(in_hw, dtype=torch.int32), True)
    return res["logits"][idx[sp["summary"][:, 0] > 0.5]]


def _threshold_ties(cfg, got, want, res_got, res_want):
    """The pixels where RLE strings of the same detection differ; each must
    trace to a threshold tie (see the module's note).  Returns their
    count."""
    area = cfg.min_mask_region_area * (cfg.low_res / cfg.img_size) ** 2

    def edit(logits):
        binm = logits > cfg.mask_threshold
        m1, _ = remove_small_regions(binm, area, "holes", cfg.cc_max_iters)
        m2, _ = remove_small_regions(m1, area, "islands", cfg.cc_max_iters)
        return m2.to(torch.int8) - binm.to(torch.int8)

    ties, rows = 0, None
    for d, (a, b) in enumerate(zip(got["rles"], want["rles"])):
        if a == b:
            continue
        h, w = a["size"]
        if rows is None:
            rows = [_survivor_rows(cfg, r, (h, w))
                    for r in (res_got, res_want)]
        lg, lw = (r[d:d + 1].float() for r in rows)
        up_tie = ((upsample_plain(lg) > cfg.mask_threshold)
                  != (upsample_plain(lw) > cfg.mask_threshold))[0, :h, :w]
        cell = (edit(lg) != edit(lw)).repeat_interleave(4, 1) \
            .repeat_interleave(4, 2)[0, :h, :w]
        diff = torch.from_numpy(coco_decode_rle(a) != coco_decode_rle(b))
        assert (up_tie | cell)[diff].all(), f"detection {d}: flips away " \
                                            "from a tie"
        ties += int(diff.sum())
    return ties


def _assert_close(got, want, exact=False, engines=None, cfg=None):
    """`engines`: (the batch's, the single runs') engine results a
    image, to tell threshold ties apart in unequal RLE strings."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert len(g["boxes"]) == len(w["boxes"])
        if len(g["boxes"]):
            np.testing.assert_array_equal(g["categories"], w["categories"])
        if exact:
            assert set(g.keys()) == set(w.keys())
            for k in g.keys():
                if isinstance(g[k], np.ndarray):
                    np.testing.assert_array_equal(g[k], w[k])
                else:
                    assert g[k] == w[k], k
        np.testing.assert_allclose(g["boxes"], w["boxes"], atol=0.5)
        np.testing.assert_allclose(g["scores"], w["scores"], atol=1e-4)
        if engines is None:
            assert g["rles"] == w["rles"]
        else:
            ties = _threshold_ties(cfg, g, w, engines[0][i], engines[1][i])
            print(f"image {i}: {ties} RLE pixels at threshold ties")


@pytest.mark.parametrize("case", list(CASES))
def test_generate_batch_matches_jax(case):
    """B = 2 over three images of different sizes (the second chunk is
    partial: JAX pads it with its last image, the port runs one)."""
    jm, pm = build_pair(CASES[case])
    images = _images()
    noise = _jax_batch_noise(jm, len(images))
    want = JaxPipeline(jm, batch=2).generate_batch(images)
    got = ShardedPipeline(pm, batch=2).generate_batch(images, noise=noise)
    _assert_close(got, want)
    assert sum(len(g["boxes"]) for g in got) > 0
    for g in got:
        if pm.output_rles:
            assert all(isinstance(r["counts"], str) for r in g["rles"])
        else:
            assert g["rles"] == [None] * len(g["boxes"])


@pytest.fixture(scope="module", params=["fused", "unfused"])
def port_model(request):
    cfg = modify_config(load_config(None), list(TINY_RLES) + [
        "tpu.fused_decode", str(request.param == "fused").lower()])
    return CrowdSAM(cfg, device="cpu")


@pytest.mark.parametrize("batch", [1, 2, 3])
def test_generate_batch_equals_generate_many(port_model, batch):
    """The same generator seed through `generate_many` and through
    `generate_batch`: item by item the same detections; the engine's loop
    makes one host sync an iteration (none past `max_iters`)."""
    images = _images(40)
    port_model.generator.manual_seed(5)
    want, single = [], []
    for im in images:             # generate_many an image at a time
        want += port_model.generate_many([im])
        single.append(port_model.last_engine)
    port_model.generator.manual_seed(5)
    pipe = ShardedPipeline(port_model, batch=batch)
    times, batched = [], []
    got = []
    for c0 in range(0, 3, batch):
        got += pipe.generate_batch(images[c0:c0 + batch], times_out=times)
        batched += pipe.last_engine
    assert len(times) == 3 and all(t > 0 for t in times)
    _assert_close(got, want, exact=batch == 1, engines=(batched, single),
                  cfg=port_model.engine_cfg)
    assert sum(len(g["boxes"]) for g in got) > 0
    loop = pipe.last_engine[0]["loop"]
    cfg = port_model.engine_cfg
    assert 1 <= loop["iterations"] <= cfg.max_iters
    assert loop["syncs"] == loop["iterations"] + (
        loop["iterations"] < cfg.max_iters)


@pytest.mark.parametrize("arch", ["mobile_sam", "sam"])
def test_archs_the_jax_batched_path_runs(arch):
    """mobile_sam (TinyViT) and vanilla sam run batched in the JAX package:
    here too, equal to `generate_many` at B = 2."""
    extra = {"mobile_sam": ["model.sam_arch", "mobile_sam",
                            "model.sam_model", "mobilevit_t",
                            "model.image_size", "256"],
             "sam": ["model.sam_arch", "sam"]}[arch]
    pm = CrowdSAM(modify_config(load_config(None), list(TINY_RLES) + extra),
                  device="cpu")
    images = _images(50)[:2]
    pm.generator.manual_seed(1)
    want = pm.generate_many(images)
    pm.generator.manual_seed(1)
    _assert_close(ShardedPipeline(pm, batch=2).generate_batch(images), want)


REFUSED = {
    "crop_n_layers": (["test.crop_n_layers", "1"], "crop_n_layers"),
    "trainfree": (["model.trainfree", "true"], "trainfree"),
    "sam_hq": (["model.sam_arch", "sam_hq", "model.sam_model",
                "hqvit_tiny"], "HQ decoder"),
}


@pytest.mark.parametrize("what", list(REFUSED))
def test_refusals_pinned_beside_jax(what):
    """What the JAX batched path asserts or fails on, the port refuses at
    construction with the reason."""
    opts, reason = REFUSED[what]
    jm, pm = build_pair(list(TINY) + opts)
    with pytest.raises(NotImplementedError, match=reason):
        ShardedPipeline(pm, batch=2)
    images = _images(60)[:1]
    if what == "sam_hq":
        with pytest.raises(TypeError, match="hq_features"):
            JaxPipeline(jm, batch=2).generate_batch(images)
    else:
        with pytest.raises(AssertionError, match="batched path requires"):
            JaxPipeline(jm, batch=2)


def test_multi_device_options_are_refused():
    """What the mesh options do not run: `spatial_axis` or a prompt axis
    without a mesh, a mesh of another device type than the model's and a
    batch that does not divide over `data` (the JAX package asserts it);
    `spatial_axis` on TinyViT (`mobile_sam`) runs, with row halos.  The
    mesh checks on (2, 1) and (1, 2) meshes over a two-rank process group
    formed in this process (`torch_ranks.fake_group`): they read only the
    mesh's shape."""
    pm = CrowdSAM(modify_config(load_config(None), list(TINY)), device="cpu")
    mobile = CrowdSAM(modify_config(load_config(None), list(TINY) + [
        "model.sam_arch", "mobile_sam", "model.sam_model", "mobilevit_t",
        "model.image_size", "256"]), device="cpu")
    with pytest.raises(NotImplementedError, match="spatial_axis needs a "
                                                  "mesh"):
        ShardedPipeline(pm, spatial_axis="model")
    with pytest.raises(NotImplementedError, match="needs a mesh"):
        ShardedPipeline(pm, prompt_axis="model")
    with pytest.raises(ValueError, match="batch"):
        ShardedPipeline(pm, batch=0)
    with fake_group(2):
        with pytest.raises(ValueError, match="mismatched device type"):
            ShardedPipeline(pm, mesh=create_mesh((2, 1), device="cuda"))
        with pytest.raises(ValueError, match="batch 3 .*data axis"):
            ShardedPipeline(pm, mesh=create_mesh((2, 1), device="cpu"),
                            batch=3)
        pipe = ShardedPipeline(mobile, mesh=create_mesh((1, 2),
                                                        device="cpu"),
                               batch=2, spatial_axis="model")
        assert pipe.spatial.size == 2


# ---------------------------------------------------------------------------
# the data axis and the composed layout, ranks spawned with gloo
# ---------------------------------------------------------------------------

# (mesh shape, batch, prompt axis): three images at batch 2, so the second
# chunk is partial and the rank at data coordinate 1 gets no image of it.
LAYOUTS = [((2, 1), 2, None), ((2, 2), 2, "model")]


@pytest.fixture(scope="module")
def data_jax():
    """The images, the noise JAX draws for them, the JAX `ShardedPipeline`
    on the composed (2, 2) layout and the port's `mesh=None` path at batch
    2.  The JAX run stands for both layouts: the JAX package's own tests
    pin its meshes equal to its one-device path."""
    jm, pm = build_pair(list(TINY_RLES))
    images = _images(90)
    noise = _jax_batch_noise(jm, len(images))
    want = JaxPipeline(jm, mesh=jax_create_mesh((2, 2)), batch=2,
                       prompt_axis="model").generate_batch(images)
    one = ShardedPipeline(pm, batch=2).generate_batch(images, noise=noise)
    return images, noise, want, one, pm.engine_cfg


@pytest.fixture(scope="module")
def data_ranks(data_jax, tmp_path_factory):
    """Four ranks running each layout (ranks 2 and 3 outside the (2, 1)
    mesh) with the noise JAX draws, and a generator-drawn run."""
    images, noise = data_jax[:2]
    return run_ranks(data_shard_rank, 4, (
        list(TINY_RLES), images, noise, LAYOUTS, 6), join_timeout_s=240.0,
        workdir=str(tmp_path_factory.mktemp("ranks")))


@pytest.mark.parametrize("layout", LAYOUTS,
                         ids=lambda lay: "x".join(map(str, lay[0])))
def test_data_axis_matches_jax_and_one_device(data_jax, data_ranks, layout):
    """Every rank of the mesh returns every image's result in order, equal
    to the JAX `ShardedPipeline`'s (its key's noise) and to the port's
    `mesh=None` path.  On the last, partial chunk the ranks at data
    coordinate 0 run the image and make one host sync a lockstep
    iteration (and, composed, one all-reduce an iteration and two more);
    those at coordinate 1 run no engine."""
    shape, _, prompt_axis = layout
    _, _, want, one, cfg = data_jax
    members = data_ranks[:shape[0] * shape[1]]
    got, _ = members[0][layout]
    _assert_close(got, want)
    _assert_close(got, one)
    assert sum(len(g["boxes"]) for g in got) > 0
    for r in members[1:]:
        _assert_close(r[layout][0], got, exact=True)
    for rank, r in enumerate(members):
        loop = r[layout][1]
        if rank // shape[1] == 1:     # no image of the partial chunk
            assert loop is None
            continue
        assert loop["syncs"] == loop["iterations"] + (
            loop["iterations"] < cfg.max_iters)
        assert loop["collectives"] == (
            loop["iterations"] + 2 if prompt_axis else 0)


def test_data_axis_draws_noise_as_generate_many(data_ranks):
    """Each rank draws every image's vector from the generator and uses its
    own: the (2, 2) mesh at batch 2 equals `generate_many` on the same
    seed."""
    pm = CrowdSAM(modify_config(load_config(None), list(TINY_RLES)),
                  device="cpu")
    pm.generator.manual_seed(6)
    want = pm.generate_many(_images(90))
    for r in data_ranks:
        _assert_close(r["generator"], want)


# ---------------------------------------------------------------------------
# the image axis of the decode and the encode against per-image forms
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def decoder_parts():
    pm = CrowdSAM(modify_config(load_config(None), list(TINY)), device="cpu")
    rng = np.random.default_rng(7)
    g = pm.sam.image_encoder.img_size // 16
    feats = torch.from_numpy(rng.normal(size=(3, g, g, 256)).astype(
        np.float32))
    pe = torch.from_numpy(rng.normal(size=(g, g, 256)).astype(np.float32))
    return pm, feats, pe


def _sparse(pm, n, seed):
    rng = np.random.default_rng(seed)
    pts = torch.from_numpy(rng.uniform(0, 200, (n, 1, 2)).astype(np.float32))
    return pm.sam.prompt_encoder(
        points=(pts, torch.ones((n, 1), dtype=torch.int64)))[0]


@torch.no_grad()
def test_plain_k5_image_axis_equals_one_image_calls(decoder_parts):
    """Prompts of images 2, 0 and 2 interleaved: each row of the image-axis
    call equals the single-image call of its image bit for bit."""
    pm, feats, pe = decoder_parts
    dec, no_mask = pm.sam.mask_decoder, pm.sam.prompt_encoder.no_mask_embed
    batched = precompute_decode_shared(dec, no_mask.weight, feats, pe,
                                       kernel_route=True)
    assert batched["keys0"].shape[0] == 3
    tokens = torch.from_numpy(np.random.default_rng(3).normal(
        size=(6, 7, 256)).astype(np.float32))
    img = torch.tensor([2, 0, 2, 2, 0, 1], dtype=torch.int32)
    args = [batched[n] for n in ("keys0", "q1i_flat", "k1_flat", "v1_flat")]
    keys2, tok = decode_tail_kernel.twoway_tail(
        *args, tokens, batched["tail"], img=img)
    for i in range(3):
        one = precompute_decode_shared(dec, no_mask.weight, feats[i:i + 1],
                                       pe, kernel_route=True)
        rows = torch.nonzero(img == i).flatten()
        k2, t1 = decode_tail_kernel.twoway_tail(
            one["keys0"], one["q1i_flat"], one["k1_flat"], one["v1_flat"],
            tokens[rows], one["tail"])
        torch.testing.assert_close(keys2[rows], k2, rtol=0, atol=0)
        torch.testing.assert_close(tok[rows], t1, rtol=0, atol=0)
    with pytest.raises(ValueError, match="image index"):
        decode_tail_kernel.twoway_tail(*args, tokens, batched["tail"])


@pytest.mark.parametrize("packed", [False, True])
@torch.no_grad()
def test_plain_fused_decode_groups_equal_per_image(decoder_parts, packed):
    """The plain fused decode (no kernel route) over two groups of four
    prompts, images 2 and 0, against each image alone; the pooled head
    with the DINO map of each group."""
    pm, feats, pe = decoder_parts
    dec, no_mask = pm.sam.mask_decoder, pm.sam.prompt_encoder.no_mask_embed
    r = 4 * feats.shape[1]
    dino = torch.from_numpy(np.random.default_rng(9).normal(
        size=(3, r, r, 256)).astype(np.float32))
    if packed:
        from crowdsam_tpu_torch.ops.packed import pack_spatial
        dino = torch.stack([pack_spatial(d.movedim(-1, 0)).reshape(
            256, -1).T for d in dino])
    shared = precompute_decode_shared(dec, no_mask.weight, feats, pe)
    sparse = _sparse(pm, 8, 11)
    img = torch.tensor([2] * 4 + [0] * 4, dtype=torch.int32)
    got = fused_decode(dec, shared, sparse, True, dino_feats_proj=dino[[2, 0]],
                       packed_masks=packed, img=img)
    for g, i in enumerate((2, 0)):
        one = precompute_decode_shared(dec, no_mask.weight, feats[i:i + 1],
                                       pe)
        want = fused_decode(dec, one, sparse[4 * g:4 * g + 4], True,
                            dino_feats_proj=dino[i], packed_masks=packed)
        for a, b in zip(got, want):
            torch.testing.assert_close(a[4 * g:4 * g + 4], b, rtol=1e-5,
                                       atol=1e-5)


def test_pooled_from_exp_groups_equal_per_group():
    rng = np.random.default_rng(4)
    e = torch.from_numpy(rng.uniform(size=(6, 4, 64, 16)).astype(np.float32))
    mx = torch.from_numpy(rng.normal(size=(6, 4)).astype(np.float32))
    dino = torch.from_numpy(rng.normal(size=(3, 64 * 16, 8)).astype(
        np.float32))
    got = _pooled_from_exp(e, mx, dino, torch.float32)
    for g in range(3):
        want = _pooled_from_exp(e[2 * g:2 * g + 2], mx[2 * g:2 * g + 2],
                                dino[g], torch.float32)
        torch.testing.assert_close(got[2 * g:2 * g + 2], want, rtol=1e-5,
                                   atol=1e-5)


@torch.no_grad()
def test_encode_batch_equals_per_image_encode():
    """`encode_batch` of two frames against the single-image encode (a
    256 px bucket padded to the square frame) and `predict_fg_map`."""
    pm = CrowdSAM(modify_config(load_config(None), list(TINY)), device="cpu")
    p = pm.predictor
    s = pm.sam.img_size
    images = [_image(70, (200, 256, 3)), _image(71, (256, 192, 3))]
    frames = torch.zeros((2, s, s, 3), dtype=torch.uint8)
    for i, im in enumerate(images):
        frames[i, :im.shape[0], :im.shape[1]] = torch.from_numpy(im)
    enc = p.encode_batch(frames, [im.shape[:2] for im in images])
    for i, im in enumerate(images):
        p.set_image_presized(im)
        torch.testing.assert_close(enc["features"][i:i + 1], p.features,
                                   rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(enc["dino_proj_256"][i].float(),
                                   p.dino_proj_256.float(), rtol=1e-2,
                                   atol=1e-2)
        torch.testing.assert_close(enc["fg_logits"][i:i + 1],
                                   p.predict_fg_map(), rtol=1e-4, atol=1e-4)
