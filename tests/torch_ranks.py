"""Rank functions of the port's multi-process tests, run by
`crowdsam_tpu_torch.parallel.launch.run_ranks` in fresh processes.

They import only the port (never JAX or the JAX package), so a spawned
rank loads no more than it runs.  Each returns plain picklable values:
per-image results as dicts of numpy arrays and lists."""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from crowdsam_tpu_torch.config import load_config, modify_config
from crowdsam_tpu_torch.parallel import collectives
from crowdsam_tpu_torch.parallel.eval_shard import ShardedPipeline
from crowdsam_tpu_torch.parallel.mesh import (
    axis_group,
    create_mesh,
    data_sharded,
    model_sharded,
    replicated,
    shard_batch,
)
from crowdsam_tpu_torch.parallel.prompt_shard import install_prompt_sharding
from crowdsam_tpu_torch.pipeline.crowdsam import CrowdSAM

# Every dtype the engine's collectives carry.
DTYPES = (torch.bool, torch.int32, torch.float32, torch.bfloat16)


def plain(result) -> dict:
    """A MaskData as a dict of its fields."""
    return {k: result[k] for k in result.keys()}


def _values(rank: int, shape, dtype, seed: int = 0) -> torch.Tensor:
    """Rank `rank`'s seeded values: special floats (-0.0, inf, nan, the
    smallest subnormal) among normal draws."""
    g = torch.Generator().manual_seed(seed + rank)
    x = torch.randn(shape, generator=g) * 1e3
    if dtype == torch.bool:
        return x > 0
    if dtype == torch.int32:
        return x.to(torch.int32)
    flat = x.reshape(-1)
    flat[:4] = torch.tensor([-0.0, float("inf"), float("nan"), 1e-45])
    return x.to(dtype)


def _collective_cases(mesh) -> dict:
    """The three collectives over `model` on every dtype: (what they gave,
    what this rank computes from every rank's seeded values)."""
    _, mr, m = axis_group(mesh, "model")
    cases = {}
    for dtype in DTYPES:
        shard = collectives.Shard(mesh.get_group("model"), mr, m)
        mine = _values(mr, (3, 5), dtype)
        every = torch.stack([_values(r, (3, 5), dtype) for r in range(m)])
        owner = torch.arange(6) % m
        rows = torch.stack([_values(r, (6, 4), dtype, seed=9)
                            for r in range(m)])
        case = {"gather": (collectives.gather_rows(mine, shard), every),
                "masked": (collectives.masked_psum(rows[mr], owner == mr,
                                                   shard),
                           rows[owner, torch.arange(6)])}
        if dtype == torch.bool:
            case["or"] = (collectives.or_reduce(mine, shard),
                          every.any(dim=0))
        case["calls"] = shard.calls
        cases[str(dtype)] = case
    return cases


def mesh_rank(rank: int, world: int, shapes):
    """For each mesh shape: None outside the mesh, else what this rank
    sees of it and the collectives over its `model` axis; under "too
    large" what a mesh of world + 1 ranks raised."""
    out = {}
    for shape in shapes:
        mesh = create_mesh(shape, device="cpu")
        out[shape] = None if mesh is None else {
            "coordinate": mesh.get_coordinate(),
            "sizes": (mesh["data"].size(), mesh["model"].size()),
            "device_type": mesh.device_type,
            "placements": [str(p) for p in (
                replicated(mesh), data_sharded(mesh), model_sharded(mesh))],
            "batch_rows": shard_batch(torch.arange(4 * shape[0]),
                                      mesh).tolist(),
            "cases": _collective_cases(mesh),
        }
    out["default"] = create_mesh(device="cpu").get_coordinate()
    try:
        create_mesh((world + 1, 1), device="cpu")
        out["too large"] = None
    except ValueError as e:
        out["too large"] = str(e)
    return out


@contextlib.contextmanager
def fake_group(world: int):
    """A default process group of `world` ranks formed in this one process
    as rank 0, on torch's testing backend (its collectives communicate
    nothing): for checks that read only a mesh's shape."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def failing_rank(rank: int, world: int, how: str):
    """Rank 1 raises or hangs in a collective; rank 0 returns."""
    import time

    import torch.distributed as dist

    if rank == 1:
        if how == "raise":
            raise ValueError("rank 1 gives up")
        time.sleep(600)
    if how == "collective":
        dist.all_reduce(torch.zeros(1))
    return rank


def _model(opts):
    return CrowdSAM(modify_config(load_config(None), list(opts)),
                    device="cpu")


def prompt_shard_rank(rank: int, world: int, opts, images, noises,
                      fused_cases):
    """`install_prompt_sharding` over all `world` ranks, a (1, world) mesh,
    for each fused_decode setting of `fused_cases`: `generate` on each
    image with its noise vector.  Returns {fused: (results, loop
    records)}."""
    model = _model(opts)
    base = model.engine_cfg
    mesh = create_mesh((1, world), device="cpu")
    out = {}
    for fused in fused_cases:
        model.engine_cfg = dataclasses.replace(base, fused_decode=fused)
        install_prompt_sharding(model, mesh)
        results, loops = [], []
        for image, noise in zip(images, noises):
            results.append(plain(model.generate(image, noise=[noise])))
            loops.append(model.last_engine["loop"])
        out[fused] = (results, loops)
    return out


def data_shard_rank(rank: int, world: int, opts, images, noises,
                    layouts, seed: int):
    """`ShardedPipeline` over the images with their noise vectors for each
    (mesh shape, batch, prompt axis) of `layouts` (ranks outside a mesh
    skip it): {layout: (results, this rank's last loop record)}; under
    "generator" a (2, world / 2) mesh at batch 2 with the noise drawn from
    the model's generator seeded with `seed`."""
    model = _model(opts)
    out = {}
    for shape, batch, prompt_axis in layouts:
        mesh = create_mesh(shape, device="cpu")
        if mesh is None:
            continue
        pipe = ShardedPipeline(model, mesh=mesh, batch=batch,
                               prompt_axis=prompt_axis)
        got = pipe.generate_batch(images, noise=noises)
        loop = pipe.last_engine[0]["loop"] if pipe.last_engine else None
        out[(shape, batch, prompt_axis)] = ([plain(r) for r in got], loop)
    model.generator.manual_seed(seed)
    pipe = ShardedPipeline(
        model, mesh=create_mesh((2, world // 2), device="cpu"), batch=2)
    out["generator"] = [plain(r) for r in pipe.generate_batch(images)]
    return out


def card_rank(rank: int, world: int, opts, images, noises, mesh_shape,
              prompt_axis, spatial_axis=None):
    """On cuda:0, gloo ranks sharing the card: with `mesh_shape` (1, M)
    and no `prompt_axis` or `spatial_axis`, `install_prompt_sharding` and
    `generate` on each image with its noise; else `ShardedPipeline(
    mesh_shape, batch=2, prompt_axis, spatial_axis)` over the images with
    their noise.  Returns the results and this rank's K5 and K6
    launches."""
    from crowdsam_tpu_torch.models import decode_tail_kernel, mask_head_kernel

    torch.cuda.set_device(0)
    model = CrowdSAM(modify_config(load_config(None), list(opts)),
                     device="cuda")
    mesh = create_mesh(mesh_shape, device="cuda")
    k5 = decode_tail_kernel.twoway_tail.launches
    k6 = mask_head_kernel.mask_head.launches
    with torch.no_grad():
        if mesh_shape[0] == 1 and prompt_axis is None and not spatial_axis:
            install_prompt_sharding(model, mesh)
            got = [model.generate(im, noise=[nz])
                   for im, nz in zip(images, noises)]
        else:
            got = ShardedPipeline(model, mesh=mesh, batch=2,
                                  prompt_axis=prompt_axis,
                                  spatial_axis=spatial_axis).generate_batch(
                                      images, noise=noises)
    return ([plain(r) for r in got],
            decode_tail_kernel.twoway_tail.launches - k5,
            mask_head_kernel.mask_head.launches - k6)


def _spatial_counts(pipe):
    return (0, 0) if pipe.spatial is None else (pipe.spatial.calls,
                                                pipe.spatial.bytes)


def spatial_rank(rank: int, world: int, opts, images, noises, frames,
                 in_hw, layouts, halo=None):
    """The spatial axis over `model`.  On a (1, 2) mesh (ranks 0 and 1)
    `gather_bands` of unequal bands on every dtype (what it gave, what it
    must give), and `encode_batch` of `frames` with the axis's shard: its
    outputs as numpy and the all-reduces it made.  Then for each (mesh
    shape, batch, prompt axis) of `layouts` (ranks outside a mesh skip it)
    `ShardedPipeline(spatial_axis="model")` over the images with their
    noise, a chunk a call: {layout: (results, [(all-reduces, bytes) of
    the spatial axis a chunk])}.  With `halo` (a dict), the axis past the
    window rows and on TinyViT too (`halo_cases`)."""
    model = _model(opts)
    out = {}
    if halo is not None:
        out["halo"] = halo_cases(rank, model, images, noises, **halo)
    mesh = create_mesh((1, 2), device="cpu")
    if mesh is not None:
        shard = collectives.Shard(*axis_group(mesh, "model"))
        bounds = ((0, 3), (3, 8))      # unequal bands of 8 rows
        out["gather"] = {str(dtype): (
            collectives.gather_bands(
                _values(rank, (2, 8, 3), dtype)[:, slice(*bounds[rank])],
                bounds, shard),
            torch.cat([_values(r, (2, 8, 3), dtype)[:, slice(*bounds[r])]
                       for r in range(2)], dim=1))
            for dtype in DTYPES}
        shard.calls = shard.bytes = 0
        with torch.no_grad():
            enc = model.predictor.encode_batch(torch.from_numpy(frames),
                                               in_hw, spatial=shard)
        out["encode"] = ({k: v.float().numpy() for k, v in enc.items()},
                         (shard.calls, shard.bytes))
    for shape, batch, prompt_axis in layouts:
        mesh = create_mesh(shape, device="cpu")
        if mesh is None:
            continue
        pipe = ShardedPipeline(model, mesh=mesh, batch=batch,
                               spatial_axis="model", prompt_axis=prompt_axis)
        results, counts = [], []
        for c0 in range(0, len(images), batch):
            before = _spatial_counts(pipe)
            results += pipe.generate_batch(images[c0:c0 + batch],
                                           noise=noises[c0:c0 + batch])
            after = _spatial_counts(pipe)
            counts.append((after[0] - before[0], after[1] - before[1]))
        out[(shape, batch, prompt_axis)] = ([plain(r) for r in results],
                                            counts)
    return out


def train_mesh_rank(rank: int, world: int, sam_state, cases):
    """The trainer's mesh step on each case of `cases` (ranks outside its
    mesh skip it): a dict with the mesh shape, the trainer's config
    overrides, the cache, the start leaves and each step's (shot, draws).
    Per case, each step's total, loss terms, gradients and all-reduces
    and bytes, and the leaves after the steps' AdamW updates."""
    from crowdsam_tpu_torch.models.build import sam_model_registry
    from crowdsam_tpu_torch.models.dinov2 import dino_model_registry
    from crowdsam_tpu_torch.pipeline.predictor import SamPredictor
    from crowdsam_tpu_torch.train.trainer import AdamW, AdapterTrainer

    sam = sam_model_registry["vit_tiny"](n_class=1, dino_dim=384)
    sam.load_state_dict(sam_state)
    predictor = SamPredictor(sam, dino_model_registry["dinov2_vits14"](),
                             device="cpu")
    out = []
    for case in cases:
        mesh = create_mesh(case["mesh"], device="cpu")
        if mesh is None:
            out.append(None)
            continue
        trainer = AdapterTrainer(
            modify_config(load_config(None), list(case["opts"])), predictor)
        trainer.cache = case["cache"]
        params = {k: v.clone() for k, v in case["params"].items()}
        opt = AdamW(trainer.lr, trainer.weight_decay, trainer.clip_grad)
        state = opt.init(params)
        steps = []
        for shot, draws in case["steps"]:
            total, terms, grads = trainer.loss_and_grads(params, shot, draws,
                                                         mesh=mesh)
            part = trainer.last_part
            steps.append(dict(
                total=float(total), terms={k: float(v)
                                           for k, v in terms.items()},
                grads=grads, prompts=part.prompts,
                all_reduces=(part.data.calls, part.model.calls),
                bytes=(part.data.bytes, part.model.bytes)))
            opt.step(params, grads, state)
        out.append(dict(steps=steps, params=params))
    return out


def _gather_halo_cases(rank: int) -> dict:
    """`gather_halo` on a (1, 3) mesh on every dtype: bands of 3, 2 and 7
    rows of 12, each rank needing the rows of the 8-row windows it
    touches ([0, 8) spans all three ranks): (what it gave, what it must
    give, the all-reduces and bytes)."""
    mesh = create_mesh((1, 3), device="cpu")
    if mesh is None:
        return None
    bounds = ((0, 3), (3, 5), (5, 12))
    need = ((0, 8), (0, 8), (0, 12))
    out = {}
    for dtype in DTYPES:
        shard = collectives.Shard(*axis_group(mesh, "model"))
        whole = _values(0, (2, 12, 3), dtype)
        lo, hi = bounds[rank]
        got = collectives.gather_halo(whole[:, lo:hi], bounds, need, shard)
        a, b = need[rank]
        out[str(dtype)] = (got, whole[:, a:b], (shard.calls, shard.bytes))
    return out


def _row_hooks(enc) -> tuple:
    """Forward pre-hooks that record the input shape of every window
    attention's qkv (SAM ViT's window blocks, TinyViT's blocks) and of
    the 1x1 convolution before each of TinyViT's strided or depthwise
    3x3 ones (MBConv, PatchMerging), in call order: (records, handles)."""
    from crowdsam_tpu_torch.models import image_encoder, tiny_vit

    seen, handles = [], []

    def hook(name):
        return lambda mod, args: seen.append((name, tuple(args[0].shape)))

    for name, mod in enc.named_modules():
        if (isinstance(mod, image_encoder.Attention) and mod.window) or \
                isinstance(mod, tiny_vit.TinyAttention):
            handles.append(mod.qkv.register_forward_pre_hook(hook(name)))
        elif isinstance(mod, (tiny_vit.MBConv, tiny_vit.PatchMerging)):
            handles.append(mod.conv1.register_forward_pre_hook(hook(name)))
    return seen, handles


def halo_cases(rank: int, model, images, noises, mobile_opts,
               mobile_noises, encodes, layouts) -> dict:
    """The spatial axis past SAM ViT's window rows and on TinyViT:
    `gather_halo` bit for bit (`_gather_halo_cases`); for each (arch, M)
    of `encodes` the band encode of its frame on a (1, M) mesh (ranks
    outside it skip): (features, all-reduces, bytes,
    the input shapes of the window attentions' qkv and the 3x3
    convolutions); for each (arch, mesh shape, batch) of `layouts`
    `ShardedPipeline(spatial_axis="model")` over the images with their
    noise: (results, [(all-reduces, bytes) a chunk]).  `arch` "vit"
    is `model` (with `noises`), "mobile" the model of `mobile_opts` (with
    `mobile_noises`)."""
    from crowdsam_tpu_torch.parallel.spatial import sam_band

    models = {"vit": model, "mobile": _model(mobile_opts)}
    out = {"gather_halo": _gather_halo_cases(rank)}
    for (arch, m), frame in encodes.items():
        mesh = create_mesh((1, m), device="cpu")
        if mesh is None:
            continue
        shard = collectives.Shard(*axis_group(mesh, "model"))
        enc = models[arch].sam.image_encoder
        seen, handles = _row_hooks(enc)
        try:
            with torch.no_grad():
                got = enc.forward_band(torch.from_numpy(frame),
                                       sam_band(enc, shard))
        finally:
            for h in handles:
                h.remove()
        out[(arch, m)] = (got.numpy(), shard.calls, shard.bytes, seen)
    for arch, shape, batch in layouts:
        mesh = create_mesh(shape, device="cpu")
        if mesh is None:
            continue
        pipe = ShardedPipeline(models[arch], mesh=mesh, batch=batch,
                               spatial_axis="model")
        nz = noises if arch == "vit" else mobile_noises
        results, counts = [], []
        for c0 in range(0, len(images), batch):
            before = _spatial_counts(pipe)
            results += pipe.generate_batch(images[c0:c0 + batch],
                                           noise=nz[c0:c0 + batch])
            after = _spatial_counts(pipe)
            counts.append((after[0] - before[0], after[1] - before[1]))
        out[(arch, shape, batch)] = ([plain(r) for r in results], counts)
    return out
