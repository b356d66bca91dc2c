"""The port's prompt-sharded EPS engine (`parallel/prompt_shard.py`) on the
CPU, ranks spawned with gloo (`parallel/launch.run_ranks`): against the
JAX package's `install_prompt_sharding` over `create_mesh((1, 4))` on its
8 virtual CPU devices, and against the port's single engine.

The parent draws the noise JAX draws for each image and hands it to the
ranks; the ranks import only the port (`torch_ranks.py`) and build the
same weights from the config.  Tolerances, as in `test_torch_pipeline.py`:
the same detection count and categories, boxes within 0.5 px, scores
within 1e-4, RLE strings equal (M decode batches of K/M prompts sum their
float32 products in another order than one batch of K).  Every rank's
result is the same as rank 0's, bit for bit; each lockstep iteration
makes one all-reduce and the loop two more."""

import dataclasses

import pytest
from test_torch_pipeline import _one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_eval_shard import _assert_close
from test_torch_pipeline import TINY_RLES, _image, _next_noise
from torch_ranks import fake_group, prompt_shard_rank

from crowdsam_tpu.config import load_config as jax_load_config
from crowdsam_tpu.config import modify_config as jax_modify_config
from crowdsam_tpu.parallel.mesh import create_mesh as jax_create_mesh
from crowdsam_tpu.parallel.prompt_shard import (
    install_prompt_sharding as jax_install,
)
from crowdsam_tpu.pipeline.crowdsam import CrowdSAM as JaxCrowdSAM

from crowdsam_tpu_torch.config import load_config, modify_config
from crowdsam_tpu_torch.parallel.launch import run_ranks
from crowdsam_tpu_torch.parallel.mesh import create_mesh
from crowdsam_tpu_torch.parallel.prompt_shard import install_prompt_sharding
from crowdsam_tpu_torch.pipeline.crowdsam import CrowdSAM

SHAPES = [(200, 256, 3), (256, 192, 3)]
JOIN_S = 180.0                 # a hung rank fails its test, not the suite
# (fused decode, M ranks on the prompt axis)
CASES = [(True, 2), (False, 2), (True, 4)]


@pytest.fixture(scope="module")
def jax_run():
    """The JAX model (fused decode, its default) prompt-sharded over
    (1, 4): its results on the images and the noise its engine drew for
    each."""
    jm = JaxCrowdSAM(jax_modify_config(jax_load_config(None), TINY_RLES))
    jax_install(jm, jax_create_mesh((1, 4)))
    images = [_image(80 + i, s) for i, s in enumerate(SHAPES)]
    noises, results = [], []
    for im in images:
        noises.append(_next_noise(jm))
        results.append(jm.generate(im))
    assert sum(len(r["boxes"]) for r in results) > 0
    return images, noises, results


@pytest.fixture(scope="module")
def ranks(jax_run, tmp_path_factory):
    """For each M, M ranks running that M's cases on the JAX run's images
    and noise: {M: [each rank's {fused: (results, loops)}]}."""
    images, noises, _ = jax_run
    return {m: run_ranks(prompt_shard_rank, m, (
        TINY_RLES, images, noises, [f for f, mm in CASES if mm == m]),
        join_timeout_s=JOIN_S, workdir=str(tmp_path_factory.mktemp("ranks")))
        for m in sorted({m for _, m in CASES})}


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"fused{c[0]}-M{c[1]}")
def test_prompt_sharded_generate_matches_jax_and_single(jax_run, ranks,
                                                        case):
    """The JAX run decodes fused; the unfused port run is held to it with
    the same tolerances (the two decodes agree within them)."""
    images, noises, want = jax_run
    fused, m = case
    members = [r[fused] for r in ranks[m]]
    got, loops = members[0]
    _assert_close(got, want)
    single = CrowdSAM(modify_config(load_config(None), list(TINY_RLES) + [
        "tpu.fused_decode", str(fused).lower()]), device="cpu")
    _assert_close(got, [single.generate(im, noise=[nz])
                       for im, nz in zip(images, noises)])
    for other, other_loops in members[1:]:
        _assert_close(other, got, exact=True)
        assert other_loops == loops
    for lp in loops:
        assert lp["syncs"] == lp["iterations"] + (
            lp["iterations"] < single.engine_cfg.max_iters)
        assert lp["collectives"] == lp["iterations"] + 2
        assert lp["reduced_bytes"] > 0


def test_indivisible_points_per_batch_raises():
    """points_per_batch 6 over a (1, 4) mesh (the JAX package asserts), on
    a four-rank process group formed in this process
    (`torch_ranks.fake_group`): the check reads only the mesh's shape."""
    model = CrowdSAM(modify_config(load_config(None), list(TINY_RLES)),
                     device="cpu")
    model.engine_cfg = dataclasses.replace(model.engine_cfg,
                                           points_per_batch=6)
    with fake_group(4):
        with pytest.raises(ValueError, match="points_per_batch 6 does not "
                                             "divide over 4"):
            install_prompt_sharding(model, create_mesh((1, 4), device="cpu"))
