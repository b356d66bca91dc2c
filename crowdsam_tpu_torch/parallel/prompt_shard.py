"""Prompt-axis parallelism of the EPS decode engine.

Counterpart of the JAX package's `parallel/prompt_shard.py`: each batch of
K prompts of the EPS loop is split over the M ranks of one mesh axis.
Rank r decodes prompts [r K/M, (r+1) K/M) of every batch, the occupancy is
OR-reduced over the axis once a lockstep iteration, and after the loop the
NMS and the top `max_keep` run replicated on the gathered per-row scalars,
with only the top rows' logits assembled from their owners
(`pipeline/engine.py`, `parallel/collectives.py`).  Every rank holds the
same inputs and gets the same result, equal to the single-rank engine's.

    dist.init_process_group(...)            # one process a rank
    mesh = create_mesh((1, M), device=...)  # parallel/mesh.py
    install_prompt_sharding(model, mesh)    # then model.generate(image)

Composes with the data axis in `parallel/eval_shard.ShardedPipeline`
(`prompt_axis`).
"""

from __future__ import annotations

from crowdsam_tpu_torch.parallel.collectives import Shard
from crowdsam_tpu_torch.parallel.mesh import axis_group, check_device
from crowdsam_tpu_torch.pipeline.engine import check_shard, run_eps_engine


def axis_shard(model, mesh, axis: str) -> Shard:
    """This rank's `Shard` of mesh axis `axis` for `model`'s engine;
    raises unless the mesh's device type is the model's and
    points_per_batch divides over the axis."""
    check_device(mesh, model.device)
    group, rank, size = axis_group(mesh, axis)
    check_shard(model.engine_cfg, size)
    return Shard(group, rank, size)


def make_prompt_sharded_engine(model, mesh, axis: str = "model"):
    """A drop-in replacement for `model.engine` (`run_eps_engine`'s
    signature) that decodes each prompt batch over the ranks of `axis`.
    Inputs are replicated (every rank encodes the same image); outputs
    are replicated, so the host tail (`CrowdSAM._finalize_crop`) is
    unchanged."""
    shard = axis_shard(model, mesh, axis)

    def engine(*args, **kwargs):
        return run_eps_engine(*args, shard=shard, **kwargs)

    return engine


def install_prompt_sharding(model, mesh, axis: str = "model"):
    """Replace `model.engine` in place; `model.generate` then decodes every
    prompt batch across the axis.  Returns the model."""
    model.engine = make_prompt_sharded_engine(model, mesh, axis=axis)
    return model
