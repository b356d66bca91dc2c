"""The port's mesh helpers (`parallel/mesh.py`), collectives
(`parallel/collectives.py`) and rank launcher (`parallel/launch.py`) on
the CPU with gloo, ranks spawned in fresh processes.

At world sizes 1 and 2: each rank's coordinate and axis sizes (row-major,
as the JAX package's `create_mesh` lays out its devices), the DTensor
placements standing for the JAX `PartitionSpec`s, `shard_batch`'s rows,
a rank outside a smaller mesh, a mesh larger than the group refused; and
the three collectives exact, bit for bit, on bool, int32, float32 and
bfloat16 (-0.0, inf, nan and a subnormal among the values).  A rank that
raises or hangs fails `run_ranks` within its time limit, with no rank
left running."""

import time

import pytest
import torch
from torch_ranks import failing_rank, mesh_rank

from crowdsam_tpu_torch.parallel.launch import run_ranks
from crowdsam_tpu_torch.parallel.mesh import create_mesh

JOIN_S = 120.0
SHAPES = {1: [(1, 1)], 2: [(2, 1), (1, 2), (1, 1)]}


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.bool else x.contiguous().view(torch.uint8)


@pytest.mark.parametrize("world", [1, 2])
def test_mesh_helpers_and_collectives(world, tmp_path):
    out = run_ranks(mesh_rank, world, (SHAPES[world],),
                    join_timeout_s=JOIN_S, workdir=str(tmp_path))
    for rank, got in enumerate(out):
        assert got["default"] == (rank, 0)          # shape=None: all data
        assert f"needs {world + 1} ranks" in got["too large"]
        for shape in SHAPES[world]:
            seen = got[shape]
            if rank >= shape[0] * shape[1]:
                assert seen is None
                continue
            assert seen["coordinate"] == (rank // shape[1], rank % shape[1])
            assert seen["sizes"] == shape
            assert seen["device_type"] == "cpu"
            assert seen["placements"] == [
                "[Replicate(), Replicate()]", "[Shard(dim=0), Replicate()]",
                "[Replicate(), Shard(dim=0)]"]
            d = seen["coordinate"][0]
            assert seen["batch_rows"] == [4 * d + i for i in range(4)]
            for dtype, case in seen["cases"].items():
                for name in ("gather", "masked", "or"):
                    if name in case:
                        a, b = case[name]
                        assert a.dtype == b.dtype and a.shape == b.shape
                        assert torch.equal(_bits(a), _bits(b)), (dtype, name)
                assert case["calls"] == (3 if dtype == "torch.bool" else 2)


def test_create_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        create_mesh((1, 1), device="cpu")


@pytest.mark.parametrize("how", ["raise", "collective"])
def test_a_failed_or_hung_rank_fails_the_run(how, tmp_path):
    """Rank 1 raises, or sleeps while rank 0 waits in a collective: the run
    fails at once with rank 1's traceback, or at its time limit."""
    t = time.monotonic()
    if how == "raise":
        with pytest.raises(RuntimeError, match="rank 1 gives up"):
            run_ranks(failing_rank, 2, (how,), join_timeout_s=JOIN_S,
                      workdir=str(tmp_path))
    else:
        with pytest.raises(TimeoutError, match="still running"):
            run_ranks(failing_rank, 2, (how,), join_timeout_s=8.0,
                      workdir=str(tmp_path))
    assert time.monotonic() - t < 60
