"""Device mesh helpers on `torch.distributed`.

Counterpart of the JAX package's `parallel/mesh.py`: a 2D (data, model)
mesh over the processes of the default process group, one process a rank
(`torchrun`, or `torch.multiprocessing` as `parallel/launch.py` starts
them).  The caller forms the default group first.  The mesh is a
`DeviceMesh` built from process groups formed here with a timeout
(`DeviceMesh.from_group`), so that ranks that diverge fail instead of
waiting forever.  The helpers give the DTensor placements that stand for
the JAX package's `PartitionSpec`s; the pipeline itself works on local
tensors and slices its batch by hand (`shard_batch`).
"""

from __future__ import annotations

import datetime
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

# Long enough for every collective of the pipeline at the sizes it runs,
# short enough that a rank left waiting by a diverged peer fails in a
# minute.
GROUP_TIMEOUT_S = 60.0


def create_mesh(shape: Optional[Tuple[int, int]] = None,
                axis_names: Sequence[str] = ("data", "model"),
                device=None) -> Optional[DeviceMesh]:
    """A 2D mesh of `shape` over ranks 0 .. shape[0] * shape[1] - 1 of the
    default process group (row-major: rank = data * shape[1] + model).
    shape=None puts every rank on `data`.  The device type is `cuda` unless
    `device` says `cpu`.  Every rank of the default group must call it (it
    forms one group a row and a column); a rank outside the mesh gets
    None.  Raises when the mesh needs more ranks than the group has."""
    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs the default process group "
                           "(torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if shape is None:
        shape = (world, 1)
    rows, cols = int(shape[0]), int(shape[1])
    if len(axis_names) != 2:
        raise ValueError(f"two axis names, got {tuple(axis_names)}")
    if rows < 1 or cols < 1 or rows * cols > world:
        raise ValueError(f"mesh {tuple(shape)} needs {rows * cols} ranks; "
                         f"the process group has {world}")
    dev_type = torch.device(device).type if device is not None else "cuda"
    grid = torch.arange(rows * cols, dtype=torch.int).reshape(rows, cols)
    timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
    me = dist.get_rank()
    mine = [None, None]
    # Every rank forms every group, in the same order (new_group is a
    # collective of the default group).
    for dim, lines in ((0, grid.T), (1, grid)):
        for line in lines:
            ranks = line.tolist()
            g = dist.new_group(ranks=ranks, timeout=timeout)
            if me in ranks:
                mine[dim] = g
    if me >= rows * cols:
        return None
    return DeviceMesh.from_group(mine, dev_type, grid,
                                 mesh_dim_names=tuple(axis_names))


def check_device(mesh: DeviceMesh, device: torch.device):
    """Raise unless the mesh's device type is that of `device` (the
    model's): the ranks' tensors live on the mesh's device type."""
    if mesh.device_type != torch.device(device).type:
        raise ValueError(f"a {mesh.device_type} mesh for a model on "
                         f"{device} (a mismatched device type)")


# The placements import DTensor (about a second) only when asked for.

def replicated(mesh: DeviceMesh) -> list:
    """Every rank holds the whole tensor (`PartitionSpec()`)."""
    from torch.distributed.tensor import Replicate
    return [Replicate()] * mesh.ndim


def data_sharded(mesh: DeviceMesh) -> list:
    """Leading axis split over `data` (`PartitionSpec("data")`)."""
    from torch.distributed.tensor import Replicate, Shard
    return [Shard(0), Replicate()]


def model_sharded(mesh: DeviceMesh) -> list:
    """Leading axis split over `model` (`PartitionSpec("model")`)."""
    from torch.distributed.tensor import Replicate, Shard
    return [Replicate(), Shard(0)]


def shard_batch(x, mesh: DeviceMesh, axis: str = "data"):
    """This rank's rows of the leading axis of `x` (a tensor, an array or
    a list), split evenly over `axis`, as `jax.device_put` with
    `data_sharded` places them.  The length must divide over the axis."""
    n, d = len(x), mesh[axis].size()
    if n % d:
        raise ValueError(f"{n} rows do not divide over '{axis}' ({d})")
    r = mesh.get_local_rank(axis)
    return x[r * (n // d):(r + 1) * (n // d)]


def axis_group(mesh: DeviceMesh, axis: str):
    """(the process group of `axis` that holds this rank, this rank's
    index in it, its size)."""
    return (mesh.get_group(axis), mesh.get_local_rank(axis),
            mesh[axis].size())
