"""Start one process a rank, run a function in each, collect the results.

    results = run_ranks(fn, world, args, backend="gloo")

The single-host counterpart of `torchrun --nproc_per_node N`, on
`torch.multiprocessing.start_processes` (the `spawn` start method): each
rank forms the default process group over a file store with the groups'
timeout (`mesh.GROUP_TIMEOUT_S`), calls `fn(rank, world, *args)` and
hands back what it returns (pickled).  The arguments reach the ranks
through a file in the work directory, not through the spawn pipe: a write
to that pipe larger than its buffer waits until the child has imported its
main module, so large arguments would start the ranks one after another.
The caller waits with a time limit
of its own: a rank that raises, exits or outlives the limit fails the run,
and every rank still running is killed.  `fn` must be importable by name
in a fresh process (a module-level function).
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import time
from typing import Callable, Optional, Sequence

import torch.multiprocessing as mp
from torch.multiprocessing.spawn import ProcessException

from crowdsam_tpu_torch.parallel.mesh import GROUP_TIMEOUT_S


def _rank_main(rank: int, fn, world: int, backend: str, workdir: str,
               threads: Optional[int]):
    import torch
    import torch.distributed as dist

    with open(os.path.join(workdir, "args.pkl"), "rb") as f:
        args = pickle.load(f)
    if threads is not None:
        torch.set_num_threads(threads)
    dist.init_process_group(
        backend, init_method=f"file://{workdir}/store", rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        out = fn(rank, world, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(workdir, f"rank{rank}.out"), "wb") as f:
        pickle.dump(out, f)


def run_ranks(fn: Callable, world: int, args: Sequence = (), *,
              backend: str = "gloo", join_timeout_s: float = 300.0,
              threads: Optional[int] = 1,
              workdir: Optional[str] = None) -> list:
    """`fn(rank, world, *args)` in `world` processes on one process group
    (`backend`); returns the results in rank order.  Raises RuntimeError
    with the first failed rank's traceback, or TimeoutError after
    `join_timeout_s`; either way no rank is left running.  `threads`:
    torch threads a rank (None leaves the default).  `workdir`: where the
    store and the results go (a temporary directory, removed afterwards,
    when None)."""
    own = workdir is None
    work = tempfile.mkdtemp(prefix="ranks_", dir=workdir)
    with open(os.path.join(work, "args.pkl"), "wb") as f:
        pickle.dump(tuple(args), f, protocol=pickle.HIGHEST_PROTOCOL)
    ctx = mp.start_processes(
        _rank_main, args=(fn, world, backend, work, threads),
        nprocs=world, join=False, start_method="spawn")
    try:
        deadline = time.monotonic() + join_timeout_s
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0)):
                if time.monotonic() >= deadline:
                    alive = sum(p.is_alive() for p in ctx.processes)
                    raise TimeoutError(
                        f"{alive} of {world} ranks still running after "
                        f"{join_timeout_s:.0f} s")
        except ProcessException as e:
            raise RuntimeError(
                f"rank {e.error_index} of {world} failed:\n{e}") from None
        out = []
        for r in range(world):
            with open(os.path.join(work, f"rank{r}.out"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        for p in ctx.processes:
            p.join(timeout=10)
        if own:
            shutil.rmtree(work, ignore_errors=True)
