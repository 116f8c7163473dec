"""Start the ranks of a group on one host: one spawned process a rank, each
joined to the group with :func:`~cppf_tpu_torch.parallel.mesh.init_group`
on a file store, each running ``fn(rank, world_size, device, job)``.

The job goes to the ranks through a file (each unpickles it after its own
imports, so that the starts do not queue behind each other), and each
rank's result comes back through one.  A rank that fails stops the others:
its traceback is raised in the caller.  Nothing here runs at import.
"""
from __future__ import annotations

import multiprocessing
import multiprocessing.connection
import os
import time
import traceback
from typing import Callable, Sequence

import torch
import torch.distributed as dist

from cppf_tpu_torch.parallel.mesh import init_group


def _rank_main(fn, rank: int, world_size: int, backend: str, device: str, work_dir: str,
               timeout_s: float) -> None:
    try:
        job = torch.load(os.path.join(work_dir, "job.pt"), weights_only=False)
        init_group(backend, device, world_size, rank,
                   "file://" + os.path.join(work_dir, "store"), timeout_s=timeout_s)
        result = fn(rank, world_size, torch.device(device), job)
        dist.barrier()
        dist.destroy_process_group()
        torch.save(result, os.path.join(work_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(work_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(fn: Callable, backend: str, devices: Sequence[str], job, work_dir: str,
              timeout_s: float = 300.0) -> list:
    """Run ``fn`` (a module-level function, so that a spawned process can
    import it) on ``len(devices)`` ranks of a ``backend`` group, rank r on
    ``devices[r]``; ``work_dir`` (empty, on this host) holds the store, the
    job and the results.  Returns the ranks' results in rank order; raises
    when a rank fails or the ranks outlast ``timeout_s`` (the collectives'
    timeout too), after stopping every rank still running."""
    world_size = len(devices)
    torch.save(job, os.path.join(work_dir, "job.pt"))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world_size, backend, str(d), work_dir,
                                                  timeout_s))
             for r, d in enumerate(devices)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    try:
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            left = deadline - time.monotonic()
            if left <= 0:
                break
            multiprocessing.connection.wait([p.sentinel for p in procs if p.is_alive()],
                                            timeout=min(left, 1.0))
    finally:
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    errors = []
    for r, p in enumerate(procs):
        err = os.path.join(work_dir, f"rank{r}.err")
        if os.path.exists(err):
            with open(err) as f:
                errors.append(f"rank {r} (exit {p.exitcode}):\n{f.read()}")
        elif p.exitcode != 0 and r not in hung:
            errors.append(f"rank {r} exited {p.exitcode}")
    if errors or hung:
        raise RuntimeError(f"{fn.__name__} on {world_size} {backend} ranks failed"
                           + (f"; ranks {hung} stopped while still running" if hung else "")
                           + ("\n" + "\n".join(errors) if errors else ""))
    return [torch.load(os.path.join(work_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world_size)]
