"""Run a function on several local ranks joined in one process group.

``run_ranks(fn, world, workdir, *args)`` starts ``world`` fresh processes
(the ``spawn`` start method), joins them in a process group through a
``FileStore`` under ``workdir`` (no port to pick), calls ``fn(rank, world,
*args)`` in each and returns the ranks' results in rank order.  ``fn`` must
be importable by name (defined at module level).  gloo on the CPU is how
the sharded paths are held to the reference without several GPUs; a rank
that fails stops every rank, and its traceback is raised here.
"""

from __future__ import annotations

import os
import time
import traceback

import torch

__all__ = ["run_ranks"]


def _entry(fn, rank, world, workdir, backend, threads, args):
    import torch.distributed as dist

    torch.set_num_threads(threads)
    try:
        dist.init_process_group(backend, init_method=f"file://{workdir}/store",
                                rank=rank, world_size=world)
        out = fn(rank, world, *args)
        torch.save(out, os.path.join(workdir, f"out{rank}.pt"))
    except BaseException:
        with open(os.path.join(workdir, f"err{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world: int, workdir: str, *args, backend: str = "gloo",
              threads: int = 1, timeout: float = 300.0) -> list:
    import torch.multiprocessing as mp

    os.makedirs(workdir, exist_ok=True)
    for name in ["store"] + [f"{k}{r}.{e}" for r in range(world)
                             for k, e in (("out", "pt"), ("err", "txt"))]:
        if os.path.exists(os.path.join(workdir, name)):
            os.remove(os.path.join(workdir, name))      # a previous run's
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn, r, world, workdir, backend, threads, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            if time.monotonic() > deadline or any(p.exitcode not in (None, 0) for p in procs):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join()
    errs = [os.path.join(workdir, f"err{r}.txt") for r in range(world)]
    for r, e in enumerate(errs):
        if os.path.exists(e):
            with open(e) as f:
                raise RuntimeError(f"rank {r} failed:\n{f.read()}")
    if any(p.exitcode != 0 for p in procs):
        codes = [p.exitcode for p in procs]
        raise RuntimeError(f"ranks ended with {codes}"
                           + (" (timed out)" if time.monotonic() > deadline else ""))
    return [torch.load(os.path.join(workdir, f"out{r}.pt"), weights_only=False)
            for r in range(world)]
