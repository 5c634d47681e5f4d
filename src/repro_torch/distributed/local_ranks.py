"""Run a function on several local ranks joined in one process group.

``run_ranks(fn, world, workdir, *args)`` starts ``world`` fresh processes
(the ``spawn`` start method), joins them in a process group through a
``FileStore`` under ``workdir`` (no port to pick), calls ``fn(rank, world,
*args)`` in each and returns the ranks' results in rank order.  ``fn`` must
be importable by name (defined at module level).  gloo on the CPU is how
the sharded paths are held to the reference without several GPUs; a rank
that fails stops every rank, and its traceback is raised here.

``run_in_turns(share, m)`` runs the ranks of a ``model`` axis of size
``m`` one after another in this process instead: ``share(rank, group)``
computes one rank's share under ``sharding.model_parallel((group, m,
rank))`` with a ``TurnGroup`` standing in for the process group.
``RankMesh`` and ``local_boxes`` give a rank's boxes of the weights
without a process group.
"""

from __future__ import annotations

import os
import time
import traceback

import torch

__all__ = ["run_ranks", "run_in_turns", "TurnGroup", "RankMesh", "local_boxes"]


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


class TurnGroup:
    """A stand-in for the ``model`` process group (``sharding.model_parallel``
    takes one) whose ranks run one after another in this process, pass
    after pass: the i-th collective of a rank's run returns what every rank
    gave the i-th collective in the pass before (in the first pass: its own
    input, repeated or cut).  A share whose collectives chain c deep is
    exact after c + 1 passes, and the last pass's results are what a real
    group of the ranks would give (sums in f32, or f64 for f64 parts, cast
    back)."""

    def __init__(self, m: int):
        self.m, self.prev, self.cur, self.rank, self.calls = m, {}, {}, 0, 0

    def start(self, rank: int):
        self.rank, self.calls = rank, 0

    def next_pass(self):
        self.prev, self.cur = self.cur, {}

    def _parts(self, x):
        i, self.calls = self.calls, self.calls + 1
        self.cur.setdefault(i, {})[self.rank] = (
            x.detach().clone() if isinstance(x, torch.Tensor) else [t.detach().clone() for t in x])
        parts = self.prev.get(i)
        return [parts[r] for r in range(self.m)] if parts and len(parts) == self.m else None

    @staticmethod
    def _sum(parts):
        f = torch.promote_types(parts[0].dtype, torch.float32)
        acc = parts[0].to(f)
        for x in parts[1:]:
            acc = acc + x.to(f)
        return acc.to(parts[0].dtype)

    def all_gather(self, x, dim: int):
        return torch.cat(self._parts(x) or [x] * self.m, dim)

    def reduce_scatter(self, x, dim: int):
        parts = self._parts(x)
        n = x.shape[dim] // self.m
        total = x if parts is None else self._sum(parts)
        return total.narrow(dim, self.rank * n, n).contiguous()

    def all_reduce(self, x, op: str):
        parts = self._parts(x)
        if parts is None:
            return x.clone()
        if op == "max":
            return torch.stack(parts).amax(0)
        return self._sum(parts)

    def all_to_all(self, x, send_sizes, recv_sizes):
        """Dim 0 of ``x`` in parts of ``send_sizes``, part t to rank t; in
        the first pass zeros of the received shape."""
        parts = self._parts(torch.split(x, list(send_sizes)))
        if parts is None:
            return x.new_zeros((sum(recv_sizes),) + tuple(x.shape[1:]))
        got = [parts[s][self.rank] for s in range(self.m)]
        if [g.shape[0] for g in got] != list(recv_sizes):
            raise ValueError(f"all_to_all: rank {self.rank} expects {list(recv_sizes)} rows, "
                             f"the ranks send {[g.shape[0] for g in got]}")
        return torch.cat(got, 0)


def run_in_turns(share, m: int) -> tuple[list, int, int]:
    """``share(rank, group)`` for every rank of a size-``m`` ``model`` axis,
    in turn, pass after pass until every collective's result is exact:
    (the last pass's results in rank order, the passes, the collectives a
    rank issued)."""
    group, passes = TurnGroup(m), 0
    while True:
        out = []
        for r in range(m):
            group.start(r)
            out.append(share(r, group))
        passes += 1
        calls = group.calls
        group.next_pass()
        if passes > calls:
            return out, passes, calls


class RankMesh:
    """Rank ``r`` of a (1, m) ("data", "model") mesh for the shardings'
    boxes, without a process group."""

    def __init__(self, m: int, r: int, device_type: str = "cpu"):
        self.mesh_dim_names, self.shape, self.r = ("data", "model"), (1, m), r
        self.device_type = device_type

    def get_coordinate(self):
        return [0, self.r]


def local_boxes(values, shardings):
    """Each leaf's box under its NamedSharding (a rank's shard)."""
    if isinstance(values, dict):
        return {k: local_boxes(v, shardings[k]) for k, v in values.items()}
    return values[shardings.local_box(values.shape)]
