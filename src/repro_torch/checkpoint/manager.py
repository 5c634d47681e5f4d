"""Checkpoint lifecycle: async save, keep-last-k GC, auto-resume.

Counterpart of ``repro/checkpoint/manager.py`` over the port's
``checkpointer`` (the JAX package's on-disk format).  A tree may hold
dicts, lists, tuples and NamedTuples (a ``TrainState``); restore gives back
the template's structure.

On several ranks (a tree of DTensors, ``training.init_train_state(...,
mesh=)``) every rank makes a manager on the same directory and calls
``save`` at the same steps: each copies its shards to the host and writes
them on its worker thread, and the step commits once every rank has
written (``checkpointer.save``).  The ranks agree on one id per save
without a collective on the worker thread: rank 0 draws a token when the
managers are made, and each save adds its count.  Only rank 0 collects
garbage.
"""

from __future__ import annotations

import concurrent.futures
import os
import shutil
import time

import torch

from repro_torch.checkpoint import checkpointer
from repro_torch.distributed.sharding import is_dtensor

__all__ = ["CheckpointManager"]


def _to_host(tree):
    """A host copy of every tensor, so the caller may go on mutating its
    buffers while the worker thread writes."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):      # a NamedTuple
        return type(tree)(*(_to_host(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if is_dtensor(tree):
        return checkpointer.host_shard(tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


class CheckpointManager:
    #: A ``.tmp`` dir younger than this is treated as another writer's
    #: in-flight save and left alone by GC (see :meth:`_gc`).
    STALE_TMP_S = checkpointer.STALE_TMP_S

    def __init__(
        self,
        directory: str,
        keep_last: int = 3,
        async_save: bool = True,
        stale_tmp_s: float | None = None,
    ):
        self.directory = directory
        self.keep_last = keep_last
        self.stale_tmp_s = self.STALE_TMP_S if stale_tmp_s is None else stale_tmp_s
        self._pool = (
            concurrent.futures.ThreadPoolExecutor(max_workers=1) if async_save else None
        )
        self._pending = None
        #: the last committed save: {"step", "host_copy_s", "write_s"}
        self.last_save = None
        self._rank, world = checkpointer._world()
        # one token per run, agreed by every rank; each save adds its count
        self._token = checkpointer.new_commit_id() if world > 1 else None
        self._saves = 0
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree) -> None:
        """Async by default: the device-to-host copy happens now, file IO on
        the worker thread."""
        t0 = time.perf_counter()
        host_tree = _to_host(tree)
        copy_s = time.perf_counter() - t0
        self.wait()
        commit = None if self._token is None else f"{self._token}-{self._saves}"
        self._saves += 1
        if self._pool is None:
            self._save_and_gc(step, host_tree, copy_s, commit)
        else:
            self._pending = self._pool.submit(self._save_and_gc, step, host_tree, copy_s, commit)

    def _save_and_gc(self, step, host_tree, copy_s, commit=None):
        t0 = time.perf_counter()
        checkpointer.save(self.directory, step, host_tree, commit=commit)
        self.last_save = {"step": step, "host_copy_s": copy_s,
                          "write_s": time.perf_counter() - t0}
        if self._rank == 0:
            self._gc()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    # -- aux metadata --------------------------------------------------------
    def save_aux(self, name: str, obj: dict) -> str:
        return checkpointer.save_aux(self.directory, name, obj)

    def load_aux(self, name: str):
        return checkpointer.load_aux(self.directory, name)

    # -- restore ------------------------------------------------------------
    def latest_step(self):
        return checkpointer.latest_step(self.directory)

    def restore_latest(self, like_tree, shardings=None, device=None):
        """Returns (step, tree) on ``device`` (default: the GPU), or placed
        by ``shardings`` (a matching tree of ``NamedSharding``) on a mesh;
        (None, None) when no checkpoint exists."""
        step = self.latest_step()
        if step is None:
            return None, None
        return step, checkpointer.restore(self.directory, step, like_tree, device=device,
                                          shardings=shardings)

    # -- GC -----------------------------------------------------------------
    def _gc(self) -> None:
        steps = checkpointer.available_steps(self.directory)
        for s in steps[: -self.keep_last] if self.keep_last else []:
            shutil.rmtree(checkpointer.step_dir(self.directory, s), ignore_errors=True)
        # Remove stale .tmp dirs of crashed saves, and only stale ones: a
        # second writer sharing the directory keeps its in-flight tmp dir's
        # mtime fresh with every file it adds.
        now = time.time()
        for d in os.listdir(self.directory):
            if not d.endswith(".tmp"):
                continue
            path = os.path.join(self.directory, d)
            try:
                age = now - os.path.getmtime(path)
            except OSError:
                continue  # already removed by a concurrent GC
            if age > self.stale_tmp_s:
                shutil.rmtree(path, ignore_errors=True)
