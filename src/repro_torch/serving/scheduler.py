"""Continuous-batching scheduler over the paged KV cache.

Counterpart of ``repro/serving/scheduler.py``.  The fixed-batch
``Engine.generate`` loop holds one rectangular batch from prefill to the
last decode step; this scheduler admits and evicts *per decode step*:

- each of ``num_slots`` decode slots carries its own position (the decode
  step takes a (B,) position vector: per-slot RoPE, cache writes and
  attention masks; models/attention.py),
- a finished slot is released and refilled from the pending queue on the
  next tick, with KV pages allocated/freed through ``kv_pages.PagePool``,
- prompt prefill is *chunked alongside decode*: every tick runs at most one
  prefill chunk (batch-1) for the oldest admitted request plus one decode
  step for the running batch,
- when the page pool runs dry mid-decode, the most recently admitted
  sequence is preempted (pages freed, request requeued at the front and
  recomputed from its prompt; deterministic sampling regenerates the same
  tokens).

Token-level semantics match ``Engine.generate``: greedy (or per-request
temperature) sampling, the first token from the prompt's final logits,
decode writes token ``t`` at position ``P + t``.  PyTorch runs eagerly, so
the reference's jitted steps are plain calls here, under
``torch.inference_mode()`` (entered by ``step()`` itself: the mode is
thread-local and the front end steps from its worker thread).  A tick sends
the decode batch's tokens, positions, active mask and page table to the
device in one copy, and brings the greedy picks back in one.

Sampling at temperature > 0 draws token ``i`` of a request from
``device.generator(device, seed, i)``: a fresh generator per draw, so an
evicted request regenerates the same tokens (the reference folds ``i`` into
the request's key; the draws differ from JAX's by design).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable

import numpy as np
import torch

from repro_torch.device import generator as make_generator
from repro_torch.device import resolve_device
from repro_torch.models.frontends import needs_embeds
from repro_torch.serving.engine import Engine, make_decode_step, make_prefill_chunk
from repro_torch.serving.kv_pages import PagePool

__all__ = ["Request", "Scheduler", "SchedulerStats"]


@dataclasses.dataclass
class Request:
    """One generation request and its runtime state."""

    prompt: np.ndarray                       # (P,) int32
    max_tokens: int
    temperature: float = 0.0
    eos_id: int | None = None                # None -> scheduler default
    seed: int | None = None                  # sampling seed (temperature > 0)

    # runtime (scheduler-owned)
    rid: int = -1
    state: str = "pending"                   # pending | prefill | running | done
    slot: int = -1
    admit_seq: int = -1
    prefill_pos: int = 0
    tokens: list = dataclasses.field(default_factory=list)
    evictions: int = 0
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0


@dataclasses.dataclass
class SchedulerStats:
    submitted: int = 0
    admitted: int = 0
    completed: int = 0
    evictions: int = 0
    steps: int = 0
    decode_steps: int = 0
    decode_tokens: int = 0
    prefill_chunks: int = 0
    prefill_tokens: int = 0
    peak_running: int = 0

    def reset(self):
        for f in dataclasses.fields(self):
            setattr(self, f.name, 0)


def _next_pow2(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


class Scheduler:
    """Continuous batching around an ``Engine``'s model/params, on
    ``device`` (default: the GPU; the engine's params must live there).

    ``num_slots`` is the decode batch width (idle slots are masked, their
    writes land on the scratch page).  ``num_pages`` bounds total KV
    memory; by default fully provisioned, pass a smaller pool to exercise
    admission control and preemption.  The kernels are the engine's: every
    prefill chunk and decode tick runs with the engine's hooks
    (``Engine.scoped``).
    """

    def __init__(self, engine: Engine, num_slots: int = 4,
                 page_size: int = 16, num_pages: int | None = None,
                 prefill_chunk: int = 16, max_len: int | None = None, device=None):
        if needs_embeds(engine.cfg):
            raise NotImplementedError(
                "the scheduler drives token front ends; embed-input archs "
                "use the fixed-batch Engine"
            )
        self.device = resolve_device(device)
        self.engine = engine
        self.cfg = engine.cfg
        self.params = engine.params
        self.num_slots = num_slots
        self.max_len = engine.max_len if max_len is None else max_len
        self.prefill_chunk = _next_pow2(prefill_chunk)
        # Chunked (pow2-padded) prefill is token-identical to one-shot
        # prefill only for pure full-causal attention stacks: pad tokens are
        # causally masked there, but they advance an SSM scan's resident
        # state, land in a sliding-window ring, and change the sequence
        # length that MoE capacity (moe_capacity(cfg, S)) is computed from.
        # Those archs prefill each prompt in one exact-length chunk instead
        # (still interleaved with decode across *requests*).
        self._chunked_prefill = (
            set(self.cfg.block_pattern) == {"attn"}
            and not self.cfg.sliding_window
        )
        self.eos_id = engine.eos_id
        self.pool = PagePool(self.cfg, num_slots, self.max_len,
                             page_size=page_size, num_pages=num_pages, device=self.device)

        self.pending: deque[Request] = deque()
        self.slot_req: list[Request | None] = [None] * num_slots
        self.stats = SchedulerStats()
        self._next_rid = 0
        self._next_admit_seq = 0
        self._decode_step = engine.scoped(make_decode_step(self.cfg))
        self._prefill_fns: dict[bool, Callable] = {}

    # ------------------------------------------------------------------
    # submission
    # ------------------------------------------------------------------

    def submit(self, prompt, max_tokens: int, temperature: float = 0.0,
               eos_id: int | None = None, seed: int | None = None) -> Request:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if max_tokens < 1:
            raise ValueError("max_tokens must be >= 1")
        total = len(prompt) + max_tokens
        if total > self.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_tokens ({max_tokens}) "
                f"exceeds max_len {self.max_len}"
            )
        if self.pool.pages_needed(total) > self.pool.num_pages - 1:
            raise ValueError(
                "request can never fit: needs "
                f"{self.pool.pages_needed(total)} pages, pool has "
                f"{self.pool.num_pages - 1} usable"
            )
        if temperature > 0.0 and seed is None:
            seed = self._next_rid
        req = Request(prompt=prompt, max_tokens=max_tokens,
                      temperature=temperature, eos_id=eos_id, seed=seed,
                      rid=self._next_rid, t_submit=time.perf_counter())
        self._next_rid += 1
        self.pending.append(req)
        self.stats.submitted += 1
        return req

    def committed_pages(self) -> tuple[int, int]:
        """(worst-case pages committed to live requests, usable pages): the
        front end's backpressure signal."""
        live = list(self.pending) + [r for r in self.slot_req if r is not None]
        committed = sum(
            self.pool.pages_needed(len(r.prompt) + r.max_tokens) for r in live
        )
        return committed, self.pool.num_pages - 1

    # ------------------------------------------------------------------
    # scheduling ticks
    # ------------------------------------------------------------------

    def has_work(self) -> bool:
        return bool(self.pending) or any(r is not None for r in self.slot_req)

    def step(self) -> list[Request]:
        """One scheduler tick: admit, one prefill chunk, one decode step.
        Returns the requests that finished this tick."""
        completed: list[Request] = []
        self.stats.steps += 1
        with torch.inference_mode():
            self._admit()
            self._prefill_tick(completed)
            self._decode_tick(completed)
        self.stats.peak_running = max(
            self.stats.peak_running,
            sum(1 for r in self.slot_req if r is not None),
        )
        return completed

    def run(self) -> list[Request]:
        """Drive until all submitted work is done."""
        done: list[Request] = []
        while self.has_work():
            done.extend(self.step())
        return done

    def generate_batch(self, prompts, max_tokens: int,
                       temperature: float = 0.0) -> list[list[int]]:
        """Convenience: submit all, run to completion, return token lists
        in submission order."""
        reqs = [self.submit(p, max_tokens, temperature) for p in prompts]
        self.run()
        return [r.tokens for r in reqs]

    # ------------------------------------------------------------------

    def _admit(self) -> None:
        while self.pending:
            slot = next(
                (s for s in range(self.num_slots) if self.slot_req[s] is None),
                None,
            )
            if slot is None:
                return
            req = self.pending[0]
            if not self.pool.ensure(slot, len(req.prompt)):
                return                      # pool dry: admission waits
            self.pending.popleft()
            self.pool.reset_slot_state(slot)
            req.slot = slot
            req.state = "prefill"
            req.prefill_pos = 0
            req.tokens = []
            req.admit_seq = self._next_admit_seq
            self._next_admit_seq += 1
            req.t_admit = time.perf_counter()
            self.slot_req[slot] = req
            self.stats.admitted += 1

    def _prefill_fn(self, attend: bool):
        fn = self._prefill_fns.get(attend)
        if fn is None:
            pool = self.pool
            fwd = self.engine.scoped(make_prefill_chunk(self.cfg, attend_cache=attend))

            def fn(params, toks, table_row, slot, start, real_len, chunk):
                cache = pool.gather_slot(pool.pools, pool.resident, table_row, slot)
                logits, new_cache = fwd(params, {"tokens": toks}, cache, start)
                pool.scatter_prefill(pool.pools, new_cache, table_row, start, real_len, chunk)
                pool.update_resident_slot(pool.resident, new_cache, slot)
                return logits

            self._prefill_fns[attend] = fn
        return fn

    def _prefill_tick(self, completed: list[Request]) -> None:
        cands = [r for r in self.slot_req if r is not None and r.state == "prefill"]
        if not cands:
            return
        req = min(cands, key=lambda r: r.admit_seq)
        P = len(req.prompt)
        start = req.prefill_pos
        if self._chunked_prefill:
            real = min(self.prefill_chunk, P - start)
            chunk = _next_pow2(real)
            if start + chunk > self.max_len:
                chunk = real                # rare tail near max_len: exact length
        else:
            real = P - start                # one exact-length chunk
            chunk = real
        # the chunk's tokens (pad tokens 0), then the slot's page table
        host = np.zeros((chunk + self.pool.max_pages_per_seq,), np.int64)
        host[:real] = req.prompt[start:start + real]
        host[chunk:] = self.pool.table[req.slot]
        dev = torch.from_numpy(host).to(self.device)         # one host-to-device copy
        logits = self._prefill_fn(attend=start > 0)(
            self.params, dev[:chunk].view(1, chunk), dev[chunk:], req.slot, start, real, chunk,
        )
        self.stats.prefill_chunks += 1
        self.stats.prefill_tokens += real
        req.prefill_pos = start + real
        if req.prefill_pos < P:
            return
        # prompt done: first token from the last real prompt position
        tok = self._sample(req, logits[0, real - 1], index=0)
        req.state = "running"
        req.tokens.append(tok)
        req.t_first_token = time.perf_counter()
        if self._finished(req, tok):
            self._finish(req, completed)

    def _decode_tick(self, completed: list[Request]) -> None:
        for slot in range(self.num_slots):
            req = self.slot_req[slot]
            if req is None or req.state != "running":
                continue
            seq_len = len(req.prompt) + len(req.tokens)
            while not self.pool.ensure(slot, seq_len):
                victim = self._pick_victim(exclude=slot)
                if victim is None:
                    raise RuntimeError(
                        "page pool exhausted with nothing to evict; "
                        "submit() validation should have rejected this"
                    )
                self._evict(victim)
        running = [
            s for s in range(self.num_slots)
            if self.slot_req[s] is not None and self.slot_req[s].state == "running"
        ]
        if not running:
            return
        B = self.num_slots
        # rows: tokens, positions, active, then the page table
        host = np.zeros((3 * B + self.pool.table.size,), np.int64)
        for s in running:
            req = self.slot_req[s]
            host[s] = req.tokens[-1]
            host[B + s] = len(req.prompt) + len(req.tokens) - 1
            host[2 * B + s] = 1
        host[3 * B:] = self.pool.table.reshape(-1)
        dev = torch.from_numpy(host).to(self.device)         # one host-to-device copy
        tok, pos, active = dev[:B], dev[B:2 * B], dev[2 * B:3 * B].bool()
        tables = dev[3 * B:].view(self.pool.table.shape)
        pool = self.pool
        cache = pool.gather(pool.pools, pool.resident, tables)
        logits, new_cache = self._decode_step(self.params, tok, cache, pos)
        pool.scatter_decode(pool.pools, new_cache, tables, pos, active)
        pool.update_resident(pool.resident, new_cache, active)
        self.stats.decode_steps += 1
        self.stats.decode_tokens += len(running)
        greedy = torch.argmax(logits, dim=-1).cpu().numpy()  # one device-to-host copy
        for s in running:
            req = self.slot_req[s]
            if req.temperature > 0.0:
                nxt = self._sample(req, logits[s], index=len(req.tokens))
            else:
                nxt = int(greedy[s])
            req.tokens.append(nxt)
            if self._finished(req, nxt):
                self._finish(req, completed)

    # ------------------------------------------------------------------

    def _sample(self, req: Request, logits_row, index: int) -> int:
        if req.temperature <= 0.0 or req.seed is None:
            return int(torch.argmax(logits_row))
        probs = torch.softmax(logits_row.to(torch.float32) / req.temperature, dim=-1)
        g = make_generator(self.device, req.seed, index)
        return int(torch.multinomial(probs, 1, generator=g)[0])

    def _finished(self, req: Request, tok: int) -> bool:
        eos = self.eos_id if req.eos_id is None else req.eos_id
        return tok == eos or len(req.tokens) >= req.max_tokens

    def _finish(self, req: Request, completed: list[Request]) -> None:
        self.pool.release(req.slot)
        self.slot_req[req.slot] = None
        req.state = "done"
        req.slot = -1
        req.t_done = time.perf_counter()
        self.stats.completed += 1
        completed.append(req)

    def _pick_victim(self, exclude: int) -> Request | None:
        cands = [
            r for r in self.slot_req
            if r is not None and r.slot != exclude
        ]
        if not cands:
            return None
        return max(cands, key=lambda r: r.admit_seq)

    def _evict(self, req: Request) -> None:
        """Preempt: free pages, requeue at the front, recompute on
        re-admission (greedy / seeded sampling regenerates identically)."""
        self.pool.release(req.slot)
        self.slot_req[req.slot] = None
        req.state = "pending"
        req.slot = -1
        req.prefill_pos = 0
        req.tokens = []
        req.evictions += 1
        self.pending.appendleft(req)
        self.stats.evictions += 1
