"""Paged KV cache: a fixed-size page pool + per-sequence page tables.

Counterpart of ``repro/serving/kv_pages.py``.  The continuous-batching
scheduler (``serving/scheduler.py``) stores the sequence axis of every
full-length KV leaf in a shared pool of fixed-size pages:

    dense leaf   (G, B, max_len, KV, hd)        (models.init_cache layout)
    pool leaf    (num_pages, G, page_size, KV, hd)
    page table   (num_slots, max_len // page_size) int32

Sequences allocate pages as they grow (``ensure``), free them on finish or
eviction (``release``), and the pool's free count is the admission /
backpressure signal.  Page 0 is a reserved scratch page: unoccupied slots
and padded prefill tokens scatter their writes there, so a masked slot can
never corrupt a live sequence's pages.

``gather`` materialises the standard dense cache tree (the structure,
shapes and dtypes of ``models.init_cache``), so the model's attention path
consumes it without any layout change; ``scatter_decode`` /
``scatter_prefill`` write the newly produced tokens back into their pages.
The gather stays explicit, as the reference keeps it (no paged-attention
kernel).

Leaves without a ``max_len`` sequence axis (SSM/conv state, and
window-sized ring KV caches) are per-slot *resident* state: allocated dense
at ``num_slots`` and reset to zero when a slot is (re)admitted.

Unlike the reference, whose views are pure functions returning new arrays,
the port's model writes the caches it is given in place
(``models/attention.py``, ``models/ssm.py``), and the scatters here write
into the pools in place (each still returns what it wrote).  Hence:

- a gathered paged leaf is a copy (``pool[table]``): the forward writes
  into the copy, and ``scatter_*`` carries its new tokens to the pages;
- ``gather`` hands out *clones* of the resident leaves, because the decode
  forward advances every row it is given, including the dummy rows of
  slots that are not decoding (free, or admitted and waiting for their
  prefill), and ``update_resident`` then keeps the new state of the active
  rows only, as the reference's ``where(active, new, old)`` does.  The
  clone costs one copy of the resident state per decode tick (zamba2-1.2b
  at 4 slots: 160 MB of SSM state), against a host-bound tick.  Saving
  and restoring the inactive rows instead would spare it when every slot
  decodes, but ``update_resident`` would then no longer be the reference's
  ``where(active, new, old)``, which the tests hold bit for bit against
  JAX's;
- ``gather_slot`` (the prefill path) hands out a *view* of one slot's
  resident rows, since a batch-1 prefill writes only that slot, and
  ``update_resident_slot`` finds the state already in place.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import init_cache

__all__ = ["PagePool", "tree_flatten", "tree_unflatten"]


def tree_flatten(tree, path=()):
    """[(path, leaf)] of a nested dict of tensors, keys sorted at every level
    (the order of ``jax.tree_util.tree_flatten``, so leaf ``i`` is the same
    leaf in both packages)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(tree_flatten(tree[k], path + (k,)))
        return out
    return [(path, tree)]


def tree_unflatten(paths, leaves) -> dict:
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def _leaf_meta(path, leaf, max_len: int):
    """(lead, paged) for one cache leaf.  ``lead`` is 1 when the leaf has a
    stacked group dim in front (cache["groups"] subtree), else 0; ``paged``
    iff the leaf is a full-length KV plane (seq axis == max_len)."""
    lead = 1 if "groups" in path else 0
    paged = (
        path[-1] in ("k", "v")
        and leaf.ndim >= lead + 2
        and leaf.shape[lead + 1] == max_len
    )
    return lead, paged


class PagePool:
    """Page pool + tables + resident state for one scheduler instance.

    Device state lives in ``self.pools`` (dict: flat-leaf-index -> pool
    tensor) and ``self.resident`` (flat leaf list, ``None`` at paged
    positions), both on ``device`` (default: the GPU).  Host state
    (``table``, free list, per-slot page lists) is plain numpy/python:
    allocation is control flow, not compute.
    """

    def __init__(self, cfg: ModelConfig, num_slots: int, max_len: int,
                 page_size: int = 16, num_pages: int | None = None, device=None):
        if max_len % page_size != 0:
            raise ValueError(
                f"max_len={max_len} must be a multiple of page_size={page_size}"
            )
        self.device = resolve_device(device)
        self.cfg = cfg
        self.num_slots = num_slots
        self.max_len = max_len
        self.page_size = page_size
        self.max_pages_per_seq = max_len // page_size
        if num_pages is None:
            # fully provisioned: every slot can reach max_len (+1 scratch)
            num_pages = num_slots * self.max_pages_per_seq + 1
        if num_pages < 2:
            raise ValueError("need at least 1 usable page beside the scratch page")
        self.num_pages = num_pages

        # shapes only: the template allocates nothing
        flat = tree_flatten(init_cache(cfg, num_slots, max_len, device="meta"))
        self._paths = [path for path, _ in flat]
        self._template_flat = flat
        self._lead = []
        self._paged = []
        self.pools: dict[str, torch.Tensor] = {}
        self.resident: list = []
        for i, (path, leaf) in enumerate(flat):
            lead, paged = _leaf_meta(path, leaf, max_len)
            self._lead.append(lead)
            self._paged.append(paged)
            if paged:
                lead_shape = tuple(leaf.shape[:lead])
                tail = tuple(leaf.shape[lead + 2:])
                self.pools[str(i)] = torch.zeros(
                    (num_pages,) + lead_shape + (page_size,) + tail, dtype=leaf.dtype,
                    device=self.device,
                )
                self.resident.append(None)
            else:
                self.resident.append(torch.zeros(leaf.shape, dtype=leaf.dtype,
                                                 device=self.device))

        # host-side allocation state; page 0 is the reserved scratch page
        self.table = np.zeros((num_slots, self.max_pages_per_seq), np.int32)
        self._free = list(range(num_pages - 1, 0, -1))
        self._slot_pages: list[list[int]] = [[] for _ in range(num_slots)]
        self.pages_high_water = 0

    # ------------------------------------------------------------------
    # host-side allocation
    # ------------------------------------------------------------------

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    def pages_needed(self, n_tokens: int) -> int:
        return max(1, math.ceil(n_tokens / self.page_size))

    def slot_pages(self, slot: int) -> int:
        return len(self._slot_pages[slot])

    def ensure(self, slot: int, upto_len: int) -> bool:
        """Allocate pages so slot covers positions [0, upto_len).  Returns
        False (allocating nothing) when the pool cannot satisfy it."""
        if upto_len > self.max_len:
            raise ValueError(f"sequence length {upto_len} > max_len {self.max_len}")
        need = self.pages_needed(upto_len) - len(self._slot_pages[slot])
        if need <= 0:
            return True
        if need > len(self._free):
            return False
        for _ in range(need):
            pid = self._free.pop()
            idx = len(self._slot_pages[slot])
            self._slot_pages[slot].append(pid)
            self.table[slot, idx] = pid
        self.pages_high_water = max(self.pages_high_water, self.pages_in_use)
        return True

    def release(self, slot: int) -> None:
        """Free all of a slot's pages (finish / eviction) and point its
        table row at the scratch page."""
        self._free.extend(reversed(self._slot_pages[slot]))
        self._slot_pages[slot] = []
        self.table[slot, :] = 0

    def reset_slot_state(self, slot: int) -> None:
        """Zero the resident (non-paged) state rows of a slot: SSM/conv
        state and ring KV carry across tokens, so a re-admitted slot must
        not inherit the previous occupant's state."""
        for i, r in enumerate(self.resident):
            if r is not None:
                r.narrow(self._lead[i], slot, 1).zero_()

    def device_table(self) -> torch.Tensor:
        return torch.as_tensor(self.table, device=self.device)

    # ------------------------------------------------------------------
    # gather/scatter views
    # ------------------------------------------------------------------

    def gather(self, pools, resident, tables):
        """Dense cache views for the whole slot batch.

        Returns the standard ``init_cache``-layout tree: paged leaves are
        gathered ``pool[table]`` copies, resident leaves are clones (the
        forward writes them in place; ``update_resident`` keeps the active
        rows).  Table entries of unoccupied positions point at the scratch
        page; whatever they gather is masked by attention's ``pos`` validity.
        """
        leaves = []
        for i, (path, tmpl) in enumerate(self._template_flat):
            if not self._paged[i]:
                leaves.append(resident[i].clone())
                continue
            g = pools[str(i)][tables]                # (B, Mp, *lead, P, *tail)
            if self._lead[i]:
                g = g.movedim(2, 0)                  # (G, B, Mp, P, *tail)
            B = tables.shape[0]
            lead_shape = tuple(tmpl.shape[: self._lead[i]])
            tail = tuple(tmpl.shape[self._lead[i] + 2:])
            leaves.append(g.reshape(lead_shape + (B, self.max_len) + tail))
        return tree_unflatten(self._paths, leaves)

    def gather_slot(self, pools, resident, table_row, slot: int):
        """Batch-1 dense cache view of one slot (the prefill path): paged
        leaves gathered (copies), resident leaves a view of the slot's rows
        (the prefill writes them in place)."""
        leaves = []
        for i, (path, tmpl) in enumerate(self._template_flat):
            lead = self._lead[i]
            if not self._paged[i]:
                leaves.append(resident[i].narrow(lead, slot, 1))
                continue
            g = pools[str(i)][table_row]             # (Mp, *lead, P, *tail)
            if lead:
                g = g.movedim(1, 0)                  # (G, Mp, P, *tail)
            lead_shape = tuple(tmpl.shape[:lead])
            tail = tuple(tmpl.shape[lead + 2:])
            g = g.reshape(lead_shape + (self.max_len,) + tail)
            leaves.append(g.unsqueeze(lead))         # (*lead, 1, S, *tail)
        return tree_unflatten(self._paths, leaves)

    def _new_cache_leaves(self, new_cache):
        flat = tree_flatten(new_cache)
        if [p for p, _ in flat] != self._paths:
            raise ValueError("new_cache tree does not match the cache template")
        return [leaf for _, leaf in flat]

    def scatter_decode(self, pools, new_cache, tables, pos, active):
        """Write each slot's decode token (at ``pos[b]``) into its page, in
        place; returns ``pools``.  ``active`` (B,) bool: inactive slots
        (free, or mid-prefill: their pages hold live prefill data) are
        redirected to the scratch page."""
        flat = self._new_cache_leaves(new_cache)
        B = pos.shape[0]
        rows = torch.arange(B, device=pos.device)
        page_idx = torch.clamp(pos // self.page_size, 0, self.max_pages_per_seq - 1)
        pid = torch.where(active, tables[rows, page_idx], 0)
        off = pos % self.page_size
        for i, leaf in enumerate(flat):
            if not self._paged[i]:
                continue
            pool = pools[str(i)]
            if self._lead[i]:
                tok = leaf[:, rows, pos]                # (G, B, *tail)
                pool[pid, :, off] = tok.movedim(1, 0).to(pool.dtype)
            else:
                pool[pid, off] = leaf[rows, pos].to(pool.dtype)
        return pools

    def scatter_prefill(self, pools, new_cache, table_row, start: int, real_len: int,
                        chunk: int):
        """Write a batch-1 prefill chunk's tokens (absolute positions
        ``start .. start+chunk``) into the slot's pages, in place; returns
        ``pools``.  Positions at or beyond ``real_len`` (pad tokens) go to
        the scratch page."""
        flat = self._new_cache_leaves(new_cache)
        offs = torch.arange(chunk, device=table_row.device)
        positions = start + offs
        page_idx = torch.clamp(positions // self.page_size, 0, self.max_pages_per_seq - 1)
        pid = torch.where(offs < real_len, table_row[page_idx], 0)
        off = positions % self.page_size
        for i, leaf in enumerate(flat):
            if not self._paged[i]:
                continue
            lead = self._lead[i]
            pool = pools[str(i)]
            # the slice clamps to fit, as dynamic_slice does
            s0 = min(max(start, 0), leaf.shape[lead + 1] - chunk)
            sl = leaf.narrow(lead + 1, s0, chunk).squeeze(lead)  # (chunk|G, ..)
            if lead:
                pool[pid, :, off] = sl.movedim(1, 0).to(pool.dtype)   # (chunk, G, *tail)
            else:
                pool[pid, off] = sl.to(pool.dtype)
        return pools

    def update_resident(self, resident, new_cache, active):
        """Carry updated resident state for active slots only, in place
        (a masked slot's SSM/ring state must not be advanced by its dummy
        token); returns ``resident``."""
        flat = self._new_cache_leaves(new_cache)
        for i, r in enumerate(resident):
            if r is None:
                continue
            lead = self._lead[i]
            sel = active.reshape((1,) * lead + (-1,) + (1,) * (flat[i].ndim - lead - 1))
            r.copy_(torch.where(sel, flat[i], r))
        return resident

    def update_resident_slot(self, resident, new_cache, slot: int):
        """Write back one slot's resident state after a prefill chunk;
        returns ``resident``.  For the views ``gather_slot`` handed out,
        which the prefill wrote in place, ``copy_`` finds source and
        destination the same memory and copies nothing."""
        flat = self._new_cache_leaves(new_cache)
        for i, r in enumerate(resident):
            if r is not None:
                r.narrow(self._lead[i], slot, 1).copy_(flat[i])
        return resident

    # ------------------------------------------------------------------

    def view_template(self):
        """Meta-tensor tree of ``gather``'s output: the structure, shapes and
        dtypes of ``models.init_cache(cfg, num_slots, max_len)``."""
        return tree_unflatten(self._paths, [leaf for _, leaf in self._template_flat])
