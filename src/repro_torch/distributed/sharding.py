"""Logical-axis sharding rules on a torch ``DeviceMesh``.

Counterpart of ``repro/distributed/sharding.py``.  Model code annotates
every parameter with *logical* axis names (``models/params.py``); this
module maps them to mesh axes with the reference's rules:

    vocab -> model, embed -> data (FSDP; (pod, data) with a pod axis),
    mlp / heads / kv / experts / ssm_in -> model

A spec is a tuple with one entry per tensor dim, as JAX's
``PartitionSpec`` (normalised as it is, by :func:`P`): ``None``, an axis
name, or a tuple of names (the dim is split over them, the first major).  ``spec_for`` keeps the reference's
fallbacks: a mesh axis appears once per spec (later dims fall back to
None), a dim that a rule does not divide falls back to None (a tuple rule
first retries its largest dividing prefix), and trailing Nones are
trimmed.  It runs on a *mesh shape* (an ordered {name: size} mapping) as
well as on a ``DeviceMesh``, so the rules need no process group.

:class:`NamedSharding` turns a spec into DTensor placements (per mesh dim
``Shard(tensor_dim)`` or ``Replicate()``) and into the global index box of
each rank's shard; a dim split over several axes is split over them in
mesh order, major first, so the rank -> box map is JAX's
``devices_indices_map`` for ranks laid out row-major.

``activation_rules`` installs the reference's activation specs for
``constrain`` and ``current_rule`` (flash-decode reads it).  The port's
sharded steps (``training/loop.py``, ``launch/cells.py``) run each rank on
its rows of the batch with explicit collectives over three pieces of
process-wide state, each installed by a context:

* ``data_parallel``: the group over which ``dp_sum`` and ``dp_mean``
  reduce a loss's batch statistics;
* ``model_parallel``: the ``model`` group, along which the model computes
  as the reference's rules partition it (tensor parallelism of heads, kv,
  mlp and vocab, expert parallelism of experts): a weight dim on ``model``
  stays this rank's box and is computed on, and activations move between
  ranks through the collectives below;
* ``gathering``: the parameter shards that ``gather_params`` gathers one
  layer group at a time, over the data-parallel axes only for a leaf with a
  dim on ``model``.

Along ``model`` every value is one of: *whole* (the same on every rank),
*split* (this rank's box of one dim) or *partial* (this rank's term of a
sum over the ranks).  The collectives are autograd functions, each with
its transpose: ``model_gather`` split -> whole (all-gather; backward
reduce-scatter), ``model_scatter`` partial -> split (reduce-scatter;
backward all-gather), ``model_sum`` partial -> whole (all-reduce; backward
all-reduce), ``model_slice`` whole -> split (no communication; backward
pads with zeros), ``model_once`` whole -> partial (rank 0 keeps it) and
``model_all_to_all``, which sends chosen indices of a dim to each rank
(an all-to-all with uneven splits; backward the reverse all-to-all, the
cotangents of an index sent to several ranks summed).
The backward of each makes one convention hold: the cotangent of a whole
value is partial, so the step seeds its replicated loss with 1/m on each of
the ``m`` ranks (``training/loop.py``) and a weight that is whole over
``model`` has its gradient summed over ``model`` as well as over the dp
group (``gather_params``).  Every rank runs the same graph, so each
collective of the backward (and of a remat's recompute) is issued on every
rank in the same order.  Outside these contexts every helper is the
identity, so model code runs on one device unchanged.
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch

from repro_torch.configs.base import ParallelConfig

__all__ = [
    "mesh_shape",
    "mesh_device",
    "P",
    "make_rules",
    "spec_for",
    "param_shardings",
    "NamedSharding",
    "activation_spec",
    "activation_rules",
    "current_rule",
    "constrain",
    "fit",
    "row_axes",
    "axes_group",
    "axes_index",
    "data_parallel",
    "model_parallel",
    "model_axis",
    "model_size",
    "model_index",
    "model_gather",
    "model_scatter",
    "model_sum",
    "model_slice",
    "model_once",
    "model_max",
    "model_all_to_all",
    "tp_dim",
    "rows_whole",
    "mark_tp",
    "whole_over_model",
    "dp_sum",
    "dp_mean",
    "gathering",
    "gather_params",
    "is_dtensor",
    "local_value",
    "full_value",
    "is_whole",
    "sharding_of",
    "dtensor_box",
]


def mesh_shape(mesh) -> dict:
    """Ordered {axis name: size} of a ``DeviceMesh``, or of a mapping that
    already is one (a mesh *shape*, which needs no process group)."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))
    return dict(mesh)


def mesh_device(mesh) -> torch.device:
    """This rank's device on ``mesh``: its current CUDA device, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def make_rules(pcfg: ParallelConfig) -> dict:
    has_model = "model" in pcfg.mesh_axes and not pcfg.dp_includes_model
    model = "model" if has_model else None
    data = "data" if "data" in pcfg.mesh_axes else None
    if data is not None and pcfg.fsdp and "pod" in pcfg.mesh_axes:
        fsdp_axes: object = ("pod", "data")
    elif pcfg.fsdp:
        fsdp_axes = data
    else:
        fsdp_axes = None
    return {
        "vocab": model,
        "embed": fsdp_axes,
        "mlp": model,
        "heads": model,
        "kv": model,
        "experts": model,
        "ssm_in": model,
        None: None,
    }


def spec_for(axes: tuple, shape: tuple, rules: dict, mesh) -> tuple:
    """Logical axes + shape -> spec, with the reference's conflict and
    divisibility fallbacks (``repro/distributed/sharding.py::spec_for``)."""
    sizes = mesh_shape(mesh)
    used = set()
    entries = []
    for dim, name in zip(shape, axes):
        rule = rules.get(name)
        cand = rule if isinstance(rule, tuple) else (rule,) if rule else ()
        cand = tuple(a for a in cand if a in sizes and a not in used)
        size = math.prod(sizes[a] for a in cand)
        if not cand or dim % size != 0:
            # tuple rule: retry with the largest divisible prefix
            while cand and (size == 0 or dim % size != 0):
                size //= sizes[cand[-1]]
                cand = cand[:-1]
            if not cand or size <= 1 or dim % size != 0:
                entries.append(None)
                continue
        used.update(cand)
        entries.append(cand if len(cand) > 1 else cand[0])
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def P(*entries) -> tuple:
    """A spec normalised as JAX's ``PartitionSpec`` normalises its entries:
    an empty tuple is None and a 1-tuple its one axis."""
    return tuple(None if e == () else e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


class NamedSharding:
    """A spec on a mesh (a ``DeviceMesh`` or a mesh shape)."""

    def __init__(self, mesh, spec: tuple):
        self.mesh, self.spec = mesh, P(*spec)
        self.sizes = mesh_shape(mesh)
        names = list(self.sizes)
        for e in self.spec:
            order = [names.index(a) for a in _entry_axes(e)]
            if order != sorted(order):
                raise NotImplementedError(
                    f"spec entry {e}: a dim split over axes out of mesh order "
                    f"{tuple(names)} has no DTensor placement"
                )

    def __repr__(self):
        return f"NamedSharding({self.sizes}, {self.spec})"

    def placements(self) -> list:
        from torch.distributed.tensor import Replicate, Shard

        out = []
        for name in self.sizes:
            dim = next((t for t, e in enumerate(self.spec) if name in _entry_axes(e)), None)
            out.append(Replicate() if dim is None else Shard(dim))
        return out

    def box(self, shape, coord: dict) -> tuple:
        """The global index box (a tuple of slices) of the shard at mesh
        coordinate ``coord`` ({axis: index})."""
        out = []
        for t, dim in enumerate(shape):
            axes = _entry_axes(self.spec[t]) if t < len(self.spec) else ()
            idx, total = 0, 1
            for a in axes:
                idx, total = idx * self.sizes[a] + coord[a], total * self.sizes[a]
            if dim % total:
                raise ValueError(f"dim {t} of shape {tuple(shape)} does not split evenly "
                                 f"over {axes} ({total} ranks)")
            step = dim // total
            out.append(slice(idx * step, (idx + 1) * step))
        return tuple(out)

    def devices_indices_map(self, shape) -> dict:
        """{rank: box} over every mesh position, ranks row-major."""
        names, dims = list(self.sizes), list(self.sizes.values())
        out = {}
        for rank in range(math.prod(dims)):
            coord, r = {}, rank
            for n, d in reversed(list(zip(names, dims))):
                coord[n], r = r % d, r // d
            out[rank] = self.box(shape, coord)
        return out

    def is_whole(self) -> bool:
        """Whether every rank's shard is the whole value."""
        return all(self.sizes[a] == 1 for e in self.spec for a in _entry_axes(e))

    def global_shape(self, local_shape) -> tuple:
        """The whole value's shape, from a shard's."""
        return tuple(d * math.prod(self.sizes[a] for a in _entry_axes(e))
                     for d, e in zip(local_shape, self.spec + (None,) * len(local_shape)))

    def holds_first_replica(self) -> bool:
        """Whether this rank's shard is the first of the ranks that hold the
        same box (index 0 along every mesh axis that the spec does not
        use): summing over the ranks that do counts each element once."""
        used = {a for e in self.spec for a in _entry_axes(e)}
        return all(c == 0 for a, c in self._coord().items() if a not in used)

    def _coord(self) -> dict:
        return dict(zip(self.sizes, self.mesh.get_coordinate()))

    def local_box(self, shape) -> tuple:
        return self.box(shape, self._coord())

    def from_local(self, local: torch.Tensor, shape):
        """The DTensor whose shard on this rank is ``local``."""
        from torch.distributed.tensor import DTensor

        shape = torch.Size(shape)
        stride = torch.empty(shape, device="meta").stride()
        return DTensor.from_local(local, self.mesh, self.placements(), run_check=False,
                                  shape=shape, stride=stride)

    def shard(self, full: torch.Tensor, device=None):
        """This rank's shard of ``full`` (a host or device tensor) as a
        DTensor on ``device``; only the shard is copied."""
        local = full[self.local_box(full.shape)]
        local = local.to(device, copy=True) if device is not None else local.clone()
        return self.from_local(local.contiguous(), full.shape)


def param_shardings(axes_tree, shapes_tree, rules: dict, mesh):
    """Trees: logical axes (tuple leaves) + shapes -> NamedSharding tree."""
    if isinstance(shapes_tree, dict):
        return {k: param_shardings(axes_tree[k], v, rules, mesh) for k, v in shapes_tree.items()}
    shp = tuple(shapes_tree.shape) if hasattr(shapes_tree, "shape") else tuple(shapes_tree)
    return NamedSharding(mesh, spec_for(axes_tree, shp, rules, mesh))


# ---------------------------------------------------------------------------
# Activation rules (model code stays mesh-agnostic)
# ---------------------------------------------------------------------------

_TLS = threading.local()


def _activation_specs(pcfg: ParallelConfig, mesh) -> dict:
    """The reference's activation specs (hidden (B, S, d): batch over the dp
    axes, embed over ``model``; or batch over the whole mesh with
    ``dp_includes_model``)."""
    sizes = mesh_shape(mesh)
    dp_names = ("pod", "data", "model") if pcfg.dp_includes_model else ("pod", "data")
    dp = tuple(a for a in dp_names if a in sizes)
    if pcfg.dp_includes_model:
        return {
            "hidden": P(dp, None, None),
            "hidden_nosp": P(dp, None, None),
            "logits": P(dp, None, None),
            "batch": P(dp),
        }
    model = "model" if "model" in sizes else None
    return {
        "hidden": P(dp, None, model),
        "hidden_nosp": P(dp, None, None),
        "logits": P(dp, None, model),
        "batch": P(dp),
        # flash-decode: decode attention over a cache sequence-sharded
        # on this axis, partial softmax stats combined across it
        "decode_sp_axis": model,
        "dp_axes": dp,
    }


def activation_spec(pcfg: ParallelConfig, mesh, kind: str):
    """The spec ``activation_rules(pcfg, mesh)`` installs for ``kind``
    (``"hidden"``, ``"logits"``, ``"batch"``, ...; None for a kind it
    installs none for), without installing it.  The reference lists the
    name in its ``__all__`` but defines no such function."""
    return _activation_specs(pcfg, mesh).get(kind)


@contextlib.contextmanager
def activation_rules(pcfg: ParallelConfig, mesh):
    """Install the reference's activation specs (``activation_spec``) for
    ``constrain`` and ``current_rule``."""
    specs = _activation_specs(pcfg, mesh)
    prev = getattr(_TLS, "rules", None)
    _TLS.rules = (specs, mesh)
    try:
        yield specs
    finally:
        _TLS.rules = prev


def current_rule(kind: str):
    """An installed activation rule (None outside ``activation_rules``)."""
    rules = getattr(_TLS, "rules", None)
    return None if rules is None else rules[0].get(kind)


def current_mesh():
    rules = getattr(_TLS, "rules", None)
    return None if rules is None else rules[1]


def fit(dim: int, entry, sizes: dict):
    """Largest dividing suffix of a spec entry (batch 256 on ('pod',
    'data', 'model') = 512 falls back to ('data', 'model') = 256)."""
    axes = _entry_axes(entry)
    while axes:
        if dim % math.prod(sizes.get(a, 1) for a in axes) == 0:
            return axes if len(axes) > 1 else axes[0]
        axes = axes[1:]
    return None


def row_axes(rows: int, mesh, include_model: bool = False) -> tuple:
    """The mesh axes a step splits ``rows`` over: the largest dividing
    suffix of the dp axes ((pod, data), with ``model`` too when
    ``include_model``), () for none."""
    sizes = mesh_shape(mesh)
    names = ("pod", "data", "model") if include_model else ("pod", "data")
    axes = fit(rows, tuple(a for a in names if a in sizes), sizes)
    return () if axes is None else axes if isinstance(axes, tuple) else (axes,)


def constrain(x, kind: str):
    """``x`` moved to the installed rule ``kind`` (each entry fitted to its
    dim): a DTensor is redistributed; a plain tensor under
    ``model_parallel``, whole along ``model`` and holding this rank's rows,
    is cut to this rank's box of each dim the rule puts on ``model``
    (``model_slice``).  Anything else, or no rule, passes unchanged.

    The model calls it where the reference constrains: the carry after the
    embedding (``hidden``, embed on ``model``) and logits from a head that
    is not vocab-sharded (``logits``)."""
    specs = current_rule(kind) if getattr(_TLS, "rules", None) else None
    if specs is None:
        return x
    entries = list(specs) + [None] * (x.ndim - len(specs))
    if is_dtensor(x):
        sizes = mesh_shape(x.device_mesh)
        spec = tuple(fit(d, e, sizes) for d, e in zip(x.shape, entries))
        return x.redistribute(x.device_mesh, NamedSharding(x.device_mesh, spec).placements())
    m = model_size()
    if m == 1:
        return x
    for t, (d, e) in enumerate(zip(x.shape, entries)):
        if "model" in _entry_axes(e) and d % m == 0:
            x = model_slice(x, t)
    return x


# ---------------------------------------------------------------------------
# Process groups over mesh axes; batch statistics over the data-parallel group
# ---------------------------------------------------------------------------

def axes_group(mesh, axes: tuple):
    """The process group of the ranks that differ only along ``axes`` from
    this one (None for no axes).  Every rank must call it with the same
    ``axes``: a group over several axes is made collectively, once.  The
    rank lists come from the mesh's rank grid read outside any dispatch
    mode, in Python ints, so this runs under ``FakeTensorMode`` too."""
    import itertools

    import torch.distributed as dist
    from torch.utils._python_dispatch import _disable_current_modes

    axes = tuple(axes)
    if not axes:
        return None
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    cache = mesh.__dict__.setdefault("_repro_axes_groups", {})
    if axes not in cache:
        names, sizes = list(mesh.mesh_dim_names), [int(s) for s in mesh.shape]
        with _disable_current_modes():
            grid = mesh.mesh.tolist()
        keep = [names.index(a) for a in axes]
        rest = [i for i in range(len(sizes)) if i not in keep]

        def rank(idx):
            v = grid
            for i in idx:
                v = v[i]
            return v

        me = dist.get_rank()
        # the ranks of each group: row-major over the other axes, then over
        # ``axes`` (the first major) inside a group
        for outer in itertools.product(*(range(sizes[i]) for i in rest)):
            ranks = []
            for inner in itertools.product(*(range(sizes[i]) for i in keep)):
                idx = [0] * len(sizes)
                for i, v in zip(rest + keep, outer + inner):
                    idx[i] = v
                ranks.append(rank(idx))
            g = dist.new_group(ranks)
            if me in ranks:
                cache[axes] = g
    return cache[axes]


def axes_index(mesh, axes: tuple) -> tuple:
    """(this rank's index, count) along ``axes``, the first major."""
    sizes = mesh_shape(mesh)
    coord = dict(zip(sizes, mesh.get_coordinate()))
    idx, total = 0, 1
    for a in axes:
        idx, total = idx * sizes[a] + coord[a], total * sizes[a]
    return idx, total


# The sharded steps' state, process-wide and not thread-local: the
# autograd engine runs a CUDA graph's backward, and so the recompute of a
# remat'd group, on its device thread.
_STEP = {"dp": None, "gather": None, "model": None}


class _GroupSum(torch.autograd.Function):
    """All-reduce SUM over a group; the gradient passes through unchanged
    (each rank's loss is the same function of the global sums, and the
    gradients are summed over the group where the parameters are gathered,
    :func:`gather_params`)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


@contextlib.contextmanager
def data_parallel(group, size: int):
    """Make ``dp_sum`` / ``dp_mean`` reduce over ``group`` (``size`` ranks,
    each holding an equal share of the batch's rows)."""
    prev = _STEP["dp"]
    _STEP["dp"] = (group, size) if size > 1 else None
    try:
        yield
    finally:
        _STEP["dp"] = prev


def dp_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of ``x`` over the data-parallel group (identity outside it)."""
    dp = _STEP["dp"]
    return x if dp is None else _GroupSum.apply(x, dp[0])


def dp_mean(x: torch.Tensor, dim) -> torch.Tensor:
    """``x.mean(dim)`` over the whole batch: this rank's rows and the
    group's (each rank holds as many rows)."""
    dp = _STEP["dp"]
    if dp is None:
        return x.mean(dim=dim)
    n = math.prod(x.shape[d] for d in (dim if isinstance(dim, tuple) else (dim,)))
    return dp_sum(x.sum(dim=dim)) / (n * dp[1])


# ---------------------------------------------------------------------------
# Tensor and expert parallelism along ``model``
# ---------------------------------------------------------------------------

def model_axis(mesh, pcfg: ParallelConfig):
    """(group, size, this rank's index) of the ``model`` axis when the
    rules shard over it (a ``model`` axis and not ``dp_includes_model``),
    else None.  Every rank must call it (the group is made collectively)."""
    sizes = mesh_shape(mesh)
    if "model" not in sizes or pcfg.dp_includes_model:
        return None
    idx, size = axes_index(mesh, ("model",))
    return axes_group(mesh, ("model",)), size, idx


@contextlib.contextmanager
def model_parallel(axis):
    """Make the model compute along ``model``: ``axis`` is ``model_axis``'s
    (group, size, index), or None (nothing installed).  A size-1 axis is
    installed too: every helper is then the identity and the step is the
    unsharded one, op for op.  The group may also be a stand-in object, not
    a ``ProcessGroup``, with ``all_gather(x, dim)``, ``reduce_scatter(x,
    dim)``, ``all_reduce(x, op)`` and ``all_to_all(x, send_sizes,
    recv_sizes)`` methods: one rank's share computed at a time on one
    device."""
    prev = _STEP["model"]
    _STEP["model"] = None if axis is None else tuple(axis)
    try:
        yield
    finally:
        _STEP["model"] = prev


def model_size() -> int:
    """The number of ranks along ``model`` under ``model_parallel`` (1
    outside it)."""
    state = _STEP["model"]
    return 1 if state is None else state[1]


def model_index() -> int:
    """This rank's index along ``model`` (0 outside ``model_parallel``)."""
    state = _STEP["model"]
    return 0 if state is None else state[2]


def tp_dim(w):
    """The dim of a gathered weight that is this rank's box along
    ``model`` (``gather_params`` marks it), None for a weight whole over
    ``model``, outside ``model_parallel``, or for anything but a tensor.
    Under ``model_parallel`` a tensor without the mark (made by an op from
    a gathered weight, or never gathered) raises: read as whole, a rank's
    box would silently drop the other ranks' terms."""
    if model_size() == 1 or not isinstance(w, torch.Tensor):
        return None
    if not hasattr(w, "_tp_dim"):
        raise ValueError(f"a weight of shape {tuple(w.shape)} without its placement along "
                         "model: take it from gather_params, or mark it (mark_tp)")
    return w._tp_dim


def mark_tp(w: torch.Tensor, dim) -> torch.Tensor:
    """``w`` marked as this rank's box of ``dim`` along ``model`` (None:
    whole), the mark that :func:`tp_dim` reads."""
    w._tp_dim = dim
    return w


def whole_over_model(w):
    """A gathered weight made whole along ``model`` (its boxes all-gathered;
    the gradient reduce-scattered back), for a weight too small to compute
    on in boxes (the SSM's conv); a whole weight, or a non-tensor, as it
    is."""
    dim = tp_dim(w)
    return w if dim is None else mark_tp(model_gather(w, dim), None)


def _stand_in(group) -> bool:
    import torch.distributed as dist

    return not isinstance(group, dist.ProcessGroup)


def _all_gather(x, dim: int, group, size: int):
    if _stand_in(group):
        return group.all_gather(x, dim)
    import torch.distributed as dist

    x0 = x.movedim(dim, 0).contiguous()
    out = x0.new_empty((size * x0.shape[0],) + tuple(x0.shape[1:]))
    dist.all_gather_into_tensor(out, x0, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(x, dim: int, group, size: int):
    if _stand_in(group):
        return group.reduce_scatter(x, dim)
    import torch.distributed as dist

    x0 = x.movedim(dim, 0).contiguous()
    out = x0.new_empty((x0.shape[0] // size,) + tuple(x0.shape[1:]))
    dist.reduce_scatter_tensor(out, x0, group=group)
    return out.movedim(0, dim)


def _all_reduce(x, group, op: str = "sum"):
    if _stand_in(group):
        return group.all_reduce(x, op)
    import torch.distributed as dist

    y = x.contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM, group=group)
    return y


def _all_to_all(x, send_sizes, recv_sizes, group):
    """Dim 0 of ``x`` in parts of ``send_sizes``, part t to rank t; the
    parts received, ``recv_sizes`` rows from each rank, in rank order."""
    if _stand_in(group):
        return group.all_to_all(x, send_sizes, recv_sizes)
    import torch.distributed as dist

    x = x.contiguous()
    out = x.new_empty((sum(recv_sizes),) + tuple(x.shape[1:]))
    dist.all_to_all_single(out, x, output_split_sizes=list(recv_sizes),
                           input_split_sizes=list(send_sizes), group=group)
    return out


class _ModelAllToAll(torch.autograd.Function):
    """Indices of ``dim`` sent to each rank; backward the reverse
    all-to-all, its rows added back at their indices (in f32 for a
    narrower dtype), so that the cotangents of an index sent to several
    ranks are summed."""

    @staticmethod
    def forward(ctx, x, index, send_sizes, recv_sizes, dim):
        group = _STEP["model"][0]
        ctx.group, ctx.index, ctx.dim, ctx.shape = group, index, dim, x.shape
        ctx.sizes = (send_sizes, recv_sizes)
        buf = x.index_select(dim, index).movedim(dim, 0)
        return _all_to_all(buf, send_sizes, recv_sizes, group).movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        send_sizes, recv_sizes = ctx.sizes
        back = _all_to_all(g.movedim(ctx.dim, 0), recv_sizes, send_sizes, ctx.group)
        acc = torch.float32 if g.element_size() < 4 and g.is_floating_point() else g.dtype
        out = g.new_zeros(ctx.shape, dtype=acc)
        out.index_add_(ctx.dim, ctx.index, back.movedim(0, ctx.dim).to(acc))
        return out.to(g.dtype), None, None, None, None


class _ModelGather(torch.autograd.Function):
    """split -> whole: all-gather along ``dim``; backward reduce-scatter."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        group, size, _ = _STEP["model"]
        ctx.group, ctx.size = group, size
        return _all_gather(x, dim, group, size)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group, ctx.size), None


class _ModelScatter(torch.autograd.Function):
    """partial -> split: reduce-scatter along ``dim``; backward all-gather."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        group, size, _ = _STEP["model"]
        ctx.group, ctx.size = group, size
        return _reduce_scatter(x, dim, group, size)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group, ctx.size), None


class _ModelSum(torch.autograd.Function):
    """partial -> whole: all-reduce; backward all-reduce (the whole value's
    cotangent is partial, each term's is the whole cotangent)."""

    @staticmethod
    def forward(ctx, x):
        ctx.group = _STEP["model"][0]
        return _all_reduce(x, ctx.group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group)


class _ModelSlice(torch.autograd.Function):
    """whole -> split: this rank's box of ``dim``; backward pads the box's
    cotangent with zeros (a partial cotangent of the whole value)."""

    @staticmethod
    def forward(ctx, x, dim):
        _, size, idx = _STEP["model"]
        ctx.dim, ctx.shape, ctx.n = dim, x.shape, x.shape[dim] // size
        ctx.start = idx * ctx.n
        return x.narrow(dim, ctx.start, ctx.n).contiguous()

    @staticmethod
    def backward(ctx, g):
        out = g.new_zeros(ctx.shape)
        out.narrow(ctx.dim, ctx.start, ctx.n).copy_(g)
        return out, None


def model_gather(x, dim: int = -1):
    """This rank's box of ``dim`` (split) -> the whole value on every rank."""
    return x if model_size() == 1 else _ModelGather.apply(x, dim % x.ndim)


def model_scatter(x, dim: int = -1):
    """This rank's term of a sum (partial) -> its box of ``dim`` of the sum."""
    return x if model_size() == 1 else _ModelScatter.apply(x, dim % x.ndim)


def model_sum(x):
    """This rank's term of a sum (partial) -> the sum on every rank."""
    return x if model_size() == 1 else _ModelSum.apply(x)


def model_slice(x, dim: int = -1):
    """A whole value -> this rank's box of ``dim``."""
    return x if model_size() == 1 else _ModelSlice.apply(x, dim % x.ndim)


def model_once(x):
    """A whole value -> a partial one whose sum over ``model`` counts it
    once: ``x`` on rank 0, zeros elsewhere (a product with a 0/1 factor,
    so every rank keeps the same graph)."""
    return x if model_size() == 1 else x * float(model_index() == 0)


def model_max(x):
    """Elementwise max over ``model`` (no gradient: a stabiliser)."""
    return x if model_size() == 1 else _all_reduce(x.detach(), _STEP["model"][0], "max")


def model_all_to_all(x, send, recv, dim: int = -1):
    """The indices ``send[t]`` of ``x``'s ``dim`` sent to rank t along
    ``model``, for every t; the result holds, along ``dim``, the ``recv[s]``
    indices that each rank s sends this one, in rank order (an index may go
    to several ranks).  With one rank, ``x``'s ``send[0]`` indices."""
    dim = dim % x.ndim
    index = torch.as_tensor([i for s in send for i in s], dtype=torch.long, device=x.device)
    if model_size() == 1:
        return x.index_select(dim, index)
    return _ModelAllToAll.apply(x, index, [len(s) for s in send], [int(n) for n in recv], dim)


class _GatherParam(torch.autograd.Function):
    """A parameter's value for this rank's compute from its shard: gathered
    over every axis that shards it (``whole``) or, under
    ``model_parallel``, over all but ``model``, whose dim stays this rank's
    box (an all-gather over the dp axes).  Backward: the gradient summed
    over the data-parallel group in ``dtype`` into this rank's box, a
    reduce-scatter where one dim is sharded over exactly the group's axes,
    else an all-reduce and a slice; and, for a value whole over ``model``
    under ``model_parallel`` (whose gradient is partial there), summed over
    ``model`` too."""

    @staticmethod
    def forward(ctx, local, sharding, shape, group, axes, dtype, model_group, name):
        ctx.box, ctx.group, ctx.dtype = sharding.local_box(shape), group, dtype
        ctx.dim = next((t for t, e in enumerate(sharding.spec) if _entry_axes(e) == axes), None)
        ctx.model_group = model_group
        if sharding.is_whole():
            return local.view_as(local)
        return sharding.from_local(local.contiguous(), shape).full_tensor()

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        none = (None,) * 7
        if ctx.group is None:
            g = g[ctx.box]
        elif ctx.dim is None:
            g = g.to(ctx.dtype, copy=True)
            dist.all_reduce(g, group=ctx.group)
            g = g[ctx.box]
        else:
            t = ctx.dim
            rows = tuple(slice(None) if d == t else b for d, b in enumerate(ctx.box))
            whole = g[rows].to(ctx.dtype).movedim(t, 0).contiguous()
            n = ctx.box[t].stop - ctx.box[t].start
            out = whole.new_empty((n,) + tuple(whole.shape[1:]))
            dist.reduce_scatter_tensor(out, whole, group=ctx.group)
            g = out.movedim(0, t)
        if ctx.model_group is not None:
            g = _all_reduce(g.to(ctx.dtype), ctx.model_group)
        return (g,) + none


@contextlib.contextmanager
def gathering(shardings, group, axes: tuple, dtype: torch.dtype):
    """Make ``gather_params`` gather parameter shards placed by
    ``shardings`` (a NamedSharding tree matching the model's values) and
    sum their gradients over ``group``, the ranks along mesh ``axes`` (None
    and (): one rank's rows), in ``dtype``."""
    prev = _STEP["gather"]
    _STEP["gather"] = (shardings, group, tuple(axes), dtype)
    try:
        yield
    finally:
        _STEP["gather"] = prev


def _without_model(ns: NamedSharding) -> tuple:
    """(the spec without ``model``, the dim it held or None)."""
    spec, dim = [], None
    for t, e in enumerate(ns.spec):
        axes = _entry_axes(e)
        if "model" in axes:
            dim = t
            axes = tuple(a for a in axes if a != "model")
        spec.append(axes if axes else None)
    return P(*spec), dim


def gather_params(tree, path: str, stacked: bool = False):
    """The values of ``tree`` for this rank's compute, from this rank's
    shards of the parameters at ``path`` of the model's values tree (one
    group's slice of them when ``stacked``), inside :func:`gathering`;
    ``tree`` itself outside it.

    Under ``model_parallel`` a leaf with a dim on ``model`` is gathered over
    the other axes only, and every leaf is marked with its dim on ``model``
    or None (``tp_dim``).  The model
    calls it where a group's (or the top level's) weights are used, inside
    the group's remat: a rank holds one group's gathered weights at a time,
    and their gradient, one group at a time."""
    state = _STEP["gather"]
    if state is None:
        return tree
    shardings, group, axes, dtype = state
    for k in path.split("/"):
        shardings = shardings[k]
    model = _STEP["model"]
    model_group = model[0] if model is not None and model[1] > 1 else None

    def one(x, ns, name):
        if stacked:
            if ns.spec and ns.spec[0] is not None:
                raise ValueError(f"{path}: a stacked leaf sharded over its layers {ns.spec}")
            ns = NamedSharding(ns.mesh, ns.spec[1:])
        dim = None
        if model_group is not None:
            spec, dim = _without_model(ns)
            if dim is not None:
                ns = NamedSharding(ns.mesh, spec)
        # a value whole over ``model`` is used alike on every model rank:
        # its gradient there is partial, summed over ``model`` by the gather
        # (an all-reduce) or by the transpose of the gather over ``model``
        mg = model_group if dim is None else None
        if group is None and mg is None and ns.is_whole():
            if dim is None:
                return x
            y = x.view_as(x)
        else:
            y = _GatherParam.apply(x, ns, ns.global_shape(x.shape), group, axes, dtype, mg,
                                   name)
        return mark_tp(y, dim)

    def walk(x, ns, name):
        if isinstance(x, dict):
            return {k: walk(v, ns[k], f"{name}/{k}") for k, v in x.items()}
        return one(x, ns, name)

    return walk(tree, shardings, path)


# ---------------------------------------------------------------------------
# DTensor leaves
# ---------------------------------------------------------------------------

def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def local_value(x):
    """The local shard of a DTensor (a view: in-place writes reach it);
    any other tensor as it is."""
    return x.to_local() if is_dtensor(x) else x


def is_whole(x) -> bool:
    """Whether this rank's shard of a DTensor is the whole value: no mesh
    dim of more than one rank shards it."""
    return all(p.is_replicate() or n == 1 for p, n in zip(x.placements, x.device_mesh.shape))


def full_value(x):
    """The whole value of a DTensor on every rank: the local tensor itself
    when it is whole (``is_whole``), else an all-gather; a plain tensor as
    it is."""
    if not is_dtensor(x):
        return x
    return x.to_local() if is_whole(x) else x.full_tensor()


def rows_whole(x, rows_dim: int):
    """A DTensor as this rank's rows (its box of ``rows_dim``) with every
    other dim made whole over its mesh axes (an all-gather over those)."""
    from torch.distributed.tensor import Replicate

    keep = [p if p.is_shard() and p.dim == rows_dim else Replicate() for p in x.placements]
    if keep == list(x.placements):
        return x.to_local()
    return x.redistribute(x.device_mesh, keep).to_local()


def sharding_of(x) -> NamedSharding:
    """The NamedSharding of a DTensor (the inverse of ``placements``)."""
    names = list(x.device_mesh.mesh_dim_names)
    spec = [[] for _ in range(x.ndim)]
    for name, p in zip(names, x.placements):
        if p.is_shard():
            spec[p.dim].append(name)
    return NamedSharding(x.device_mesh, tuple(tuple(e) for e in spec))


def dtensor_box(x) -> tuple:
    """The global index box of this rank's shard of a DTensor."""
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    sizes = [int(s) for s in mesh.shape]
    out = []
    for t, dim in enumerate(x.shape):
        idx, total = 0, 1
        for i, p in enumerate(x.placements):
            if p.is_shard() and p.dim == t:
                idx, total = idx * sizes[i] + coord[i], total * sizes[i]
        step = dim // total
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)
