"""Weight-compression byte costing and compositional roofline costing.

Counterpart of ``repro/launch/costing.py``.  The three byte functions are
pure: :mod:`repro_torch.compression.plan` predicts bytes with them before
any solver runs.

``cost_cell`` gives a cell's per-rank roofline terms without running the
whole step.  The port counts what the step dispatches (``roofline.
CostCounter``) on fake tensors as rank 0 of a fake process group
(``launch/fakeworld.py``); at about a millisecond an op, a full-width step
(tens of thousands of ops a layer group) is composed from three programs
on the same mesh with the same placements, as the reference composes
XLA's costs:

  B  = one layer group: its fwd+bwd under the model's remat when training
       (so B holds the recompute, where the reference adds a ``layer_fwd``
       part; with the group's gathers and, in the backward, its
       reduce-scatters), its forward with the cache when serving; with the
       model's costing twins (``unroll=True``);
  A  = a one-group end-to-end step (same kind)  ->  stem = A - B (- C1);
  C  = the optimiser update alone (train), on one group and on the model.

  total = microbatches * (stem + num_groups * B [+ remainder layers]) + C

FLOPs and collective bytes are sums over ops, so the composition is exact
for them (the batch's all-gather, once a step, counts once a microbatch);
bytes accessed are op-by-op upper bounds.  The peak of live bytes (the
dry run's ``temp_bytes``) composes as described at :func:`cost_cell`.

The kernels K3, K4 and K5 launch through ``ctypes`` on data pointers:
they cannot take fake tensors and no dispatch mode sees inside them.  While
counting, the hooks that ``kernels.ops.enable_kernels`` installs are
replaced by costing adapters that return an empty output of the kernel's
shape and dtype and add the kernel's operations and bytes from its shapes,
as ``chip_smoke.py``'s bounds count them: x @ M and z @ C at 2 operations a
multiply-add, each input read and the output written once.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch.distributed import sharding as shd

__all__ = [
    "cost_cell",
    "trace_cell",
    "counting",
    "compressed_weight_bytes",
    "int8_weight_bytes",
    "dense_weight_bytes",
]


# ---------------------------------------------------------------------------
# Weight-compression byte costing (pure)
# ---------------------------------------------------------------------------


def dense_weight_bytes(shape, itemsize: int) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n * int(itemsize)


def compressed_weight_bytes(
    d_in: int, d_out: int, tile_n: int, tile_d: int, K: int,
    itemsize: int, groups: int = 1,
) -> int:
    """Stored bytes of the {"m_packed", "C"} form: per tile, M packs to
    tile_n * ceil(K/8) uint8 and C stays (K, tile_d) at the weight's dtype.
    Must agree with ``quantized.compressed_num_bytes`` on the result."""
    r, c = d_in // tile_n, d_out // tile_d
    m_bytes = r * c * tile_n * ((K + 7) // 8)
    c_bytes = r * c * K * tile_d * int(itemsize)
    return int(groups) * (m_bytes + c_bytes)


def int8_weight_bytes(
    d_in: int, d_out: int, tile_n: int, tile_d: int, groups: int = 1,
) -> int:
    """Stored bytes of the int8-baseline {"q", "scale"} form: per tile,
    tile_n * tile_d int8 values plus one float32 scale."""
    r, c = d_in // tile_n, d_out // tile_d
    return int(groups) * (r * c * tile_n * tile_d + r * c * 4)


# ---------------------------------------------------------------------------
# Counting
# ---------------------------------------------------------------------------

_COUNTER = []       # the CostCounter the kernel adapters add to


def _flash_adapter(qh, k, v, window):
    # K5 at the shape the model hands it: under tensor parallelism the
    # rank's q heads and the kv heads they read
    B, S, KV, rep, hd = qh.shape
    pairs = sum(min(i + 1, window) if window > 0 else i + 1 for i in range(S))
    _COUNTER[-1].extra(flops=4 * B * KV * rep * hd * pairs,
                       bytes=(2 * qh.numel() + k.numel() + v.numel()) * qh.element_size())
    return torch.empty_like(qh)


def _bitlinear_cost(x_rows: int, x_itemsize: int, mp, C, lead: int) -> None:
    E = mp.shape[0] if lead else 1
    n_r, n_c, tn = mp.shape[lead:lead + 3]
    K, td = C.shape[lead + 2], C.shape[lead + 3]
    ops = 2 * E * x_rows * (n_r * tn * n_c * K + n_r * n_c * K * td)
    nbytes = mp.numel() + C.numel() * C.element_size() \
        + E * x_rows * (n_r * tn + n_c * td) * x_itemsize
    _COUNTER[-1].extra(flops=ops, bytes=nbytes)


def _fused_adapter(x, w):
    mp, C = w["m_packed"], w["C"]
    T = x.numel() // x.shape[-1]
    _bitlinear_cost(T, x.element_size(), mp, C, 0)
    return x.new_empty(tuple(x.shape[:-1]) + (C.shape[1] * C.shape[3],))


def _grouped_adapter(x, w):
    mp, C = w["m_packed"], w["C"]
    E = C.shape[0]
    T = x.numel() // (E * x.shape[-1])
    _bitlinear_cost(T, x.element_size(), mp, C, 1)
    return x.new_empty(tuple(x.shape[:-1]) + (C.shape[2] * C.shape[4],))


@contextlib.contextmanager
def counting(kernels: bool = False):
    """A fresh ``roofline.CostCounter`` over the block, with the kernel hooks
    replaced by the costing adapters (``kernels=True``, the compressed
    cells) or cleared; whatever was registered is restored after."""
    from repro_torch.core import quantized
    from repro_torch.kernels import ops
    from repro_torch.models import attention as attn_lib
    from repro_torch.roofline import CostCounter

    with ops.kernels_off():
        if kernels:
            attn_lib.register_flash(_flash_adapter)
            quantized.register_bitlinear_fused(_fused_adapter)
            quantized.register_bitlinear_grouped(_grouped_adapter)
        counter = CostCounter()
        _COUNTER.append(counter)
        try:
            with counter:
                yield counter
        finally:
            _COUNTER.pop()


def _costs(counter) -> dict:
    """A program's counts: the sums the composition adds up (FLOPs, bytes,
    transcendentals, collective bytes and counts by kind) and its peak."""
    out = {"flops": float(counter.dot_flops + counter.elementwise_flops),
           "dot_flops": float(counter.dot_flops),
           "transcendentals": float(counter.transcendentals),
           "bytes": float(counter.bytes),
           "coll": float(sum(counter.coll.values()))}
    for k, v in counter.coll.items():
        out[f"coll/{k}"] = float(v)
        out[f"count/{k}"] = float(counter.coll_counts[k])
    out["temp"] = float(counter.peak_bytes)
    return out


def _extra_out(args, out) -> int:
    """Bytes of a step's results that are not its arguments updated in place."""
    from repro_torch.roofline import _tensors, tree_bytes

    arg_ids = {id(t) for t in _tensors(list(args))}
    return tree_bytes([t for t in _tensors(list(out)) if id(t) not in arg_ids])


def _fake(shape, dtype, device, requires_grad):
    x = torch.empty(tuple(shape), dtype=dtype, device=device)
    return x.requires_grad_() if requires_grad and x.is_floating_point() else x


def _group_local(shapes, shardings, device, requires_grad=False, stacked=True):
    """One group's local tensors: each stacked leaf's rank-0 box without
    its leading (layer) axis (``stacked=False``: each leaf's box)."""
    from repro_torch.launch.cells import _local_shape, _tree_map

    lead = 1 if stacked else 0
    return _tree_map(lambda t, ns: _fake(_local_shape(ns, t.shape)[lead:], t.dtype, device,
                                         requires_grad), shapes, shardings)


def _leaf_input(x):
    """A gathered weight as a leaf of its own (its ``model`` placement
    kept), so that a program's gradient stops there."""
    return shd.mark_tp(x.detach().requires_grad_(x.is_floating_point()), shd.tp_dim(x))


def _carry_width(cfg, axis) -> int:
    """The carry's last dim on a rank: its box of d_model along ``model``
    under tensor parallelism (``axis``: ``sharding.model_axis``'s)."""
    m = 1 if axis is None else axis[1]
    return cfg.d_model // m if cfg.d_model % m == 0 else cfg.d_model


def _sub_artifact(artifact, groups: int):
    """The artifact of the model cut to ``groups`` layer groups and no
    remainder: stacked entries keep their first ``groups`` layers."""
    import copy

    from repro_torch.compression.artifact import CompressionArtifact

    man = copy.deepcopy(artifact.manifest)
    tensors = {}
    for path, e in man["tensors"].items():
        top = path.split("/")[0]
        if top == "rem":
            continue
        if top == "groups":
            e["shape"] = [groups] + list(e["shape"][1:])
            if e.get("group_dims"):
                e["group_dims"] = [groups] + list(e["group_dims"][1:])
            for k in ("m_packed", "C", "q", "scale"):
                if k in e and isinstance(e[k], dict) and "shape" in e[k]:
                    e[k]["shape"] = [groups] + list(e[k]["shape"][1:])
        tensors[path] = e
    man["tensors"] = tensors
    return CompressionArtifact(man)


# ---------------------------------------------------------------------------
# The programs
# ---------------------------------------------------------------------------

def _train_parts(cfg, shape, pcfg, mesh, arch) -> tuple[dict, dict]:
    from repro_torch.device import dtype_from_name
    from repro_torch.launch.cells import _build, _leaves, _tree_map, materialize
    from repro_torch.models import layers
    from repro_torch.models import transformer as tr
    from repro_torch.optim import constant
    from repro_torch.training.loop import (
        _axes_trees,
        make_optimizer,
        sharded_update,
        state_shardings,
    )

    micro = pcfg.microbatches
    accum = dtype_from_name(pcfg.accum_dtype)
    rows = shape.global_batch // micro
    row_axes = shd.row_axes(rows, mesh, pcfg.dp_includes_model)
    _, count = shd.axes_index(mesh, row_axes)
    group = shd.axes_group(mesh, row_axes) if count > 1 else None
    b_loc = rows // count
    shapes, _ = _axes_trees(cfg)
    p_sh = state_shardings(cfg, pcfg, mesh).params
    dtype = tr.model_dtype(cfg)
    dev = mesh.device_type
    parts, sizes_out = {}, {}

    # B: one group as the step runs it, under the model's remat (whose
    # recompute is then inside B; the reference adds a forward for it)
    gp = _group_local(shapes["groups"], p_sh["groups"], dev, requires_grad=True)
    shared = _group_local(shapes["shared"], p_sh["shared"], dev, requires_grad=True,
                          stacked=False) if "shared" in shapes else None
    axis = shd.model_axis(mesh, pcfg)
    h = torch.empty((b_loc, shape.seq_len, _carry_width(cfg, axis)), dtype=dtype, device=dev,
                    requires_grad=True)
    sizes_out["h"] = h.numel() * h.element_size()
    sizes_out["group_grads"] = sum(x.numel() for x in _leaves(gp)) * accum.itemsize

    def group_fn(h_, gp_, shared_):
        return tr._apply_group(h_, shd.gather_params(gp_, "groups", stacked=True), cfg,
                               shared_, cache=None, pos_offset=0, window=cfg.sliding_window,
                               unroll=True)

    with torch.enable_grad(), shd.data_parallel(group, count), shd.model_parallel(axis), \
            shd.activation_rules(pcfg, mesh), shd.gathering(p_sh, group, row_axes, accum):
        # the shared block is gathered once a forward, in the stem
        shared = None if shared is None else _tree_map(_leaf_input,
                                                       shd.gather_params(shared, "shared"))
        with counting() as c:
            out, _, aux = layers.remat(group_fn, h, gp, shared) if cfg.remat \
                else group_fn(h, gp, shared)
            wrt = [h] + _leaves(gp) + (_leaves(shared) if shared is not None else [])
            torch.autograd.grad(torch.sum(out.to(torch.float32)) + aux, wrt, allow_unused=True)
    parts["layer"] = _costs(c)
    del gp, shared, h, out, aux

    # A: a one-group step on one microbatch; C: the optimiser alone
    one_cfg = dataclasses.replace(cfg, num_layers=len(cfg.block_pattern))
    one_pcfg = dataclasses.replace(pcfg, microbatches=1)
    micro_shape = dataclasses.replace(shape, global_batch=shape.global_batch // micro)
    cell = _build(one_cfg, micro_shape, mesh, one_pcfg, arch, unroll=True,
                  lr_schedule=constant(1e-4))
    args = materialize(cell.args, cell.in_shardings)
    with counting() as c:
        out = cell.fn(*args)
    parts["one_group_step"] = _costs(c)
    sizes_out["out_extra"] = _extra_out(args, out)
    del args, out

    def opt_only(cfg_, pcfg_, name):
        from repro_torch.compression.plan import tree_paths

        c_ = _build(cfg_, micro_shape, mesh, pcfg_, arch)
        state = materialize(c_.args[0], c_.in_shardings[0])
        grads = [torch.empty(shd.local_value(x).shape, dtype=accum, device=dev)
                 for _, x in tree_paths(state.params)]
        step = shd.local_value(state.step)
        lr = constant(1e-4)(step)
        with counting() as c:
            sharded_update(make_optimizer(pcfg_), pcfg_, state, grads, step, lr)
        parts[name] = _costs(c)
        if name == "opt_full":
            sizes_out["accum"] = sum(g.numel() for g in grads) * accum.itemsize

    opt_only(one_cfg, one_pcfg, "opt_one_group")
    opt_only(cfg, pcfg, "opt_full")
    return parts, sizes_out


def _serve_parts(cfg, shape, pcfg, mesh, arch, artifact) -> tuple[dict, dict]:
    from repro_torch.launch.cells import (
        _build,
        _tree_map,
        local_rows,
        materialize,
        serving_context,
    )
    from repro_torch.models import transformer as tr

    parts = {}
    kernels = artifact is not None
    cell = _build(cfg, shape, mesh, pcfg, arch, artifact, unroll=True)
    args = materialize(cell.args, cell.in_shardings)
    params, cache = args[0], args[2]
    p_sh = cell.in_shardings[0]
    b_loc = local_rows(shape.global_batch, mesh)
    dev = mesh.device_type
    S = 1 if shape.kind == "decode" else shape.seq_len
    h = torch.empty((b_loc, S, _carry_width(cfg, shd.model_axis(mesh, pcfg))),
                    dtype=tr.model_dtype(cfg), device=dev)
    gp = tr._index(_tree_map(shd.local_value, params["groups"]), 0)
    shared = _tree_map(shd.local_value, params["shared"]) if "shared" in params else None
    with serving_context(cfg, pcfg, p_sh, cache) as work:
        # the group's cache slice: a prefill writes it too (every kv head)
        gc = tr._index(work["groups"], 0)
        # the shared block is gathered once a forward, in the stem
        shared = None if shared is None else shd.gather_params(shared, "shared")
        with counting(kernels) as c:
            tr._apply_group(h, shd.gather_params(gp, "groups", stacked=True), cfg, shared,
                            cache=gc,
                            pos_offset=shape.seq_len - 1 if shape.kind == "decode" else 0,
                            window=cfg.sliding_window, unroll=True)
    parts["layer"] = _costs(c)
    del args, params, cache, work

    one_cfg = dataclasses.replace(cfg, num_layers=len(cfg.block_pattern))
    one_art = None if artifact is None else _sub_artifact(artifact, 1)
    cell = _build(one_cfg, shape, mesh, pcfg, arch, one_art, unroll=True)
    args = materialize(cell.args, cell.in_shardings)
    with counting(kernels) as c:
        out = cell.fn(*args)
    parts["one_group_step"] = _costs(c)
    return parts, {"out_extra": _extra_out(args, out)}


# ---------------------------------------------------------------------------
# Composition
# ---------------------------------------------------------------------------

def _resolve(arch, shape_name, multi_pod, overrides):
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.presets import parallel_preset

    cfg = get_config(arch)
    shape = shape_name if isinstance(shape_name, ShapeConfig) else SHAPES[shape_name]
    pcfg = parallel_preset(cfg, shape, multi_pod=multi_pod)
    if overrides:
        pcfg = dataclasses.replace(pcfg, **overrides)
    return cfg, shape, pcfg


@contextlib.contextmanager
def world(mesh, multi_pod: bool = False):
    """The mesh to cost on: a ``DeviceMesh`` as it is (the caller is inside
    ``fake_world``); a mesh shape ({axis: size}) or None (the production
    mesh, 16 x 16, or 2 x 16 x 16 with ``multi_pod``) inside a fake world
    of its own for the block."""
    from repro_torch.launch.fakeworld import fake_world

    if mesh is not None and hasattr(mesh, "mesh_dim_names"):
        yield mesh
        return
    if mesh is None:
        mesh = {"pod": 2, "data": 16, "model": 16} if multi_pod else {"data": 16, "model": 16}
    with fake_world(tuple(mesh.values()), tuple(mesh)) as m:
        yield m


def _compose(cfg, shape, pcfg, parts, sizes) -> dict:
    kind = shape.kind
    micro = pcfg.microbatches
    G = cfg.num_groups
    A, layer = parts["one_group_step"], parts["layer"]
    n_rem, n_pat = len(cfg.remainder_pattern), len(cfg.block_pattern)
    total = {}
    for k in A:
        if k == "temp":
            continue
        if kind == "train":
            stem = max(A[k] - layer[k] - parts["opt_one_group"][k], 0.0)
            total[k] = micro * (stem + G * layer[k]) + parts["opt_full"][k]
        else:
            total[k] = max(A[k] - layer[k], 0.0) + G * layer[k]
        # remainder layers (zamba2) approximated by the group average
        total[k] += (micro if kind == "train" else 1) * n_rem * layer[k] / n_pat
    # the peak is not a sum: the one-group step's, plus what each further
    # group keeps alive until the backward reaches it (its remat input and,
    # once its backward ran, its gradient boxes), plus the microbatches'
    # accumulators; serving keeps nothing from group to group
    if kind == "train":
        total["temp"] = A["temp"] + (G - 1 + n_rem / n_pat) * \
            (sizes["h"] + sizes["group_grads"]) + (sizes["accum"] if micro > 1 else 0)
    else:
        total["temp"] = max(A["temp"], layer["temp"])
    total["out_extra"] = float(sizes["out_extra"])
    return total


def _cell_costs(arch, shape_name, *, multi_pod=False, causal_skip=False, overrides=None,
                mesh=None, artifact=None):
    """(cfg, shape, pcfg, described mesh, composed totals, parts)."""
    from repro_torch.launch.mesh import describe
    from repro_torch.models import attention as attn_lib

    cfg, shape, pcfg = _resolve(arch, shape_name, multi_pod, overrides)
    saved = attn_lib.CAUSAL_SKIP_UNROLL, attn_lib.Q_CHUNK_DEFAULT
    attn_lib.CAUSAL_SKIP_UNROLL = bool(causal_skip)
    # coarser costing chunks at long sequence, as the reference: FLOPs are
    # chunk-size-invariant but for the causal diagonal's granularity
    attn_lib.Q_CHUNK_DEFAULT = max(shape.seq_len // 8, 512) if shape.seq_len >= 16384 else 512
    try:
        with world(mesh, multi_pod) as m:
            if shape.kind == "train":
                if artifact is not None:
                    raise ValueError("compression artifacts only apply to serving cells "
                                     "(prefill/decode), not train")
                parts, sizes = _train_parts(cfg, shape, pcfg, m, arch)
            else:
                parts, sizes = _serve_parts(cfg, shape, pcfg, m, arch, artifact)
            where = describe(m)
    finally:
        attn_lib.CAUSAL_SKIP_UNROLL, attn_lib.Q_CHUNK_DEFAULT = saved
    return cfg, shape, pcfg, where, _compose(cfg, shape, pcfg, parts, sizes), parts


def cost_cell(arch: str, shape_name, multi_pod: bool = False, causal_skip: bool = False,
              overrides: dict | None = None, *, mesh=None, artifact=None) -> dict:
    """Compositional roofline terms for one cell, per rank.

    ``shape_name`` is a key of ``SHAPES`` or a ``ShapeConfig``; ``mesh`` is
    None (the production mesh), a mesh shape ({axis: size}) or a
    ``DeviceMesh`` inside ``fake_world``; ``overrides`` replace fields of
    the preset's ``ParallelConfig``; ``artifact`` costs the compressed
    serving program through the kernels' adapters.  ``causal_skip`` costs
    the causal-block-skipping attention instead of the all-blocks baseline.

    Besides the reference's keys, ``dot_flops`` (matrix products alone)
    and ``temp_bytes``, the composed peak of live bytes: the one-group
    step's peak, plus for training per further group its saved input and
    its gradient boxes in the accumulation dtype, plus the accumulators
    when there are several microbatches; for serving the larger of the
    one-group step's and the group's."""
    from repro_torch import roofline

    cfg, shape, pcfg, where, total, parts = _cell_costs(
        arch, shape_name, multi_pod=multi_pod, causal_skip=causal_skip, overrides=overrides,
        mesh=mesh, artifact=artifact)
    return {
        "arch": arch, "shape": shape.name,
        "mesh": where,
        "kind": shape.kind, "micro": pcfg.microbatches, "groups": cfg.num_groups,
        "causal_skip": causal_skip, "compressed": artifact is not None,
        "flops": total["flops"], "bytes": total["bytes"], "coll_bytes": total["coll"],
        "dot_flops": total["dot_flops"], "temp_bytes": total["temp"],
        "parts": {k: {f: v[f] for f in _PART_KEYS} for k, v in parts.items()},
        **roofline.roofline_terms(total["flops"], total["bytes"], total["coll"]),
    }


_PART_KEYS = ("flops", "bytes", "coll", "dot_flops", "transcendentals", "temp")


def trace_cell(cell, kernels: bool = False) -> dict:
    """The whole step of ``cell`` (built on a ``DeviceMesh`` inside
    ``fake_world``) traced under the counter: its record
    (``roofline.CostCounter.record``), ``argument_bytes``, ``output_bytes``
    and ``alias_bytes`` (results that are arguments updated in place).
    For cells small enough to trace whole; ``cost_cell`` composes."""
    from repro_torch.launch.cells import argument_bytes, materialize
    from repro_torch.roofline import _tensors, tree_bytes

    args = materialize(cell.args, cell.in_shardings)
    with counting(kernels) as c:
        out = cell.fn(*args)
    arg_ids = {id(t) for t in _tensors(list(args))}
    outs = list(_tensors(list(out)))
    aliased = [t for t in outs if id(t) in arg_ids]
    rec = c.record()
    rec.update(argument_bytes=argument_bytes(cell), output_bytes=tree_bytes(outs),
               alias_bytes=tree_bytes(aliased))
    return rec
