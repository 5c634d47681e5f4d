"""Cell builder: one (architecture x input-shape x mesh) dry-run unit.

Counterpart of ``repro/launch/cells.py``.  A *cell* is the step function of
the shape's kind (train step, prefill, decode step), templates of its
arguments (``device="meta"`` trees of the whole values: no allocation) and
their ``NamedSharding`` trees, the reference's specs leaf for leaf.  The
mesh may be a ``DeviceMesh`` (the step then runs on it,
``launch/dryrun.py``) or a mesh shape ({axis: size}: specs and bytes need no
process group).  ``materialize`` turns the templates into DTensors whose
local tensors are rank 0's boxes, made in the current mode (fake tensors
inside ``launch/fakeworld.fake_world``).

The steps are the port's own programs on a mesh:

* train: ``make_train_step``'s sharded step (``training/loop.py``): each
  rank its rows over the dp axes, tensor- and expert-parallel along
  ``model``, its weights' ``model`` boxes gathered over the dp axes one
  group at a time, gradients reduce-scattered into its boxes;
* prefill and decode (:func:`serving_step`): each rank its rows of the
  batch over the dp axes and its share of each product along ``model``
  (``sharding.model_parallel``), as the train step; the weights stored as
  the reference places them and gathered over the dp axes one group at a
  time (``sharding.gather_params``; compressed leaves are replicated, so
  kernels K3 and K4 run on whole compressed layers, computed alike on every
  model rank), the KV cache's rows and its slice of the sequence over
  ``model`` as DTensors (written where they fall, read by flash-decode with
  every head), each SSM state used in place where its box of the heads is
  the heads the rank computes (``ssm.rank_heads``), each conv window made
  whole over ``model`` for the step (a rank's box of the channels is not
  the channels it computes) and its box written back; the logits gathered
  whole over ``model``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ModelConfig, ParallelConfig, ShapeConfig
from repro_torch.distributed import sharding as shd
from repro_torch.launch.presets import parallel_preset
from repro_torch.models import frontends
from repro_torch.models.transformer import init_cache, model_dtype
from repro_torch.optim import warmup_cosine
from repro_torch.serving.engine import cache_shardings
from repro_torch.training.loop import (
    TrainState,
    _axes_trees,
    make_optimizer,
    make_train_step,
    state_shardings,
)

__all__ = ["Cell", "build_cell", "materialize", "argument_bytes", "serving_step",
           "serving_context", "local_rows"]


class Cell(NamedTuple):
    arch: str
    shape: ShapeConfig
    cfg: ModelConfig
    pcfg: ParallelConfig
    fn: Any                 # step callable on DTensor arguments
    args: tuple             # device="meta" templates of the whole values
    in_shardings: tuple
    out_shardings: Any
    donate_argnums: tuple
    static_argnums: tuple = ()


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _dp_spec(mesh, ndim: int, batch: int, include_model: bool = False) -> shd.NamedSharding:
    names = ("pod", "data", "model") if include_model else ("pod", "data")
    sizes = shd.mesh_shape(mesh)
    dp = tuple(a for a in names if a in sizes)
    # largest dividing suffix (e.g. batch 256 on a 512-way full mesh falls
    # back to ('data', 'model') = 256)
    while dp:
        size = 1
        for a in dp:
            size *= sizes[a]
        if batch % size == 0:
            break
        dp = dp[1:]
    lead = dp if dp else None
    return shd.NamedSharding(mesh, (lead,) + (None,) * (ndim - 1))


def _batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh, pcfg: ParallelConfig):
    B, S = shape.global_batch, shape.seq_len
    inc = pcfg.dp_includes_model
    if frontends.needs_embeds(cfg):
        sds = {"embeds": _meta((B, S, cfg.d_model), model_dtype(cfg)),
               "labels": _meta((B, S), torch.int32)}
        sh = {"embeds": _dp_spec(mesh, 3, B, inc), "labels": _dp_spec(mesh, 2, B, inc)}
    else:
        sds = {"tokens": _meta((B, S), torch.int32)}
        sh = {"tokens": _dp_spec(mesh, 2, B, inc)}
    return sds, sh


def _param_trees(cfg: ModelConfig, pcfg: ParallelConfig, mesh):
    shapes, axes = _axes_trees(cfg)
    return shapes, shd.param_shardings(axes, shapes, shd.make_rules(pcfg), mesh)


def _compressed_param_trees(p_shapes, p_sh, artifact, mesh):
    """Rewrite the dense param template and shardings for a compression
    artifact: every manifested weight becomes a {"m_packed", "C"} dict
    (shapes from the manifest), replicated, as in the reference: the
    compressed form is ~an order of magnitude smaller than the dense weight,
    and the bitlinear kernel wants whole tiles."""
    rep = shd.NamedSharding(mesh, ())
    entries = artifact.manifest["tensors"]

    def rewrite(tree, prefix):
        if isinstance(tree, dict):
            return {k: rewrite(v, f"{prefix}/{k}" if prefix else k) for k, v in tree.items()}
        return {"m_packed": rep, "C": rep} if prefix in entries else tree

    return artifact.restore_template(p_shapes), rewrite(p_sh, "")


def _tree_map(fn, *trees):
    """``fn`` over the leaves of trees of one structure (dicts, tuples,
    NamedTuples; None stays None)."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, tuple):
        vals = [_tree_map(fn, *(x[i] for x in trees)) for i in range(len(t))]
        return type(t)(*vals) if hasattr(t, "_fields") else tuple(vals)
    if t is None:
        return None
    return fn(*trees)


def _box0(ns: shd.NamedSharding, shape) -> tuple:
    """Rank 0's box of a value of ``shape`` (the rank a dry run plays)."""
    return ns.box(tuple(shape), {a: 0 for a in ns.sizes})


def _local_shape(ns, shape) -> tuple:
    return tuple(b.stop - b.start for b in _box0(ns, shape))


def argument_bytes(cell: Cell) -> int:
    """Bytes of rank 0's boxes of every argument of the cell."""
    total = 0

    def add(t, ns):
        nonlocal total
        n = 1
        for d in _local_shape(ns, t.shape):
            n *= d
        total += n * t.element_size()

    _tree_map(add, cell.args, cell.in_shardings)
    return total


def materialize(templates, shardings):
    """DTensors (on the shardings' ``DeviceMesh``) whose local tensors are
    rank 0's boxes of the templates, made with ``torch.empty`` on the
    mesh's device type in the current mode: fake tensors inside
    ``fake_world``."""
    def one(t, ns):
        local = torch.empty(_local_shape(ns, t.shape), dtype=t.dtype,
                            device=ns.mesh.device_type)
        return ns.from_local(local, t.shape)

    return _tree_map(one, templates, shardings)


def local_rows(rows: int, mesh, include_model: bool = False) -> int:
    """The rows of ``rows`` that one rank runs, as the steps split them
    (``sharding.row_axes``)."""
    sizes = shd.mesh_shape(mesh)
    n = 1
    for a in shd.row_axes(rows, mesh, include_model):
        n *= sizes[a]
    return rows // n


def _cache_rows(cache) -> slice:
    """The rows of the batch that this rank's box of the cache holds (over
    the dp axes, as the reference's cache shardings place them)."""
    path, x = next(_paths(cache))
    if not shd.is_dtensor(x):
        return slice(None)
    return shd.dtensor_box(x)[1 if path.split("/")[0] == "groups" else 0]


def _input_rows(x, rows: slice):
    """This rank's rows of a step's input, the cache's ``rows``: a prompt
    whose rows are placed over ``model`` too (``dp_includes_model``, as
    the reference's prefill cells place it) is gathered and cut to them."""
    if not shd.is_dtensor(x) or shd.dtensor_box(x)[0] == rows:
        return shd.local_value(x)
    return shd.full_value(x)[rows]


def _box_of(x, whole, rows_dim: int):
    """This rank's box of ``x`` out of ``whole``, which holds the rank's
    rows with the other dims whole."""
    box = list(shd.dtensor_box(x))
    box[rows_dim] = slice(None)
    return whole[tuple(box)]


@contextlib.contextmanager
def serving_context(cfg: ModelConfig, pcfg: ParallelConfig, p_sh, cache):
    """The serving steps' setting on a mesh, for the block: no autograd, the
    activation rules (flash-decode), tensor parallelism along ``model``,
    parameter gathers by ``p_sh``; the value is the cache to run on: the
    KV leaves the given DTensors, each SSM state its local tensor where that
    holds the heads the rank computes (``cache_shardings`` splits the heads
    over ``model`` only), and every other SSM leaf this rank's rows made
    whole, whose box is written back into its DTensor on exit."""
    from repro_torch.models.ssm import rank_heads

    mesh = next(x for _, x in _paths(cache)).device_mesh
    axis = shd.model_axis(mesh, pcfg)
    heads = rank_heads(cfg, 1 if axis is None else axis[1])
    ssm = []

    def prep(path, x):
        name = path.rsplit("/", 1)[-1]
        if name in ("k", "v"):
            return x
        rows_dim = 1 if path.split("/")[0] == "groups" else 0
        if name == "state" and x.to_local().shape[rows_dim + 1] == heads:
            return x.to_local()
        ssm.append((x, shd.rows_whole(x, rows_dim), rows_dim))
        return ssm[-1][1]

    work = _map_paths(prep, cache)
    with torch.no_grad(), shd.activation_rules(pcfg, mesh), \
            shd.model_parallel(axis), \
            shd.gathering(p_sh, None, (), model_dtype(cfg)):
        yield work
        for x, whole, rows_dim in ssm:
            if not shd.is_whole(x):
                x.to_local().copy_(_box_of(x, whole, rows_dim))


def serving_step(cfg: ModelConfig, pcfg: ParallelConfig, p_sh, kind: str, *,
                 unroll: bool = False, decode_pos: int | None = None):
    """The port's prefill (``kind="prefill"``: ``fn(params, inputs, cache)
    -> (last logits, cache)``) or decode step (``fn(params, tok, cache,
    pos) -> (logits, cache)``) on DTensor arguments placed as the cell's
    ``in_shardings`` (module docstring).  A decode step's ``pos`` may be a
    0-d tensor template (a fake tensor has no value): it then decodes at
    ``decode_pos``, the cell's last position, as the costing does."""
    from repro_torch.models import forward

    def run(params, inputs, cache, pos):
        local_p = _tree_map(shd.local_value, params)
        rows = _cache_rows(cache)
        local_in = {k: _input_rows(v, rows) for k, v in inputs.items()}
        with serving_context(cfg, pcfg, p_sh, cache) as work:
            logits, _, _ = forward(local_p, local_in, cfg, cache=work, pos_offset=pos,
                                   last_only=kind == "prefill", unroll=unroll)
            if logits.shape[-1] < cfg.vocab_size:
                logits = shd.model_gather(logits, -1)     # the rank's vocabulary box
        return logits, cache

    if kind == "prefill":
        def prefill(params, inputs, cache):
            logits, cache = run(params, inputs, cache, 0)
            return logits[:, -1], cache
        return prefill

    def decode_step(params, tok, cache, pos):
        if isinstance(pos, torch.Tensor):
            pos = decode_pos
        tok = shd.local_value(tok)
        inputs = {"embeds": tok[:, None, :]} if frontends.needs_embeds(cfg) \
            else {"tokens": tok[:, None]}
        logits, cache = run(params, inputs, cache, pos)
        return logits[:, 0], cache

    return decode_step


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def _leaves(tree):
    return [x for _, x in _paths(tree)]


def _map_paths(fn, tree, prefix=""):
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, f"{prefix}/{k}" if prefix else k) for k, v in tree.items()}
    return fn(prefix, tree)


def _build(cfg: ModelConfig, shape: ShapeConfig, mesh, pcfg: ParallelConfig, arch: str,
           artifact=None, *, unroll: bool = False, lr_schedule=None) -> Cell:
    if shape.kind == "train":
        if artifact is not None:
            raise ValueError("compression artifacts only apply to serving "
                             "cells (prefill/decode), not train")
        shapes, _ = _axes_trees(cfg)
        state_sds = TrainState(step=_meta((), torch.int32), params=shapes,
                               opt=make_optimizer(pcfg).init(shapes))
        st_sh = state_shardings(cfg, pcfg, mesh)
        batch_sds, batch_sh = _batch_specs(cfg, shape, mesh, pcfg)
        fn = make_train_step(cfg, pcfg, lr_schedule or warmup_cosine(3e-4, 2000, 100_000),
                             unroll=unroll)
        return Cell(arch, shape, cfg, pcfg, fn, args=(state_sds, batch_sds),
                    in_shardings=(st_sh, batch_sh), out_shardings=(st_sh, None),
                    donate_argnums=(0,))

    p_shapes, p_sh = _param_trees(cfg, pcfg, mesh)
    if artifact is not None:
        p_shapes, p_sh = _compressed_param_trees(p_shapes, p_sh, artifact, mesh)
    B, S = shape.global_batch, shape.seq_len
    cache_sds = init_cache(cfg, B, S, stacked=True, device="meta")
    cache_sh = cache_shardings(cfg, pcfg, mesh, B, S, stacked=True)

    if shape.kind == "prefill":
        batch_sds, batch_sh = _batch_specs(cfg, shape, mesh, pcfg)
        fn = serving_step(cfg, pcfg, p_sh, "prefill", unroll=unroll)
        return Cell(arch, shape, cfg, pcfg, fn, args=(p_shapes, batch_sds, cache_sds),
                    in_shardings=(p_sh, batch_sh, cache_sh), out_shardings=(None, cache_sh),
                    donate_argnums=(2,))

    # decode: one new token per sequence against a seq_len-deep cache
    if frontends.needs_embeds(cfg):
        tok_sds, tok_sh = _meta((B, cfg.d_model), model_dtype(cfg)), _dp_spec(mesh, 2, B)
    else:
        tok_sds, tok_sh = _meta((B,), torch.int32), _dp_spec(mesh, 1, B)
    fn = serving_step(cfg, pcfg, p_sh, "decode", unroll=unroll, decode_pos=S - 1)
    return Cell(arch, shape, cfg, pcfg, fn,
                args=(p_shapes, tok_sds, cache_sds, _meta((), torch.int32)),
                in_shardings=(p_sh, tok_sh, cache_sh, shd.NamedSharding(mesh, ())),
                out_shardings=(None, cache_sh), donate_argnums=(2,))


def build_cell(arch: str, shape_name, mesh, pcfg: ParallelConfig | None = None,
               artifact=None, **overrides) -> Cell:
    """``shape_name`` is a key of ``SHAPES`` or a ``ShapeConfig``.
    ``artifact`` (a ``CompressionArtifact``, possibly predicted via
    ``CompressionArtifact.from_plan``) switches serving cells to the
    compressed-weights param template.  Kernel routing is the caller's
    choice (``ops.enable_kernels()``; the dry run swaps in costing adapters,
    ``launch/costing.py``).  Train cells reject artifacts (compression is
    post-training)."""
    cfg = get_config(arch)
    shape = shape_name if isinstance(shape_name, ShapeConfig) else SHAPES[shape_name]
    if pcfg is None:
        pcfg = parallel_preset(cfg, shape, multi_pod="pod" in shd.mesh_shape(mesh))
    if overrides:
        pcfg = dataclasses.replace(pcfg, **overrides)
    return _build(cfg, shape, mesh, pcfg, arch, artifact)
