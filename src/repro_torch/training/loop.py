"""The training step: microbatched gradient accumulation and the optimiser.

Counterpart of ``repro/training/loop.py``:

    for each microbatch:                  # gradient accumulation in accum_dtype
        loss, grads += grad(train_loss)   # remat inside the model
    grads /= n_micro
    params, opt_state = optimizer.update(...)

Gradients come from ``torch.autograd.grad`` on detached aliases of the
parameters; the optimiser then updates the state's tensors in place
(``repro_torch/optim/adamw.py``), so ``train_step`` returns a new
``TrainState`` that holds the same parameter and moment tensors.  The step
runs the model's own attention (``_chunked_attention`` under remat) with
every kernel hook cleared (``kernels.ops.kernels_off``): K5 has no backward,
and the JAX trainer registers no hook either.

On a mesh (``init_train_state(..., mesh=)``) the state's leaves are
DTensors placed by ``state_shardings``, the reference's logical-axis rules:
parameters stored sharded over ``data`` (FSDP) and ``model``, same-shape
moments as their parameter, Adafactor's factored moments and the step
replicated.  The step computes as those rules partition the work, with
explicit collectives, one layer group at a time (DTensor propagation
through the model's ops is not used):

* microbatch i is the global batch's i-th block of rows, as the
  reference's reshape gives it, and each rank runs its share of the block's
  rows, split over the dp axes (``fit`` of the ``batch`` rule);
* along ``model`` (unless ``dp_includes_model``) the ranks compute one
  product each, tensor- and expert-parallel (``sharding.model_parallel``):
  a weight dim on ``model`` (heads, kv, mlp, vocab, experts, the SSM's
  ``ssm_in``) stays the rank's box and the rank computes with it, the
  carry between blocks is its box of the embed dim, and activations move
  by all-gathers, reduce-scatters, all-reduces and (the SSM's fused
  ``in_proj`` columns) all-to-alls along ``model`` whose transposes the
  backward runs (``distributed/sharding.py``);
* the model gathers the top level's weights (embedding, head, final norm,
  zamba2's shared block) when the forward starts, and each group's (and
  remainder layer's) inside that group's remat (``sharding.gather_params``),
  over the dp axes only for a weight with a dim on ``model``: beside its
  shards a rank holds the top level and one group, each its ``model`` box,
  and the recompute gathers the group again;
* the backward of each gather sums the gradient over the dp group in
  ``accum_dtype`` into the rank's box: a reduce-scatter where the weight
  is sharded over exactly the dp axes (the FSDP dim), else an all-reduce
  and a slice.  The gradient of a weight whole over ``model`` (norm scales,
  the router, qk-norm, a replicated vocabulary, the SSM's ``A_log``, ``D``
  and ``dt_bias``) is each model rank's term, so it is summed over
  ``model`` too; a weight's ``model`` box (among them the SSM's
  ``in_proj``, ``out_proj`` and norm scale) gets its own gradient there
  and is not.  The SSM's conv weights, made whole over ``model`` by an
  all-gather, get their gradient summed into their boxes by its
  reduce-scatter.  The loss, whole
  on the model ranks, seeds the backward with 1/m on each of them, so that
  those terms sum to the gradient;
* the loss's batch statistics (the CE's sums, the MoE balance loss's
  means) are reduced over the dp group inside the forward
  (``sharding.data_parallel``), so every rank's loss is the global batch's;
* the global norm sums each box once (on the first rank that holds it)
  and all-reduces that sum;
* AdamW updates each rank's shards of the parameters and moments from its
  boxes (elementwise, with that norm); Adafactor, whose factored moments
  and update clipping reduce over whole dims, gathers one leaf at a time,
  updates it whole and keeps each rank's box.

With ``dp_includes_model`` the whole mesh is data-parallel: the rules put
nothing on ``model``, the rows split over it too and every rank computes
with whole weights.  On a one-rank mesh every collective is skipped and
the step is the unsharded step bit for bit.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.device import dtype_from_name, resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.models import init_model, train_loss
from repro_torch.models.params import placing, split
from repro_torch.optim import adafactor, adamw
from repro_torch.optim.adamw import global_norm

__all__ = [
    "TrainState",
    "make_optimizer",
    "init_train_state",
    "make_train_step",
    "state_shardings",
    "batch_sharding",
    "sharded_update",
]


class TrainState(NamedTuple):
    step: torch.Tensor   # () int32
    params: dict         # model values tree
    opt: dict            # optimiser state tree


def make_optimizer(pcfg: ParallelConfig):
    return {"adamw": adamw, "adafactor": adafactor}[pcfg.optimizer]()


def _axes_trees(cfg: ModelConfig):
    """(meta values tree, logical-axes tree): shapes without allocating."""
    return split(init_model(cfg, device="meta"))


def _subtree(tree, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def state_shardings(cfg: ModelConfig, pcfg: ParallelConfig, mesh) -> TrainState:
    """NamedSharding tree matching ``TrainState``.  Same-shape moments
    inherit the parameter's sharding; factored (lower-rank) Adafactor
    moments are replicated; so is the step."""
    shapes, axes = _axes_trees(cfg)
    p_sh = shd.param_shardings(axes, shapes, shd.make_rules(pcfg), mesh)
    opt_shapes = make_optimizer(pcfg).init(shapes)
    replicated = shd.NamedSharding(mesh, ())

    def match(shape_tree, sh_tree, opt_tree):
        def one(pshape, psh, osub):
            return _map(lambda o: psh if tuple(o.shape) == tuple(pshape.shape) else replicated,
                        osub)
        if isinstance(shape_tree, dict):
            return {k: match(shape_tree[k], sh_tree[k], opt_tree[k]) for k in shape_tree}
        return one(shape_tree, sh_tree, opt_tree)

    if pcfg.optimizer == "adamw":
        opt_sh = {k: match(shapes, p_sh, opt_shapes[k]) for k in opt_shapes}
    else:
        opt_sh = match(shapes, p_sh, opt_shapes)
    return TrainState(step=replicated, params=p_sh, opt=opt_sh)


def batch_sharding(mesh, ndim: int = 2) -> shd.NamedSharding:
    dp = tuple(a for a in ("pod", "data") if a in shd.mesh_shape(mesh))
    return shd.NamedSharding(mesh, (dp,) + (None,) * (ndim - 1))


def init_train_state(seed: int, cfg: ModelConfig, pcfg: ParallelConfig,
                     device=None, mesh=None) -> TrainState:
    """Step 0, the model's weights from ``seed`` and zero optimiser moments,
    on ``device`` (default: the GPU; ``"meta"`` gives a template that holds
    shapes and dtypes only).

    With ``mesh``, on this rank's device: DTensor leaves placed by
    ``state_shardings``, each rank holding exactly its shards of what the
    unsharded ``init_train_state(seed)`` gives.  The weights are drawn one
    Param at a time in the unsharded order, and each is cut to this rank's
    shard as soon as it is drawn: a stacked leaf is never whole, and
    beyond the shards a device holds at most one layer's weight at once."""
    if mesh is None:
        device = resolve_device(device)
        values, _ = split(init_model(cfg, seed=seed, device=device))
        return TrainState(step=torch.zeros((), dtype=torch.int32, device=device),
                          params=values, opt=make_optimizer(pcfg).init(values))

    dev = shd.mesh_device(mesh)
    rules = shd.make_rules(pcfg)
    sh = state_shardings(cfg, pcfg, mesh)

    def keep(v, axes):
        box = shd.NamedSharding(mesh, shd.spec_for(axes, tuple(v.shape), rules, mesh)) \
            .local_box(v.shape)
        return v[box].clone()

    with placing(keep):
        local, _ = split(init_model(cfg, seed=seed, device=dev))
    shapes, _ = _axes_trees(cfg)
    params = _map(lambda v, s, ns: ns.from_local(v, s.shape), local, shapes, sh.params)

    def zeros(o, ns):
        box = ns.local_box(o.shape)
        local_shape = [b.stop - b.start for b in box]
        return ns.from_local(torch.zeros(local_shape, dtype=o.dtype, device=dev), o.shape)

    opt = _map(zeros, make_optimizer(pcfg).init(shapes), sh.opt)
    step = sh.step.from_local(torch.zeros((), dtype=torch.int32, device=dev), ())
    return TrainState(step=step, params=params, opt=opt)


def sharded_update(opt, pcfg: ParallelConfig, state: TrainState, grads: list, step, lr):
    """The sharded step's update of ``state`` (DTensor leaves) in place from
    ``grads``, this rank's boxes of the gradients in ``tree_paths`` order:
    the global norm, each element counted once over the ranks, then the
    optimiser on this rank's shards.  Returns the norm."""
    import torch.distributed as dist

    from repro_torch.compression.execute import _replace
    from repro_torch.compression.plan import tree_paths

    mesh = state.step.device_mesh
    paths, leaves = zip(*tree_paths(state.params))
    local = [shd.local_value(p).detach() for p in leaves]
    shardings = {p: shd.sharding_of(x) for p, x in zip(paths, leaves)}
    if math.prod(shd.mesh_shape(mesh).values()) == 1:
        gnorm = global_norm(_replace(state.params, dict(zip(paths, grads))))
    else:
        # each element once: a box held by several ranks counts on one
        sq = [torch.sum(torch.square(g.to(torch.float32))) *
              float(shardings[p].holds_first_replica()) for p, g in zip(paths, grads)]
        gnorm = torch.sum(torch.stack(sq))
        dist.all_reduce(gnorm)
        gnorm = torch.sqrt(gnorm)
    if pcfg.optimizer == "adamw":
        opt.update(_replace(state.params, dict(zip(paths, grads))),
                   _map(shd.local_value, state.opt), _replace(state.params,
                                                          dict(zip(paths, local))),
                   step, lr, norm=gnorm)
    else:
        # factored moments and update clipping reduce over whole dims:
        # one whole leaf at a time, each rank keeping its box
        for p, x, g in zip(paths, leaves, grads):
            moments = _subtree(state.opt, p)
            whole = [shd.full_value(x)] + [shd.full_value(m) for m in moments.values()]
            grad = shardings[p].from_local(g, x.shape)
            opt.update({"x": shd.full_value(grad)}, {"x": dict(zip(moments, whole[1:]))},
                       {"x": whole[0]}, step, lr)
            for dt, full in zip([x, *moments.values()], whole):
                if not shd.is_whole(dt):
                    dt.to_local().copy_(full[shd.dtensor_box(dt)])
    return gnorm


def make_train_step(cfg: ModelConfig, pcfg: ParallelConfig, lr_schedule, *,
                    unroll: bool = False):
    """Returns ``train_step(state, batch) -> (state, metrics)`` with metrics
    ``loss``, ``grad_norm`` and ``lr`` (0-d float32 tensors).  ``unroll``
    runs the model's costing twins (``models.forward``).  The batch's
    leading dim splits into ``pcfg.microbatches`` microbatches; the loss and
    the gradients are their means, the gradients summed in
    ``pcfg.accum_dtype``.  A state of DTensors (``init_train_state(...,
    mesh=)``) takes the sharded step (module docstring); its batch is the
    global batch, as DTensors (``make_pipeline(..., mesh)``) or whole."""
    from repro_torch.compression.execute import _replace
    from repro_torch.compression.plan import tree_paths
    from repro_torch.kernels.ops import kernels_off

    opt = make_optimizer(pcfg)
    n_micro = pcfg.microbatches
    accum_dtype = dtype_from_name(pcfg.accum_dtype)

    def gradients(state, params, micro_batches):
        """(mean loss, mean-over-microbatch gradients in accum_dtype) of the
        given parameter tensors, summed over the microbatches given.  Under
        ``model_parallel`` each of the m model ranks seeds the backward of
        the loss with 1/m (module docstring)."""
        paths = [p for p, _ in tree_paths(state.params)]
        m = shd.model_size()

        def loss_and_grads(mb):
            live = [p.detach().requires_grad_(True) for p in params]
            with kernels_off(), torch.enable_grad():
                loss = train_loss(_replace(state.params, dict(zip(paths, live))), mb, cfg,
                                  unroll=unroll)[0]
                seed = None if m == 1 else torch.full_like(loss, 1.0 / m)
                grads = torch.autograd.grad(loss, live, grad_outputs=seed, allow_unused=True)
            return loss.detach(), [torch.zeros_like(p) if g is None else g
                                   for p, g in zip(params, grads)]

        if n_micro == 1:
            loss, grads = loss_and_grads(micro_batches[0])
            return loss, [g.to(accum_dtype) for g in grads]
        grads = [torch.zeros(p.shape, dtype=accum_dtype, device=p.device) for p in params]
        loss_sum = torch.zeros((), dtype=torch.float32, device=params[0].device)
        for mb in micro_batches:
            loss, g = loss_and_grads(mb)
            for a, b in zip(grads, g):
                a.add_(b.to(a.dtype))
            del g
            loss_sum = loss_sum + loss
        return loss_sum, grads

    def train_step(state: TrainState, batch: dict):
        if shd.is_dtensor(state.step):
            return sharded_step(state, batch)
        paths, params = zip(*tree_paths(state.params))
        micro = {k: v.reshape((n_micro, v.shape[0] // n_micro) + tuple(v.shape[1:]))
                 for k, v in batch.items()}
        loss, grads = gradients(state, params, [{k: v[i] for k, v in micro.items()}
                                                for i in range(n_micro)])
        if n_micro > 1:
            for a in grads:
                a.div_(n_micro)
            loss = loss / n_micro

        lr = lr_schedule(state.step)
        new_params, new_opt, gnorm = opt.update(_replace(state.params, dict(zip(paths, grads))),
                                                state.opt, state.params, state.step, lr)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        return TrainState(state.step + 1, new_params, new_opt), metrics

    def sharded_step(state: TrainState, batch: dict):
        mesh = state.step.device_mesh
        paths, leaves = zip(*tree_paths(state.params))
        local = [shd.local_value(p).detach() for p in leaves]
        shardings = {p: shd.sharding_of(x) for p, x in zip(paths, leaves)}

        # microbatch i = the global batch's i-th block of rows; this rank
        # runs its share of the block over the dp axes
        glob = {k: shd.full_value(v) for k, v in batch.items()}
        rows = next(iter(glob.values())).shape[0] // n_micro
        row_axes = shd.row_axes(rows, mesh, pcfg.dp_includes_model)
        idx, count = shd.axes_index(mesh, row_axes)
        group = shd.axes_group(mesh, row_axes) if count > 1 else None
        per = rows // count
        micro = [{k: v[i * rows + idx * per:i * rows + (idx + 1) * per] for k, v in glob.items()}
                 for i in range(n_micro)]
        # each group's weights gathered where the model uses them, their
        # gradients summed over the dp group (and over model for a weight
        # whole there) into this rank's boxes; the model computes along model
        with shd.data_parallel(group, count), \
                shd.model_parallel(shd.model_axis(mesh, pcfg)), \
                shd.activation_rules(pcfg, mesh), \
                shd.gathering(_replace(state.params, shardings), group, row_axes, accum_dtype):
            loss, grads = gradients(state, local, micro)
        if n_micro > 1:
            for a in grads:
                a.div_(n_micro)
            loss = loss / n_micro

        step = shd.local_value(state.step)
        lr = lr_schedule(step)
        gnorm = sharded_update(opt, pcfg, state, grads, step, lr)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        new_step = shd.NamedSharding(mesh, ()).from_local(step + 1, ())
        return TrainState(new_step, state.params, state.opt), metrics

    return train_step
