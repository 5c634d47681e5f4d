"""Roofline terms of a step on one NVIDIA H100, counted from what it dispatches.

Counterpart of ``repro/roofline.py``.  The reference reads XLA's compiled
SPMD program (``memory_analysis``, ``cost_analysis``, the collectives in the
HLO text) against a TPU v5e's figures.  PyTorch compiles no SPMD program, so
the port runs the step itself, eagerly, as one rank of its mesh (on fake
tensors and a fake process group for a mesh larger than the machine:
``launch/dryrun.py``), under :class:`CostCounter`, a ``TorchDispatchMode``
that records what every dispatched op costs.  ``cost_summary``,
``memory_summary`` and ``collective_bytes`` read that record into the
reference's dict shapes.

The card (NVIDIA H100 SXM5 80GB at its 700 W power limit; NVIDIA's
datasheet figures, dense, without sparsity):

    peak bf16 compute (tensor cores)   989 TFLOP/s     PEAK_FLOPS
    peak f32 compute (no tensor cores)  67 TFLOP/s     PEAK_F32_FLOPS
    HBM3 bandwidth                    3.35 TB/s        HBM_BW
    NVLink 4, all 18 links             450 GB/s        ICI_BW
                                       each direction (900 GB/s both ways)

``HBM_BYTES`` is the device memory ``torch.cuda.get_device_properties(0)
.total_memory`` reported on an NVIDIA H100 80GB HBM3 at a 700 W power
limit (``chip_smoke.py`` phase 13 prints it beside the card's name).

Terms per step, all per rank:

    compute_s    = FLOPs / PEAK_FLOPS
    memory_s     = bytes accessed / HBM_BW
    collective_s = collective bytes / (ICI_BW x links)

Every op is counted as it runs, so loop bodies count once per trip (no
scan is counted once, unlike XLA's cost model); what costs a full-width
step too long to trace is composed from parts (``launch/costing.py``).
"""

from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

__all__ = [
    "PEAK_FLOPS",
    "PEAK_F32_FLOPS",
    "HBM_BW",
    "ICI_BW",
    "HBM_BYTES",
    "CostCounter",
    "tree_bytes",
    "memory_summary",
    "cost_summary",
    "collective_bytes",
    "analytic_memory_bytes",
    "roofline_terms",
]

PEAK_FLOPS = 989e12      # bf16 FLOP/s, tensor cores, dense (H100 SXM5 datasheet, 700 W)
PEAK_F32_FLOPS = 67e12   # f32 FLOP/s outside the tensor cores (datasheet)
HBM_BW = 3.35e12         # bytes/s of HBM3 (datasheet)
ICI_BW = 450e9           # bytes/s of NVLink 4, all links, one direction (datasheet)
# total_memory of an NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py phase 13)
HBM_BYTES = 85_017_493_504

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")

# op name (overload packet) -> collective kind, for both namespaces: the
# process-group ops ``c10d.*`` that torch.distributed's calls dispatch, and
# the functional ``_c10d_functional.*`` ones DTensor's redistributions use
# (their ``wait_tensor`` carries no traffic and is not counted)
_KIND = {
    "allreduce_": "all-reduce", "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "broadcast_": "collective-permute", "broadcast": "collective-permute",
}

# elementwise ops whose every output element costs a transcendental (the
# reference's "transcendentals"), and those that cost one FLOP
_TRANSCENDENTAL = {
    "exp", "exp2", "expm1", "log", "log1p", "log2", "log10", "tanh", "sigmoid", "sin",
    "cos", "rsqrt", "sqrt", "erf", "erfc", "pow", "softplus", "silu", "gelu", "_softmax",
    "_log_softmax", "logsumexp", "sigmoid_backward", "tanh_backward", "silu_backward",
    "gelu_backward", "softplus_backward", "_softmax_backward_data",
    "_log_softmax_backward_data",
}
_ELEMENTWISE = {
    "add", "sub", "mul", "div", "neg", "abs", "maximum", "minimum", "clamp", "clamp_min",
    "clamp_max", "where", "reciprocal", "square", "rsub", "masked_fill", "lerp", "addcmul",
    "addcdiv", "gt", "lt", "ge", "le", "eq", "ne", "logical_and", "logical_or",
    "logical_not", "bitwise_and", "bitwise_or", "bitwise_xor", "sign", "floor", "ceil",
    "round", "remainder", "fmod", "threshold_backward", "relu", "isfinite", "isinf", "isnan",
}
_REDUCTION = {"sum", "mean", "amax", "amin", "max", "min", "var", "var_mean", "norm",
              "linalg_vector_norm", "cumsum", "cumprod", "prod", "argmax", "argmin", "any",
              "all", "topk", "sort", "std"}
# factories write nothing worth counting (their tensors count as memory);
# metadata ops touch no data
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
             "device", "dim", "size", "stride", "sym_size", "sym_stride", "sym_numel",
             "is_same_size", "_local_scalar_dense", "wait_tensor", "_has_compatible_shallow_copy_type"}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class CostCounter(TorchDispatchMode):
    """A dispatch mode (entered with ``with``) that counts, per op
    the step dispatches on this rank:

    * ``dot_flops``: matrix products as ``torch.utils.flop_counter`` reckons
      them (2 x M x N x K for every mm, bmm, addmm, baddbmm, convolution);
    * ``elementwise_flops``: one per output element of arithmetic ops, one
      per input element of reductions; ``transcendentals``: one per output
      element of exp, log, tanh, rsqrt, softmax and their kin;
    * ``bytes``: every input read and every output written, op by op, with
      no fusion (views and factories move nothing): an upper bound on the
      HBM traffic, as the reference says of XLA-CPU's bytes
      (``benchmarks/roofline.py``);
    * ``coll``/``coll_counts``: per collective kind, the bytes of its
      result (the gathered buffer of an all-gather, the scattered one of a
      reduce-scatter, the buffer of an all-reduce), as the reference counts
      result shapes in the HLO;
    * ``peak_bytes``: the most bytes of tensors made inside the mode and
      alive at once (a tensor is freed when Python drops it; a view keeps
      its base alive), and ``live_bytes`` at the end.

    ``extra(flops=, bytes=)`` adds the cost of work the mode cannot see (a
    kernel's products, launched through ``ctypes``: ``launch/costing.py``'s
    adapters).
    """

    def __init__(self):
        super().__init__()
        self.dot_flops = 0
        self.elementwise_flops = 0
        self.transcendentals = 0
        self.bytes = 0
        self.coll = {k: 0 for k in _COLLECTIVES}
        self.coll_counts = {k: 0 for k in _COLLECTIVES}
        self.ops = 0
        self.live_bytes = 0
        self.peak_bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    def extra(self, *, flops: float, bytes: float) -> None:
        self.dot_flops += flops
        self.bytes += bytes

    def _free(self, n: int) -> None:
        self.live_bytes -= n

    def _count(self, func, args, kwargs, out) -> None:
        self.ops += 1
        ns = func.namespace
        name = func.overloadpacket.__name__ if hasattr(func, "overloadpacket") else str(func)
        if ns in ("c10d", "_c10d_functional"):
            kind = _KIND.get(name)
            if kind is not None:
                # a c10d op's first argument is its result buffer(s) (the
                # output of a gather or scatter); a functional op returns it
                res = args[0] if ns == "c10d" else out
                self.coll[kind] += sum(_nbytes(t) for t in _tensors(res))
                self.coll_counts[kind] += 1
            return
        packet = getattr(func, "overloadpacket", None)
        if packet in flop_registry:
            self.dot_flops += flop_registry[packet](*args, **kwargs, out_val=out)
        base = name.rstrip("_")
        outs = list(_tensors(out))
        if base in _TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in outs)
        elif base in _ELEMENTWISE:
            self.elementwise_flops += sum(t.numel() for t in outs)
        elif base in _REDUCTION:
            self.elementwise_flops += sum(t.numel() for t in _tensors(args))
        if getattr(func, "is_view", False):
            return
        ins = list(_tensors(args)) + list(_tensors(kwargs))
        if base not in _NO_BYTES:
            self.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        # memory: tensors this op made (not an argument written in place)
        seen = {id(t) for t in ins}
        for t in outs:
            if id(t) in seen:
                continue
            n = _nbytes(t)
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(t, self._free, n)

    def record(self) -> dict:
        return {"dot_flops": self.dot_flops, "elementwise_flops": self.elementwise_flops,
                "transcendentals": self.transcendentals, "bytes": self.bytes,
                "coll": dict(self.coll), "coll_counts": dict(self.coll_counts),
                "peak_bytes": self.peak_bytes, "ops": self.ops}


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a tree (a DTensor counts its local shard)."""
    from torch.distributed.tensor import DTensor

    return sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t) for t in _tensors(tree))


def memory_summary(argument_bytes: int, output_bytes: int, temp_bytes: int,
                   alias_bytes: int) -> dict:
    """The reference's dict: ``argument_bytes`` the rank's boxes of every
    argument, ``output_bytes`` of every result, ``alias_bytes`` the results
    that are arguments updated in place (the port's counterpart of donated
    buffers), ``temp_bytes`` the peak of tensors made during the step beyond
    them; donated buffers are counted once."""
    return {
        "argument_bytes": argument_bytes,
        "output_bytes": output_bytes,
        "temp_bytes": temp_bytes,
        "alias_bytes": alias_bytes,
        "per_device_total": argument_bytes + output_bytes + temp_bytes - alias_bytes,
    }


def cost_summary(record: dict) -> dict:
    """``flops`` (matrix products plus elementwise arithmetic),
    ``dot_flops`` apart, ``bytes`` accessed and ``transcendentals`` of a
    :class:`CostCounter` record.  XLA counts after fusion; these are op by
    op, so ``bytes`` is an upper bound and the FLOPs are exact."""
    return {
        "flops": float(record["dot_flops"] + record["elementwise_flops"]),
        "dot_flops": float(record["dot_flops"]),
        "bytes": float(record["bytes"]),
        "transcendentals": float(record["transcendentals"]),
    }


def collective_bytes(record: dict) -> dict:
    """Result bytes of every collective the rank issued, by kind, with
    ``total`` and ``counts``: the reference's dict."""
    out = {k: float(record["coll"][k]) for k in _COLLECTIVES}
    out["total"] = sum(out[k] for k in _COLLECTIVES)
    out["counts"] = dict(record["coll_counts"])
    return out


def analytic_memory_bytes(cfg, shape, pcfg, chips: int = 256) -> float:
    """First-principles per-device HBM traffic per step (napkin model):
    the reference's, line for line.

    train:  micro * (3 x gathered-weights + activation stream) + optimiser
    serve:  local weight shards + KV/SSM cache traffic + activations
    """
    p_bytes = cfg.param_count() * 2  # bf16
    mesh_model = 1
    for ax, dim in zip(pcfg.mesh_axes, pcfg.mesh_shape):
        if ax == "model":
            mesh_model = dim
    dp = chips // mesh_model

    d = cfg.d_model
    micro = max(pcfg.microbatches, 1)
    B_loc = max(shape.global_batch // (dp * micro), 1) if shape.kind == "train" \
        else max(shape.global_batch // dp, 1)
    S = 1 if shape.kind == "decode" else shape.seq_len
    # activation stream: ~8 residual-width tensors per layer, fwd(+remat+bwd)
    act_layer = B_loc * S * d * 2 / (mesh_model if not pcfg.dp_includes_model else 1)
    passes = 3 if shape.kind == "train" else 1
    act = 8 * act_layer * cfg.num_layers * passes

    if shape.kind == "train":
        # FSDP gather: each device streams the model-shard of every param
        # 3x per microbatch (fwd, remat re-fwd, bwd)
        w_gathered = p_bytes / (mesh_model if not pcfg.dp_includes_model else 1)
        opt = (2 + 2 + 4 + 4 + 4) * cfg.param_count() / chips  # p,g,m,v r/w
        return micro * (3.0 * w_gathered + act) + opt

    w_local = p_bytes / chips
    cache = 0.0
    hd, KV = cfg.resolved_head_dim, cfg.num_kv_heads
    n_attn = sum(
        1 for k in cfg.block_pattern * cfg.num_groups + cfg.remainder_pattern
        if k in ("attn", "attn_moe")
    ) + (cfg.num_groups if cfg.shared_attn else 0)
    if n_attn:
        seq_span = min(shape.seq_len, cfg.sliding_window or shape.seq_len)
        per_seq = seq_span * KV * hd * 2 * 2  # k+v bf16
        cache = n_attn * per_seq * max(shape.global_batch // chips, B_loc / mesh_model)
    n_ssm = sum(
        1 for k in cfg.block_pattern * cfg.num_groups + cfg.remainder_pattern
        if k in ("ssm", "ssm_attn")
    )
    if n_ssm:
        state = cfg.ssm_nheads * cfg.ssm_headdim * cfg.ssm_state * 4
        cache += n_ssm * state * 2 * max(shape.global_batch // chips, 1)
    return w_local + cache + act


def roofline_terms(flops: float, bytes_accessed: float, coll_bytes: float,
                   ici_links: int = 1) -> dict:
    """Seconds per step by each roofline ceiling, per rank.  ``ICI_BW`` is
    already all of the card's NVLink links, so ``ici_links`` defaults to 1
    (the reference's 4 counts a v5e chip's separate links)."""
    compute_s = flops / PEAK_FLOPS
    memory_s = bytes_accessed / HBM_BW
    collective_s = coll_bytes / (ICI_BW * ici_links)
    dominant = max(
        ("compute", compute_s), ("memory", memory_s), ("collective", collective_s),
        key=lambda kv: kv[1],
    )[0]
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
        "bound_s": max(compute_s, memory_s, collective_s),
    }
