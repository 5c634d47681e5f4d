"""Serving: batched prefill + decode against a KV cache.

Counterpart of the fixed-batch half of ``repro/serving/engine.py``:
``make_prefill`` / ``make_prefill_chunk`` / ``make_decode_step`` build the
step functions over ``models.forward``, and ``Engine`` drives greedy or
temperature sampling with EOS masking over one rectangular batch.  PyTorch
runs eagerly, so there is no jit: each step calls the forward directly,
under ``torch.inference_mode()``.  The continuous-batching scheduler over
a paged KV cache is ``serving/scheduler.py``.  ``cache_shardings`` places
a cache tree on a mesh, as the reference's does.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import forward, init_cache
from repro_torch.models.frontends import needs_embeds

__all__ = ["make_decode_step", "make_prefill", "make_prefill_chunk", "cache_shardings",
           "Engine"]


def cache_shardings(cfg: ModelConfig, pcfg, mesh, batch: int, max_len: int,
                    stacked: bool = True):
    """NamedSharding tree matching ``init_cache(cfg, batch, max_len,
    stacked)`` (and ``PagePool.view_template()``): k/v (B, S, KV, hd)
    sequence-sharded over ``model``, SSM state (B, nh, hp, ds) head-sharded,
    conv (B, dconv-1, conv_dim) channel-sharded, each where ``model``
    divides, and the batch over the dp axes only when they divide it.
    ``mesh`` may be a mesh shape; ``pcfg`` is unused, as in the reference."""
    from repro_torch.compression.plan import tree_paths, tree_rebuild
    from repro_torch.distributed.sharding import NamedSharding, mesh_shape

    sizes = mesh_shape(mesh)
    dp = tuple(a for a in ("pod", "data") if a in sizes)
    dp_size = 1
    for a in dp:
        dp_size *= sizes[a]
    model = "model" if "model" in sizes else None
    m = sizes.get("model", 1)

    def spec(path, leaf):
        names = path.split("/")
        lead = (None,) if stacked and "groups" in names else ()
        shape = tuple(leaf.shape)
        nd = len(shape) - len(lead)
        b = dp if shape[len(lead)] % max(dp_size, 1) == 0 else None
        if names[-1] in ("k", "v"):
            seq = model if shape[len(lead) + 1] % m == 0 else None
            return (*lead, b, seq, None, None)
        if names[-1] == "state":
            h = model if model and shape[len(lead) + 1] % m == 0 else None
            return (*lead, b, h, None, None)
        if names[-1] == "conv":
            c = model if model and shape[len(lead) + 2] % m == 0 else None
            return (*lead, b, None, c)
        return (*lead, b, *([None] * (nd - 1)))

    shapes = init_cache(cfg, batch, max_len, stacked=stacked, device="meta")
    return tree_rebuild(shapes, {p: NamedSharding(mesh, spec(p, leaf))
                                 for p, leaf in tree_paths(shapes)})


def make_prefill(cfg: ModelConfig):
    """prefill(params, inputs, cache) -> (last_logits (B, V), cache)."""

    def prefill(params, inputs, cache):
        logits, cache, _ = forward(params, inputs, cfg, cache=cache, pos_offset=0,
                                   last_only=True)
        return logits[:, -1], cache

    return prefill


def make_prefill_chunk(cfg: ModelConfig, attend_cache: bool = True):
    """prefill_chunk(params, inputs, cache, pos) -> (logits (B, S, V), cache).

    One chunk of a chunked prefill: the chunk's tokens are written to the
    cache at positions ``pos .. pos+S`` and (with ``attend_cache=True``)
    attend to the full cache.  The first chunk (``pos == 0``) may use
    ``attend_cache=False``, which is then the same as ``make_prefill``."""

    def prefill_chunk(params, inputs, cache, pos):
        logits, cache, _ = forward(params, inputs, cfg, cache=cache, pos_offset=pos,
                                   attend_cache=attend_cache)
        return logits, cache

    return prefill_chunk


def make_decode_step(cfg: ModelConfig):
    """decode_step(params, token (B,) or embed (B, d), cache, pos) ->
    (logits (B, V), cache).  ``pos`` is the index the new token is written
    to: an int for the whole batch or a (B,) tensor of per-row positions."""

    def decode_step(params, tok, cache, pos):
        inputs = {"embeds": tok[:, None, :]} if needs_embeds(cfg) else {"tokens": tok[:, None]}
        logits, cache, _ = forward(params, inputs, cfg, cache=cache, pos_offset=pos)
        return logits[:, 0], cache

    return decode_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Engine:
    """Single-host batched serving loop.

    ``artifact`` is an optional compression manifest (a
    ``repro_torch.compression.CompressionArtifact`` or its raw manifest
    dict).  When given, the params tree is validated against it at
    construction and ``self.compression`` summarises what is served.

    ``use_fused_bitlinear`` controls the kernels:
      None (default)  ``kernels.ops.enable_kernels()`` iff an artifact is
                      present: flash attention (K5) and the fused bitlinear
                      kernel (K3) on CUDA tensors, their plain versions on
                      CPU ones;
      True            enable them unconditionally;
      False           clear the fused bitlinear hook, so compressed layers
                      take the unpack+einsum form.
    The hooks are process-global and read at call time.  An Engine records
    its setting at construction (``self.kernel_hooks``, the hooks the
    choice above gives over those registered then) and leaves the process's
    hooks as it found them: ``self.prefill`` and ``self.decode`` (so
    ``generate`` and a ``Scheduler`` over the Engine) register the
    Engine's hooks for the call and restore the caller's after it
    (``scoped``), as the reference's Engine compiles the hooks of its first
    trace into its jitted steps.  With the kernels enabled, a manifest's
    tuned ``kernel_schedules`` table is installed
    (``kernels.autotune.load_schedules``), so every fused call resolves its
    tuned schedule; ``self.kernel_schedules`` (and
    ``compression["kernel_schedules"]``) counts its entries.
    """

    cfg: ModelConfig
    params: dict
    max_len: int
    batch: int
    temperature: float = 0.0
    eos_id: int = 1
    artifact: object = None
    use_fused_bitlinear: bool | None = None

    def __post_init__(self):
        self.compression = None
        if self.artifact is not None:
            from repro_torch.compression.artifact import CompressionArtifact

            art = (
                self.artifact
                if isinstance(self.artifact, CompressionArtifact)
                else CompressionArtifact(self.artifact)
            )
            problems = art.validate_params(self.params)
            if problems:
                raise ValueError(
                    "params tree does not match the compression manifest:\n  "
                    + "\n  ".join(problems)
                )
            self.artifact = art
            self.compression = _summary(art)

        from repro_torch.core import quantized
        from repro_torch.kernels import ops

        fused = self.use_fused_bitlinear
        if fused is None:
            fused = self.artifact is not None
        self.kernel_schedules = 0
        if fused and self.compression is not None:
            table = self.artifact.manifest.get("kernel_schedules")
            if table:
                from repro_torch.kernels import autotune

                self.kernel_schedules = autotune.load_schedules(table)
                self.compression["kernel_schedules"] = self.kernel_schedules
        with ops.hooks_as(ops.kernel_hooks()):
            if fused:
                ops.enable_kernels()
            elif self.use_fused_bitlinear is False:
                quantized.clear_bitlinear()
            self.kernel_hooks = ops.kernel_hooks()
            self.fused_bitlinear = fused and quantized.has_fused_bitlinear()
        self.prefill = self.scoped(make_prefill(self.cfg))
        self.decode = self.scoped(make_decode_step(self.cfg))
        self.last_timing = None

    def scoped(self, fn):
        """``fn`` run with this Engine's kernel hooks registered, and the
        caller's restored after it."""
        from repro_torch.kernels import ops

        hooks = self.kernel_hooks

        @functools.wraps(fn)
        def run(*args, **kwargs):
            with ops.hooks_as(hooks):
                return fn(*args, **kwargs)

        return run

    @torch.inference_mode()
    def generate(self, prompts: torch.Tensor, steps: int,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        """prompts (B, P) int -> (B, P+steps) greedy/sampled tokens, on the
        prompts' device.

        Sequences that emit ``eos_id`` are finished: their remaining
        positions pad with ``eos_id`` and once every sequence is finished
        the decode loop exits early.  ``self.last_timing`` records the
        prefill (to the first token) and decode wall times, each ending in
        a device synchronisation."""
        B, Plen = prompts.shape
        dev = prompts.device
        t0 = time.perf_counter()
        cache = init_cache(self.cfg, B, self.max_len, device=dev)
        last, cache = self.prefill(self.params, {"tokens": prompts}, cache)
        cur = self._pick(last, generator)
        _sync(dev)
        t1 = time.perf_counter()
        toks = [prompts]
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        decode_steps = 0
        for t in range(steps):
            cur = torch.where(done, self.eos_id, cur).to(prompts.dtype)
            toks.append(cur[:, None])
            done = done | (cur == self.eos_id)
            if t == steps - 1:
                break
            if bool(done.all()):
                toks.append(torch.full((B, steps - 1 - t), self.eos_id, dtype=prompts.dtype,
                                       device=dev))
                break
            logits, cache = self.decode(self.params, cur, cache, Plen + t)
            decode_steps += 1
            cur = self._pick(logits, generator)
        out = torch.cat(toks, dim=1)
        _sync(dev)
        self.last_timing = {"prefill_s": t1 - t0, "decode_s": time.perf_counter() - t1,
                            "decode_steps": decode_steps}
        return out

    def _pick(self, logits, generator):
        if self.temperature <= 0.0 or generator is None:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.to(torch.float32) / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _summary(art) -> dict:
    """What ``Engine.compression`` reports: tensors, ratio, methods and the
    delta / autotune provenance the manifest carries."""
    tensors = art.manifest["tensors"]
    out = {
        "tensors": len(tensors),
        # tensors that keep a group (expert) axis after the layer slice
        "grouped_tensors": sum(
            1 for e in tensors.values() if len(e.get("group_dims", [])) >= 2
        ),
        "ratio": round(art.total_ratio, 3),
        "methods": sorted({e["method"] for e in tensors.values()}),
    }
    delta = art.manifest.get("delta")
    if delta:
        out["delta"] = {
            k: delta.get(k)
            for k in ("parent_fingerprint", "generation", "tiles_resolved", "tiles_reused",
                      "fraction_resolved")
        }
    autotune = art.manifest.get("autotune")
    if autotune:
        out["autotune"] = {
            "budget_bytes": autotune.get("budget_bytes"),
            "engine": autotune.get("engine"),
            "predicted_distortion": autotune.get("predicted_distortion"),
            "calibrated": autotune.get("calibrated", False),
            "objective": autotune.get("objective", "frobenius"),
        }
        ev = autotune.get("eval")
        if ev:
            out["autotune"]["eval"] = {
                k: ev.get(k)
                for k in ("num_batches", "batch", "seq_len", "seed", "baseline_loss",
                          "surrogate_skip_rate")
            }
        lp = autotune.get("lp_check")
        if lp:
            out["autotune"]["lp_check"] = {
                "relative_gap": lp.get("relative_gap"),
                "within_tolerance": lp.get("within_tolerance"),
            }
    return out
