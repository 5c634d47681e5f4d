"""Whole-model compression passes: ``execute_plan`` over every tensor the
policy compresses, one pass after another.

Pass i compresses dense weights drawn on the device from (seed, i), in one
draw, between passes and off the clock, so no pass replays an earlier one.
Each pass's wall time ends in a device synchronisation.  After each pass,
off the clock, the benchmark measures the stored artifact's residual
``||W - M C||`` (C as cast) against ``||W||``; after the window the
reference judges a sample of the last pass's tiles, M and C both.

Traffic parameters: ``policy`` (the compression policy as its JSON dict)
and ``check`` (tiles of the last pass the reference judges).
"""

from __future__ import annotations

import math
import time

import torch

from benchlib import port, weights
from reference import compress as ref
from reference.common import dense, leaf, unpack_signs
from work import counts

WARMUP = -1


class Cell:
    def __init__(self, conf: dict, traffic: dict, seed: int, device,
                 overrides: dict | None = None):
        self.conf, self.traffic, self.seed = conf, traffic, seed
        self.device = torch.device(device)
        self.cfg, self.sizes = port.model_config(conf, overrides)
        self.last = None

    def setup(self) -> None:
        clock = port.Phases(self.device)
        self.layout = port.layout(self.cfg)
        self.plan = port.plan(self.cfg, self.traffic["policy"])
        self.dtype = self.layout[self.plan.tensors[0].path][1]
        self.params = sum(math.prod(t.shape) for t in self.plan.tensors)
        clock("layout_and_plan")
        self.run_item(WARMUP)
        clock("warmup_pass")
        self.setup_phases = clock.seconds

    def draw(self, i: int) -> dict:
        g = weights.generator(self.device, self.seed, 0xD0, i)
        buf = torch.randn(self.params, generator=g, device=self.device, dtype=self.dtype)
        values, at = {}, 0
        for t in self.plan.tensors:
            n = math.prod(t.shape)
            w = buf[at:at + n].view(t.shape).mul_(weights.TRUNC_STD / math.sqrt(t.shape[-2]))
            weights.put(values, t.path, w)
            at += n
        return values

    def run_item(self, i: int) -> dict:
        from repro_torch.compression import execute_plan

        self.last = None
        values = self.draw(i)
        self._sync()
        t0 = time.perf_counter()
        new, _ = execute_plan(self.plan, values, seed=self.seed, device=self.device)
        self._sync()
        t1 = time.perf_counter()
        err, norm = self.residual(values, new)
        self.last = (values, new)
        return {"index": i, "params": self.params, "seconds": t1 - t0, "start": t0, "end": t1,
                "sq_err": err, "sq_norm": norm}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def residual(self, values: dict, new: dict, block: int = 64) -> tuple:
        """Squared ||W - M C|| and ||W|| over every compressed tensor, a
        block of leading slices at a time, summed on the device."""
        err = torch.zeros((), dtype=torch.float64, device=self.device)
        norm = torch.zeros_like(err)
        for t in self.plan.tensors:
            W, w = leaf(values, t.path), leaf(new, t.path)
            W2 = W.reshape(-1, *W.shape[-2:])
            mp = w["m_packed"].reshape(-1, *w["m_packed"].shape[-4:])
            C = w["C"].reshape(-1, *w["C"].shape[-4:])
            for s in range(0, W2.shape[0], block):
                Ws = W2[s:s + block].float()
                d = Ws - dense({"m_packed": mp[s:s + block], "C": C[s:s + block]})
                err += (d * d).sum(dtype=torch.float64)
                norm += (Ws * Ws).sum(dtype=torch.float64)
        return float(err), float(norm)

    def pass_ops(self) -> int:
        return counts.compress_pass_ops([(t.num_tiles, t.tile_n, t.K, t.tile_d, t.method,
                                          t.bbo_iters) for t in self.plan.tensors])

    def attempted(self, items: list) -> int:
        return len(items)

    def free(self) -> None:
        """Nothing of the program's state outlives a pass but its output."""

    def check(self, items: list, control: str | None = None) -> dict:
        """Tiles of the last pass, drawn from the seed in each pool's share,
        judged by the reference (``reference/compress.py``): ``c_excess``, the
        stored C's excess residual over the float64 least-squares C for the
        program's M, pooled, over that of C* as stored; ``m_mismatch``, the
        share of the tiles whose M is not the one the compression's equations
        give in float64 from the same restarts; and, reported beside them,
        ``m_excess``, the program's pooled residual over the reference's, less
        1.  With ``control`` ("bf16") also the same numbers with the
        reference computed in bfloat16 in the program's place (returned as
        ``{"program": ..., "control": ...}``)."""
        values, new = self.last
        pools = {}
        for t in self.plan.tensors:
            pools.setdefault(t.method, []).append(t)
        order = ref.leaf_indices(self.layout)
        g = weights.generator("cpu", self.seed, 0xC5)
        whos = ("program", "control") if control is not None else ("program",)
        sums = {w: {"c": [0.0, 0.0], "m_diff": 0, "r": 0.0, "r_ref": 0.0} for w in whos}
        n_all = 0
        for method, members in pools.items():
            if method != "alternating":
                raise ValueError(f"the reference judges alternating pools, not {method!r}")
            total = sum(t.num_tiles for t in members)
            for t in members:
                k = max(1, round(self.traffic["check"] * t.num_tiles / total))
                idx = torch.randperm(t.num_tiles, generator=g)[:k].sort().values.to(self.device)
                w = leaf(new, t.path)
                W = ref.tiles(leaf(values, t.path), t.tile_n, t.tile_d)[idx]
                mp = w["m_packed"].reshape(-1, t.tile_n, w["m_packed"].shape[-1])[idx]
                C = w["C"].reshape(-1, t.K, t.tile_d)[idx]
                signs = self.restarts(t, idx, order[t.path])
                M_ref = ref.decompose(W, signs)
                r_ref = ref.residual(M_ref, W)
                for who in whos:
                    if who == "program":
                        M, c = unpack_signs(mp, t.K), C
                    else:
                        M = ref.decompose(W, signs, dtype=torch.bfloat16)
                        c = ref.control_c(M, W).to(C.dtype)
                        mp = _pack(M)
                    s = sums[who]
                    a, b = ref.c_excess(mp, c, W)
                    s["c"][0] += a
                    s["c"][1] += b
                    s["m_diff"] += int((M.double() != M_ref).flatten(1).any(1).sum())
                    s["r"] += float(ref.residual(M, W).sum())
                    s["r_ref"] += float(r_ref.sum())
                n_all += k
        out = {who: {"c_excess": s["c"][0] / s["c"][1], "m_mismatch": s["m_diff"] / n_all,
                     "m_excess": s["r"] / s["r_ref"] - 1.0, "tiles": n_all}
               for who, s in sums.items()}
        return out if control is not None else out["program"]

    def restarts(self, t, idx: torch.Tensor, leaf_index: int) -> torch.Tensor:
        """The greedy restarts of tiles ``idx`` of tensor ``t`` by the seed
        rule: one draw per group slice of (seed, leaf index, slice)."""
        per = t.num_tiles // t.groups
        out = torch.empty((idx.numel(), t.K, ref.RESTARTS, t.tile_n), dtype=torch.float64,
                          device=self.device)
        for s in idx.div(per, rounding_mode="floor").unique().tolist():
            rows = (idx // per) == s
            out[rows] = ref.restart_signs(self.device, per, t.K, t.tile_n, self.seed,
                                          leaf_index, s)[idx[rows] - s * per]
        return out


def _pack(M: torch.Tensor) -> torch.Tensor:
    """±1 (..., K) -> uint8 (..., ceil(K / 8)), bit j of byte b for column
    8 b + j set where +1."""
    K = M.shape[-1]
    bits = torch.nn.functional.pad((M > 0).to(torch.uint8), (0, (-K) % 8))
    bits = bits.reshape(*M.shape[:-1], -1, 8)
    return (bits << torch.arange(8, device=M.device, dtype=torch.uint8)).sum(-1).to(torch.uint8)
