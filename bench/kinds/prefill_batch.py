"""Offline batches: B prompts of P tokens, then G greedy tokens each.

One batch after another through ``Engine.generate``.  The weights are
compressed ones drawn from the seed in the plan's shapes (no compression
runs); the prompts of batch i are drawn from (seed, i).  The end-of-sequence
id is the vocabulary size, which is never emitted, so every batch does the
same work.

Traffic parameters: ``batch``, ``prompt``, ``generate``, ``policy`` (the
compression policy whose plan gives the served shapes) and ``check`` (how
many finished requests the reference judges).
"""

from __future__ import annotations

import importlib
import time

import torch

from benchlib import port, weights
from reference.common import Precision
from work import counts

WARMUP = -1          # the batch index set-up runs


class Cell:
    def __init__(self, conf: dict, traffic: dict, seed: int, device,
                 overrides: dict | None = None):
        self.conf, self.traffic, self.seed = conf, traffic, seed
        self.device = torch.device(device)
        self.cfg, self.sizes = port.model_config(conf, overrides)
        self.B, self.P, self.G = traffic["batch"], traffic["prompt"], traffic["generate"]
        self.V = self.sizes["vocab_size"]
        # the configuration's reference and work count, found by its name
        self.reference = importlib.import_module(f"reference.{conf['reference']}")
        self.work = importlib.import_module(f"work.{conf['reference']}")

    # ---- set-up -----------------------------------------------------------
    def setup(self) -> None:
        from repro_torch.serving import Engine

        clock = port.Phases(self.device)
        lay = port.layout(self.cfg)
        self.plan = port.plan(self.cfg, self.traffic["policy"])
        clock("layout_and_plan")
        comp = {t.path: (t.K, t.tile_n, t.tile_d) for t in self.plan.tensors}
        self.params = weights.make(lay, comp, self.seed, self.device)
        clock("weights")
        self.engine = Engine(self.cfg, self.params, max_len=self.P + self.G, batch=self.B,
                             eos_id=self.V, use_fused_bitlinear=True)
        clock("engine")
        self.run_item(WARMUP)
        clock("warmup_batch")
        self.setup_phases = clock.seconds

    def prompts(self, i: int) -> torch.Tensor:
        g = weights.generator(self.device, self.seed, 0x5E, i)
        return torch.randint(0, self.V, (self.B, self.P), generator=g, device=self.device)

    # ---- the window -------------------------------------------------------
    def run_item(self, i: int) -> dict:
        t0 = time.perf_counter()
        out = self.engine.generate(self.prompts(i), self.G)
        t1 = time.perf_counter()
        timing = self.engine.last_timing
        return {"index": i, "start": t0, "end": t1, "tokens": self.B * (self.P + self.G),
                "served": out[:, self.P:], "prefill_s": timing["prefill_s"],
                "decode_s": timing["decode_s"], "decode_steps": timing["decode_steps"]}

    def attempted(self, items: list) -> int:
        return self.B * len(items)

    def prefill_ops(self) -> int:
        geo = {counts.role(t.path): (t.tile_n, t.K, t.tile_d) for t in self.plan.tensors}
        return self.work.prefill_ops(self.sizes, geo, self.B, self.P)

    def free(self) -> None:
        """Drop the program's state; the weights stay (the reference's inputs)."""
        self.engine = None

    # ---- correctness ------------------------------------------------------
    def check(self, items: list, control: str | None = None) -> dict:
        """The gaps by which the served tokens' logits lie below the best
        logit of the reference, over a sample (drawn from the seed) of the
        finished requests: the widest (``served_gap``), the mean over the
        sampled tokens (``mean_gap``) and how many are off the reference's
        best.  With ``control`` (a lower precision, "fp8") also the same
        numbers of the control: the reference in that precision, whose own
        picks at the same positions stand in place of the served tokens
        (returned as ``{"program": ..., "control": ...}``)."""
        n = min(self.traffic["check"], self.B * len(items))
        g = weights.generator("cpu", self.seed, 0xC4)
        picks = torch.randperm(self.B * len(items), generator=g)[:n].tolist()
        model = self.reference.logits
        positions = list(range(self.P - 1, self.P + self.G - 1))
        block = self.traffic.get("check_block", 8)
        gaps, low_gaps = [], []
        for a in range(0, n, block):
            toks, served = [], []
            for r in picks[a:a + block]:
                item = items[r // self.B]
                served.append(item["served"][r % self.B])
                toks.append(torch.cat([self.prompts(item["index"])[r % self.B], served[-1]]))
            toks, served = torch.stack(toks)[:, :-1], torch.stack(served)
            logits = model(self.sizes, self.params, toks, self.P, positions, Precision())
            gaps.append(_gaps(logits, served))
            if control is not None:
                low = model(self.sizes, self.params, toks, self.P, positions,
                            Precision(control))
                low_gaps.append(_gaps(logits, low.argmax(-1)))
                del low
            del logits
        if control is None:
            return _summary(torch.cat(gaps), n)
        return {"program": _summary(torch.cat(gaps), n),
                "control": _summary(torch.cat(low_gaps), n)}


def _gaps(logits: torch.Tensor, picked: torch.Tensor) -> torch.Tensor:
    best = logits.max(-1).values
    return (best - logits.gather(-1, picked[..., None].to(logits.device).long())[..., 0]).cpu()


def _summary(gaps: torch.Tensor, n: int) -> dict:
    return {"served_gap": float(gaps.max()), "mean_gap": float(gaps.mean()),
            "requests": n, "tokens": gaps.numel(), "off_best": int((gaps > 0).sum()),
            "gap_by_position": [float(x) for x in gaps.max(0).values]}
