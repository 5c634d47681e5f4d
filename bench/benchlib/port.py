"""The program under test: its configuration, parameter layout and plan.

Everything the benchmark takes from the program passes through here: the
model configuration (checked against the benchmark's configuration file),
the parameter tree's layout on the ``meta`` device, and the compression
plan's tile geometry.  No value is taken from the program.
"""

from __future__ import annotations

import dataclasses
import time


def model_config(conf: dict, overrides: dict | None = None):
    """The program's ModelConfig for ``conf`` (a configuration file), after
    checking that each size the file states is the one the program runs.
    ``overrides`` (file key -> value) shrink a configuration for the CPU
    tests only."""
    from repro_torch.configs import get_config

    port = conf["port"]
    cfg = get_config(port["arch"])
    sizes = dict(conf["model"], **(overrides or {}))
    if overrides:
        cfg = dataclasses.replace(cfg, **{port["keys"][k]: _as(cfg, port["keys"][k], v)
                                          for k, v in overrides.items()})
    wrong = {k: (v, getattr(cfg, port["keys"][k])) for k, v in sizes.items()
             if k in port["keys"] and _as(cfg, port["keys"][k], v) != getattr(cfg, port["keys"][k])}
    if wrong:
        raise ValueError(f"the program's {port['arch']} differs from {conf['name']}: {wrong}")
    return cfg, sizes


def _as(cfg, field: str, v):
    cur = getattr(cfg, field)
    return tuple(v) if isinstance(cur, tuple) else v


def layout(cfg) -> dict:
    """path -> (shape, dtype) of the program's parameter tree."""
    from repro_torch.models import init_model
    from repro_torch.models.params import split

    from benchlib.weights import paths

    values, _ = split(init_model(cfg, seed=0, device="meta"))
    return {p: (tuple(v.shape), v.dtype) for p, v in paths(values)}


def plan(cfg, policy: dict):
    """The program's compression plan of ``cfg``'s parameters under a
    policy given as its JSON dict."""
    from repro_torch.compression import CompressionPolicy, plan_compression
    from repro_torch.models import init_model
    from repro_torch.models.params import split

    values, _ = split(init_model(cfg, seed=0, device="meta"))
    return plan_compression(values, CompressionPolicy.from_dict(policy))


class Phases:
    """Seconds of each named phase of a set-up, each ending in a device
    synchronisation: ``clock("name")`` closes the phase begun at the last
    call."""

    def __init__(self, device):
        import torch

        self._sync = (lambda: torch.cuda.synchronize(device)) \
            if torch.device(device).type == "cuda" else (lambda: None)
        self.seconds = {}
        self._t = time.perf_counter()

    def __call__(self, name: str) -> None:
        self._sync()
        t = time.perf_counter()
        self.seconds[name] = t - self._t
        self._t = t
