"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is looked up by name in ``BENCHMARK.json``; its configuration file,
its traffic file (``bench/traffic/<traffic>.json``, whose ``kind`` names the
generator ``bench/kinds/<kind>.py``), its limits (``bench/cells/<cell>.json``)
and one reader per metric (``bench/metrics/<metric>.py``) are found by name,
so a new cell, configuration, traffic mix or metric is a new file.

A run sets up (weights from the seed, one warm-up item), measures for
``--seconds`` (items begin while the time is not up), then checks the
outputs against the plain reference and prints, as the last line of
standard output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks`` (each compared number beside its limit).  It needs a CUDA card
and never falls back to the CPU; it refuses to print a result if the JAX
package, JAX or flax was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is JAX's,
    jaxlib's, flax's or the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class ForbiddenModules(RuntimeError):
    pass


def load_file(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


class Spec:
    """``BENCHMARK.json`` and the files it names."""

    def __init__(self, root: str = ROOT):
        self.root = root
        self.bench = read_json(root, "BENCHMARK.json")

    def workload(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return read_json(self.root, c["file"])
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def metrics(self, workload: str, trace: bool) -> list:
        """The metrics a run of ``workload`` reports: its end-to-end ones,
        or with ``trace`` its per-layer ones."""
        e2e = [m for m in self.bench["end_to_end"]
               if workload in m.get("workloads", [workload])]
        if not trace:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.bench["per_layer"]
                if workload in m.get("workloads", [workload] if m["moves"] in names else [])]


class Run:
    """What the readers of ``bench/metrics`` read."""

    def __init__(self, cell, items, setup_s, peak_bytes, trace, ranges):
        self.cell, self.items, self.setup_s, self.peak_bytes = cell, items, setup_s, peak_bytes
        self.trace, self.ranges = trace, ranges


def run_cell(spec: Spec, workload: str, seed: int, seconds: float, trace: bool, device,
             overrides: dict | None = None, traffic_overrides: dict | None = None,
             t_start: float = T_START, after_setup=None) -> dict:
    """Set up, measure and check one cell; returns the result line's dict.
    ``after_setup()`` is called once set-up is done."""
    import torch

    from benchlib.ranges import Ranges
    from benchlib.trace import analyse

    w = spec.workload(workload)
    conf = spec.config(w["config"])
    traffic = dict(read_json(BENCH, "traffic", f"{w['traffic']}.json"),
                   **(traffic_overrides or {}))
    limits = read_json(BENCH, "cells", f"{workload}.json")
    kind = load_file(os.path.join(BENCH, "kinds", f"{traffic['kind']}.py"),
                     f"bench_kind_{traffic['kind']}")
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    cell = kind.Cell(conf, traffic, seed, device, overrides)
    cell.setup()
    sync()
    if after_setup is not None:
        after_setup()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    items, traced, ranges, trace_path = [], [], None, None
    i = 0
    if trace:
        ranges = Ranges()
        n_traced = traffic.get("trace_items", 1)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        ranges.install()
        try:
            with torch.profiler.profile(activities=acts) as prof:
                with torch.profiler.record_function("bench.window"):
                    while i < n_traced:
                        traced.append(cell.run_item(i))
                        i += 1
                    sync()
        finally:
            ranges.uninstall()
        fd, trace_path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        prof.export_chrome_trace(trace_path)
        del prof
    while time.perf_counter() - t0 < seconds:
        items.append(cell.run_item(i))
        i += 1
    sync()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    tr = None
    if trace_path is not None:
        try:
            tr = analyse(trace_path)
        finally:
            os.remove(trace_path)
    run = Run(cell, items or traced, setup_s, peak, tr, ranges)
    metrics = {}
    for m in spec.metrics(workload, trace):
        reader = load_file(os.path.join(BENCH, "metrics", f"{m['name']}.py"),
                           f"bench_metric_{m['name'].replace('.', '_')}")
        v = reader.read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    cell.free()
    if cuda:
        torch.cuda.empty_cache()
    found = cell.check(items + traced)
    checks = {k: {"value": found[k], "limit": lim} for k, lim in limits["limits"].items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": correct, "attempted": cell.attempted(items + traced), "failed": 0,
           "metrics": metrics, "device": device_info(torch, device, peak, tr)}
    if tr is not None:
        out["breakdown"] = tr["breakdown"]
    out["reported"] = dict({k: v for k, v in found.items() if k not in checks},
                           setup_phases=getattr(cell, "setup_phases", {}),
                           item_s=[it["end"] - it["start"] for it in items])
    out["checks"] = checks
    return out


def device_info(torch, device, peak: int, tr) -> dict:
    if torch.device(device).type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
                "memory_peak_bytes": int(peak)}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    if tr is not None:
        info["busy_s"] = tr["busy_s"]
        info["window_s"] = tr["window_s"]
    return info


def smi(fields: str = "name,power.limit") -> str:
    """The card's readings by ``nvidia-smi``: its name and power limit, or
    the fields asked for."""
    try:
        return subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [BENCH, os.path.join(ROOT, "src")]
    try:
        spec = Spec()
        w = spec.workload(args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    import torch

    t_torch = time.perf_counter() - T_START
    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        print(f"bench: the cell needs {w['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"bench: the program under test is missing: {e}", file=sys.stderr)
        return 5
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.zeros(1, device="cuda")
    print(f"bench: {args.workload} seed {args.seed} on {smi()}; torch imported at "
          f"{t_torch:.2f} s, the program and the device context ready at "
          f"{time.perf_counter() - T_START:.2f} s", file=sys.stderr)

    def guard():
        bad = forbidden_modules()
        if bad:
            raise ForbiddenModules(bad)

    try:
        out = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                       after_setup=guard)
        guard()
    except ForbiddenModules as e:
        print(f"bench: forbidden modules loaded: {e.args[0]}", file=sys.stderr)
        return 4
    out["reported"]["card_after"] = smi("clocks.sm,clocks.mem,temperature.gpu,power.draw")
    print(f"bench: reported {json.dumps(out['reported'])}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
