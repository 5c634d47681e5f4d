"""Readings for a cell's limits: the program's and the control's, over seeds.

    python3 bench/prove.py --workload <name> --seeds 11,12,13 [--items N]
        [--control fp8|bf16]

For each seed, in one process: the cell's set-up, N items of its timed
path, then its check (the program's numbers), and with ``--control`` the
same check with the control in the program's place (the reference computed
in the lower precision).  One JSON line per seed on standard output.  The
limits in ``bench/cells/<cell>.json`` are set from these readings: above
the program's largest, below the control's smallest.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--items", type=int, default=2)
    ap.add_argument("--control", default="fp8",
                    help="the lower precision of the control: fp8 for the served models, bf16 "
                         "for compression")
    args = ap.parse_args(argv)
    sys.path[:0] = [BENCH, os.path.join(ROOT, "src")]
    import torch

    if not torch.cuda.is_available():
        print("prove: no CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import run as bench_run

    spec = bench_run.Spec()
    w = spec.workload(args.workload)
    conf = spec.config(w["config"])
    traffic = bench_run.read_json(BENCH, "traffic", f"{w['traffic']}.json")
    kind = bench_run.load_file(os.path.join(BENCH, "kinds", f"{traffic['kind']}.py"), "kind")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        cell = kind.Cell(conf, traffic, seed, "cuda")
        cell.setup()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        items = [cell.run_item(i) for i in range(args.items)]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        cell.free()
        torch.cuda.empty_cache()
        line = {"workload": args.workload, "seed": seed, "setup_s": t1 - t0,
                "items_s": t2 - t1, "setup_phases": getattr(cell, "setup_phases", {})}
        line.update(cell.check(items, control=args.control))
        line["check_s"] = time.perf_counter() - t2
        del cell, items
        torch.cuda.empty_cache()
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
