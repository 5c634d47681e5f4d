#!/usr/bin/env python3
"""``chip_smoke.py``'s qwen3-32b serve (phase 4) of an earlier commit against
this tree's, on one GPU.

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 tools/torch_serve_ab.py --parent build/parent [--pairs 5] [--serves 3]

Builds both trees' kernels (each tree's ``repro_torch.kernels._build``, into
its own ``build/kernels/``, the two at once), then runs ``2 x pairs``
processes, alternating which side goes first in each pair (earlier, this,
this, earlier, ...).  Each process imports its tree's ``chip_smoke.py`` and
``repro_torch``, compresses the full-width qwen3-32b block (phase 3:
``phase_compress``) and serves it ``serves`` times (phase 4:
``phase_generate``, with its own checks of launches and logits).  The first
serve of a process carries its warm-up (the libraries' first launches), so
``decode_ms`` takes the serves after it.  Host-clock numbers: the serve's
decode is host-bound, so this compares the two trees' host paths too.

Prints the card, one JSON line per serve (``serve`` lines), and a
``summary`` line: for each side the decode ms per step of its later serves
(each, and median), of its first serves, the compression's ``wall_s``
(compress_model alone) and the median time to first token; per pair which
side's median decode step was faster.  Needs one CUDA card and nvcc;
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(root: str, serves: int) -> int:
    """Phases 3 and 4 of ``root``'s chip_smoke.py; a ``serve`` line each."""
    sys.path.insert(0, root)
    sys.path.insert(0, os.path.join(root, "src"))
    import torch

    import chip_smoke as cs

    if os.path.dirname(os.path.abspath(cs.__file__)) != root:
        raise RuntimeError(f"imported {cs.__file__}, not {root}'s chip_smoke.py")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    seen = {}
    emit = cs.emit

    def keep(obj):
        seen.update(obj)
        emit(obj)

    cs.emit = keep
    out_dir = os.path.join(root, "build", "serve_ab_ckpt")
    cs.phase_compress(torch, dev, out_dir)
    for i in range(serves):
        gen = cs.phase_generate(torch, dev, out_dir)
        print("serve " + json.dumps({"root": root, "serve": i,
                                     "compress_wall_s": seen["compress"]["wall_s"],
                                     "decode_ms_per_step": gen["decode_ms_per_step"],
                                     "ttft_median_s": gen["ttft_median_s"],
                                     "launches": gen["launches"]}), flush=True)
    return 0


def build(root: str) -> subprocess.Popen:
    code = "from repro_torch.kernels import _build; _build.build_all()"
    return subprocess.Popen([sys.executable, "-c", code], cwd=root,
                            env={**os.environ, "PYTHONPATH": os.path.join(root, "src")},
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def run(root: str, serves: int) -> list[dict]:
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root,
                           "--serves", str(serves)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"serve of {root} failed:\n{(proc.stdout + proc.stderr)[-4000:]}")
    rows = [json.loads(ln[6:]) for ln in proc.stdout.splitlines() if ln.startswith("serve ")]
    for r in rows:
        print("serve " + json.dumps(r), flush=True)
    return rows


def side(rows: list[dict]) -> dict:
    later = [r["decode_ms_per_step"] for r in rows if r["serve"] > 0]
    first = [r["decode_ms_per_step"] for r in rows if r["serve"] == 0]
    wall = [r["compress_wall_s"] for r in rows if r["serve"] == 0]
    return {"decode_ms": later, "decode_ms_median": statistics.median(later),
            "first_serve_decode_ms": first, "compress_wall_s": wall,
            "compress_wall_s_median": statistics.median(wall),
            "ttft_median_s": statistics.median(r["ttft_median_s"] for r in rows)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="root of the earlier checkout (git archive)")
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--serves", type=int, default=3, help="serves per process, >= 2")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(os.path.abspath(args.child), args.serves)
    import torch

    if not torch.cuda.is_available():
        print("torch_serve_ab: no CUDA device", file=sys.stderr)
        return 2
    if not args.parent or args.serves < 2 or args.pairs < 1:
        ap.error("--parent is required, --serves >= 2, --pairs >= 1")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    earlier = os.path.abspath(args.parent)
    builds = {root: build(root) for root in (earlier, ROOT)}
    for root, p in builds.items():
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"building {root}'s kernels failed:\n{out[-4000:]}")
    rows = {earlier: [], ROOT: []}
    pairs = []
    for i in range(args.pairs):
        order = (earlier, ROOT) if i % 2 == 0 else (ROOT, earlier)
        got = {root: run(root, args.serves) for root in order}
        for root, r in got.items():
            rows[root] += r
        med = {root: statistics.median(x["decode_ms_per_step"] for x in r if x["serve"] > 0)
               for root, r in got.items()}
        pairs.append({"first": "earlier" if order[0] == earlier else "this",
                      "earlier_decode_ms": med[earlier], "this_decode_ms": med[ROOT]})
    print(json.dumps({"summary": {"gpu": smi, "earlier": side(rows[earlier]),
                                  "this": side(rows[ROOT]), "pairs": pairs,
                                  "this_faster_pairs": sum(p["this_decode_ms"] <
                                                           p["earlier_decode_ms"]
                                                           for p in pairs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
