#!/usr/bin/env python3
"""Largest batch of K x K symmetric matrices that ``torch.linalg.eigh``
accepts on a CUDA card.

    python3 tools/torch_eigh_batch_probe.py [--k 2 3 4 8 16] [--max 4194304]

Compression solves its per-tile least squares through a batched eigh of
the (P, K, K) Gram matrices M^T M (``repro_torch/core/decomposition.py``).
cuSOLVER's batched path refuses a large enough P with
``CUSOLVER_STATUS_INVALID_VALUE``; ``compression/execute.py`` bounds a
greedy or alternating pool's chunk below that limit.  For each K this
doubles P from 1024 until a call fails (or ``--max`` is reached), then
bisects to within 1024 matrices, and prints one JSON line per K and a
summary line.  After each refusal a small eigh checks that the process can
go on.  Needs a card; the card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys


def accepts(torch, K: int, P: int, dev) -> tuple[bool, str]:
    g = torch.Generator(device=dev).manual_seed(P + K)
    A = torch.randn((P, K, K), generator=g, device=dev)
    G = A + A.transpose(-1, -2)
    try:
        lam, _ = torch.linalg.eigh(G)
        torch.cuda.synchronize()
        ok = bool(torch.isfinite(lam).all())
        return ok, "" if ok else "non-finite eigenvalues"
    except RuntimeError as e:          # the refusal is what is measured
        msg = str(e).splitlines()[0]
        torch.linalg.eigh(torch.eye(K, device=dev).expand(4, K, K).contiguous())
        torch.cuda.synchronize()       # the context still works after a refusal
        return False, msg


def probe(torch, K: int, limit: int, dev) -> dict:
    lo, hi, err = 0, None, ""
    P = 1024
    while P <= limit:
        ok, msg = accepts(torch, K, P, dev)
        if not ok:
            hi, err = P, msg
            break
        lo = P
        P *= 2
    if hi is None:
        return {"K": K, "largest_accepted": lo, "smallest_refused": None,
                "note": f"no refusal up to {limit}"}
    while hi - lo > 1024:
        mid = (lo + hi) // 2
        ok, msg = accepts(torch, K, mid, dev)
        if ok:
            lo = mid
        else:
            hi, err = mid, msg
    return {"K": K, "largest_accepted": lo, "smallest_refused": hi, "error": err}


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, nargs="+", default=[2, 3, 4, 8, 16])
    ap.add_argument("--max", type=int, default=1 << 22)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_eigh_batch_probe: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    rows = [probe(torch, K, args.max, dev) for K in args.k]
    for r in rows:
        print(json.dumps(r), flush=True)
    print(json.dumps({"eigh_batch_probe": {"torch": torch.__version__,
                                           "cuda": torch.version.cuda,
                                           "device": torch.cuda.get_device_name(0),
                                           "min_largest_accepted": min(
                                               r["largest_accepted"] for r in rows)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
