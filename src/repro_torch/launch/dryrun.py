"""Multi-GPU dry run: cost the production meshes without the hardware.

Counterpart of ``repro/launch/dryrun.py``.  For every (architecture x
input-shape) cell, on the single-pod (16 x 16 = 256 GPUs) and multi-pod
(2 x 16 x 16 = 512) production meshes, this process plays rank 0 of a fake
process group of the mesh's size (``launch/fakeworld.py``: no card, no
network, no allocation), builds the cell (``launch/cells.py``) and costs
its step (``launch/costing.py``).  It needs no GPU and never claims to have
run on one.

The record has the reference's keys, read as follows:

* ``memory.argument_bytes``: rank 0's boxes of the state and batch (or
  parameters, inputs and cache), exactly, from the cell's shardings;
* ``memory.alias_bytes``: the arguments the step updates in place (the
  train state; a serving cache), the port's counterpart of donation;
* ``memory.output_bytes``: those plus the step's other results (metrics,
  logits), from the one-group step;
* ``memory.temp_bytes``: the peak of live bytes beyond the arguments
  during the step, composed as ``cost_cell`` composes it (the one-group
  step's peak plus what each further group keeps alive; a whole-step trace
  at full width is too slow);
* ``cost`` (``flops``, ``bytes``, ``transcendentals``, ``dot_flops``) and
  ``collectives`` (bytes by kind, ``total``, ``counts``) as composed;
* ``trace_s``, the seconds the costing took, in place of the reference's
  ``lower_s`` and ``compile_s``;
* ``fits_hbm``: ``per_device_total`` within ``roofline.HBM_BYTES``, an
  80 GB H100's memory (the reference holds a TPU v5e's 16 GiB).

Records go to ``<out>/<arch>__<shape>__<pod|multipod>[__compressed].json``.

Usage (no GPU needed):
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod-only|--single-pod-only]
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch.configs import ARCHITECTURES, SHAPES, get_config, shape_cells
from repro_torch.roofline import HBM_BYTES

__all__ = ["run_cell", "main"]


def _predicted_artifact(arch: str):
    """Plan-predicted compression artifact for ``arch`` (no solver runs:
    the dry run needs only the manifest's shapes to build the compressed
    serving program, costed through the kernels' adapters)."""
    from repro_torch.compression import CompressionArtifact, CompressionPolicy, plan_compression
    from repro_torch.training.loop import _axes_trees

    shapes, _ = _axes_trees(get_config(arch))
    policy = CompressionPolicy(
        method="alternating", tile_n=32, tile_d=128, rank_ratio=0.125,
        min_size=1 << 16,
    )
    return CompressionArtifact.from_plan(plan_compression(shapes, policy))


def run_cell(arch: str, shape_name, multi_pod: bool, out_dir: str | None,
             compress: bool = False, *, mesh=None, overrides: dict | None = None) -> dict:
    """Cost one cell on the production mesh (or ``mesh``, a mesh shape
    {axis: size}), print its summary, write its record under ``out_dir``
    (None: do not write) and return it."""
    from repro_torch import roofline
    from repro_torch.launch import costing
    from repro_torch.launch.cells import argument_bytes, build_cell

    t0 = time.time()
    artifact = _predicted_artifact(arch) if compress else None
    _, shape, pcfg = costing._resolve(arch, shape_name, multi_pod, overrides)
    with costing.world(mesh, multi_pod) as m:
        cell = build_cell(arch, shape, m, pcfg=pcfg, artifact=artifact)
        args_b = argument_bytes(cell)
        alias_b = _alias_bytes(cell)
        _, _, _, where, total, _ = costing._cell_costs(
            arch, shape, multi_pod=multi_pod, overrides=overrides, mesh=m, artifact=artifact)
    trace_s = time.time() - t0

    mem = roofline.memory_summary(args_b, alias_b + int(total["out_extra"]), int(total["temp"]),
                                  alias_b)
    cost = {"flops": total["flops"], "bytes": total["bytes"],
            "transcendentals": total["transcendentals"], "dot_flops": total["dot_flops"]}
    kinds = [k.split("/", 1)[1] for k in total if k.startswith("coll/")]
    coll = {k: total[f"coll/{k}"] for k in kinds}
    coll["total"] = sum(coll.values())
    coll["counts"] = {k: int(round(total[f"count/{k}"])) for k in kinds}
    rec = {
        "arch": arch,
        "shape": shape.name,
        "mesh": where,
        "kind": shape.kind,
        "compressed": bool(compress),
        "pcfg": {
            "microbatches": pcfg.microbatches,
            "optimizer": pcfg.optimizer,
            "accum_dtype": pcfg.accum_dtype,
        },
        "memory": mem,
        "cost": cost,
        "collectives": coll,
        "trace_s": round(trace_s, 1),
        "fits_hbm": mem["per_device_total"] <= HBM_BYTES,
        "roofline": roofline.roofline_terms(cost["flops"], cost["bytes"], coll["total"]),
    }
    print(
        f"[{arch} x {shape.name} @ {where}] "
        f"per-device {mem['per_device_total']/2**30:.2f} GiB "
        f"({'FITS' if rec['fits_hbm'] else 'OVER'} {HBM_BYTES/2**30:.2f} GiB) | "
        f"flops/dev {cost['flops']:.3e} | coll bytes/dev {coll['total']:.3e} | "
        f"trace {trace_s:.0f}s", flush=True
    )
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, _name(arch, shape.name, multi_pod, compress)), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def _alias_bytes(cell) -> int:
    """Bytes of rank 0's boxes of the arguments the step updates in place."""
    from repro_torch.launch.cells import argument_bytes

    keep = set(cell.donate_argnums)
    return argument_bytes(cell._replace(
        args=tuple(a if i in keep else None for i, a in enumerate(cell.args)),
        in_shardings=tuple(s if i in keep else None for i, s in enumerate(cell.in_shardings))))


def _name(arch: str, shape: str, multi_pod: bool, compress: bool) -> str:
    tag = "multipod" if multi_pod else "pod"
    if compress:
        tag += "__compressed"
    return f"{arch}__{shape}__{tag}.json"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--compress", action="store_true",
                    help="cost serving cells with a plan-predicted compression artifact: "
                         "manifest-templated params through the bitlinear kernels' costing "
                         "adapters (serving cells only)")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args()

    if args.all:
        cells = [(a, s) for a in ARCHITECTURES for s in shape_cells(a)]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch/--shape or --all")

    meshes = [False, True]
    if args.multi_pod_only:
        meshes = [True]
    if args.single_pod_only:
        meshes = [False]
    if args.compress:
        cells = [(a, s) for a, s in cells if SHAPES[s].kind != "train"]

    failures = []
    for arch, shape in cells:
        for mp in meshes:
            path = os.path.join(args.out, _name(arch, shape, mp, args.compress))
            if args.skip_existing and os.path.exists(path):
                print(f"[skip existing] {path}")
                continue
            try:
                run_cell(arch, shape, mp, args.out, compress=args.compress)
            except Exception as e:  # noqa: BLE001 - report-and-continue CLI
                failures.append((arch, shape, "multipod" if mp else "pod", repr(e)))
                traceback.print_exc()
    if failures:
        print("\nFAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print("\nAll dry-run cells costed successfully.")


if __name__ == "__main__":
    main()
