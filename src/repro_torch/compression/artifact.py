"""Compression artifact: the serving-consumable manifest.

Counterpart of ``repro/compression/artifact.py``, same format
(``repro.compression/v1``, saved as ``compression_manifest.json`` next to
the checkpoint's step directories): per compressed tensor the tile
geometry, method, bytes, errors and the shapes and dtypes of the stored
leaves.  ``restore_template`` rewrites a dense values tree into the
compressed checkpoint's structure (as ``meta`` tensors), so a compressed
checkpoint restores without re-running compression; ``validate_params``
checks a params tree against the manifest.  ``fingerprint`` is the
reference's content hash (sha256 of the canonical JSON, 16 hex digits), so
both packages name the same manifest alike; delta recompression records it
as the parent of a lineage (``delta``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import torch

from repro_torch.core.compress import CompressionReport
from repro_torch.device import dtype_from_name, dtype_name

__all__ = ["CompressionArtifact", "MANIFEST_NAME", "MANIFEST_FORMAT"]

MANIFEST_NAME = "compression_manifest.json"
MANIFEST_FORMAT = "repro.compression/v1"


def _entry_leaf_keys(e: dict) -> tuple:
    return ("q", "scale") if e.get("method") == "int8" else ("m_packed", "C")


@dataclasses.dataclass
class CompressionArtifact:
    manifest: dict

    def __post_init__(self):
        fmt = self.manifest.get("format")
        if fmt != MANIFEST_FORMAT:
            raise ValueError(
                f"unsupported compression manifest format {fmt!r} "
                f"(expected {MANIFEST_FORMAT!r})"
            )

    @property
    def report(self) -> CompressionReport:
        """The ``CompressionReport`` view of the manifest."""
        compressed = [
            (path, e["orig_bytes"], e["new_bytes"], e["rel_err"])
            for path, e in self.manifest["tensors"].items()
        ]
        return CompressionReport(compressed, list(self.manifest["skipped"].items()))

    @property
    def total_ratio(self) -> float:
        return self.manifest["totals"]["ratio"]

    @property
    def compression_ratio(self) -> float:
        return self.total_ratio

    def total_bytes(self) -> int:
        """Stored bytes of the compressed tensors."""
        return int(self.manifest["totals"]["new_bytes"])

    def fingerprint(self) -> str:
        """Content hash of the manifest: sha256 of its canonical JSON, 16
        hex digits, the reference's, so both packages agree on it."""
        blob = json.dumps(self.manifest, sort_keys=True, separators=(",", ":")).encode()
        return hashlib.sha256(blob).hexdigest()[:16]

    @property
    def delta(self) -> dict | None:
        """The delta-lineage block (None for a cold artifact)."""
        return self.manifest.get("delta")

    def solver_batches(self) -> list:
        """Pooled ``solve_many`` batch sizes, one per BBO chunk."""
        return [
            size
            for p in self.manifest["pools"]
            if p.get("solver_batch")
            for size in p.get("chunk_sizes", [p["solver_batch"]])
        ]

    def summary(self) -> str:
        t = self.manifest["totals"]
        lines = [
            f"CompressionArtifact: {len(self.manifest['tensors'])} tensors, "
            f"{t['orig_bytes'] / 2**20:.2f} -> {t['new_bytes'] / 2**20:.2f} MiB "
            f"(x{t['ratio']:.2f})"
        ]
        d = self.delta
        if d:
            lines.append(
                f"  delta gen {d['generation']} from {d['parent_fingerprint']}: "
                f"{d['tiles_resolved']}/{d['tiles_total']} tiles re-solved "
                f"({d['fraction_resolved']:.1%})"
            )
        for path, e in self.manifest["tensors"].items():
            lines.append(
                f"  {path:48s} {e['method']:11s} tile "
                f"{e['tile_n']}x{e['tile_d']} K={e['K']} rel_err {e['rel_err']:.3f}"
            )
        return "\n".join(lines)

    def save(self, directory: str) -> str:
        from repro_torch.checkpoint import checkpointer

        return checkpointer.save_aux(directory, MANIFEST_NAME, self.manifest)

    @classmethod
    def load(cls, directory: str) -> "CompressionArtifact":
        from repro_torch.checkpoint import checkpointer

        manifest = checkpointer.load_aux(directory, MANIFEST_NAME)
        if manifest is None:
            raise FileNotFoundError(f"no {MANIFEST_NAME} in {directory!r}")
        return cls(manifest)

    @classmethod
    def exists(cls, directory: str) -> bool:
        return os.path.exists(os.path.join(directory, MANIFEST_NAME))

    @classmethod
    def from_plan(cls, plan) -> "CompressionArtifact":
        """The predicted artifact of a plan that has not been executed:
        geometry and bytes from the plan, ``rel_err`` None, marked
        ``predicted_only`` (delta recompression refuses to anchor on it)."""
        tensors = {}
        for t in plan.tensors:
            r, c = t.d_in // t.tile_n, t.d_out // t.tile_d
            lead = list(t.shape[:-2])
            if t.method == "int8":
                leaf_spec = {
                    "q": {"shape": lead + [r, c, t.tile_n, t.tile_d], "dtype": "int8"},
                    "scale": {"shape": lead + [r, c, 1, 1], "dtype": "float32"},
                }
            else:
                leaf_spec = {
                    "m_packed": {"shape": lead + [r, c, t.tile_n, (t.K + 7) // 8],
                                 "dtype": "uint8"},
                    "C": {"shape": lead + [r, c, t.K, t.tile_d], "dtype": t.dtype},
                }
            tensors[t.path] = {
                "shape": list(t.shape),
                "dtype": t.dtype,
                "groups": t.groups,
                "group_dims": lead,
                "tile_n": t.tile_n,
                "tile_d": t.tile_d,
                "K": t.K,
                "method": t.method,
                "rule": t.rule,
                "leaf_index": t.leaf_index,
                "bbo_iters": t.bbo_iters,
                "num_tiles": t.num_tiles,
                "orig_bytes": t.orig_bytes,
                "new_bytes": t.pred_bytes,
                "rel_err": None,
                **leaf_spec,
            }
        manifest = {
            "format": MANIFEST_FORMAT,
            "policy": plan.policy.to_dict(),
            "solver_backend": plan.policy.solver_backend,
            "predicted_only": True,
            **({"autotune": plan.autotune} if plan.autotune else {}),
            "tensors": tensors,
            "skipped": {p: r for p, r in plan.skipped},
            "pools": [],
            "totals": {
                "orig_bytes": int(plan.total_orig_bytes),
                "new_bytes": int(plan.total_pred_bytes),
                "ratio": plan.pred_ratio,
            },
        }
        return cls(manifest)

    def restore_template(self, dense_values):
        """Each manifested leaf of a dense values tree becomes
        {"m_packed": meta tensor, "C": meta tensor} of the stored shapes
        and dtypes; other leaves are kept."""
        entries = self.manifest["tensors"]

        def rewrite(tree, prefix):
            if isinstance(tree, dict):
                return {
                    k: rewrite(v, f"{prefix}/{k}" if prefix else str(k))
                    for k, v in tree.items()
                }
            e = entries.get(prefix)
            if e is None:
                return tree
            if tuple(e["shape"]) != tuple(tree.shape):
                raise ValueError(
                    f"manifest/template shape mismatch at {prefix!r}: "
                    f"{tuple(e['shape'])} vs {tuple(tree.shape)}"
                )
            return {
                k: torch.empty(e[k]["shape"], dtype=dtype_from_name(e[k]["dtype"]),
                               device="meta")
                for k in _entry_leaf_keys(e)
            }

        return rewrite(dense_values, "")

    def validate_params(self, params) -> list:
        """Mismatches between the manifest and a params tree ([] == valid)."""
        from repro_torch.compression.plan import tree_paths

        leaves = dict(tree_paths(params))
        problems = []
        for path, e in self.manifest["tensors"].items():
            keys = _entry_leaf_keys(e)
            leaf_paths = [f"{path}/{k}" for k in keys]
            if any(lp not in leaves for lp in leaf_paths):
                problems.append(f"{path}: not compressed in params")
                continue
            for lp, k in zip(leaf_paths, keys):
                leaf, spec = leaves[lp], e[k]
                if tuple(leaf.shape) != tuple(spec["shape"]):
                    problems.append(
                        f"{lp}: shape {tuple(leaf.shape)} != manifest {tuple(spec['shape'])}"
                    )
                elif dtype_name(leaf.dtype) != spec["dtype"]:
                    problems.append(
                        f"{lp}: dtype {dtype_name(leaf.dtype)} != manifest {spec['dtype']}"
                    )
        return problems
