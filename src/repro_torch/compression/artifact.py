"""Compression artifact: the serving-consumable manifest.

Counterpart of ``repro/compression/artifact.py``, same format
(``repro.compression/v1``, saved as ``compression_manifest.json`` next to
the checkpoint's step directories): per compressed tensor the tile
geometry, method, bytes, errors and the shapes and dtypes of the stored
leaves.  ``restore_template`` rewrites a dense values tree into the
compressed checkpoint's structure (as ``meta`` tensors), so a compressed
checkpoint restores without re-running compression; ``validate_params``
checks a params tree against the manifest.
"""

from __future__ import annotations

import dataclasses
import os

import torch

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
    def total_ratio(self) -> float:
        return self.manifest["totals"]["ratio"]

    @property
    def compression_ratio(self) -> float:
        return self.total_ratio

    def total_bytes(self) -> int:
        """Stored bytes of the compressed tensors."""
        return int(self.manifest["totals"]["new_bytes"])

    def summary(self) -> str:
        t = self.manifest["totals"]
        lines = [
            f"CompressionArtifact: {len(self.manifest['tensors'])} tensors, "
            f"{t['orig_bytes'] / 2**20:.2f} -> {t['new_bytes'] / 2**20:.2f} MiB "
            f"(x{t['ratio']:.2f})"
        ]
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
