"""Ranges around the program's kernel entry points, for traced runs only.

While installed, each call into K3 (``kernels.bitlinear.bitlinear``), K4
(``bitlinear_grouped``) or K5 (``flash_attention``) runs inside a
``bench.k3`` / ``k4`` / ``k5`` profiler range, and its least time on the
card (``work.counts``) is added to that kernel's total.  The names
are replaced where the program looks them up at call time and put back on
``uninstall``.
"""

from __future__ import annotations

import collections

import torch

from work import counts


def _k3(x, mp, C, *a, **k):
    n_r, n_c, tn, _ = mp.shape
    K, td = C.shape[-2:]
    ops, nb = counts.k3(x.shape[0], n_r, n_c, tn, K, td, x.element_size(), C.element_size(),
                        x.element_size())
    return counts.bound_s(ops, nb)


def _k4(x, mp, C, *a, **k):
    E, n_r, n_c, tn, _ = mp.shape
    K, td = C.shape[-2:]
    ops, nb = counts.k4(E, x.shape[1], n_r, n_c, tn, K, td, x.element_size(),
                        C.element_size(), x.element_size())
    return counts.bound_s(ops, nb)


def _k5(q, k, v, window=0, *a, **kw):
    B, H, S, hd = q.shape
    ops, nb = counts.k5(B, H, k.shape[1], S, hd, int(window), q.element_size())
    return counts.bound_s(ops, nb)


class Ranges:
    """Install with ``install()``; ``bound_s[name]`` and ``calls[name]``
    accumulate while installed."""

    def __init__(self):
        self.bound_s = collections.Counter()
        self.calls = collections.Counter()
        self._saved = []

    def _wrap(self, module, attr: str, name: str, bound):
        fn = getattr(module, attr)

        def call(*args, **kwargs):
            self.bound_s[name] += bound(*args, **kwargs)
            self.calls[name] += 1
            with torch.profiler.record_function(f"bench.{name}"):
                return fn(*args, **kwargs)

        self._saved.append((module, attr, fn))
        setattr(module, attr, call)

    def install(self) -> None:
        from repro_torch.kernels import ops

        self._wrap(ops, "_bitlinear", "k3", _k3)
        self._wrap(ops, "_bitlinear_grouped", "k4", _k4)
        self._wrap(ops, "flash_attention", "k5", _k5)

    def uninstall(self) -> None:
        for module, attr, fn in reversed(self._saved):
            setattr(module, attr, fn)
        self._saved = []
