"""``repro_torch.roofline`` against ``repro.roofline`` on the CPU: the
analytic per-device bytes of every cell, the roofline terms, and the
counting dispatch mode (dot FLOPs of products, collective bytes of both
namespaces on a fake world of 4 ranks, in a subprocess so that no test
worker keeps a process group), with the reference's dict shapes."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro import roofline as jroof
from repro.configs import ARCHITECTURES
from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.configs import shape_cells as j_shape_cells
from repro.launch.presets import parallel_preset as j_preset
from repro_torch import roofline
from repro_torch.configs import SHAPES, get_config, shape_cells
from repro_torch.launch.presets import parallel_preset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("arch", sorted(ARCHITECTURES))
def test_analytic_memory_bytes_matches_jax(arch):
    """Every cell of the arch, on both production meshes, exactly."""
    assert shape_cells(arch) == j_shape_cells(arch)
    for shape in shape_cells(arch):
        for multi_pod, chips in ((False, 256), (True, 512)):
            jc, tc = j_get_config(arch), get_config(arch)
            want = jroof.analytic_memory_bytes(jc, J_SHAPES[shape],
                                               j_preset(jc, J_SHAPES[shape], multi_pod=multi_pod),
                                               chips)
            got = roofline.analytic_memory_bytes(tc, SHAPES[shape],
                                                 parallel_preset(tc, SHAPES[shape],
                                                                 multi_pod=multi_pod), chips)
            assert got == want, (shape, multi_pod)


def test_roofline_terms_dominance():
    """As tests/test_substrates.py holds the reference's, at the H100's
    datasheet figures."""
    t = roofline.roofline_terms(flops=roofline.PEAK_FLOPS, bytes_accessed=roofline.HBM_BW * 2,
                                coll_bytes=0)
    assert t["dominant"] == "memory"
    assert np.isclose(t["memory_s"], 2.0) and np.isclose(t["compute_s"], 1.0)
    t = roofline.roofline_terms(flops=0, bytes_accessed=0, coll_bytes=roofline.ICI_BW * 3)
    assert t["dominant"] == "collective" and np.isclose(t["bound_s"], 3.0)
    assert set(t) == set(jroof.roofline_terms(1.0, 1.0, 1.0))
    assert (roofline.PEAK_FLOPS, roofline.PEAK_F32_FLOPS, roofline.HBM_BW, roofline.ICI_BW) == \
        (989e12, 67e12, 3.35e12, 450e9)


def test_counter_dot_flops_are_2mnk():
    a, b = torch.randn(3, 5, 7), torch.randn(3, 7, 4)
    w, bias = torch.randn(7, 6), torch.randn(6)
    with roofline.CostCounter() as c:
        torch.einsum("bqd,bdk->bqk", a, b)                       # 2 * 3*5*4*7
        torch.bmm(a, b)
        a[0] @ w                                                 # 2 * 5*6*7
        torch.nn.functional.linear(a[0], w.T, bias)              # addmm, 2 * 5*6*7
        torch.einsum("bhqd,bhkd->bhqk", torch.randn(2, 3, 4, 8), torch.randn(2, 3, 5, 8))
    assert c.dot_flops == 2 * (2 * 3 * 5 * 4 * 7 + 2 * 5 * 6 * 7 + 2 * 3 * 4 * 5 * 8)
    cost = roofline.cost_summary(c.record())
    assert set(cost) >= {"flops", "bytes", "transcendentals"}
    assert cost["flops"] >= cost["dot_flops"] == c.dot_flops and cost["bytes"] > 0


def test_counter_elementwise_transcendentals_and_peak():
    x = torch.randn(10, 10)
    with roofline.CostCounter() as c:
        y = torch.exp(x) + x          # 100 transcendentals, 100 FLOPs
        del y
        z = torch.empty(50)           # a factory moves no bytes
    assert c.transcendentals == 100 and c.elementwise_flops == 100 and c.dot_flops == 0
    # exp's output and the sum were alive at once; then the empty one
    assert c.peak_bytes == 2 * 100 * 4 and c.live_bytes == z.numel() * 4


def test_memory_summary_counts_donated_buffers_once():
    m = roofline.memory_summary(100, 60, 30, 50)
    assert m["per_device_total"] == 140
    want = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes", "per_device_total"}
    assert set(m) == want


def test_fake_process_group_store_is_importable():
    """The dry run's one private import (``launch/fakeworld.py``): fails
    here by name if torch moves it."""
    from repro_torch.launch.fakeworld import _fake_store

    assert _fake_store() is not None


_COLLECTIVES = r"""
import json
import torch, torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from repro_torch import roofline
from repro_torch.distributed import sharding as shd
from repro_torch.launch.fakeworld import fake_world

with fake_world((2, 2), ("data", "model")) as mesh:
    x = torch.empty(8, 16, device=mesh.device_type)          # 512 bytes
    out = {}
    with roofline.CostCounter() as c:
        funcol.all_gather_tensor(x, 0, mesh.get_group("data"))          # result 1,024
        funcol.reduce_scatter_tensor(x, "sum", 0, mesh.get_group("data"))  # result 256
        funcol.all_reduce(x, "sum", mesh.get_group("model"))            # 512
    out["functional"] = roofline.collective_bytes(c.record())
    with roofline.CostCounter() as c:
        big = torch.empty(16, 16, device=mesh.device_type)
        dist.all_gather_into_tensor(big, x, group=mesh.get_group("model"))   # 1,024
        small = torch.empty(4, 16, device=mesh.device_type)
        dist.reduce_scatter_tensor(small, x, group=mesh.get_group("model"))  # 256
        dist.all_reduce(x)                                                   # 512
    out["c10d"] = roofline.collective_bytes(c.record())
    d = shd.NamedSharding(mesh, (("data", "model"),)).from_local(x, (32, 16))
    with roofline.CostCounter() as c:
        d.full_tensor()                                     # 1,024 then 2,048
    out["full_tensor"] = roofline.collective_bytes(c.record())
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def collectives():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_COLLECTIVES)],
                       capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    line = next(ln for ln in r.stdout.splitlines() if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


@pytest.mark.parametrize("ns", ["functional", "c10d"])
def test_collective_bytes_are_result_shapes(collectives, ns):
    """The gathered buffer of an all-gather, the scattered one of a
    reduce-scatter, the buffer of an all-reduce; each op once (a functional
    op's ``wait_tensor`` is not counted); the reference's keys."""
    got = collectives[ns]
    assert (got["all-gather"], got["reduce-scatter"], got["all-reduce"]) == (1024, 256, 512)
    assert got["total"] == 1024 + 256 + 512
    assert got["counts"] == {"all-reduce": 1, "all-gather": 1, "reduce-scatter": 1,
                             "all-to-all": 0, "collective-permute": 0}
    assert set(got) == set(jroof.collective_bytes(""))


def test_dtensor_full_tensor_is_an_all_gather(collectives):
    """A DTensor split over both mesh axes gathers one axis at a time: the
    (16, 16) buffer over ``model``, then the whole (32, 16) over ``data``."""
    got = collectives["full_tensor"]
    assert got["all-gather"] == (16 + 32) * 16 * 4 and got["counts"]["all-gather"] == 2
