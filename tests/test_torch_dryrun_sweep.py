"""Every architecture's reduced config through the port's dry run
(``launch.dryrun.run_cell``) for a train, a prefill and a decode cell
(seq 64, batch 8), each under the reference preset's ``ParallelConfig``, on
a fake (2, 2) mesh, in a subprocess of its own (the fake process group;
four run at once):
a fault that only one architecture's path reaches (a name used without its
import, say) fails here.  The counts are held to what each path must give:
finite, positive FLOPs, bytes and peak, and collectives; the SSM layers
move their fused columns by all-to-all (at batch 8 the preset keeps even
the train cells tensor-parallel)."""

import json
import math
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.configs import ARCHITECTURES

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SSM_ARCHS = ("zamba2-1.2b", "mamba2-130m")

_SWEEP = r"""
import json, sys
import repro_torch.configs as C
from repro_torch.configs import reduced_for_smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import cells, dryrun

arch = sys.argv[1]
red = reduced_for_smoke(C.get_config(arch))
C.get_config = cells.get_config = lambda a: red
out = {}
for kind in ("train", "prefill", "decode"):
    rec = dryrun.run_cell(arch, ShapeConfig(kind, kind, 64, 8), False, None,
                          mesh={"data": 2, "model": 2})
    out[kind] = {"dot_flops": rec["cost"]["dot_flops"], "flops": rec["cost"]["flops"],
                 "bytes": rec["cost"]["bytes"], "coll": rec["collectives"],
                 "temp": rec["memory"]["temp_bytes"]}
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def sweep():
    """Each architecture's subprocess, four at a time: {arch: (return
    code, stdout, stderr)}."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out, todo, running = {}, list(ARCHITECTURES), {}
    while todo or running:
        while todo and len(running) < 4:
            arch = todo.pop(0)
            running[arch] = subprocess.Popen(
                [sys.executable, "-c", textwrap.dedent(_SWEEP), arch], env=env, text=True,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        arch = next(iter(running))
        proc = running.pop(arch)
        try:
            so, se = proc.communicate(timeout=300)
        finally:
            proc.kill()
        out[arch] = (proc.returncode, so, se)
    return out


@pytest.mark.parametrize("arch", ARCHITECTURES)
def test_every_cell_kind_is_costed(sweep, arch):
    rc, so, se = sweep[arch]
    assert rc == 0, se[-3000:]
    res = json.loads(next(ln for ln in so.splitlines()
                          if ln.startswith("RESULT "))[len("RESULT "):])
    for kind, c in res.items():
        for k in ("dot_flops", "flops", "bytes", "temp"):
            assert math.isfinite(c[k]) and c[k] > 0, (arch, kind, k, c[k])
        assert c["coll"]["total"] > 0, (arch, kind)
        if arch in SSM_ARCHS:
            assert c["coll"]["all-to-all"] > 0, (arch, kind, c["coll"])
