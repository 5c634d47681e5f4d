"""Reading a profiler trace: device time by range, busy time, idle gaps.

The benchmark opens ``bench.<name>`` ranges (``torch.profiler.
record_function``) around its calls into the program's kernel entry points
and one ``bench.window`` range around the traced work.  From the exported
trace (Chrome's format) a device operation belongs to the range that was
open on the host when it was launched (the launch and the operation share a
correlation id).  Busy time is the union of the device operations'
intervals inside the window, not their sum, so operations that overlap on
two streams count once.
"""

from __future__ import annotations

import bisect
import collections
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def short(name: str, width: int = 160) -> str:
    """A kernel's name without its ``void`` and cut to ``width``: enough to
    tell the functor of an elementwise kernel, short enough for a ledger."""
    return name[5:width + 5] if name.startswith("void ") else name[:width]


def _union(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def analyse(path: str, top: int = 10) -> dict:
    """busy_s, window_s, device seconds by ``bench.*`` range, and the
    breakdown (the device operations that took most time; the longest idle
    gaps by the host operation open at their start)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    window, ranges, launches, device, host = None, [], {}, [], []
    for e in events:
        cat, ph = e.get("cat", ""), e.get("ph")
        if ph != "X":
            continue
        if cat == "user_annotation" and e["name"].startswith("bench."):
            rng = (e["ts"], e["ts"] + e["dur"], e.get("tid"), e["name"][6:])
            if rng[3] == "window":
                window = rng
            else:
                ranges.append(rng)
        elif cat == "cuda_runtime" or cat == "cuda_driver":
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (e["ts"], e.get("tid"))
        elif cat in DEVICE_CATS:
            device.append(e)
        elif cat == "cpu_op":
            host.append((e["ts"], e["ts"] + e["dur"], e["name"]))
    if window is None:
        raise RuntimeError("the trace has no bench.window range")
    w0, w1 = window[0], window[1]
    ranges.sort()
    starts = [r[0] for r in ranges]
    by_range = collections.Counter()
    by_name = collections.Counter()
    spans = []
    for e in device:
        a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if b <= a:
            continue
        spans.append((a, b))
        by_name[short(e["name"])] += (b - a) * 1e-6
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is None:
            continue
        t, tid = launch
        i = bisect.bisect_right(starts, t) - 1
        # the benchmark's ranges never nest: only the last one begun can cover t
        if i >= 0 and ranges[i][1] >= t and ranges[i][2] == tid:
            by_range[ranges[i][3]] += (b - a) * 1e-6
    busy = _union(spans)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    gaps, prev = [], w0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    host.sort()
    hstarts = [h[0] for h in host]
    by_host = collections.Counter()
    for a, b in gaps:
        i = bisect.bisect_right(hstarts, a) - 1
        name = "python"
        # the innermost host operation open at the gap's start: the latest
        # begun that still covers it, among the few begun just before
        for h in reversed(host[max(i - 50, 0):i + 1]):
            if h[1] >= a:
                name = h[2]
                break
        by_host[name] += (b - a) * 1e-6
    return {
        "busy_s": busy_s,
        "window_s": (w1 - w0) * 1e-6,
        "by_range": dict(by_range),
        "breakdown": {"device_ops": [[n, s] for n, s in by_name.most_common(top)],
                      "idle_gaps": [[n, s] for n, s in by_host.most_common(top)]},
    }
