"""The device trace of a traced window, from ``torch.profiler``.

The profiler records the host's ranges (``record_function``; the
benchmark's own are named ``bench.*``) and every operation on the device.
Its Chrome trace is written to a temporary file, read back and deleted.
From it:

- ``kernels``: (name, start, duration) of every device operation (kernels,
  copies, sets) inside the window, in microseconds;
- ``busy_s``: the union of their intervals, clipped to the window;
- ``window_s``: the length of the ``bench.window`` range;
- ``idle``: the gaps between busy intervals, each named by the
  ``bench.*`` range the host was in when the gap began (``bench.loop``
  between them), summed by name;
- ``device_ops``: device time by operation name.
"""

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import NamedTuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"


class Trace(NamedTuple):
    kernels: list
    busy_s: float
    window_s: float
    idle: dict
    device_ops: dict


def profiler(dev):
    """A profiler of the host and, on a card, of the device."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def export(prof):
    """The profiler's trace events (a list of dicts)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _host_range(ranges, starts, t):
    """Name of the range containing time ``t``: the benchmark's ranges
    inside the window follow one another and do not nest (sorted by
    start, with ``starts`` their starts); between them the host is in its
    own loop."""
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and ranges[i][1] >= t:
        return ranges[i][2]
    return "bench.loop"


def reduce(events):
    """A ``Trace`` of the ``bench.window`` range in ``events``."""
    windows = [e for e in events if e.get("name") == WINDOW
               and e.get("cat") == "user_annotation"]
    if not windows:
        raise RuntimeError(f"the trace has no {WINDOW} range")
    w0 = windows[0]["ts"]
    w1 = w0 + windows[0]["dur"]
    kernels = []
    for e in events:
        if e.get("cat") in DEVICE_CATS and e.get("ph") == "X":
            s, d = float(e["ts"]), float(e.get("dur", 0.0))
            if s + d > w0 and s < w1:
                kernels.append((e["name"], s, d))
    busy = _merge((max(s, w0), min(s + d, w1)) for _, s, d in kernels)
    busy_us = sum(e - s for s, e in busy)
    ranges = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                    for e in events
                    if e.get("cat") == "user_annotation"
                    and e.get("name", "").startswith("bench.")
                    and e["name"] != WINDOW)
    starts = [r[0] for r in ranges]
    idle = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e > s:
            idle[_host_range(ranges, starts, s)] += (e - s) / 1e6
    ops = defaultdict(float)
    for name, _, d in kernels:
        ops[name] += d / 1e6
    return Trace(kernels, busy_us / 1e6, (w1 - w0) / 1e6, dict(idle), dict(ops))


def top(d, n=10, width=120):
    """The ``n`` largest entries of {name: seconds}, names cut to ``width``."""
    return [[k[:width], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
