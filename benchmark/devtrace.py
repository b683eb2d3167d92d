"""The device trace of a traced segment: ``torch.profiler`` around it,
its Chrome trace read back into intervals.

``capture(fn, device)`` runs ``fn`` inside a user annotation under the
profiler (CPU and, on a card, CUDA activity) and synchronises before the
annotation closes, so all device work of the segment lies inside it.
``Trace`` keeps the device intervals that fall in the annotation, their
union (the busy time), the idle gaps between them, and for each gap the
innermost host event that was running at its middle.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import math
import os
import re
import tempfile
import typing

import torch

WINDOW = "benchmark.traced_window"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "cuda_runtime", "cuda_driver", "python_function",
             "user_annotation"}
BREAKDOWN_ENTRIES = 10


class Kernel(typing.NamedTuple):
    name: str
    seconds: float
    blocks: int | None     # thread blocks of its grid; None if not traced


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: list          # Kernel of every kernel in the window
    device_ops: list       # (name, seconds), largest first
    idle_gaps: list        # (host event name, seconds), largest first

    def kernel_seconds(self, pattern: str, invert: bool = False) -> float:
        """Seconds of the kernels whose name matches ``pattern`` (a
        regular expression), or of the others with ``invert``."""
        rx = re.compile(pattern)
        return sum(k.seconds for k in self.kernels
                   if bool(rx.search(k.name)) != invert)


def short_name(name: str) -> str:
    """A kernel's name without its return type, argument list and
    PyTorch's ``at::native::`` prefixes."""
    if name.startswith("void "):
        name = name[5:]
    name = name.replace("at::native::", "")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name[:160]


def _blocks(event):
    """The number of thread blocks in a kernel event's grid, or None."""
    grid = event.get("args", {}).get("grid")
    if not isinstance(grid, list) or not grid:
        return None
    return int(math.prod(int(g) for g in grid))


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def parse(trace: dict) -> Trace:
    """The ``Trace`` of a Chrome trace (times in microseconds) that holds
    one ``WINDOW`` annotation."""
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    windows = [e for e in events if e["name"] == WINDOW
               and e.get("cat", "").lower() == "user_annotation"]
    if len(windows) != 1:
        raise ValueError(f"{len(windows)} traced windows in the trace")
    w = windows[0]
    w0, w1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    device, kernels = [], []
    for e in events:
        cat = e.get("cat", "").lower()
        if cat not in DEVICE_CATS:
            continue
        s = max(float(e["ts"]), w0)
        t = min(float(e["ts"]) + float(e["dur"]), w1)
        if t <= s:
            continue
        device.append((s, t))
        if cat == "kernel":
            kernels.append(Kernel(short_name(e["name"]), (t - s) * 1e-6,
                                  _blocks(e)))
    busy = _union(device)
    busy_us = sum(t - s for s, t in busy)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"]) for e in events
                  if e.get("cat", "").lower() in HOST_CATS
                  and e.get("tid") == w.get("tid") and e is not w)
    starts = [h[0] for h in host]
    by_host = collections.Counter()
    for s, t in gaps:
        mid = 0.5 * (s + t)
        name = "(host: no op running)"
        for k in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if host[k][1] >= mid:
                name = host[k][2]
                break
        by_host[name] += (t - s) * 1e-6
    by_kernel = collections.Counter()
    for k in kernels:
        by_kernel[k.name] += k.seconds
    return Trace(window_s=(w1 - w0) * 1e-6, busy_s=busy_us * 1e-6,
                 kernels=kernels,
                 device_ops=by_kernel.most_common(BREAKDOWN_ENTRIES),
                 idle_gaps=by_host.most_common(BREAKDOWN_ENTRIES))


def capture(fn, device: torch.device):
    """Run ``fn()`` under the profiler; return (its result, ``Trace``).
    The Chrome trace passes through a temporary file in TMPDIR."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            out = fn()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    return out, parse(data)


def idle_pct(trace: Trace | None):
    """100 x (1 - busy / window); None without device activity."""
    if trace is None or trace.busy_s <= 0 or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
