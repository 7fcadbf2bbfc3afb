"""The traced segment of a ``--trace 1`` run: torch.profiler, exported as
a Chrome trace into the run's temporary folder and reduced there to what
the per-layer readers and the ``breakdown`` need: the device's busy
time, each kernel's count and time by name, and the device's idle gaps
by what the host was doing in them.

Recording the host's ops slows the host by about as much as the ops
take, which on a host-paced loop opens idle gaps that an untraced run
does not have.  So :func:`segment` profiles the same work twice: once
with CUDA activity alone, whose busy time, window and kernels are the
readings, and once with the host's ops too, which only names the gaps.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from collections import defaultdict
from typing import Any, Callable, Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
SEGMENT = "capbench.segment"


def segment(work: Callable[[], None]) -> Dict[str, Any]:
    """Profile ``work`` (which ends on a device sync) with the card's
    activity alone, then again with the host's ops to name the idle
    gaps; returns the first's reduction with the second's gaps."""
    summary: Dict[str, Any] = {}
    with traced(summary, host=False):
        work()
    named: Dict[str, Any] = {}
    with traced(named):
        work()
    summary["idle"] = named["idle"]
    return summary


@contextlib.contextmanager
def traced(summary: Dict[str, Any], host: bool = True):
    """Profile the body, which has to end with a device sync; on exit
    ``summary`` holds the reduced trace (see :func:`reduce`).  Without
    ``host`` only the card's activity is recorded, and the window is the
    span of that activity."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host else [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        with record_function(SEGMENT):
            yield
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    summary.update(reduce(events))


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def reduce(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Times in seconds.  ``window_s``: the segment's span (without the
    host's ops recorded, the span of the card's activity); ``busy_s``: the
    union of device activity inside it; ``kernels``: {name: [count, s]};
    ``launches``: kernels run (copies and fills left out); ``idle``: {host op: idle s}."""
    seg = next((e for e in events if e.get("name") == SEGMENT and e.get("ph") == "X"
                and e.get("cat") == "user_annotation"), None)
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
             if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS and "dur" in e]
    if seg is not None:
        w0, w1 = float(seg["ts"]), float(seg["ts"]) + float(seg["dur"])
    elif spans:
        w0, w1 = min(s for s, _ in spans), max(e for _, e in spans)
    else:
        return {"window_s": 0.0, "busy_s": 0.0, "kernels": {}, "launches": 0, "idle": {}}
    device, host = [], []
    launches = 0
    kernels: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        if e.get("cat") in DEVICE_CATS:
            if s + d <= w0 or s >= w1:
                continue
            device.append((max(s, w0), min(s + d, w1)))
            launches += e.get("cat") == "kernel"
            k = kernels[e["name"][:160]]
            k[0] += 1
            k[1] += d * 1e-6
        elif e.get("cat") in HOST_CATS and e.get("name") != SEGMENT:
            host.append((s, s + d, e["name"][:80]))
    busy = _union(device)
    idle: Dict[str, float] = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    host.sort()
    active: List[Tuple[float, float, str]] = []
    i = 0
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        while i < len(host) and host[i][0] <= mid:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[1] >= mid]
        label = min(active, key=lambda h: h[1] - h[0])[2] if active else "python"
        idle[label] += (b - a) * 1e-6
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "kernels": {k: [int(v[0]), v[1]] for k, v in kernels.items()},
        "launches": launches,
        "idle": dict(idle),
    }


def kernel_time(summary: Dict[str, Any], fragment: str) -> Tuple[int, float]:
    """(launches, seconds) of the kernels whose name holds ``fragment``."""
    hits = [v for k, v in summary["kernels"].items() if fragment in k]
    return sum(v[0] for v in hits), sum(v[1] for v in hits)


def breakdown(summary: Dict[str, Any]) -> Dict[str, List[List[Any]]]:
    ops = sorted(summary["kernels"].items(), key=lambda kv: -kv[1][1])[:10]
    gaps = sorted(summary["idle"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v[1]] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}
