"""The traced sub-window: ``torch.profiler`` over a region, its Chrome
trace read back into device intervals, host events and the benchmark's
own spans.

Device work is every kernel, copy and memset the trace shows; the busy
time of a window is the length of the union of their intervals inside
it.  Host events (operators, runtime and driver calls, annotations) label
the device's idle gaps by what the host was doing.  The benchmark's spans
are ``record_function`` ranges named ``bench.*``, opened by its own code
around its calls into the program.  The trace is written to a temporary
file under ``TMPDIR`` and removed once read.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
import tempfile
from typing import Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


def short(name: str, width: int = 80) -> str:
    name = re.sub(r"^void |\(anonymous namespace\)::", "", name)
    return name.split("(")[0].strip()[:width]


class Trace:
    def __init__(self, events):
        self.device: List[Tuple[float, float, str, str]] = []
        self.host: List[Tuple[float, float, str]] = []
        self.spans: Dict[str, List[Tuple[float, float]]] = {}
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            ts = float(e["ts"])
            te = ts + float(e.get("dur", 0.0))
            if cat in DEVICE_CATS:
                self.device.append((ts, te, e.get("name", ""), cat))
            elif cat in HOST_CATS:
                name = e.get("name", "")
                if cat == "user_annotation" and name.startswith("bench."):
                    self.spans.setdefault(name, []).append((ts, te))
                if name != "bench.window":
                    self.host.append((ts, te, name))
        self.device.sort()
        self.host.sort()
        w = self.spans.get("bench.window", [])
        self.window = (w[0][0], w[0][1]) if w else (
            (self.device[0][0], self.device[-1][1]) if self.device
            else (0.0, 0.0))

    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def in_spans(self, name):
        """Device events that start inside a ``bench.<name>`` span."""
        spans = sorted(self.spans.get(name, []))
        starts = [s for s, _ in spans]
        out = []
        for ev in self.device:
            i = bisect.bisect_right(starts, ev[0]) - 1
            if i >= 0 and ev[0] <= spans[i][1]:
                out.append(ev)
        return out

    def busy_s(self, lo=None, hi=None) -> float:
        """Seconds in [lo, hi] (the window by default) in which a device
        event runs."""
        lo = self.window[0] if lo is None else lo
        hi = self.window[1] if hi is None else hi
        busy, cur_s, cur_e = 0.0, None, None
        for ts, te, _, _ in self.device:
            ts, te = max(ts, lo), min(te, hi)
            if te <= ts:
                continue
            if cur_e is None or ts > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = ts, te
            else:
                cur_e = max(cur_e, te)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy / 1e6

    def device_ops(self, top: int = 10):
        by: Dict[str, float] = {}
        for ts, te, name, _ in self.device:
            k = short(name)
            by[k] = by.get(k, 0.0) + (te - ts) / 1e6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10, scan: int = 4000):
        """Idle seconds of the device in the window, summed by the
        innermost host event under each gap's middle."""
        lo, hi = self.window
        gaps, edge = [], lo
        for ts, te, _, _ in self.device:
            if ts > edge:
                gaps.append((edge, min(ts, hi)))
            edge = max(edge, te)
            if edge >= hi:
                break
        if edge < hi:
            gaps.append((edge, hi))
        starts = [h[0] for h in self.host]
        by: Dict[str, float] = {}
        for g0, g1 in gaps:
            if g1 <= g0:
                continue
            mid = (g0 + g1) / 2
            label = "no host event"
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - scan, -1), -1):
                if self.host[j][1] >= mid:
                    label = short(self.host[j][2])
                    break
            by[label] = by.get(label, 0.0) + (g1 - g0) / 1e6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:top]


@contextlib.contextmanager
def profiled(device, out: dict):
    """Run the region under ``torch.profiler`` (device activity on the
    card) inside a ``bench.window`` span; ``out["trace"]`` holds the
    parsed :class:`Trace` afterwards."""
    from torch.profiler import ProfilerActivity, profile, record_function
    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize(device)
    with profile(activities=acts) as prof:
        with record_function("bench.window"):
            yield
            if cuda:
                torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    out["trace"] = Trace(events)


@contextlib.contextmanager
def span(name: str, device):
    """A ``bench.<name>`` range around a call into the program, ending
    once the device has finished what the call launched."""
    from torch.profiler import record_function
    with record_function(f"bench.{name}"):
        yield
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
