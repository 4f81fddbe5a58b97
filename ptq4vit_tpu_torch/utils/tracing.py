"""Tracing and profiling: nested wall-clock spans, and device traces.

The counterpart of ``ptq4vit_tpu/utils/tracing.py``: ``Tracer.span`` and
``summary`` as there; ``device_trace`` takes the place of ``xla_trace``,
wrapping a region in ``torch.profiler`` (CUDA activity on the card) and
exporting a Chrome trace (chrome://tracing, Perfetto) into a directory.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def device_trace(profile_dir: str, device=None, name: str = "trace"):
    """Run the region under ``torch.profiler`` (CPU activity, and CUDA
    activity unless ``device`` is the CPU or there is no card) and write
    ``{profile_dir}/{name}.{pid}.{ns}.json``; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if torch.cuda.is_available() and not on_cpu:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        profile_dir, f"{name}.{os.getpid()}.{time.time_ns()}.json"))


class Tracer:
    """Nested scoped wall-clock timing, with optional device traces."""

    def __init__(self, profile_dir: Optional[str] = None):
        self.profile_dir = profile_dir
        self.spans: Dict[str, float] = {}
        self._stack = []

    @contextlib.contextmanager
    def span(self, name: str):
        self._stack.append(name)
        key = "/".join(self._stack)
        t0 = time.time()
        try:
            yield
        finally:
            self.spans[key] = self.spans.get(key, 0.0) + time.time() - t0
            self._stack.pop()

    @contextlib.contextmanager
    def device_trace(self, device=None):
        """Wrap a region in ``torch.profiler`` when ``profile_dir`` is
        set (see :func:`device_trace`)."""
        if self.profile_dir is None:
            yield
            return
        with device_trace(self.profile_dir, device):
            yield

    def summary(self) -> str:
        return json.dumps(
            {k: round(v, 3) for k, v in sorted(self.spans.items())}, indent=2)
