"""Tracing and profiling: named spans on the profiler's clock, and device
traces.

``span(name)`` marks a region of the port's host code.  While a
``torch.profiler`` records on the calling thread it is a
``record_function`` range, so the span lands in the same Chrome trace as
the kernels, copies and runtime calls it launched, nested under the span
that was open when it began; otherwise it is one shared no-op context,
and a span costs one flag read.  It never synchronizes or reads a device
value.  Span names are fixed (``ptq.<layer>.<part>``), never one per op
or block: a trace sums its idle gaps by name, and an op's or a block's
identity comes from the order and nesting of its spans.

``device_trace`` takes the place of the JAX package's ``xla_trace``,
wrapping a region in ``torch.profiler`` (CUDA activity on the card) and
exporting a Chrome trace (chrome://tracing, Perfetto) into a directory.
"""
from __future__ import annotations

import contextlib
import functools
import os
import time

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that marks ``name`` in the trace of a running
    ``torch.profiler``, and does nothing when none records."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def spanned(name: str):
    """Decorator: every call of the function runs inside ``span(name)``;
    the function's attributes (launch counters) stay reachable under its
    name."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


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
