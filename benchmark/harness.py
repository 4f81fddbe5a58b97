"""One run of one cell: find it by name, set it up, measure its window,
check its outputs against the plain reference, print the result.

Everything specific lives in files found by name:

* ``BENCHMARK.json`` (the checkout's root): the cell's configuration and
  traffic names and the metrics it reports;
* ``benchmark/workloads/<cell>.json``: the limits of the numbers that
  decide ``correct``;
* ``benchmark/configs/<config>.json``: the model's sizes (``model``);
* ``benchmark/mixes/<traffic>.json``: the traffic's parameters, with the
  ``generator`` that reads them, ``benchmark/traffic/<generator>.py``;
* ``benchmark/metrics/<metric>.py``: one reader per per-layer metric,
  ``read(run)`` returning a number or None (nothing to read);
* ``benchmark/reference/<generator>.py``: the plain reference.

A generator module has ``setup(run)``, ``window(run)`` (fills
``run.e2e``, ``run.attempted``, ``run.failed`` and, traced,
``run.trace``), ``release(run)`` and ``check(run)`` (the numbers
compared, by name).
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import sys
import time
from typing import Any, Dict, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")
FORBIDDEN = ("jax", "jaxlib", "flax", "ptq4vit_tpu")


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    config: Dict[str, Any]          # the configuration file
    mix: Dict[str, Any]             # the traffic mix file
    limits: Dict[str, float]        # workloads/<cell>.json "limits"
    chips: int = 1
    end_to_end: tuple = ()          # metric names this cell reports
    per_layer: tuple = ()
    units: Dict[str, str] = dataclasses.field(default_factory=dict)


def reports(metric, cell_name):
    """Whether a BENCHMARK.json metric is reported in the cell: in the
    cells it lists under ``workloads``, in every cell where it lists none
    (``setup_s``)."""
    return cell_name in metric.get("workloads", (cell_name,))


def load_cell(name: str, root: str = ROOT) -> Cell:
    bench = load_json(root, "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    here = os.path.join(root, "benchmark")
    cfg = load_json(here, "configs", f"{entry['config']}.json")
    mix = load_json(here, "mixes", f"{entry['traffic']}.json")
    cell = load_json(here, "workloads", f"{name}.json")
    e2e = tuple(m["name"] for m in bench["end_to_end"]
                if reports(m, name))
    layer = tuple(m["name"] for m in bench["per_layer"]
                  if reports(m, name))
    return Cell(name=name, config=cfg, mix=mix, limits=cell["limits"],
                chips=entry.get("chips", 1), end_to_end=e2e,
                per_layer=layer,
                units={m["name"]: m["unit"]
                       for m in bench["end_to_end"] + bench["per_layer"]})


class Run:
    """The state of one run, handed to the generator and the readers."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device, t0: float, control: bool = False):
        self.cell = cell
        self.cfg = cell.config["model"]
        self.mix = cell.mix
        self.seed = seed
        self.seconds = seconds
        self.traced = trace
        self.device = device
        self.t0 = t0
        self.control = control
        self.e2e: Dict[str, float] = {}
        self.attempted = 0
        self.failed = 0
        self.trace = None           # trace.Trace of the traced sub-window
        self.records: Dict[str, Any] = {}
        self.state: Dict[str, Any] = {}

    def log(self, msg):
        print(f"[bench] {msg}", file=sys.stderr, flush=True)


def cache_dirs(root: str = ROOT):
    """Every build and kernel cache at a fixed path inside the checkout
    (the program's own kernel libraries build into its ``_build``)."""
    base = os.path.join(root, ".bench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, os.path.join(base, sub))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def host_threads(cell: Cell):
    """The mix's ``host_threads``, a stated property of the measured
    deployment: the host threads of torch's operator pool, set in
    ``OMP_NUM_THREADS`` before torch is first imported and in torch's
    own setting.  A mix without it leaves torch's default."""
    n = cell.mix.get("host_threads")
    if n is None:
        return
    os.environ["OMP_NUM_THREADS"] = str(int(n))
    import torch
    torch.set_num_threads(int(n))


def loaded_forbidden():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def read_layer(name: str, run: Run):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t0: Optional[float] = None, control: bool = False):
    """Drive one run; returns (the result line's dict, the numbers
    compared {name: [value, limit]}, the Run)."""
    import torch
    t0 = time.time() if t0 is None else t0
    run = Run(cell, seed, seconds, trace, torch.device(device), t0, control)
    gen = importlib.import_module(
        f"benchmark.traffic.{cell.mix['generator']}")
    cuda = run.device.type == "cuda"
    gen.setup(run)
    run.t_window = time.time()
    run.e2e["setup_s"] = run.t_window - t0
    gen.window(run)
    peak = torch.cuda.max_memory_allocated(run.device) if cuda else 0
    gen.release(run)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = gen.check(run)
    compared = {k: [numbers.get(k, float("inf")), lim]
                for k, lim in cell.limits.items()}
    for k in sorted(set(numbers) - set(compared)):
        run.log(f"not compared in this cell: {k} {numbers[k]!r}")
    correct = run.failed == 0 and run.attempted > 0 and bool(compared) \
        and all(lim is not None and v <= lim for v, lim in compared.values())
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": (torch.cuda.get_device_name(run.device) if cuda
                            else "cpu"),
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    if trace:
        metrics = {}
        for name in cell.per_layer:
            v = read_layer(name, run)
            if v is not None:
                metrics[name] = {"value": v,
                                 "unit": cell.units.get(name, "")}
        if run.trace is not None:
            device_info["busy_s"] = run.trace.busy_s()
            device_info["window_s"] = run.trace.window_s()
    else:
        metrics = {k: {"value": run.e2e[k], "unit": cell.units.get(k, "")}
                   for k in cell.end_to_end if k in run.e2e}
    result = {"correct": bool(correct), "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics,
              "device": device_info}
    if trace and run.trace is not None:
        result["breakdown"] = {"device_ops": run.trace.device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["check"] = compared
    return result, compared, run


def parse(argv):
    import argparse
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, t0: Optional[float] = None) -> int:
    t0 = time.time() if t0 is None else t0
    args = parse(sys.argv[1:] if argv is None else argv)
    cache_dirs()
    try:
        cell = load_cell(args.workload)
        host_threads(cell)
        import torch
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if not torch.cuda.is_available():
            print("[bench] no CUDA device: the benchmark runs on the card",
                  file=sys.stderr)
            return 3
        if torch.cuda.device_count() < cell.chips:
            print(f"[bench] the cell needs {cell.chips} cards, "
                  f"{torch.cuda.device_count()} found", file=sys.stderr)
            return 3
        result, compared, _ = run_cell(cell, args.seed, args.seconds,
                                       bool(args.trace), "cuda:0", t0)
    except Exception:
        import traceback
        traceback.print_exc()
        return 1
    bad = loaded_forbidden()
    if bad:
        print(f"[bench] the run loaded {', '.join(bad)}", file=sys.stderr)
        return 1
    for k, (v, lim) in compared.items():
        print(f"[check] {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
