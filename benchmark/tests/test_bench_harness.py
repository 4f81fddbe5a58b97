"""The harness: cells, configurations, mixes and metrics found by name,
BENCHMARK.json against the contract, the window arithmetic, and whole
runs of small cells on the CPU (the kernels' plain versions)."""
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.traffic import calib as calib_traffic
from benchmark.traffic import serve as serve_traffic

ROOT = harness.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")

TINY_VIT = {"kind": "vit", "img_size": 32, "patch_size": 8, "embed_dim": 32,
            "depth": 2, "num_heads": 2, "mlp_ratio": 4.0, "num_classes": 10,
            "ln_eps": 1e-6, "in_chans": 3}
TINY_SWIN = {"kind": "swin", "img_size": 32, "patch_size": 2,
             "embed_dim": 12, "depths": [2, 2], "num_heads": [2, 4],
             "window_size": 4, "mlp_ratio": 4.0, "num_classes": 10,
             "ln_eps": 1e-5, "in_chans": 3}
TINY_CALIB = {"generator": "calib", "images": 8, "micro_batch": 4,
              "config": "PTQ4ViT", "bits": [8, 8], "cache_dtype": "bfloat16",
              "warmup_jobs": 1, "eq_n": 8, "check_reductions": 1,
              "check_ops": {"qkv": 1, "matmul": 1, "sos": 1, "linear": 2,
                            "postgelu": 1}}
TINY_SERVE = {"generator": "serve", "batch": 4, "pool": 3, "warmup": 1,
              "traced_after": 1, "traced_requests": 2, "check_requests": 2}


def tiny_cell(kind, model, limits=None):
    cal = kind == "calib"
    src = harness.load_cell(f"vit_b384.{'calib32' if cal else 'serve32'}")
    return harness.Cell(
        name=f"tiny.{kind}", config={"name": "tiny", "model": model},
        mix=dict(TINY_CALIB if cal else TINY_SERVE),
        limits=dict(src.limits if limits is None else limits),
        end_to_end=src.end_to_end, per_layer=src.per_layer, units=src.units)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cells_found_by_name(cell):
    c = harness.load_cell(cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    conf = next(x for x in BENCH["configs"] if x["name"] == entry["config"])
    assert os.path.exists(os.path.join(ROOT, conf["file"]))
    assert c.config["name"] == entry["config"]
    assert os.path.exists(os.path.join(ROOT, "benchmark", "traffic",
                                       c.mix["generator"] + ".py"))
    assert "setup_s" in c.end_to_end and len(c.end_to_end) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics",
                                           m + ".py"))
    assert set(c.limits) and all(v is not None for v in c.limits.values())


def test_benchmark_json_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    # a full check at 24 cells fits its 43200 seconds
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["reduced"] == []
        names.add(c["name"])
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in names
        assert w["chips"] == 1 and len(w["why"]) <= 200
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == cells
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_is_the_registry_row(name):
    from ptq4vit_tpu_torch.models.registry import model_config
    from benchmark import model
    conf = json.load(open(os.path.join(ROOT, "benchmark", "configs",
                                       f"{name}.json")))
    assert model.port_config(conf["model"], conf["registry"]) == \
        model_config(conf["registry"])


@pytest.mark.parametrize("config", ["vit_b384", "swin_b384"])
@pytest.mark.parametrize("seed", [0, 2 ** 31 + 11, 2 ** 33 + 7])
def test_check_samples_every_stage(config, seed):
    """The calibration check draws each sampled op kind in every stage
    (every Swin head count and fold factor), a downsample reduction, the
    patch embedding and the head."""
    from benchmark.reference.models import op_kinds
    cell = harness.load_cell(f"{config}.calib32")
    run = harness.Run(cell, seed, 1, False, torch.device("cpu"), 0.0)
    picked = calib_traffic.sample_ops(run)
    kinds = op_kinds(run.cfg)
    stages = {calib_traffic.stage(n) for n in kinds} - {None}
    assert len(stages) == (4 if config == "swin_b384" else 1)
    for st in stages:
        for kind, k in cell.mix["check_ops"].items():
            assert sum(1 for n, t in picked.items()
                       if t == kind and calib_traffic.stage(n) == st) == k
    red = [n for n in picked if n.endswith("downsample.reduction")]
    assert len(red) == (1 if config == "swin_b384" else 0)
    assert {"patch_embed.proj", "head"} <= set(picked)


class _Engine:
    """Stands in for ServingEngine: sleeps a fixed pattern, returns
    (B, 10) logits."""

    def __init__(self, waits):
        self.waits, self.i = waits, 0

    def __call__(self, x):
        time.sleep(self.waits[self.i % len(self.waits)])
        self.i += 1
        return torch.zeros(x.shape[0], 10)


def test_serve_window_arithmetic():
    cell = tiny_cell("serve", TINY_VIT)
    run = harness.Run(cell, 1, 0.3, False, torch.device("cpu"), 0.0)
    run.state.update(engine=_Engine([0.002, 0.002, 0.002, 0.012]),
                     pool=[np.zeros((4, 3, 8, 8), np.float32)] * 3)
    serve_traffic.window(run)
    spans, lat = run.records["spans"], run.records["latency"]
    assert run.attempted == len(lat) == len(spans) > 10
    wall = spans[-1][1] - spans[0][0]
    assert run.e2e["serve_img_s"] == pytest.approx(4 * len(lat) / wall)
    assert run.e2e["serve_p95_ms"] == pytest.approx(
        np.percentile(np.array(lat) * 1e3, 95))
    # a quarter of the requests are slow: the tail sees them, the median
    # does not
    assert run.e2e["serve_p95_ms"] > 10 > 1e3 * statistics.median(lat)


def test_calib_window_arithmetic(monkeypatch):
    cell = tiny_cell("calib", TINY_VIT)
    run = harness.Run(cell, 1, 0.25, False, torch.device("cpu"), 0.0)

    def job(run, spans=False):
        t0 = time.time()
        time.sleep(0.1)
        return t0, time.time(), {}, None
    monkeypatch.setattr(calib_traffic, "job", job)
    t = time.time()
    calib_traffic.window(run)
    jobs = run.records["jobs"]
    # jobs start while under the window and all complete: 3 of 0.1 s
    assert run.attempted == len(jobs) == 3 and time.time() - t >= 0.3
    span = jobs[-1][1] - jobs[0][0]
    assert run.e2e["calib_s"] == pytest.approx(span / 3)


def test_no_card_exits_without_a_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "vit_b384.serve32", "--seed", str(2 ** 31 + 5),
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, env=env, timeout=300)
    assert p.returncode == 3 and p.stdout == ""


def test_bare_checkout_fails(tmp_path):
    """Only BENCHMARK.json and the benchmark's folder: the program is
    missing, so a run fails before it prints anything."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, '.'); "
            "from benchmark import harness; "
            "c = harness.load_cell('vit_b384.serve32'); "
            "r = harness.run_cell(c, 1, 0.1, False, 'cpu'); print(r[0])")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, env=env, timeout=300)
    assert p.returncode != 0 and p.stdout == ""
    assert "ptq4vit_tpu_torch" in p.stderr


@pytest.mark.parametrize("kind", ["calib", "serve"])
@pytest.mark.parametrize("model", ["vit", "swin"])
@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_cell_runs(kind, model, trace):
    cell = tiny_cell(kind, TINY_VIT if model == "vit" else TINY_SWIN)
    result, compared, run = harness.run_cell(cell, 2 ** 33 + 7, 0.5,
                                             bool(trace), "cpu")
    assert result["correct"], compared
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "check"
    if trace:
        assert "breakdown" in result and "busy_s" in result["device"]
    else:
        assert set(result["metrics"]) == {
            "setup_s", "calib_s" if kind == "calib" else "serve_img_s"} \
            | ({"serve_p95_ms"} if kind == "serve" else set())


def test_run_loads_no_jax():
    """A whole small run in a fresh process loads nothing of JAX or of
    the JAX package."""
    code = (
        "import sys; sys.path.insert(0, '.'); import torch; "
        "torch.set_num_threads(2); "
        "from benchmark import harness; "
        "from benchmark.tests.test_bench_harness import tiny_cell, TINY_VIT; "
        "c = tiny_cell('serve', TINY_VIT); "
        "harness.run_cell(c, 3, 0.2, False, 'cpu'); "
        "print(harness.loaded_forbidden())")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"
