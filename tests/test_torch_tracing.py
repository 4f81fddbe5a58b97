"""The port's spans (``utils/tracing.span``) and the benchmark readers of
them, on the CPU.

With no profiler running a span is one shared no-op and no
``record_function`` is made.  Under a CPU ``torch.profiler`` a tiny ViT's
and a tiny Swin's ``ServingEngine`` call, and a tiny ``quantize``, give
the span tree the layers promise: one request or job span with every
part nested in it, one block span a block, one search span an op named by
its quantizer; the calibrator's ``profile_dir`` trace holds the same
spans.  On the card (``-m cuda``) a Swin request's forward makes no host
wait.  The readers of ``benchmark/metrics`` give known values on a
hand-built trace."""
import collections
import json
import os
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness
from benchmark.metrics import _spans
from benchmark.trace import Trace
from ptq4vit_tpu_torch import ServingEngine, quantize
from ptq4vit_tpu_torch.calib.calibrator import CalibReport
from ptq4vit_tpu_torch.configs import ptq4vit
from ptq4vit_tpu_torch.models import get_net, swin, vit
from ptq4vit_tpu_torch.models.registry import net_from_config
from ptq4vit_tpu_torch.ops import int8_serve, search_kernels
from ptq4vit_tpu_torch.utils import tracing
from ptq4vit_tpu_torch.utils.synthetic import (synthetic_images,
                                               synthetic_qstate)

TINY_VIT = vit.ViTConfig(name="tiny_vit", img_size=32, patch_size=8,
                         embed_dim=32, depth=2, num_heads=2, num_classes=10)
TINY_SWIN = swin.SwinConfig(name="tiny_swin", img_size=32, patch_size=2,
                            embed_dim=12, depths=(2, 2), num_heads=(2, 4),
                            window_size=4, num_classes=10)
MODELS = {"vit": (TINY_VIT, vit), "swin": (TINY_SWIN, swin)}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_net(model):
    cfg, mod = MODELS[model]
    return net_from_config(cfg, mod.init_params(cfg,
                                                np.random.default_rng(0)))


def images(n=4):
    return np.random.default_rng(1).standard_normal(
        (n, 3, 32, 32)).astype(np.float32)


def small_policy():
    cfg = ptq4vit()
    for kw in (cfg.ptqsl_conv2d_kwargs, cfg.ptqsl_linear_kwargs,
               cfg.ptqsl_matmul_kwargs):
        kw["eq_n"], kw["search_round"] = 4, 2
    return cfg


def ptq_spans(events):
    """{name: [(start, end)]} of the trace's ``ptq.*`` annotations."""
    out = collections.defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" \
                and e["name"].startswith("ptq."):
            out[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
    return out


def traced(fn, tmp_path):
    """Run ``fn`` under a CPU profiler; its ``ptq.*`` spans and result."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        result = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return ptq_spans(json.loads(path.read_text())["traceEvents"]), result


def inside(child, parent):
    return parent[0] <= child[0] and child[1] <= parent[1]


def counts(spans):
    return {k: len(v) for k, v in spans.items()}


def test_span_without_a_profiler_is_the_shared_noop(monkeypatch):
    made = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: made.append(name))
    assert tracing.span("ptq.serve.request") is tracing.span("ptq.x")
    with tracing.span("ptq.serve.request"):
        pass
    net = tiny_net("vit")
    ServingEngine(net, synthetic_qstate(net, ptq4vit()),
                  device="cpu")(images(2))
    assert made == []


def test_kernel_wrappers_keep_their_names_and_counters():
    for mod in (int8_serve, search_kernels):
        for fn in mod.KERNELS:
            assert getattr(mod, fn.__name__) is fn
            assert fn.__name__ in mod.launch_counts()
            assert isinstance(fn.launches, int)


@pytest.mark.parametrize("model", ["vit", "swin"])
def test_serving_request_spans(model, tmp_path):
    net = tiny_net(model)
    engine = ServingEngine(net, synthetic_qstate(net, ptq4vit()),
                           device="cpu")
    x = images(2)
    spans, out = traced(lambda: engine(x), tmp_path)
    assert out.shape == (2, 10)
    (req,) = spans["ptq.serve.request"]
    n_blocks = (TINY_VIT.depth if model == "vit"
                else sum(TINY_SWIN.depths))
    want = {"ptq.serve.request": 1, "ptq.serve.h2d": 1,
            "ptq.serve.forward": 1, "ptq.forward.prep": 1,
            "ptq.forward.embed": 1, "ptq.forward.block": n_blocks,
            "ptq.forward.head": 1}
    if model == "swin":
        want.update({"ptq.forward.geometry": n_blocks,
                     "ptq.forward.downsample": 1})
    got = counts(spans)
    kernels = {k: v for k, v in got.items() if k.startswith("ptq.kernel.")}
    assert {k: v for k, v in got.items() if k not in kernels} == want
    names = {f"ptq.kernel.{k}" for k in int8_serve.launch_counts()}
    assert kernels and set(kernels) <= names
    for name, ivs in spans.items():
        assert all(inside(iv, req) for iv in ivs), name
    (h2d,), (fwd,) = spans["ptq.serve.h2d"], spans["ptq.serve.forward"]
    assert h2d[1] <= fwd[0]
    for name in ["ptq.forward.block", "ptq.forward.geometry"] + \
            list(kernels):
        assert all(inside(iv, fwd) for iv in spans.get(name, [])), name
    # each block's geometry opens inside that block
    for iv in spans.get("ptq.forward.geometry", []):
        assert any(inside(iv, b) for b in spans["ptq.forward.block"])


@pytest.mark.cuda
def test_swin_request_forward_waits_for_nothing_on_the_card(tmp_path):
    """After warm-up a Swin-T/224 engine request (random weights, a
    synthetic qstate, 8 images) under ``torch.profiler``: no
    ``cudaStreamSynchronize`` or ``cudaMemcpy``, and no host-to-device
    ``cudaMemcpyAsync``, starts inside ``ptq.serve.forward``; B9 runs once
    a block on the engine's terms and the request builds no geometry."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    net = get_net("swin_tiny_patch4_window7_224", device="cuda")
    engine = ServingEngine(net, synthetic_qstate(net, ptq4vit()))
    x = synthetic_images(8, 224)
    engine(x).cpu()
    swin.reset_geometry_counts()
    int8_serve.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        assert engine(x).cpu().shape == (8, 1000)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    (fwd,) = ptq_spans(events)["ptq.serve.forward"]
    copies = {e["args"]["correlation"]: e["name"] for e in events
              if e.get("cat") == "gpu_memcpy" and "correlation" in
              e.get("args", {})}
    waits = [e["name"] for e in events
             if e.get("cat") == "cuda_runtime" and fwd[0] <= e["ts"] < fwd[1]
             and (e["name"] in ("cudaStreamSynchronize", "cudaMemcpy")
                  or e["name"] == "cudaMemcpyAsync" and "HtoD" in copies.get(
                      e.get("args", {}).get("correlation"), "HtoD"))]
    assert waits == []
    blocks = sum(net.cfg.depths)
    assert int8_serve.launch_counts()["fused_window_attention_qkv"] == blocks
    assert swin.geometry_counts() == {
        "index_builds": 0, "index_hits": 0, "mask_builds": 0, "mask_hits": 0,
        "term_builds": 0, "term_hits": blocks}


@pytest.mark.parametrize("model", ["vit", "swin"])
@pytest.mark.parametrize("scoring", ["exact", "int8_kernels"])
def test_calibration_job_spans(model, scoring, tmp_path):
    net = tiny_net(model)
    pol = small_policy()
    kw = ({} if scoring == "exact" else
          dict(int8_score=True, use_kernels=True))
    spans, (_, qstate, report) = traced(lambda: quantize(
        net, images(), config=pol, batch_size=2, device="cpu",
        return_report=True, **kw), tmp_path)
    assert report.device_allocs == 0
    (job,) = spans["ptq.calib.job"]
    for name, ivs in spans.items():
        assert all(inside(iv, job) for iv in ivs), name
    quantizers = collections.Counter(
        pol.op_policy(t).quantizer for _, t in net.op_inventory)
    assert {k[len("ptq.calib.search."):]: len(v) for k, v in spans.items()
            if k.startswith("ptq.calib.search.")} == dict(quantizers)
    assert len(qstate) == sum(quantizers.values())
    got = counts(spans)
    assert got["ptq.calib.plan"] == 1
    assert got["ptq.calib.capture"] == report.num_groups >= 1
    # two micro-batches of the four images a capture pass
    assert got["ptq.capture.forward"] == got["ptq.capture.backward"] \
        == 2 * report.num_groups
    rounds = pol.ptqsl_matmul_kwargs["search_round"]
    assert got["ptq.search.split"] == rounds * quantizers["sos_matmul"]
    assert got["ptq.search.init"] >= sum(quantizers.values())
    assert got["ptq.search.score"] >= rounds
    search = [iv for k, v in spans.items()
              if k.startswith("ptq.calib.search.") for iv in v]
    for name in ("ptq.search.init", "ptq.search.score", "ptq.search.split"):
        assert all(any(inside(iv, s) for s in search)
                   for iv in spans[name]), name
    kernels = {k for k in got if k.startswith("ptq.kernel.")}
    if scoring == "exact":
        assert not kernels
    else:
        want = {"linear_w_hessian_sims_i8", "linear_a_hessian_sims_i8"}
        for info in net.op_shapes.values():
            if info["kind"] == "matmul":
                folded = search_kernels.mm_fold_factor(
                    info["heads"], info["inner"], info["cols"]) > 1
                want.add("matmul_hessian_sims_b3f" if folded
                         else "matmul_hessian_sims_b3")
        assert kernels == {f"ptq.kernel.{k}" for k in want}


@pytest.mark.parametrize("model", ["vit", "swin"])
def test_profile_dir_trace_holds_the_calibrators_spans(model, tmp_path):
    net = tiny_net(model)
    spans, _ = traced(lambda: quantize(
        net, images(), config=small_policy(), batch_size=2,
        device="cpu"), tmp_path)
    quantize(net, images(), config=small_policy(), batch_size=2,
             device="cpu", profile_dir=str(tmp_path / "prof"))
    (path,) = (tmp_path / "prof").glob("calibration.*.json")
    written = ptq_spans(json.loads(path.read_text())["traceEvents"])
    # the job's span opens in quantize, before the calibrator's profiler
    want = {k: v for k, v in counts(spans).items() if k != "ptq.calib.job"}
    assert counts(written) == want


def test_calib_report_counts_no_device_allocs_off_the_card():
    assert CalibReport(model="m", config="c").device_allocs == 0


# -- the benchmark's readers on a hand-built trace ---------------------------

def ev(name, ts, dur, cat):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}


def serve_trace():
    """A 100 us window: two forward spans [10, 40] and [50, 90] over
    kernels [0, 20], [30, 35], [60, 95]; syncs at 15 and 55 (inside), 45
    and 92 (outside), an async copy at 20 (not a sync)."""
    events = [ev("bench.window", 0, 100, "user_annotation"),
              ev("ptq.serve.forward", 10, 30, "user_annotation"),
              ev("ptq.serve.forward", 50, 40, "user_annotation"),
              ev("k1", 0, 20, "kernel"), ev("k2", 30, 5, "kernel"),
              ev("k3", 60, 35, "kernel")]
    for t in (15, 45, 92):
        events.append(ev("cudaStreamSynchronize", t, 1, "cuda_runtime"))
    events.append(ev("cudaMemcpy", 55, 1, "cuda_runtime"))
    events.append(ev("cudaMemcpyAsync", 20, 1, "cuda_runtime"))
    return Trace(events)


def fake_run(tr, **records):
    return types.SimpleNamespace(trace=tr, records=records)


def test_spans_union_clips_merges_and_measures_idle():
    tr = Trace([ev("bench.window", 100, 100, "user_annotation"),
                ev("ptq.a", 90, 30, "user_annotation"),     # [100, 120]
                ev("ptq.a", 110, 20, "user_annotation"),    # overlaps
                ev("ptq.b", 125, 10, "user_annotation"),
                ev("ptq.a", 150, 70, "user_annotation"),    # [150, 200]
                ev("k", 115, 20, "kernel"), ev("k", 160, 10, "kernel")])
    spans = _spans.union(tr, "ptq.a")
    assert spans == [(100, 130), (150, 200)]
    assert _spans.union(tr, "ptq.a", "ptq.b") == [(100, 135), (150, 200)]
    assert _spans.length_s(spans) == pytest.approx(80e-6)
    # busy inside: [115, 130] and [160, 170]
    assert _spans.idle_s(tr, spans) == pytest.approx(55e-6)
    assert _spans.union(tr, "ptq.none") == []


def test_serve_forward_readers():
    run = fake_run(serve_trace(), traced_n=2)
    # idle in [10, 40]: [20, 30] and [35, 40]; in [50, 90]: [50, 60]
    assert harness.read_layer("serve_forward_idle_ms", run) == \
        pytest.approx(1e3 * 25e-6 / 2)
    assert harness.read_layer("serve_forward_syncs", run) == 1.0
    # a program without the spans (the parent) reports nothing
    bare = fake_run(Trace([ev("bench.window", 0, 100, "user_annotation"),
                           ev("k1", 0, 20, "kernel")]), traced_n=2)
    for name in ("serve_forward_idle_ms", "serve_forward_syncs"):
        assert harness.read_layer(name, bare) is None
        assert harness.read_layer(name, fake_run(None)) is None


def test_calibration_span_readers():
    tr = Trace([ev("bench.window", 0, 1000, "user_annotation"),
                ev("ptq.calib.capture", 100, 200, "user_annotation"),
                ev("ptq.calib.release", 250, 100, "user_annotation"),
                ev("ptq.calib.search.sos_matmul", 400, 100,
                   "user_annotation"),
                ev("ptq.calib.search.sos_matmul", 600, 50,
                   "user_annotation"),
                ev("ptq.calib.search.linear", 700, 100, "user_annotation"),
                ev("k", 120, 100, "kernel"), ev("k", 400, 100, "kernel")])
    run = fake_run(tr, traced_job=(0, 1, {}, None), jobs=[])
    # capture and release [100, 350], busy [120, 220]
    assert harness.read_layer("capture_idle_s", run) == pytest.approx(150e-6)
    assert harness.read_layer("search_sos_s", run) == pytest.approx(150e-6)
    bare = fake_run(Trace([ev("bench.window", 0, 10, "user_annotation")]),
                    traced_job=(0, 1, {}, None), jobs=[])
    for name in ("capture_idle_s", "search_sos_s"):
        assert harness.read_layer(name, bare) is None


def test_calib_device_allocs_reader():
    def job(allocs):
        rep = CalibReport(model="m", config="c")
        rep.device_allocs = allocs
        return (0.0, 1.0, {}, rep)
    run = fake_run(None, jobs=[job(10), job(20)], traced_job=job(99))
    assert harness.read_layer("calib_device_allocs", run) == 15.0
    run = fake_run(None, jobs=[], traced_job=job(7))
    assert harness.read_layer("calib_device_allocs", run) == 7.0
    # a report without the counter (the parent's) reports nothing
    old = types.SimpleNamespace(search_seconds={})
    run = fake_run(None, jobs=[(0.0, 1.0, {}, old)], traced_job=None)
    assert harness.read_layer("calib_device_allocs", run) is None


def test_benchmark_names_every_reader():
    bench = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
    names = {m["name"] for m in bench["per_layer"]}
    assert {"serve_forward_idle_ms", "serve_forward_syncs", "capture_idle_s",
            "search_sos_s", "calib_device_allocs"} <= names
