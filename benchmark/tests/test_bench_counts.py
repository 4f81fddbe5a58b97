"""The benchmark's work counts against hand-worked shapes, the readers'
arithmetic on made-up traces, and what the harness and the reference
import."""
import ast
import os

import pytest

from benchmark import counts
from benchmark.trace import Trace

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

VIT_B384 = dict(kind="vit", img_size=384, patch_size=16, embed_dim=768,
                depth=12, num_heads=12, mlp_ratio=4.0, num_classes=1000)
SWIN_B384 = dict(kind="swin", img_size=384, patch_size=4, embed_dim=128,
                 depths=[2, 2, 18, 2], num_heads=[4, 8, 16, 32],
                 window_size=12, mlp_ratio=4.0, num_classes=1000)
TINY = dict(kind="vit", img_size=32, patch_size=16, embed_dim=8, depth=1,
            num_heads=2, mlp_ratio=4.0, num_classes=10)


def test_vit_b384_forward_by_hand():
    N, d = 577, 768
    linears = N * d * (3 * d + d + 4 * d + 4 * d)          # qkv proj fc1 fc2
    attention = 2 * 12 * N * 64 * N                         # q k^T and p v
    block = linears + attention
    patch = 576 * 768 * 768
    head = 768 * 1000
    assert counts.forward_flops(VIT_B384) == 2 * (12 * block + patch + head)
    # about 111 G int8 operations an image
    assert abs(counts.serve_work(VIT_B384, 1)["int8"] / 1e9 - 111.0) < 0.1


def test_swin_b384_shapes():
    ops = counts.op_shapes(SWIN_B384)
    by = {o["name"]: o for o in ops}
    assert len(ops) == 149
    m = by["layers.0.blocks.1.attn.matmul1"]
    assert (m["S"], m["G"], m["R"], m["Ci"], m["Co"]) == (64, 4, 144, 32, 144)
    m = by["layers.3.blocks.0.attn.matmul2"]               # one window
    assert (m["S"], m["G"], m["R"], m["Ci"], m["Co"]) == (1, 32, 144, 144, 32)
    r = by["layers.2.downsample.reduction"]
    assert (r["T"], r["ic"], r["oc"]) == (144, 2048, 1024)


def test_tiny_calibration_work_by_hand():
    # one block, N = 4 + 1 tokens, d = 8, 2 heads of 4, 2 images
    n, N, d, P, R = 2, 5, 8, 100, 3
    w = counts.calib_work(TINY, n, eq_n=P, rounds=R)["search"]
    lin = N * d * (3 * d + d + 4 * d + 4 * d) * n           # MACs a side
    mm = 2 * N * 4 * N * n                                  # q k^T, 2 heads
    int8 = R * 2 * P * 2 * lin + R * 2 * P * 2 * mm + R * P * 2 * mm \
        + R * 2 * P * 2 * (d * 10 * n)                      # head
    assert w["int8"] == int8
    patch = 4 * 768 * 8 * n
    fp32 = 2 * (lin + 2 * mm + d * 10 * n + patch) + R * 20 * 2 * mm \
        + R * P * 2 * patch
    assert w["fp32"] == fp32
    assert w["least_s"] >= counts.peak_seconds(w) * 0.999


def test_least_and_peak_seconds():
    work = {"int8": 1979e12, "fp32": 67e12, "bytes": 3.35e12}
    assert counts.peak_seconds(work) == pytest.approx(2.0)
    assert counts.least_seconds(work) == pytest.approx(2.0)
    assert counts.least_seconds({"bytes": 6.7e12}) == pytest.approx(2.0)


def _trace(device, spans=(), window=(0.0, 100.0), host=()):
    ev = [{"ph": "X", "cat": c, "name": n, "ts": s, "dur": e - s}
          for s, e, n, c in device]
    ev += [{"ph": "X", "cat": "user_annotation", "name": n, "ts": s,
            "dur": e - s} for n, s, e in spans]
    ev += [{"ph": "X", "cat": "user_annotation", "name": "bench.window",
            "ts": window[0], "dur": window[1] - window[0]}]
    ev += [{"ph": "X", "cat": "cpu_op", "name": n, "ts": s, "dur": e - s}
           for n, s, e in host]
    return Trace(ev)


def test_trace_busy_union_and_idle_gaps():
    tr = _trace([(10, 30, "void k1<int>(int)", "kernel"),
                 (20, 40, "k2", "kernel"),
                 (60, 70, "Memcpy HtoD", "gpu_memcpy")],
                host=[("aten::copy_", 40, 60), ("cudaSync", 75, 100)])
    assert tr.busy_s() == pytest.approx(40e-6)
    assert tr.window_s() == pytest.approx(100e-6)
    ops = dict(tr.device_ops())
    assert ops["k1<int>"] == pytest.approx(20e-6)
    gaps = dict(tr.idle_gaps())
    assert gaps["aten::copy_"] == pytest.approx(20e-6)
    assert gaps["cudaSync"] == pytest.approx(30e-6)
    assert gaps["no host event"] == pytest.approx(10e-6)


def test_trace_span_attribution():
    tr = _trace([(10, 20, "a", "kernel"), (35, 50, "b", "kernel"),
                 (80, 90, "c", "kernel")],
                spans=[("bench.search", 5, 40), ("bench.search", 75, 85)])
    names = [e[2] for e in tr.in_spans("bench.search")]
    assert names == ["a", "b", "c"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources(sub=""):
    for dp, _, fs in os.walk(os.path.join(HERE, sub)):
        for f in fs:
            if f.endswith(".py"):
                yield os.path.join(dp, f)


@pytest.mark.parametrize("forbidden,sub", [
    (("jax", "jaxlib", "flax", "ptq4vit_tpu"), ""),
    (("jax", "jaxlib", "flax", "ptq4vit_tpu", "ptq4vit_tpu_torch"),
     "reference")])
def test_imports_by_top_level_name(forbidden, sub):
    bad = [(p, m) for p in _sources(sub) for m in _imports(p)
           if m.split(".")[0] in forbidden]
    assert not bad
