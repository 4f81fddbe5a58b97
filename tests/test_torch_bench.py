"""The port's benchmark scripts on the CPU, at the tiny MODEL_ZOO row of
tests/test_torch_examples.py: ``bench_torch.py`` (the stdout contract,
bench.py's metric names, failures that end in a null row and a non-zero
exit), ``bench_infer_torch.py`` (bench_infer.py's modes minus the relaxed
one, finite logits) and ``scripts/torch_serve_e2e_bench.py`` (the uint8
route's logits bitwise the float route's).  Times from these runs are CPU
times and are checked for nothing but their presence."""
import io
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench_infer_torch as bi
import bench_torch as bt
from ptq4vit_tpu_torch.models import registry as preg
from ptq4vit_tpu_torch.quant.fakequant import exact_div
from tests.test_torch_examples import TINY_NAME, TINY_ROW

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import torch_serve_e2e_bench as se  # noqa: E402

CPU = {"BENCH_MODEL": TINY_NAME, "BENCH_DEVICE": "cpu"}
FINAL_KEYS = {"metric", "value", "unit", "vs_baseline", "median",
              "median_vs_baseline", "warm_minutes", "capture_s", "search_s",
              "target_s", "sync_s", "setup_s", "other_s", "overlap_s",
              "num_groups", "all_minutes", "peak_gib", "build_s", "card",
              "device"}


@pytest.fixture
def tiny_zoo(monkeypatch):
    monkeypatch.setitem(preg.MODEL_ZOO, TINY_NAME, TINY_ROW)


def lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.strip()]


def test_bench_torch_prints_interim_then_final_row(tiny_zoo):
    out, err = io.StringIO(), io.StringIO()
    rc, row, qstate = bt.run(dict(CPU, BENCH_CALIB="8"), out, err)
    rows = lines(out.getvalue())
    assert rc == 0 and len(rows) == 2
    first, last = rows
    assert first["interim"] and first["startup"] and first["value"] is None
    assert last == row and set(last) == FINAL_KEYS
    assert last["metric"] == first["metric"] == \
        f"ptq4vit_calib_minutes_{TINY_NAME}_8imgs"
    runs = lines(err.getvalue())
    assert [r["run"] for r in runs] == [1, 2]
    assert last["all_minutes"] == [r["value"] for r in runs]
    assert last["value"] == min(last["all_minutes"])
    # the median is over the repeats after the first
    assert last["warm_minutes"] == last["all_minutes"][1:] == \
        [last["median"]]
    assert last["device"] == "cpu" and last["card"] is None
    assert last["peak_gib"] is None and last["vs_baseline"] is None
    wall = last["value"] * 60
    phases = last["capture_s"] + last["search_s"] + last["target_s"] \
        + last["sync_s"]
    assert last["other_s"] == pytest.approx(max(0.0, wall - phases))
    assert last["overlap_s"] == pytest.approx(max(0.0, phases - wall))
    net = preg.get_net(TINY_NAME, device="cpu")
    assert set(qstate) == {n for n, _ in net.op_inventory}
    for qp in qstate.values():
        for v in vars(qp).values():
            if torch.is_tensor(v):
                assert v.device.type == "cpu"
                assert torch.isfinite(v).all() and (v > 0).all()


def bench_py_metric(env):
    """bench.py's metric name for ``env``: its startup line, printed before
    any JAX import; an injected hang and a short watchdog end it."""
    full = {k: v for k, v in os.environ.items()
            if not k.startswith("BENCH_")}
    full.update(env, BENCH_TEST_HANG_S="60", BENCH_HARD_TIMEOUT_S="0.2")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "bench.py")],
                          capture_output=True, text=True, timeout=60,
                          env=full, cwd=REPO)
    first = lines(proc.stdout)[0]
    assert first["startup"]
    return first["metric"]


@pytest.mark.parametrize("env", [
    {},
    {"BENCH_MODEL": "swin_base_patch4_window12_384", "BENCH_CALIB": "128"},
    {"BENCH_CONFIG": "BasePTQ", "BENCH_BITS": "6,6"},
    {"BENCH_METRIC": "config", "BENCH_SEQUENTIAL": "1"},
    {"BENCH_CACHE_DTYPE": "bfloat16", "BENCH_REPEATS": "3"},
], ids=["default", "swin128", "baseptq-w6a6", "config-sequential",
        "bf16-cache"])
def test_bench_torch_metric_name_is_bench_py_s(env):
    assert bt.metric_name(bt.knobs(env)) == bench_py_metric(env)


def test_bench_torch_own_knobs_and_baselines():
    """The port's suffixes, and the reference's minutes as bench.py has
    them."""
    import bench
    assert bt._BASELINES == bench._BASELINES
    k = bt.knobs({"PTQ4VIT_TPU_INT8_SCORE": "0"})
    assert k.exact and bt.metric_name(k).endswith("_32imgs_exact")
    assert bt.baseline_minutes(k) == 12.0      # the reference scores fp32
    k = bt.knobs({"BENCH_DEVICE": "cpu"})
    assert bt.metric_name(k) == bt.metric_name(bt.knobs({}))
    assert k.device == "cpu" and bt.baseline_minutes(k) == 12.0
    assert bt.baseline_minutes(bt.knobs({"BENCH_BITS": "6,6"})) is None
    assert bt.knobs({}) == bt.Knobs()
    with pytest.raises(ValueError, match="BENCH_BITS"):
        bt.knobs({"BENCH_BITS": "8"})


@pytest.mark.parametrize("env", [
    {"BENCH_MODEL": "no_such_model", "BENCH_DEVICE": "cpu"},
    {"BENCH_DEVICE": "cuda"},            # no card here: never the CPU
], ids=["unknown-model", "no-card"])
def test_bench_torch_failure_is_a_null_row_and_nonzero_exit(env):
    full = {k: v for k, v in os.environ.items()
            if not k.startswith("BENCH_")}
    full.update(env, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, os.path.join(REPO,
                                                        "bench_torch.py")],
                          capture_output=True, text=True, timeout=120,
                          env=full, cwd=REPO)
    rows = lines(proc.stdout)
    assert proc.returncode != 0
    assert rows[0]["startup"] and rows[0]["interim"]
    assert rows[-1]["value"] is None and rows[-1]["error"]
    assert rows[-1]["metric"] == rows[0]["metric"]
    assert ("unknown model" in rows[-1]["error"]) == ("BENCH_MODEL" in env)


def test_bench_torch_a_failed_repeat_fails_the_run(tiny_zoo, monkeypatch):
    """A repeat that raises ends the run in a null row; it does not drop
    out of the median."""
    real = bt.one_run
    calls = []

    def flaky(*a):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("out of memory")
        return real(*a)
    monkeypatch.setattr(bt, "one_run", flaky)
    out, err = io.StringIO(), io.StringIO()
    rc, row, qstate = bt.run(dict(CPU, BENCH_CALIB="4", BENCH_REPEATS="3"),
                             out, err)
    assert rc == 1 and qstate is None and len(calls) == 2
    assert lines(out.getvalue())[-1] == row
    assert row["value"] is None and "run 2" in row["error"]
    assert "out of memory" in row["error"] and len(row["all_minutes"]) == 1
    assert lines(err.getvalue())[-1]["run"] == 2


def bench_infer_py_keys():
    """The img/s keys of bench_infer.py's JSON line, read from its
    source."""
    with open(os.path.join(REPO, "bench_infer.py")) as fh:
        return set(re.findall(r'"(\w+)": round\(', fh.read()))


@pytest.mark.parametrize("bits", [8, 6])
def test_bench_infer_torch_modes_and_finite_logits(tiny_zoo, bits, capsys):
    rc, row, logits = bi.run(dict(CPU, BENCH_BS="4", BENCH_ITERS="1",
                                  BENCH_BITS=str(bits)))
    assert rc == 0 and lines(capsys.readouterr().out) == [row]
    jax_keys = bench_infer_py_keys()
    assert "int8_fused_relaxed_bf16" in jax_keys and \
        "int8_fused_relaxed_bf16" in row
    assert set(row) == jax_keys | {"metric", "unit", "card", "device"}
    assert set(logits) == set(bi.MODES)
    for mode, lg in logits.items():
        assert lg.shape == (4, 1000) and torch.isfinite(lg.float()).all(), \
            mode
        assert row[mode] > 0
    assert row["int8_fused_vs_bf16"] == row["int8_fused_bf16"] / row["bf16"]
    assert row["metric"] == f"infer_images_per_s_{TINY_NAME}_bs4" + (
        "_w6a6" if bits == 6 else "")


def test_serve_e2e_u8_route_equals_f32_route(tiny_zoo, capsys):
    rc, row, logits = se.run(dict(CPU, BENCH_BS="4", BENCH_NBATCH="3"))
    assert rc == 0 and lines(capsys.readouterr().out) == [row]
    assert set(se.MODES) <= set(row) and row["u8_equals_f32"] is True
    assert row["u8_pipe_vs_f32_sync"] == row["u8_pipe"] / row["f32_sync"]
    for mode in se.MODES:
        assert len(logits[mode]) == 3
        assert all(o.dtype == torch.bfloat16 and o.shape == (4, 1000)
                   for o in logits[mode])
    for a, b in (("u8_sync", "f32_sync"), ("u8_pipe", "f32_pipe"),
                 ("f32_pipe", "f32_sync")):
        for x, y in zip(logits[a], logits[b]):
            assert torch.equal(x, y), (a, b)
    # distinct batches; the host normalization is the engine's on the
    # device, bit for bit (true divisions)
    net = preg.get_net(TINY_NAME, device="cpu")
    u8, f32 = se.batches(net.data_config, 4, 3, 32)
    assert not np.array_equal(u8[0], u8[1])
    mean = torch.full((1, 3, 1, 1), TINY_ROW["mean"][0])
    std = torch.full((1, 3, 1, 1), TINY_ROW["std"][0])
    dev = exact_div(exact_div(torch.from_numpy(u8[2]).float(), 255.0)
                    - mean, std)
    assert torch.equal(dev, torch.from_numpy(f32[2]))


def test_bench_scripts_fail_without_a_card(monkeypatch, capsys):
    """With no card and no BENCH_DEVICE=cpu, each script fails."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for mod in (bi, se):
        rc, row, _ = mod.run({})
        assert rc == 1 and row["value"] is None
        assert "no CUDA device" in row["error"]
