"""The plain reference against the port on small models on the CPU, the
control (the reference one precision lower) and the planted faults that
``correct`` has to catch, and the same readings at a cell's size on the
card."""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import harness, model
from benchmark.reference import calib as ref_calib
from benchmark.reference import serve as ref_serve
from benchmark.reference.models import op_kinds
from benchmark.tests.test_bench_harness import (TINY_CALIB, TINY_SERVE,
                                                TINY_SWIN, TINY_VIT,
                                                tiny_cell)
from benchmark.traffic import calib as calib_traffic

MODELS = {"vit": TINY_VIT, "swin": TINY_SWIN}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _calibrated(cfg, seed, cache="float32"):
    cell = tiny_cell("calib", cfg)
    cell.mix = dict(TINY_CALIB, cache_dtype=cache)
    run = harness.Run(cell, seed, 0.1, False, torch.device("cpu"), 0.0)
    calib_traffic.setup(run)
    return run, calib_traffic.job(run)[2]


@pytest.mark.parametrize("name", ["vit", "swin"])
def test_calibration_reference_is_the_port(name):
    """Every op of a small net: the reference's intervals are the port's,
    bit for bit, on float32 caches."""
    cfg = MODELS[name]
    run, qstate = _calibrated(cfg, 11)
    st, kinds = run.state, op_kinds(cfg)
    pol = ref_calib.Policy(run.mix)
    caches = ref_calib.capture(st["params"], cfg, st["images"], st["probe"],
                               list(kinds), micro=4,
                               cache_dtype=torch.float32)
    for n, k in kinds.items():
        r = ref_calib.search_op(k, caches[n], st["params"], n, pol,
                                torch.float32)
        p = model.plain_intervals(qstate[n])
        for f, v in r.items():
            if v is not None:
                assert torch.equal(p[f].reshape(v.shape), v), (n, f)


@pytest.mark.parametrize("name", ["vit", "swin"])
def test_serving_reference_is_the_ports_fake_quant(name):
    """The reference's served model is the port's fake-quant forward on
    the same weights and qstate (float32; the fused engine is judged by
    the cell's limits)."""
    cfg = MODELS[name]
    params = model.make_params(cfg, 5, "cpu")
    x = model.make_images(4, cfg, 5, "cpu")
    plain = model.serving_qstate(params, cfg, x)
    from ptq4vit_tpu_torch.models.registry import net_from_config
    net = net_from_config(model.port_config(cfg, "tiny"), params)
    ours = ref_serve.logits(params, cfg, plain, x)
    with torch.no_grad():
        port = net.apply(x, qstate=model.port_qstate(plain, cfg))
    assert ref_serve.judge(port, ours)["logit_rms"] < 1e-5


def test_calibration_control_is_not_correct():
    cell = tiny_cell("calib", TINY_VIT)
    result, compared, run = harness.run_cell(cell, 21, 0.2, False, "cpu",
                                             control=True)
    assert result["correct"]
    control = run.records["control"]
    assert any(control[k] > lim for k, lim in cell.limits.items())


def _faulty_calib_run(monkeypatch, fault):
    """A small ViT calibration cell with the timed path broken
    underneath: "unchanged" searches that return their start intervals,
    "half" the images left out (the capture's means over the rest),
    "altered" one op's weight interval scaled where it is produced,
    "step" every first-operand interval of one op kind (the q k^T
    matmuls) one candidate up."""
    from ptq4vit_tpu_torch.calib import calibrator, search
    if fault == "unchanged":
        for attr in ("search_linear", "search_matmul", "search_conv"):
            fn = getattr(search, attr)

            def stuck(*a, _fn=fn, _i=1 if attr == "search_matmul" else 3,
                      **k):
                a = list(a)
                a[_i] = dataclasses.replace(a[_i], search_round=0)
                return _fn(*a, **k)
            monkeypatch.setattr(search, attr, stuck)
    elif fault == "half":
        init = calibrator.HessianQuantCalibrator.__init__

        def half(self, net, cfg, calib_x, *a, probe_u=None, **k):
            n = len(calib_x) // 2
            init(self, net, cfg, np.asarray(calib_x)[:n], *a,
                 probe_u=None if probe_u is None else probe_u[:n], **k)
        monkeypatch.setattr(calibrator.HessianQuantCalibrator, "__init__",
                            half)
    elif fault == "step":
        from ptq4vit_tpu_torch.quant import fakequant as pfq
        fn = search.search_matmul

        def stepped(cap, policy, *a, **k):
            qp = fn(cap, policy, *a, **k)
            if qp.split is not None:
                return qp
            A = cap.inputs["a"].float()
            a0 = pfq.matmul_operand_interval_init(
                A, A.shape[1], 1, 1, pfq.qmax_for_bit(policy.a_bit))
            step = (policy.eq_beta - policy.eq_alpha) / policy.eq_n
            return dataclasses.replace(
                qp, A_interval=qp.A_interval
                + step * a0.reshape(qp.A_interval.shape))
        monkeypatch.setattr(search, "search_matmul", stepped)
    else:
        fn = search.search_linear

        def altered(*a, **k):
            qp = fn(*a, **k)
            return dataclasses.replace(qp, w_interval=qp.w_interval * 1.05)
        monkeypatch.setattr(search, "search_linear", altered)
    return harness.run_cell(tiny_cell("calib", TINY_VIT), 31, 0.2, False,
                            "cpu")


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered", "step"])
def test_calibration_faults_are_not_correct(monkeypatch, fault):
    result, compared, _ = _faulty_calib_run(monkeypatch, fault)
    assert not result["correct"], compared
    if fault == "step":
        # the one op kind's entries are a few of the sample's, but the
        # moved share of that op alone is read
        value, limit = compared["moved"]
        assert value > limit, compared


def _serve_limits():
    return harness.load_cell("vit_b384.serve32").limits


@pytest.mark.parametrize("fault", ["altered", "half"])
def test_serving_faults_are_not_correct(monkeypatch, fault):
    """The engine's answer altered where it is produced (one image's
    logits those of another image), or half of the batch left out (the
    other half's logits their mean)."""
    from ptq4vit_tpu_torch.parallel import serve
    call = serve.ServingEngine.__call__

    def broken(self, x):
        out = call(self, x).clone()
        if fault == "altered":
            out[0] = out[1]
        else:
            h = out.shape[0] // 2
            out[h:] = out[:h].float().mean(0).to(out.dtype)
        return out
    monkeypatch.setattr(serve.ServingEngine, "__call__", broken)
    cell = tiny_cell("serve", TINY_VIT, _serve_limits())
    result, compared, _ = harness.run_cell(cell, 41, 0.2, False, "cpu")
    assert not result["correct"], compared


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["vit_b384.calib32", "swin_b384.serve32",
                                  "swin_b384.calib32", "vit_b384.serve32"])
def test_control_at_cell_size_on_the_card(cell):
    """One seed of ``readings.py`` at the cell's own size: the program
    within every limit, the control beyond one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    root = harness.ROOT
    p = subprocess.run([sys.executable, "benchmark/readings.py",
                        "--workload", cell, "--seeds", "2147483711",
                        "--seconds", "1", "--warmup", "0"], cwd=root,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    row = json.loads(p.stdout.strip().splitlines()[-1])
    limits = harness.load_cell(cell).limits
    assert all(row["program"][k] <= v for k, v in limits.items())
    assert any(row["control"][k] > v for k, v in limits.items())
