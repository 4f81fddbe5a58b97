"""The port's experiment drivers (examples/torch_test_all.py,
torch_test_ablation.py, torch_get_int.py, torch_stability.py) against the
JAX package's (examples/test_all.py, test_ablation.py, get_int.py,
stability.py), on the CPU at the tiny MODEL_ZOO row of
tests/test_torch_examples.py, registered in both packages.

The grids are compared by running each script's own ``__main__`` with the
calibrator, the data and the evaluation replaced by recorders: the same
cells in the same order, each with the same QuantConfig field values
after its modifier, and the same JSON keys.  The integer export's weights
and intervals are bitwise JAX's on the same params and qstate, its keys
and dtypes JAX's; the stability study's calibration subsets are bitwise
JAX's.  Every comparison is exact (no tolerance) except the int
activations, which go through each package's own capture."""
import dataclasses
import json
import os
import runpy
import sys
import types
from argparse import Namespace

import numpy as np
import pytest
import torch
from PIL import Image

import ptq4vit_tpu.calib.calibrator as jcal
import ptq4vit_tpu_torch.calib.calibrator as pcal
from ptq4vit_tpu.models import registry as jreg
from ptq4vit_tpu_torch.models import registry as preg
from ptq4vit_tpu_torch.utils.convert import qstate_from_numpy
from tests.test_torch_examples import TINY_NAME, TINY_ROW
from tests.torch_port_helpers import (TINY, images, jax_net, minmax_qstate,
                                      port_net)

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "examples")
sys.path.insert(0, EXAMPLES)

import get_int as jgi  # noqa: E402
import stability as jst  # noqa: E402
import test_vit as jtv  # noqa: E402
import torch_get_int as pgi  # noqa: E402
import torch_stability as pst  # noqa: E402
import torch_test_ablation as pab  # noqa: E402
import torch_test_all as pta  # noqa: E402
import torch_test_vit as ptv  # noqa: E402

QUICK = ["--synthetic", "--quick", "--max_iteration", "1",
         "--calib_size", "8"]


@pytest.fixture
def tiny_zoo(monkeypatch):
    monkeypatch.setitem(preg.MODEL_ZOO, TINY_NAME, TINY_ROW)
    monkeypatch.setitem(jreg.MODEL_ZOO, TINY_NAME, TINY_ROW)


class Recorder:
    """Stands in for a package's HessianQuantCalibrator: records the
    config and the calibration images of each call, returns ``qstate``."""

    def __init__(self, log, qstate=None):
        self.log, self.qstate = log, qstate

    def __call__(self, net, quant_cfg, calib, *a, **kw):
        self.log.append((quant_cfg, np.array(calib, copy=True)))
        qstate = self.qstate
        return types.SimpleNamespace(
            batching_quant_calib=lambda verbose=False: qstate or {},
            report=types.SimpleNamespace(capture_seconds=0.0,
                                         search_seconds={}, num_groups=0),
            scratch_bounds={})


class FakeNet:
    params = {"head": {"weight": torch.zeros(1)}}


def run_grid(monkeypatch, capsys, script, helpers, calibrator_module):
    """Run ``script``'s ``__main__`` with recorders; returns [(model,
    calib_size, QuantConfig)] of its cells in order and its stdout rows."""
    built, calls = [], []
    monkeypatch.setattr(helpers, "parse_args", lambda *a, **k: Namespace(
        multiprocess=False, n_workers=1, max_iteration=None, quick=False,
        synthetic=True, device="cpu"))
    monkeypatch.setattr(helpers, "build_net_and_data",
                        lambda name, args, n: built.append((name, n)) or (
                            FakeNet(), [], np.zeros((n, 3, 1, 1),
                                                    np.float32)))
    monkeypatch.setattr(helpers, "test_classification",
                        lambda *a, **k: 0.0)
    monkeypatch.setattr(calibrator_module, "HessianQuantCalibrator",
                        Recorder(calls))
    runpy.run_path(os.path.join(EXAMPLES, script), run_name="__main__")
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]
    assert len(built) == len(calls) == len(rows)
    return [(n, c, cfg) for (n, c), (cfg, _) in zip(built, calls)], rows


@pytest.mark.parametrize("jax_script,port_script,cells", [
    ("test_all.py", "torch_test_all.py", 104),
    ("test_ablation.py", "torch_test_ablation.py", 48)],
    ids=["test_all", "test_ablation"])
def test_grid_equals_jax_cell_by_cell(monkeypatch, capsys, jax_script,
                                      port_script, cells):
    jcells, jrows = run_grid(monkeypatch, capsys, jax_script, jtv, jcal)
    pcells, prows = run_grid(monkeypatch, capsys, port_script, ptv, pcal)
    assert len(jcells) == len(pcells) == cells
    for (jn, jc, jcfg), (pn, pc, pcfg) in zip(jcells, pcells):
        assert (jn, jc) == (pn, pc)
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(pcfg), jn
    for jr, pr in zip(jrows, prows):
        assert list(jr) == list(pr)
        for k in jr:
            if k not in ("calib_minutes", "capture_seconds",
                         "search_seconds"):
                assert jr[k] == pr[k], k


def test_test_all_filters_keep_the_grid_order():
    args = ptv.parse_args(pta.grid_filters, argv=[
        "--names", "swin_base_patch4_window12_384", "vit_base_patch16_384",
        "--calib_sizes", "128"])
    full = pta.grid(ptv.parse_args(pta.grid_filters, argv=[]))
    part = pta.grid(args)
    key = [(c["name"], c["calib_size"], c["cfg_modifier"].bit_setting,
            c["config_name"]) for c in full]
    kept = [(c["name"], c["calib_size"], c["cfg_modifier"].bit_setting,
             c["config_name"]) for c in part]
    assert kept == [k for k in key if k[0] in (
        "vit_base_patch16_384", "swin_base_patch4_window12_384")
        and k[1] == 128]
    assert [k[0] for k in kept] == ["vit_base_patch16_384"] * 4 + [
        "swin_base_patch4_window12_384"] * 4


def test_test_all_cell_on_the_cpu(tiny_zoo, capsys):
    """One real cell (BasePTQ W6A6, hessian) through the port: the JSON
    line has test_all.py's keys, the qstate covers every op at 6 bits."""
    args = ptv.parse_args(pta.grid_filters, argv=QUICK + ["--device", "cpu"])
    out = pta.test_all(TINY_NAME, pta.CfgModifier(
        linear_ptq_setting=(1, 1, 1), metric="hessian", bit_setting=(6, 6)),
        calib_size=8, config_name="BasePTQ", args=args)
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]
    assert list(rows[-1]) == ["model", "config", "calib_size", "w_bit",
                              "linear_kwargs", "calib_minutes",
                              "capture_seconds", "search_seconds", "top1"]
    assert rows[-1]["w_bit"] == 6 and rows[-1]["config"] == "BasePTQ"
    assert rows[-1]["linear_kwargs"]["metric"] == "hessian"
    assert out["peak_gib"] is None
    assert set(out["qstate"]) == {n for n, _ in out["net"].op_inventory}
    assert out["qstate"]["blocks.0.mlp.fc1"].w_bit == 6


def test_ablation_cell_on_the_cpu(tiny_zoo, capsys):
    args = ptv.parse_args(argv=QUICK + ["--device", "cpu"])
    out = pab.test_all_ablation(TINY_NAME, pab.CfgModifier(
        linear_ptq_setting=(1, 1, 1), metric="hessian", search_round=3,
        bit_setting=(8, 8), no_softmax=True, no_postgelu=True),
        calib_size=8, args=args)
    row = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert row == {k: out[k] for k in row}
    assert (row["no_softmax"], row["no_postgelu"], row["metric"]) == \
        (True, True, "hessian")
    q = out["qstate"]
    assert not q["blocks.0.mlp.fc2"].postgelu
    assert q["blocks.0.attn.matmul2"].split is None        # no SoS


def _record_cell(name, cfg_modifier, calib_size, config_name, args):
    # the experiment body of the worker test: the cell it was given
    with open(args.record, "a") as f:
        f.write(f"{name} {calib_size} {cfg_modifier.bit_setting} "
                f"{config_name} {os.environ['CUDA_VISIBLE_DEVICES']}\n")


def test_multiprocess_on_one_card_runs_the_cells_in_order(tmp_path,
                                                          monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3")
    args = ptv.parse_args(pta.grid_filters, argv=[
        "--multiprocess", "--names", "vit_base_patch16_384",
        "deit_base_patch16_384"])
    args.record = str(tmp_path / "cells.txt")
    cells = pta.grid(args)
    ptv.multiprocess(_record_cell, cells, n_workers=1)
    assert (tmp_path / "cells.txt").read_text().splitlines() == [
        f"{c['name']} {c['calib_size']} {c['cfg_modifier'].bit_setting} "
        f"{c['config_name']} 3" for c in cells]


def test_get_int_keys_and_dtypes_are_jax_s(tiny_zoo, tmp_path):
    """Both packages' scripts end to end (quick calibrations of their own):
    the same keys, dtypes and shapes."""
    jargs = Namespace(**vars(ptv.parse_args(argv=QUICK)))
    pargs = ptv.parse_args(argv=QUICK + ["--device", "cpu"])
    jpath = jgi.get_int_weights(TINY_NAME, args=jargs,
                                out_dir=str(tmp_path / "j"),
                                activations=True)
    ppath = pgi.get_int_weights(TINY_NAME, args=pargs,
                                out_dir=str(tmp_path / "p"),
                                activations=True)
    assert os.path.basename(jpath) == os.path.basename(ppath)
    with np.load(jpath) as j, np.load(ppath) as p:
        assert sorted(j.files) == sorted(p.files)
        assert {k.split(":")[0] for k in p.files} == {"weight", "interval",
                                                      "act"}
        for k in j.files:
            assert (j[k].dtype, j[k].shape) == (p[k].dtype, p[k].shape), k


def test_get_int_weights_and_intervals_are_jax_s_bitwise(monkeypatch,
                                                         tmp_path):
    """On the same params (carried across by convert.py) and the same
    qstate, the two scripts' files: weights and intervals bitwise, int
    activations (each package's own capture) the same dtypes, a level
    apart at most and in at most 1% of the elements."""
    jnet = jax_net(TINY)
    pnet = port_net(jnet)
    x = images(8, TINY["img_size"])
    jq = minmax_qstate(jnet, x)
    pq = qstate_from_numpy(jq)
    for mod, net, cal, q in ((jgi, jnet, jcal, jq), (pgi, pnet, pcal, pq)):
        monkeypatch.setattr(mod, "build_net_and_data",
                            lambda name, args, n, _net=net: (_net, None, x))
        monkeypatch.setattr(cal, "HessianQuantCalibrator", Recorder([], q))
    args = Namespace(quick=False, calib_size=8)
    jpath = jgi.get_int_weights("t", args=args, out_dir=str(tmp_path / "j"),
                                activations=True)
    ppath = pgi.get_int_weights("t", args=args, out_dir=str(tmp_path / "p"),
                                activations=True)
    with np.load(jpath) as j, np.load(ppath) as p:
        assert sorted(j.files) == sorted(p.files)
        assert any(k.startswith("weight:") for k in j.files)
        for k in j.files:
            assert j[k].dtype == p[k].dtype and j[k].shape == p[k].shape, k
            if not k.startswith("act:"):
                np.testing.assert_array_equal(p[k], j[k], err_msg=k)
                continue
            d = np.abs(p[k].astype(np.int32) - j[k].astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() <= 0.01, k


@pytest.fixture(scope="module")
def image_folder(tmp_path_factory):
    """train/ and val/, 2 classes, 6 and 2 JPEGs a class, seeded pixels."""
    root = tmp_path_factory.mktemp("imagenet")
    rng = np.random.default_rng(11)
    for split, n in (("train", 6), ("val", 2)):
        for cls in ("n01", "n02"):
            d = root / split / cls
            d.mkdir(parents=True)
            for i in range(n):
                h, w = (40, 52) if i % 2 else (52, 40)
                Image.fromarray((rng.random((h, w, 3)) * 255).astype(
                    np.uint8)).save(d / f"img{i}.jpg", quality=90)
    return str(root)


@pytest.mark.parametrize("synthetic", [True, False],
                         ids=["synthetic", "image-folder"])
def test_stability_subsets_are_jax_s(tiny_zoo, monkeypatch, image_folder,
                                     synthetic, capsys):
    argv = ["--calib_size", "4", "--max_iteration", "1",
            "--dataset_root", image_folder] + (["--synthetic"] if synthetic
                                               else [])
    subsets = {}
    for mod, cal, extra in ((jst, jcal, []), (pst, pcal, ["--device",
                                                          "cpu"])):
        log = []
        monkeypatch.setattr(cal, "HessianQuantCalibrator", Recorder(log))
        monkeypatch.setattr(mod, "test_classification",
                            lambda *a, **k: 0.5)
        args = Namespace(**vars(ptv.parse_args(argv=argv + extra)))
        assert mod.stability(TINY_NAME, seeds=2, args=args) == [0.5, 0.5]
        subsets[mod.__name__] = [c for _, c in log]
    jsub, psub = subsets["stability"], subsets["torch_stability"]
    assert len(jsub) == len(psub) == 2
    for a, b in zip(jsub, psub):
        assert a.dtype == b.dtype == np.float32 and a.shape == (4, 3, 32, 32)
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(psub[0], psub[1])
    assert "mean 0.5000 std 0.0000" in capsys.readouterr().out


def test_stability_on_the_cpu(tiny_zoo, capsys):
    """The port's study end to end: two quick calibrations, mean and std
    of top-1 (random weights: it says nothing of accuracy)."""
    args = ptv.parse_args(argv=QUICK + ["--device", "cpu"])
    accs = pst.stability(TINY_NAME, seeds=2, args=args)
    assert len(accs) == 2 and all(0.0 <= a <= 1.0 for a in accs)
    out = capsys.readouterr().out
    assert "seed 0:" in out and "seed 1:" in out and "mean " in out
