"""Port searches (search_linear / search_matmul / search_conv) against the
JAX package's searches on the same captured caches, in two modes:

  fp32: the CPU defaults on both sides (the JAX XLA branches, the port's
        plain fp32 branches);
  int8: the JAX side with PTQ4VIT_TPU_PALLAS=1 and PTQ4VIT_TPU_INT8_SCORE=1
        (read at call time, search.py:494) — the Pallas int8 scorers in
        interpret mode — and the port with int8_score=True,
        use_kernels=True on CPU tensors, i.e. the kernels' plain versions.

Intervals must be equal (rtol 1e-5), or both picks proven fp-degenerate
argmax ties by the f64 oracles of tests/test_reference_goldens.py.  The net
is wide enough (embed 128) for every JAX Pallas linear scorer to engage.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from ptq4vit_tpu.calib import search as jsearch
from ptq4vit_tpu.calib.capture import capture as jcapture
from ptq4vit_tpu.configs import ptq4vit as jptq4vit
from ptq4vit_tpu_torch.calib import search as psearch
from ptq4vit_tpu_torch.calib.calibrator import params_for_op
from ptq4vit_tpu_torch.calib.capture import OpCapture
from ptq4vit_tpu_torch.configs import ptq4vit as pptq4vit
from tests.torch_port_helpers import (WIDE, assert_qstate_matches,
                                      bits_meta, golden_view, images,
                                      jax_net, np_fields, shrink)

KINDS = {"conv": ("qconv",),
         "linear": ("qlinear_qkv", "qlinear_proj", "qlinear_MLP_1",
                    "qlinear_MLP_2", "qlinear_classifier"),
         "matmul": ("qmatmul_qk", "qmatmul_scorev")}


@pytest.fixture(scope="module")
def setup():
    jnet = jax_net(WIDE)
    caps = jcapture(jnet, images(4, 32), batch_size=2, need_grad=True,
                    probe_sigma=1e-1)
    params = jax.tree.map(np.asarray, jnet.params)
    return jnet, params, caps


def port_cap(cap, with_out=True):
    return OpCapture(kind=cap.kind,
                     inputs={k: torch.from_numpy(np.array(v))
                             for k, v in cap.inputs.items()},
                     out=torch.from_numpy(np.array(cap.out))
                     if with_out else None,
                     grad=torch.from_numpy(np.array(cap.grad)))


@pytest.mark.parametrize("kind", ["linear", "matmul", "conv"])
@pytest.mark.parametrize("mode", ["fp32", "int8"])
def test_search_matches_jax(setup, monkeypatch, mode, kind):
    jnet, params, caps = setup
    int8 = mode == "int8"
    flag = "1" if int8 else "0"
    monkeypatch.setenv("PTQ4VIT_TPU_PALLAS", flag)
    monkeypatch.setenv("PTQ4VIT_TPU_INT8_SCORE", flag)
    # the unfolded _mm_kernel body (B3) at this shape; the folded body
    # (B3f) is held in tests/test_torch_swin_search.py
    monkeypatch.setenv("PTQ4VIT_TPU_MM_FOLD", "1")
    jcfg = shrink(jptq4vit())
    pcfg = shrink(pptq4vit())
    ops = [(n, t) for n, t in jnet.op_inventory if t in KINDS[kind]]
    jq, pq = {}, {}
    for name, mtype in ops:
        cap = caps[name]
        jpol, ppol = jcfg.op_policy(mtype), pcfg.op_policy(mtype)
        assert dataclasses.asdict(jpol) == dataclasses.asdict(ppol)
        if kind == "matmul":
            # the JAX Pallas matmul scorer recomputes raw = A@B itself
            jcap = (type(cap)(kind=cap.kind, inputs=cap.inputs, out=None,
                              grad=cap.grad) if int8 else cap)
            jq[name] = jsearch.search_matmul(jcap, jpol)
            pq[name] = psearch.search_matmul(
                port_cap(cap, with_out=not int8), ppol, int8_score=int8,
                use_kernels=int8)
            continue
        w, b = (np.array(a) for a in params_for_op(params, name))
        if kind == "conv":
            jq[name] = jsearch.search_conv(w, b, cap, jpol)
            pq[name] = psearch.search_conv(torch.from_numpy(w),
                                           torch.from_numpy(b),
                                           port_cap(cap), ppol)
        else:
            jq[name] = jsearch.search_linear(w, b, cap, jpol)
            pq[name] = psearch.search_linear(
                torch.from_numpy(w), torch.from_numpy(b), port_cap(cap),
                ppol, int8_score=int8, use_kernels=int8)
    mods = {n: np_fields(q) for n, q in jq.items()}
    z = golden_view(params, {n: caps[n] for n, _ in ops}, mods,
                    WIDE["patch_size"])
    kws = {"conv": jcfg.ptqsl_conv2d_kwargs,
           "linear": jcfg.ptqsl_linear_kwargs,
           "matmul": jcfg.ptqsl_matmul_kwargs}
    assert_qstate_matches(pq, mods, z, bits_meta(jcfg, WIDE["patch_size"]),
                          ops, kws)


def test_cuda_paths_refuse_plain_scoring():
    """On the card a case the JAX package scores in a Pallas kernel scores
    only through the port's kernel (asking for plain scoring raises); a
    case JAX runs as XLA code is plain torch on any device; on the CPU a
    kernel case runs the kernel's plain version when asked."""
    dev = torch.device("cuda")
    with pytest.raises(NotImplementedError):
        psearch._scorer(dev, False, True, "linear weight")
    assert psearch._scorer(dev, True, True, "linear weight")
    assert not psearch._scorer(dev, False, False, "linear input")
    assert not psearch._scorer(dev, True, False, "matmul")
    cpu = torch.device("cpu")
    assert not psearch._scorer(cpu, False, True, "linear weight")
    assert psearch._scorer(cpu, True, True, "linear weight")
    assert not psearch._scorer(cpu, True, False, "matmul")
    assert psearch._defaults(cpu, None, None) == (False, False)
    assert psearch._defaults(dev, None, None) == (True, True)


class _NoCall:
    """A kernel wrapper stand-in that records the kernel each search case
    picks, returning the plain version's sims (the wrapper's own
    ``scratch_bound`` is not the plain version's)."""

    def __init__(self, name, fn):
        self.name, self.fn = name, fn

    def __call__(self, *a, scratch_bound=None, **k):
        _NoCall.calls.append(self.name)
        return self.fn(*a, **k)


@pytest.mark.parametrize("metric,grid,int8,expect", [
    # hessian, n_H = n_a = 1: B1 + B2 with int8 scoring, B4w + B4a exact
    ("hessian", (1, 1, 1), True, {"B1", "B2"}),
    ("hessian", (1, 1, 1), False, {"B4w", "B4a"}),
    # n_a > 1: the weight side keeps a kernel (B4w even with int8 scoring,
    # the input scale no longer factors out); the input side is plain
    ("hessian", (1, 1, 2), True, {"B4w"}),
    # n_H > 1: the input side keeps a kernel (B4a), the weight side plain
    ("hessian", (1, 2, 1), True, {"B4a"}),
    ("cosine", (1, 1, 1), True, set()),
])
def test_linear_dispatch_rule(setup, monkeypatch, metric, grid, int8,
                              expect):
    """Which scorer each linear case takes (search.py:250-263, :347-362),
    recorded on CPU tensors through the plain versions."""
    jnet, params, caps = setup
    name = "blocks.0.mlp.fc1"
    for attr, tag in (("linear_w_hessian_sims_i8", "B1"),
                      ("linear_a_hessian_sims_i8", "B2"),
                      ("linear_w_hessian_sims", "B4w"),
                      ("linear_a_hessian_sims", "B4a")):
        monkeypatch.setattr(psearch.K, attr,
                            _NoCall(tag, getattr(psearch.K, attr + "_ref")))
    _NoCall.calls = []
    cfg = shrink(pptq4vit())
    cfg.ptqsl_linear_kwargs.update(metric=metric, n_V=grid[0], n_H=grid[1],
                                   n_a=grid[2])
    w, b = (torch.from_numpy(np.array(a)) for a in params_for_op(params,
                                                                  name))
    psearch.search_linear(w, b, port_cap(caps[name]),
                          cfg.op_policy("qlinear_MLP_1"), int8_score=int8,
                          use_kernels=True)
    assert set(_NoCall.calls) == expect
