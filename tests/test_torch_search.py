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
    """On the card the linear and matmul searches score only through the
    kernels; asking for anything else raises instead of running plain
    torch there."""
    dev = torch.device("cuda")
    with pytest.raises(NotImplementedError):
        psearch._kernel_path(dev, False, True, True, "linear")
    with pytest.raises(NotImplementedError):
        psearch._kernel_path(dev, True, False, True, "matmul")
    with pytest.raises(NotImplementedError):
        psearch._kernel_path(dev, True, True, False, "linear")
    assert psearch._kernel_path(dev, True, True, True, "linear")
    cpu = torch.device("cpu")
    assert not psearch._kernel_path(cpu, False, False, True, "linear")
    assert psearch._kernel_path(cpu, True, True, True, "linear")
    assert psearch._defaults(cpu, None, None) == (False, False)
    assert psearch._defaults(dev, None, None) == (True, True)
