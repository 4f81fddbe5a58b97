"""The port's search branches of the calibration surface against the JAX
package's on the same captured caches (the tiny wide ViT of
tests/test_torch_search.py, probe and images from fixed seeds):

  * the matmul int8 XLA branch (int8 scoring with no kernel: levels
    multiplied exactly, one fp32 rescale), hessian and cosine, with and
    without the SoS quantizer;
  * the general blocked matmul engine (n_V = n_H = 2 operand grids);
  * the pearson linear with its batch chunk pinned to the calib batch;
  * the blocked linear grid, and the linear kernel cases B4w / B4a take
    (exact scoring; int8 scoring with n_a = 2 or n_H = 2), through their
    plain versions on the port side and the Pallas scorers in interpret
    mode on the JAX side;
  * ``conv_ptqsl``, ``conv_quantile`` and the layerwise conv.

The JAX side reads ``PTQ4VIT_TPU_PALLAS`` / ``PTQ4VIT_TPU_INT8_SCORE`` at
call time; the port takes ``int8_score`` / ``use_kernels``.  Intervals
must be equal (rtol 1e-5) or proven f64 ties (tests/torch_port_helpers.py
``assert_qstate_matches``).

The SoS split must match exactly, but for one op: under the cosine metric
blocks.0.attn.matmul2's splits 2^-11 and 2^-12 score 3.9979084730927825
and 3.9979083227603063 in f64 (1.5e-7 apart on a curve whose range is
0.366, an f64 tie by TIE_TOL); the port's fp32 scores rank them as f64
does and it takes 2^-11, JAX's take 2^-12."""
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

LINEARS = ("qlinear_qkv", "qlinear_proj", "qlinear_MLP_1", "qlinear_MLP_2",
           "qlinear_classifier")
MATMULS = ("qmatmul_qk", "qmatmul_scorev")


@pytest.fixture(scope="module")
def setup():
    jnet = jax_net(WIDE)
    caps = jcapture(jnet, images(4, 32), batch_size=2, need_grad=True,
                    probe_sigma=1e-1)
    return jnet, jax.tree.map(np.asarray, jnet.params), caps


def port_cap(cap):
    return OpCapture(kind=cap.kind,
                     inputs={k: torch.from_numpy(np.array(v))
                             for k, v in cap.inputs.items()},
                     out=torch.from_numpy(np.array(cap.out)),
                     grad=torch.from_numpy(np.array(cap.grad)))


def both(edit):
    """(JAX config, port config), shrunk, with ``edit`` applied to each."""
    out = []
    for cfg in (jptq4vit(), pptq4vit()):
        cfg = shrink(cfg, eq_n=8, rounds=2)
        edit(cfg)
        out.append(cfg)
    return out


def matmul_edit(metric, blocks=None, no_softmax=False):
    def edit(cfg):
        cfg.ptqsl_matmul_kwargs["metric"] = metric
        cfg.ptqsl_matmul_kwargs.update(blocks or {})
        cfg.no_softmax = no_softmax
    return edit


def linear_edit(metric, grid=(1, 1, 1)):
    def edit(cfg):
        n_V, n_H, n_a = grid
        cfg.ptqsl_linear_kwargs.update(metric=metric, n_V=n_V, n_H=n_H,
                                       n_a=n_a)
    return edit


def conv_edit(metric, quantizer=None, grid=(1, 1), channelwise=True):
    def edit(cfg):
        cfg.ptqsl_conv2d_kwargs.update(metric=metric, n_V=grid[0],
                                       n_H=grid[1])
        cfg.conv_quantizer = quantizer
        cfg.conv_channelwise = channelwise
    return edit


MM_BLOCKS = {"n_V_A": 2, "n_H_A": 2, "n_V_B": 2, "n_H_B": 2}

SPLIT_TIES = {"matmul-int8-xla-cosine": ("blocks.0.attn.matmul2",)}

# (id, kinds, config edit, JAX PALLAS, JAX INT8, port kwargs)
CASES = [
    ("matmul-int8-xla-hessian", MATMULS, matmul_edit("hessian"), "0", "1",
     dict(int8_score=True, use_kernels=False)),
    ("matmul-int8-xla-cosine", MATMULS, matmul_edit("cosine"), "1", "1",
     dict(int8_score=True, use_kernels=True)),
    ("matmul-int8-xla-nosoftmax-L2", MATMULS,
     matmul_edit("L2_norm", no_softmax=True), "1", "1",
     dict(int8_score=True, use_kernels=True)),
    ("matmul-blocked-hessian", MATMULS, matmul_edit("hessian", MM_BLOCKS),
     "0", "0", {}),
    ("matmul-blocked-cosine-nosoftmax", MATMULS,
     matmul_edit("cosine", MM_BLOCKS, no_softmax=True), "0", "0", {}),
    ("linear-pearson", LINEARS, linear_edit("pearson"), "0", "0",
     dict(calib_bs=2)),
    ("linear-blocked-hessian", LINEARS, linear_edit("hessian", (2, 2, 2)),
     "0", "0", {}),
    ("linear-exact-kernels", LINEARS, linear_edit("hessian"), "1", "0",
     dict(int8_score=False, use_kernels=True)),
    ("linear-int8-n_a2", LINEARS, linear_edit("hessian", (1, 1, 2)), "1",
     "1", dict(int8_score=True, use_kernels=True)),
    ("linear-int8-n_H2", LINEARS, linear_edit("hessian", (1, 2, 1)), "1",
     "1", dict(int8_score=True, use_kernels=True)),
    ("conv-ptqsl", ("qconv",), conv_edit("hessian", "conv_ptqsl", (2, 2)),
     "0", "0", {}),
    ("conv-quantile", ("qconv",), conv_edit("hessian", "conv_quantile"), "0",
     "0", {}),
    ("conv-layerwise-cosine", ("qconv",),
     conv_edit("cosine", channelwise=False), "0", "0", {}),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_search_variant_matches_jax(setup, monkeypatch, case):
    case_id, kinds, edit, pallas, int8, pkw = case
    jnet, params, caps = setup
    monkeypatch.setenv("PTQ4VIT_TPU_PALLAS", pallas)
    monkeypatch.setenv("PTQ4VIT_TPU_INT8_SCORE", int8)
    monkeypatch.setenv("PTQ4VIT_TPU_MM_FOLD", "1")
    jcfg, pcfg = both(edit)
    ops = [(n, t) for n, t in jnet.op_inventory if t in kinds]
    jq, pq = {}, {}
    for name, mtype in ops:
        cap = caps[name]
        jpol, ppol = jcfg.op_policy(mtype), pcfg.op_policy(mtype)
        assert jpol == type(jpol)(**vars(ppol))
        if "qmatmul" in mtype:
            jq[name] = jsearch.search_matmul(cap, jpol)
            pq[name] = psearch.search_matmul(port_cap(cap), ppol, **pkw)
            continue
        w, b = (np.array(a) for a in params_for_op(params, name))
        if mtype == "qconv":
            jq[name] = jsearch.search_conv(w, b, cap, jpol)
            pq[name] = psearch.search_conv(torch.from_numpy(w),
                                           torch.from_numpy(b),
                                           port_cap(cap), ppol)
        else:
            jq[name] = jsearch.search_linear(w, b, cap, jpol,
                                             calib_bs=pkw.get("calib_bs"))
            pq[name] = psearch.search_linear(torch.from_numpy(w),
                                             torch.from_numpy(b),
                                             port_cap(cap), ppol, **pkw)
    mods = {n: np_fields(q) for n, q in jq.items()}
    for n, q in pq.items():
        assert set(np_fields(q)) == set(mods[n]), n
        for f, v in np_fields(q).items():
            assert v.shape == np.shape(mods[n][f]), (n, f)
    z = golden_view(params, {n: caps[n] for n, _ in ops}, mods,
                    WIDE["patch_size"])
    kws = {"conv": jcfg.ptqsl_conv2d_kwargs,
           "linear": jcfg.ptqsl_linear_kwargs,
           "matmul": jcfg.ptqsl_matmul_kwargs}
    assert_qstate_matches(pq, mods, z, bits_meta(jcfg, WIDE["patch_size"]),
                          ops, kws, split_ties=SPLIT_TIES.get(case_id, ()))
    if kinds == ("qconv",):
        assert pq[ops[0][0]].blocked == (pcfg.conv_quantizer == "conv_ptqsl")


def test_search_plans_chunks_on_the_larger_operand(setup, monkeypatch):
    """The candidate chunk bounds the quantized candidate operand as well
    as the output: here matmul1's A (R x Ci per head) outgrows its R x Co
    output, and fc2's input its output (at ViT-B/384 matmul2's R x R
    softmax side is 9x its output)."""
    _, params, caps = setup
    seen = []
    plan = psearch.plan_chunks

    def spy(eq_n, samples, elems, *a, **k):
        seen.append(elems)
        return plan(eq_n, samples, elems, *a, **k)

    monkeypatch.setattr(psearch, "plan_chunks", spy)
    cfg = shrink(pptq4vit(), eq_n=8, rounds=1)
    cap = port_cap(caps["blocks.0.attn.matmul1"])
    _, G, R, Ci = cap.inputs["a"].shape
    Co = cap.inputs["b"].shape[-1]
    psearch.search_matmul(cap, cfg.op_policy("qmatmul_qk"))
    w, b = (torch.from_numpy(np.array(a))
            for a in params_for_op(params, "blocks.0.mlp.fc2"))
    cap = port_cap(caps["blocks.0.mlp.fc2"])
    psearch.search_linear(w, b, cap, cfg.op_policy("qlinear_MLP_2"))
    T, (oc, ic) = cap.inputs["x"].shape[1], w.shape
    assert R * Ci > R * Co and ic > oc
    assert seen == [G * R * Ci, T * ic]
