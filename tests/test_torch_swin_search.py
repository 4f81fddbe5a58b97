"""The Swin slice of the port against the JAX package on the CPU:

  * ``mm_fold_factor`` is the JAX ``_mm_fold_factor`` over the zoo's matmul
    shapes, so the card launches B3f exactly where JAX runs its folded
    body;
  * B3f's plain version (``matmul_hessian_sims_ref``) against the JAX
    ``matmul_hessian_sims`` in interpret mode at fold shapes, with no
    PTQ4VIT_TPU_MM_FOLD override, i.e. through ``_mm_kernel_folded``
    (sims rtol 1e-5, argmax equal unless a 1e-5 tie);
  * the tiny Swin's window-matmul searches, int8-scored: the port's plain
    kernels against the JAX Pallas folded scorer;
  * the slice as a whole: the port's ``quantize`` of the tiny Swin against
    the JAX ``HessianQuantCalibrator`` with the JAX probe noise.

Intervals must be equal (rtol 1e-5) or both picks proven fp-degenerate
argmax ties by the f64 oracles of tests/test_reference_goldens.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ptq4vit_tpu_torch
from ptq4vit_tpu.calib import search as jsearch
from ptq4vit_tpu.calib.calibrator import HessianQuantCalibrator
from ptq4vit_tpu.calib.capture import capture as jcapture
from ptq4vit_tpu.configs import ptq4vit as jptq4vit
from ptq4vit_tpu.ops import pallas_search as jps
from ptq4vit_tpu_torch.calib import search as psearch
from ptq4vit_tpu_torch.configs import ptq4vit as pptq4vit
from ptq4vit_tpu_torch.models import MODEL_ZOO, model_config
from ptq4vit_tpu_torch.models.registry import _model_module
from ptq4vit_tpu_torch.ops import search_kernels as sk
from ptq4vit_tpu_torch.quant.qparams import LinearQP, MatMulQP
from tests.test_torch_cuda import Q, T, matmul_case
from tests.test_torch_search import port_cap
from tests.torch_port_helpers import (SWIN3, TINY_SWIN, assert_qstate_matches,
                                      bits_meta, golden_view, images,
                                      jax_probe_u, jax_swin_net, np_fields,
                                      port_net, shrink)

PROBE_SEED = 3


def test_mm_fold_factor_matches_jax(monkeypatch):
    monkeypatch.delenv("PTQ4VIT_TPU_MM_FOLD", raising=False)
    seen = set()
    for name in MODEL_ZOO:
        cfg = model_config(name)
        for info in _model_module(cfg).op_shapes(cfg).values():
            if info["kind"] == "matmul":
                seen.add((info["heads"], info["inner"], info["cols"]))
    for G in (2, 3, 4, 6, 8):
        for Ci, Co in ((6, 16), (8, 17), (64, 17), (16, 8)):
            seen.add((G, Ci, Co))
    folds = {}
    for G, Ci, Co in sorted(seen):
        f = sk.mm_fold_factor(G, Ci, Co)
        assert f == jps._mm_fold_factor(G, Ci, Co), (G, Ci, Co)
        folds[(G, Ci, Co)] = f
    # every Swin-B/384 window matmul folds; ViT-B/384 and Swin-T stage 1
    # (3 heads) do not
    assert folds[(4, 32, 144)] == folds[(32, 144, 32)] == 4
    assert folds[(12, 64, 577)] == folds[(3, 32, 49)] == 1


def close_sims(port, jax_out):
    p, j = port.numpy().astype(np.float64), np.asarray(jax_out, np.float64)
    assert p.shape == j.shape
    np.testing.assert_allclose(p, j, rtol=1e-5)
    for col in range(j.shape[1]):
        a, b = int(p[:, col].argmax()), int(j[:, col].argmax())
        assert a == b or abs(j[a, col] - j[b, col]) <= 1e-5 * abs(j[b, col])


@pytest.mark.parametrize("shape", [(2, 4, 16, 8, 16, 6), (3, 2, 16, 6, 16, 5),
                                   (2, 8, 9, 8, 9, 4)],
                         ids=["F4", "F2", "F8"])
@pytest.mark.parametrize("mode", ["a", "b", "b_sos"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_folded_ref_matches_pallas(monkeypatch, shape, mode, dtype):
    monkeypatch.delenv("PTQ4VIT_TPU_MM_FOLD", raising=False)
    rng = np.random.default_rng(50)
    A, B, g, cands, fixed, sos = matmul_case(rng, mode, dtype, shape)
    F = jps._mm_fold_factor(A.shape[1], A.shape[3], B.shape[3])
    assert F > 1 and F == sk.mm_fold_factor(A.shape[1], A.shape[3],
                                            B.shape[3])
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    sv = None if sos is None else [float(v) for v in sos]
    sk.reset_launch_counts()
    got = sk.matmul_hessian_sims(T(A, td), T(B, td), T(g, td), T(cands),
                                 T(fixed), mode, Q, Q, sv)
    assert sk.launch_counts() == {k.__name__: 0 for k in sk.KERNELS}
    ref = jps.matmul_hessian_sims(
        jnp.asarray(A, jd), jnp.asarray(B, jd), jnp.asarray(g, jd),
        jnp.asarray(cands), jnp.asarray(fixed), mode, Q, Q,
        sos=None if sos is None else tuple(jnp.float32(v) for v in sos),
        interpret=True)
    close_sims(got, ref)


@pytest.fixture(scope="module")
def swin_caps():
    jnet = jax_swin_net(TINY_SWIN)
    caps = jcapture(jnet, images(4, 32), batch_size=2, need_grad=True,
                    probe_sigma=1e-1)
    return jnet, caps


def test_window_matmul_search_int8_matches_pallas(swin_caps, monkeypatch):
    """Every window-matmul search of the tiny Swin (heads 2 and 4: folds 2
    and 4) scored in int8: the JAX Pallas folded scorer (interpret mode)
    against the port's plain kernels."""
    jnet, caps = swin_caps
    monkeypatch.setenv("PTQ4VIT_TPU_PALLAS", "1")
    monkeypatch.setenv("PTQ4VIT_TPU_INT8_SCORE", "1")
    monkeypatch.delenv("PTQ4VIT_TPU_MM_FOLD", raising=False)
    jcfg, pcfg = shrink(jptq4vit()), shrink(pptq4vit())
    ops = [(n, t) for n, t in jnet.op_inventory if "qmatmul" in t]
    jq, pq = {}, {}
    for name, mtype in ops:
        cap = caps[name]
        A, B = cap.inputs["a"], cap.inputs["b"]
        assert jps._mm_fold_factor(A.shape[1], A.shape[3], B.shape[3]) > 1
        jpol, ppol = jcfg.op_policy(mtype), pcfg.op_policy(mtype)
        assert dataclasses.asdict(jpol) == dataclasses.asdict(ppol)
        jq[name] = jsearch.search_matmul(
            type(cap)(kind=cap.kind, inputs=cap.inputs, out=None,
                      grad=cap.grad), jpol)
        pq[name] = psearch.search_matmul(port_cap(cap, with_out=False), ppol,
                                         int8_score=True, use_kernels=True)
    mods = {n: np_fields(q) for n, q in jq.items()}
    params = jax.tree.map(np.asarray, jnet.params)
    z = golden_view(params, {n: caps[n] for n, _ in ops}, mods,
                    TINY_SWIN["patch_size"])
    assert_qstate_matches(pq, mods, z, bits_meta(jcfg, TINY_SWIN["patch_size"]),
                          ops, {"matmul": jcfg.ptqsl_matmul_kwargs})


@pytest.fixture(scope="module", params=[TINY_SWIN, SWIN3],
                ids=["tiny", "odd_heads"])
def calibrated(request):
    shape = request.param
    jnet = jax_swin_net(shape)
    pnet = port_net(jnet)
    x = images(8, 32)
    jcfg = shrink(jptq4vit())
    jq = HessianQuantCalibrator(jnet, jcfg, x, batch_size=4,
                                probe_seed=PROBE_SEED) \
        .batching_quant_calib(verbose=False)
    _, pq, report = ptq4vit_tpu_torch.quantize(
        pnet, x, config=shrink(pptq4vit()), batch_size=4, device="cpu",
        probe_u=jax_probe_u(8, shape["num_classes"], PROBE_SEED),
        return_report=True)
    return shape, jnet, pnet, x, jcfg, jq, pq, report


def test_swin_quantize_matches_jax_calibrator(calibrated):
    shape, jnet, _, x, jcfg, jq, pq, report = calibrated
    assert set(pq) == set(jq) == {n for n, _ in jnet.op_inventory}
    assert report.num_groups == 1
    assert isinstance(pq["layers.0.downsample.reduction"], LinearQP)
    assert isinstance(pq["layers.1.blocks.1.attn.matmul2"], MatMulQP)
    assert pq["layers.1.blocks.1.attn.matmul1"].A_interval.shape == \
        (1, shape["num_heads"][1], 1, 1, 1, 1, 1)
    caps = jcapture(jnet, x, batch_size=4, need_grad=True,
                    probe_seed=PROBE_SEED)
    mods = {n: np_fields(q) for n, q in jq.items()}
    z = golden_view(jax.tree.map(np.asarray, jnet.params), caps, mods,
                    shape["patch_size"])
    kws = {"conv": jcfg.ptqsl_conv2d_kwargs,
           "linear": jcfg.ptqsl_linear_kwargs,
           "matmul": jcfg.ptqsl_matmul_kwargs}
    assert_qstate_matches(pq, mods, z, bits_meta(jcfg, shape["patch_size"]),
                          jnet.op_inventory, kws)


def test_swin_quantized_logits_match_jax(calibrated):
    """Fake-quant logits under each side's own calibrated qstate: within
    1e-2 of max|logit| (level flips compound through the 27 quantizers, as
    tests/test_torch_swin.py measures), and the port's logits under the
    JAX qstate within the same bound."""
    _, jnet, pnet, x, _, jq, pq, _ = calibrated
    from ptq4vit_tpu_torch.utils.convert import qstate_from_numpy
    jl = np.asarray(jnet.apply(jnp.asarray(x), qstate=jq))
    with torch.no_grad():
        for q in (pq, qstate_from_numpy(jq)):
            got = pnet.apply(torch.from_numpy(x), qstate=q).numpy()
            assert np.abs(got - jl).max() <= 1e-2 * np.abs(jl).max()
