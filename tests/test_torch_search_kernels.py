"""The search kernels' plain PyTorch versions against the JAX Pallas
scorers run in interpret mode (as tests/test_pallas_search.py runs them):
B1 plain and twin with n_V 1 and 3, B2 signed and post-GELU, B3 in modes
a, b and b_sos.  Sims rtol 1e-5.  The CUDA kernels themselves are checked
against the same plain versions on the card by tests/test_torch_cuda.py
and chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptq4vit_tpu.ops import pallas_search as jps
from ptq4vit_tpu_torch.ops import search_kernels as sk
from ptq4vit_tpu_torch.quant.fakequant import GELU_NEG_CLIP
from tests.test_torch_cuda import A_NEG, Q, T, linear_case, matmul_case


def close(port, jax_out):
    p, j = port.numpy(), np.asarray(jax_out)
    assert p.shape == j.shape
    np.testing.assert_allclose(p, j, rtol=1e-5)


@pytest.mark.parametrize("n_V,twin", [(1, False), (1, True), (3, False),
                                      (3, True)])
def test_linear_w_ref_matches_pallas(n_V, twin):
    rng = np.random.default_rng(n_V + 2 * twin)
    M, ic, oc, P = 40, 32, 3 * 128, 6
    x, w, raw, g, cands, a = linear_case(rng, M, ic, oc, n_V, P, twin)
    lo = 0 if twin else -Q
    x_lv = np.clip(np.round(x / a), lo, Q - 1).astype(np.int8)
    xn = (np.clip(np.round(x / np.float32(A_NEG)), -Q, 0).astype(np.int8)
          if twin else None)
    got = sk.linear_w_hessian_sims_i8(
        T(x_lv, torch.int8), None if xn is None else T(xn, torch.int8),
        T(a), A_NEG if twin else None, T(w), T(cands), T(raw), T(g), Q)
    ref = jps.linear_w_hessian_sims_i8(
        jnp.asarray(x_lv), None if xn is None else jnp.asarray(xn),
        jnp.asarray(a), A_NEG if twin else None, jnp.asarray(w),
        jnp.asarray(cands), jnp.asarray(raw), jnp.asarray(g), Q,
        interpret=True)
    close(got, ref)


@pytest.mark.parametrize("postgelu", [False, True])
def test_linear_a_ref_matches_pallas(postgelu):
    rng = np.random.default_rng(10 + postgelu)
    M, ic, oc, P = 40, 64, 128, 6
    x, w, raw, g, _, a = linear_case(rng, M, ic, oc, 1, P, postgelu)
    w_int = np.float32(np.abs(w).max() / (Q - 0.5))
    w_lv = np.clip(np.round(w / w_int), -Q, Q - 1).astype(np.int8)
    ws = np.full(oc, w_int, np.float32)
    cands = (np.linspace(0.3, 1.2, P) * a).astype(np.float32)
    a_neg = GELU_NEG_CLIP / Q if postgelu else 0.0
    got = sk.linear_a_hessian_sims_i8(T(x), T(w_lv, torch.int8), T(ws),
                                      T(cands), T(raw), T(g), Q, postgelu,
                                      a_neg)
    ref = jps.linear_a_hessian_sims_i8(
        jnp.asarray(x), jnp.asarray(w_lv), jnp.asarray(ws),
        jnp.asarray(cands), jnp.asarray(raw), jnp.asarray(g), Q,
        postgelu=postgelu, a_neg=a_neg, interpret=True)
    close(got, ref)


@pytest.mark.parametrize("mode", ["a", "b", "b_sos"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_matmul_ref_matches_pallas(mode, dtype):
    rng = np.random.default_rng(20)
    A, B, g, cands, fixed, sos = matmul_case(rng, mode, dtype)
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    got = sk.matmul_hessian_sims(T(A, td), T(B, td), T(g, td), T(cands),
                                 T(fixed), mode, Q, Q,
                                 None if sos is None else
                                 [float(v) for v in sos])
    ref = jps.matmul_hessian_sims(
        jnp.asarray(A, jd), jnp.asarray(B, jd), jnp.asarray(g, jd),
        jnp.asarray(cands), jnp.asarray(fixed), mode, Q, Q,
        sos=None if sos is None else tuple(jnp.float32(v) for v in sos),
        interpret=True)
    close(got, ref)


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(30)
    x, w, raw, g, cands, a = linear_case(rng, 8, 16, 8, 1, 3, False)
    x_lv = np.clip(np.round(x / a), -Q, Q - 1).astype(np.int8)
    sk.reset_launch_counts()
    out = sk.linear_w_hessian_sims_i8(T(x_lv, torch.int8), None, T(a), None,
                                      T(w), T(cands[:, 0]), T(raw), T(g), Q)
    assert out.shape == (3,)
    assert sk.launch_counts() == {k.__name__: 0 for k in sk.KERNELS}
