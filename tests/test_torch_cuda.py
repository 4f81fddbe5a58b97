"""The hand-written CUDA search kernels against their plain PyTorch
versions, on the card.  These tests need an NVIDIA GPU (marker ``cuda``)
and skip without one; this file imports no JAX, so it runs on a machine
with the card and only the port installed:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Sims must agree within rtol 1e-4 (the kernels sum in another order)."""
import numpy as np
import pytest
import torch

from ptq4vit_tpu_torch.ops import search_kernels as sk
from ptq4vit_tpu_torch.quant.fakequant import GELU_NEG_CLIP

Q = 128
A_NEG = float(np.float32(GELU_NEG_CLIP / Q))


def gelu(x):
    return x * 0.5 * (1 + np.tanh(0.7978845608 * (x + 0.044715 * x ** 3)))


def linear_case(rng, M, ic, oc, n_V, P, postgelu):
    x = rng.standard_normal((M, ic)).astype(np.float32)
    if postgelu:
        x = gelu(x).astype(np.float32)
    w = (rng.standard_normal((oc, ic)) * 0.1).astype(np.float32)
    raw = (x @ w.T).astype(np.float32)
    g = rng.standard_normal((M, oc)).astype(np.float32)
    base = np.abs(w.reshape(n_V, -1)).max(1) / (Q - 0.5)
    cands = (np.linspace(0.3, 1.2, P)[:, None] * base[None]).astype(np.float32)
    a = np.float32((x.max() if postgelu else np.abs(x).max()) / (Q - 0.5))
    return x, w, raw, g, cands, a


def T(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def matmul_case(rng, mode, dtype):
    # G = 3 keeps the JAX scorer on its unfolded body (_mm_fold_factor = 1)
    S, G, R, Ci, Co, P = 2, 3, 17, 8, 17, 6
    if mode == "b_sos":
        Ci, Co = 17, 8
    A = rng.standard_normal((S, G, R, Ci)).astype(np.float32)
    if mode == "b_sos":
        A = np.exp(A)
        A = A / A.sum(-1, keepdims=True)
    B = rng.standard_normal((S, G, Ci, Co)).astype(np.float32)
    g = rng.standard_normal((S, G, R, Co)).astype(np.float32)
    if dtype == "bf16":   # round through bf16 so both sides read the same
        A, B, g = (torch.from_numpy(v).bfloat16().float().numpy()
                   for v in (A, B, g))

    def hmax(v):
        return (np.abs(v).max((0, 2, 3)) / (Q - 0.5)).astype(np.float32)

    cand_src, fixed = {"a": (A, hmax(B)), "b": (B, hmax(A)),
                       "b_sos": (B, np.ones(G, np.float32))}[mode]
    cands = (np.linspace(0.3, 1.2, P)[:, None] * hmax(cand_src)[None]) \
        .astype(np.float32)
    sos = None
    if mode == "b_sos":
        split = np.float32(2.0 ** -4)
        a_int = np.float32(split / np.float32(Q - 1))
        sos = (split, a_int, np.float32(1.0) / np.float32(Q - 1), a_int)
    return A, B, g, cands, fixed, sos


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    rng = np.random.default_rng(40)
    dev = "cuda"
    sk.reset_launch_counts()
    for n_V, twin in ((1, False), (3, True)):
        x, w, raw, g, cands, a = linear_case(rng, 100, 64, 3 * 64, n_V, 7,
                                             twin)
        x_lv = np.clip(np.round(x / a), 0 if twin else -Q, Q - 1) \
            .astype(np.int8)
        xn = np.clip(np.round(x / np.float32(A_NEG)), -Q, 0).astype(np.int8)
        args = (T(x_lv, torch.int8).to(dev),
                T(xn, torch.int8).to(dev) if twin else None, float(a),
                A_NEG if twin else None, T(w).to(dev), T(cands).to(dev),
                T(raw).to(dev), T(g).to(dev), Q)
        torch.testing.assert_close(sk.linear_w_hessian_sims_i8(*args),
                                   sk.linear_w_hessian_sims_i8_ref(*args),
                                   rtol=1e-4, atol=0)
        w_int = np.float32(np.abs(w).max() / (Q - 0.5))
        w_lv = np.clip(np.round(w / w_int), -Q, Q - 1).astype(np.int8)
        args = (T(x).to(dev), T(w_lv, torch.int8).to(dev),
                T(np.full(w.shape[0], w_int, np.float32)).to(dev),
                T(np.linspace(0.3, 1.2, 7) * a).to(dev), T(raw).to(dev),
                T(g).to(dev), Q, twin, GELU_NEG_CLIP / Q if twin else 0.0)
        torch.testing.assert_close(sk.linear_a_hessian_sims_i8(*args),
                                   sk.linear_a_hessian_sims_i8_ref(*args),
                                   rtol=1e-4, atol=0)
    for mode in ("a", "b", "b_sos"):
        A, B, g, cands, fixed, sos = matmul_case(rng, mode, "bf16")
        args = (T(A, torch.bfloat16).to(dev), T(B, torch.bfloat16).to(dev),
                T(g, torch.bfloat16).to(dev), T(cands).to(dev),
                T(fixed).to(dev), mode, Q, Q,
                None if sos is None else [float(v) for v in sos])
        torch.testing.assert_close(sk.matmul_hessian_sims(*args),
                                   sk.matmul_hessian_sims_ref(*args),
                                   rtol=1e-4, atol=0)
    assert sk.launch_counts() == {"linear_w_hessian_sims_i8": 2,
                                  "linear_a_hessian_sims_i8": 2,
                                  "matmul_hessian_sims": 3}


def test_wrapper_checks_reject_bad_inputs():
    """What the wrappers check before any pointer reaches a kernel."""
    x = torch.zeros(4, 8)
    sk._check(x, "x", torch.float32, (4, 8), x.device)
    with pytest.raises(TypeError):
        sk._check(x, "x", torch.int8)
    with pytest.raises(ValueError):
        sk._check(x, "x", torch.float32, (8, 4))
    with pytest.raises(ValueError):
        sk._check(x.t(), "x", torch.float32)
    with pytest.raises(TypeError):
        sk._check(x.numpy(), "x", torch.float32)

