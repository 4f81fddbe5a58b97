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


# (S, G, R, Ci, Co, P) of matmul1; matmul2 (b_sos) swaps Ci and Co.
# G = 3 keeps the JAX scorer on its unfolded body (_mm_fold_factor = 1)
UNFOLDED = (2, 3, 17, 8, 17, 6)
# fold shapes (B3f): window-7 (R = 49) and window-12 (R = 144) attention
# with head dim 32, and enough small windows (S = 2100) that a B3f block
# walks a chunk of several windows
FOLDED = [(3, 4, 49, 32, 49, 5), (2, 8, 144, 32, 144, 4),
          (2100, 2, 16, 16, 8, 3)]


def matmul_case(rng, mode, dtype, shape=UNFOLDED):
    S, G, R, Ci, Co, P = shape
    if mode == "b_sos":
        Ci, Co = Co, Ci
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
                                  "matmul_hessian_sims_b3": 3,
                                  "matmul_hessian_sims_b3f": 0,
                                  "linear_w_hessian_sims": 0,
                                  "linear_a_hessian_sims": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("M,ic,oc", [(100, 64, 3 * 64), (130, 72, 3 * 40)])
def test_fp32_kernels_match_plain_versions_on_the_card(M, ic, oc):
    """B4w (n_V 1 and 3, signed and twin fake-quant input) and B4a (signed
    and post-GELU) against their plain versions: rows and columns past a
    64 x 64 tile, K not a multiple of the 32-wide chunk, and row blocks
    (oc / n_V = 40) that straddle tiles.  rtol 1e-4: fp32 sums in another
    order."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    rng = np.random.default_rng(42)
    dev = "cuda"
    sk.reset_launch_counts()
    for n_V, twin in ((1, False), (3, True), (3, False), (1, True)):
        x, w, raw, g, cands, a = linear_case(rng, M, ic, oc, n_V, 7, twin)
        an = np.float32(A_NEG)
        x_sim = (np.clip(np.round(x / a), 0, Q - 1) * a
                 + np.clip(np.round(x / an), -Q, 0) * an) if twin else \
            np.clip(np.round(x / a), -Q, Q - 1) * a
        args = (T(x_sim).to(dev), T(w).to(dev),
                T(cands if n_V > 1 else cands[:, 0]).to(dev),
                T(raw).to(dev), T(g).to(dev), Q)
        torch.testing.assert_close(sk.linear_w_hessian_sims(*args),
                                   sk.linear_w_hessian_sims_ref(*args),
                                   rtol=1e-4, atol=0)
        w_int = np.float32(np.abs(w).max() / (Q - 0.5))
        w_sim = np.clip(np.round(w / w_int), -Q, Q - 1) * w_int
        args = (T(x).to(dev), T(w_sim).to(dev),
                T(np.linspace(0.3, 1.2, 7) * a).to(dev), T(raw).to(dev),
                T(g).to(dev), Q, twin, GELU_NEG_CLIP / Q if twin else 0.0)
        torch.testing.assert_close(sk.linear_a_hessian_sims(*args),
                                   sk.linear_a_hessian_sims_ref(*args),
                                   rtol=1e-4, atol=0)
    counts = sk.launch_counts()
    assert counts["linear_w_hessian_sims"] == 4
    assert counts["linear_a_hessian_sims"] == 4


@pytest.mark.cuda
def test_folded_kernel_matches_plain_version_on_the_card():
    """At fold shapes matmul_hessian_sims launches B3f (never B3 or the
    plain version); B3f agrees with the plain version in every mode and
    dtype, and its geometry stays inside a block's shared memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from ptq4vit_tpu_torch.ops.build import load
    lib = load()
    for K in (8, 32, 49, 144, 3072):
        assert lib.ptq_k_pad(K) == sk.k_pad(K)
    rng = np.random.default_rng(41)
    dev = "cuda"
    n = 0
    for shape in FOLDED:
        for mode in ("a", "b", "b_sos"):
            for dtype in ("f32", "bf16"):
                td = torch.bfloat16 if dtype == "bf16" else torch.float32
                A, B, g, cands, fixed, sos = matmul_case(rng, mode, dtype,
                                                         shape)
                assert sk.mm_fold_factor(A.shape[1], A.shape[3],
                                         B.shape[3]) > 1
                args = (T(A, td).to(dev), T(B, td).to(dev), T(g, td).to(dev),
                        T(cands).to(dev), T(fixed).to(dev), mode, Q, Q,
                        None if sos is None else [float(v) for v in sos])
                sk.reset_launch_counts()
                got = sk.matmul_hessian_sims(*args)
                assert sk.launch_counts()["matmul_hessian_sims_b3f"] == 1
                assert sk.launch_counts()["matmul_hessian_sims_b3"] == 0
                torch.testing.assert_close(
                    got, sk.matmul_hessian_sims_ref(*args), rtol=1e-4,
                    atol=0, msg=f"{shape} {mode} {dtype}")
                n += 1
    assert n == 3 * 3 * 2


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

