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


# (S, G, R, Ci, Co, P) of B3's edge cases on the card, taken as they are
# in every mode: R and Co of 1, 63, 65, 144 and 577 (ragged row and column
# tiles; 144 takes 48-wide tiles), K = 8, 32, 49, 64, 144 and 577 (K not a
# multiple of the 32-byte pad; 577: five 128-byte chunks, the I2F
# conversion, one block an SM), P = 1, 7 and 100.  G = 3 keeps the JAX
# scorer unfolded (B3); S keeps at least ~1000 terms a head, so the raw
# product's fp32 summation order stays inside rtol 1e-4.
MM_EDGES = [(1000, 3, 1, 8, 1, 1), (2, 3, 63, 32, 65, 7),
            (2, 3, 65, 49, 63, 7), (1, 3, 144, 64, 144, 100),
            (1, 3, 577, 144, 577, 7), (1, 3, 577, 577, 64, 100),
            (30, 3, 65, 577, 1, 7)]


def matmul_case(rng, mode, dtype, shape=UNFOLDED, swap=True):
    """Inputs of a B3 / B3f call; ``swap``: matmul2 (b_sos) takes the
    shape's Ci as its Co and its Co as its K."""
    S, G, R, Ci, Co, P = shape
    if mode == "b_sos" and swap:
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


# (M, ic, oc, n_V, twin, P) of the B1 / B2 cases on the card: rows and
# columns past the 64 x 64 tiles, K not a multiple of the 32-byte pad
# (72 -> 96) nor of the 128-byte TMA box, K = 3072 where the fixed tile
# streams with every chunk (the plan's non-resident mode), row blocks
# (oc / n_V = 40, 48) that straddle tiles, P = 7 (not a multiple of any
# ring depth), and n_V = 120 (one column a bin) with 20 candidates, whose
# per-warp sums split them over two launches (LinearPlan.pc 16)
LINEAR_EDGES = [(100, 64, 3 * 64, 1, False, 7), (100, 64, 3 * 64, 3, True, 7),
                (130, 72, 3 * 40, 3, False, 7), (130, 72, 3 * 40, 1, True, 7),
                (77, 3072, 144, 3, True, 7), (77, 3072, 144, 1, False, 7),
                (200, 96, 120, 120, False, 20)]


def near_tie(got, ref, tie=1e-4):
    """Every head whose argmax differs has its two candidates' plain sims
    within ``tie`` (relative): a near-tie the two sums may swap."""
    for col in range(ref.shape[1]):
        i, j = int(got[:, col].argmax()), int(ref[:, col].argmax())
        if i != j and abs(float(ref[i, col] - ref[j, col])) > \
                tie * abs(float(ref[j, col])):
            return False
    return True


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card():
    """B1 and B2 on the tensor cores at LINEAR_EDGES, both post-GELU
    twins, B3 in every mode at MM_EDGES with f32 and bf16 operands; each
    within rtol 1e-4 of its plain version (sums in another order), B3's
    argmax equal unless a near-tie, one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    rng = np.random.default_rng(40)
    dev = "cuda"
    sk.reset_launch_counts()
    plans = set()
    for M, ic, oc, n_V, twin, P in LINEAR_EDGES:
        x, w, raw, g, cands, a = linear_case(rng, M, ic, oc, n_V, P, twin)
        plans.add(sk.linear_plan("w", M, oc, ic, P, n_V, twin)[:3] + (P,))
        x_lv = np.clip(np.round(x / a), 0 if twin else -Q, Q - 1) \
            .astype(np.int8)
        xn = np.clip(np.round(x / np.float32(A_NEG)), -Q, 0).astype(np.int8)
        args = (T(x_lv, torch.int8).to(dev),
                T(xn, torch.int8).to(dev) if twin else None, float(a),
                A_NEG if twin else None, T(w).to(dev), T(cands).to(dev),
                T(raw).to(dev), T(g).to(dev), Q)
        torch.testing.assert_close(sk.linear_w_hessian_sims_i8(*args),
                                   sk.linear_w_hessian_sims_i8_ref(*args),
                                   rtol=1e-4, atol=0,
                                   msg=f"B1 {M} {ic} {oc} {n_V} {twin}")
        w_int = np.float32(np.abs(w).max() / (Q - 0.5))
        w_lv = np.clip(np.round(w / w_int), -Q, Q - 1).astype(np.int8)
        args = (T(x).to(dev), T(w_lv, torch.int8).to(dev),
                T(np.full(w.shape[0], w_int, np.float32)).to(dev),
                T(np.linspace(0.3, 1.2, P) * a).to(dev), T(raw).to(dev),
                T(g).to(dev), Q, twin, GELU_NEG_CLIP / Q if twin else 0.0)
        torch.testing.assert_close(sk.linear_a_hessian_sims_i8(*args),
                                   sk.linear_a_hessian_sims_i8_ref(*args),
                                   rtol=1e-4, atol=0,
                                   msg=f"B2 {M} {ic} {oc} {twin}")
    # the cases reach both fixed-tile modes and a split candidate loop
    assert {r for r, _, _, _ in plans} == {True, False}
    assert any(pc < P for _, _, pc, P in plans)
    n_mm = 0
    for shape in MM_EDGES:
        for mode in ("a", "b", "b_sos"):
            for dtype in ("f32", "bf16"):
                td = torch.bfloat16 if dtype == "bf16" else torch.float32
                A, B, g, cands, fixed, sos = matmul_case(rng, mode, dtype,
                                                         shape, swap=False)
                args = (T(A, td).to(dev), T(B, td).to(dev), T(g, td).to(dev),
                        T(cands).to(dev), T(fixed).to(dev), mode, Q, Q,
                        None if sos is None else [float(v) for v in sos])
                got = sk.matmul_hessian_sims(*args)
                ref = sk.matmul_hessian_sims_ref(*args)
                torch.testing.assert_close(got, ref, rtol=1e-4, atol=0,
                                           msg=f"B3 {shape} {mode} {dtype}")
                assert torch.equal(got.argmax(0), ref.argmax(0)) or \
                    near_tie(got, ref), (shape, mode, dtype)
                n_mm += 1
    n = len(LINEAR_EDGES)
    assert n_mm == 3 * 2 * len(MM_EDGES)
    assert sk.launch_counts() == {"linear_w_hessian_sims_i8": n,
                                  "linear_a_hessian_sims_i8": n,
                                  "matmul_hessian_sims_b3": n_mm,
                                  "matmul_hessian_sims_b3f": 0,
                                  "linear_w_hessian_sims": 0,
                                  "linear_a_hessian_sims": 0}


def forced_fp32_plan(pc, stages):
    """An ``fp32_plan`` with pc candidates a block and ``stages`` ring
    slots (at most the plan's own), for the card tests' edge cases."""
    orig = sk.fp32_plan

    def plan(kind, M, N, K, P, twin=False, num_sms=sk.NUM_SMS):
        p = orig(kind, M, N, K, P, twin, num_sms)
        st, c = min(stages, p.stages), min(pc, P)
        groups = -(-P // c)
        return p._replace(stages=st, pc=c, groups=groups,
                          blocks=p.tiles * groups,
                          smem=sk.fp32_smem_bytes(kind, twin, st))
    return plan


@pytest.mark.cuda
@pytest.mark.parametrize("M,ic,oc", [(100, 64, 3 * 64), (130, 72, 3 * 40),
                                     (260, 72, 3 * 100), (77, 3072, 144)])
def test_fp32_kernels_match_plain_versions_on_the_card(M, ic, oc,
                                                       monkeypatch):
    """B4w (n_V 1 and 3, signed and twin fake-quant input) and B4a (signed
    and post-GELU) against their plain versions: rows and columns past the
    128 x 128 tiles, K not a multiple of the 32-wide chunk (64 -> 64,
    72 -> 96), K = 3072, row blocks (oc / n_V = 40, 100) that straddle
    tiles, under the plan and under forced plans -- 7 candidates in
    groups of 3 (the last holds 1), the ring at 2 and 4 slots -- and
    P = 1.  rtol 1e-4: fp32 sums in another order."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    rng = np.random.default_rng(42)
    dev = "cuda"
    sk.reset_launch_counts()
    calls = 0
    for forced in (None, (3, 2), (3, 4), (1, 3)):
        if forced is not None:
            monkeypatch.setattr(sk, "fp32_plan",
                                forced_fp32_plan(*forced))
        for n_V, twin, P in ((1, False, 7), (3, True, 7), (3, False, 7),
                             (1, True, 7), (3, False, 1), (1, True, 1)):
            x, w, raw, g, cands, a = linear_case(rng, M, ic, oc, n_V, P,
                                                 twin)
            an = np.float32(A_NEG)
            x_sim = (np.clip(np.round(x / a), 0, Q - 1) * a
                     + np.clip(np.round(x / an), -Q, 0) * an) if twin else \
                np.clip(np.round(x / a), -Q, Q - 1) * a
            args = (T(x_sim).to(dev), T(w).to(dev),
                    T(cands if n_V > 1 else cands[:, 0]).to(dev),
                    T(raw).to(dev), T(g).to(dev), Q)
            msg = f"{forced} n_V={n_V} twin={twin} P={P}"
            torch.testing.assert_close(sk.linear_w_hessian_sims(*args),
                                       sk.linear_w_hessian_sims_ref(*args),
                                       rtol=1e-4, atol=0, msg="B4w " + msg)
            w_int = np.float32(np.abs(w).max() / (Q - 0.5))
            w_sim = np.clip(np.round(w / w_int), -Q, Q - 1) * w_int
            args = (T(x).to(dev), T(w_sim).to(dev),
                    T(np.linspace(0.3, 1.2, P) * a).to(dev), T(raw).to(dev),
                    T(g).to(dev), Q, twin, GELU_NEG_CLIP / Q if twin else 0.0)
            torch.testing.assert_close(sk.linear_a_hessian_sims(*args),
                                       sk.linear_a_hessian_sims_ref(*args),
                                       rtol=1e-4, atol=0, msg="B4a " + msg)
            calls += 1
    counts = sk.launch_counts()
    assert counts["linear_w_hessian_sims"] == calls == 24
    assert counts["linear_a_hessian_sims"] == calls


@pytest.mark.cuda
def test_fp32_plan_matches_the_library_on_the_card():
    """The wrappers size B4w's / B4a's partial sums from the library's
    tile count, and the library sizes a block's shared memory as
    fp32_plan does."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from ptq4vit_tpu_torch.ops.build import load
    lib = load()
    for M, ic, oc in ((100, 64, 192), (130, 72, 300), (2308, 768, 3072),
                      (2308, 3072, 768), (18464, 768, 2304)):
        for code, (kind, twin) in enumerate((("w", False), ("a", False),
                                             ("a", True))):
            plan = sk.fp32_plan(kind, M, oc, ic, 100, twin)
            assert lib.ptq_fp32_num_partials(M, oc) == plan.tiles
            assert lib.ptq_fp32_smem_bytes(code, plan.stages) == plan.smem


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


def matmul_calls(name, images):
    """(S, G, R, Ci, Co, P, mode) of every B3 / B3f call a PTQ4ViT W8A8
    calibration of ``name`` on ``images`` images makes: modes a and b at
    matmul1, b_sos at the SoS matmul2."""
    from ptq4vit_tpu_torch.configs import ptq4vit
    from ptq4vit_tpu_torch.models import model_config, swin, vit
    cfg = model_config(name)
    mod = swin if name.startswith("swin") else vit
    pol = ptq4vit()
    shapes = mod.op_shapes(cfg)
    for op, mtype in mod.op_inventory(cfg):
        info = shapes[op]
        if info["kind"] != "matmul":
            continue
        p = pol.op_policy(mtype)
        modes = ("b_sos",) if p.quantizer == "sos_matmul" else ("a", "b")
        for mode in modes:
            yield (info.get("windows", 1) * images, info["heads"],
                   info["rows"], info["inner"], info["cols"], p.eq_n, mode)


def plain_levels(x, d, lo, hi, kp):
    """clip(round(x / d), lo, hi) along the last axis, K-padded to kp, as
    int8 (the CPU's IEEE division)."""
    lv = torch.clamp(torch.round(x.float().cpu() / d), lo, hi).to(torch.int8)
    return torch.nn.functional.pad(lv, (0, kp - lv.shape[-1]))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["a", "b", "b_sos"])
def test_matmul_level_prepass_is_exact_on_the_card(mode):
    """The B3 / B3f level pre-pass writes bit for bit the plain levels,
    K-padded with zeros, in every buffer of the mode, with many values at
    and next to a rounding boundary: power-of-two scales put x / d exactly
    on a half, and the values one float step either side of it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    rng = np.random.default_rng(47)
    S, G, R, Ci, Co, P = 3, 2, 33, 49, 40, 5
    if mode == "b_sos":
        Ci, Co = Co, Ci
    A = rng.standard_normal((S, G, R, Ci)).astype(np.float32)
    if mode == "b_sos":
        A = np.exp(A) / np.exp(A).sum(-1, keepdims=True)
    B = rng.standard_normal((S, G, Ci, Co)).astype(np.float32)
    scales = np.array([0.25, 0.0625, 0.03125, 1 / 3, 0.0173], np.float32)
    # a third of the values on a half of the first scale, a step either
    # side, or 0.5 itself
    halves = (rng.integers(-200, 200, A.shape) + 0.5) * np.float32(0.25)
    pick = rng.integers(0, 4, A.shape)
    A = np.where(pick == 1, halves, A)
    A = np.where(pick == 2, np.nextafter(halves, np.float32(np.inf)), A)
    A = np.where(pick == 3, np.nextafter(halves, np.float32(-np.inf)), A)
    A = A.astype(np.float32)
    halves_b = (rng.integers(-200, 200, B.shape) + 0.5) * np.float32(0.25)
    B = np.where(rng.integers(0, 2, B.shape) == 1, halves_b, B) \
        .astype(np.float32)
    cands = np.tile(scales[:P, None], (1, G)).astype(np.float32)
    fixed = np.full(G, 0.0625, np.float32)
    sos = None
    if mode == "b_sos":
        A = np.abs(A) / np.float32(60)       # softmax-range values
        split = np.float32(2.0 ** -4)
        a_int = np.float32(split / np.float32(Q - 1))
        sos = [float(split), float(a_int),
               float(np.float32(1) / np.float32(Q - 1)), float(a_int)]
    g = rng.standard_normal((S, G, R, Co)).astype(np.float32)
    dev = "cuda"
    _, (la, la2, lb) = sk._matmul_launch(
        T(A).to(dev), T(B).to(dev), T(g).to(dev), T(cands).to(dev),
        T(fixed).to(dev), mode, Q, Q, sos, return_levels=True)
    kp = sk.k_pad(Ci)
    At = torch.from_numpy(A).permute(1, 0, 2, 3)        # (G, S, R, Ci): z
    Bt = torch.from_numpy(B).permute(1, 0, 3, 2)        # (G, S, Co, Ci)
    f4 = torch.from_numpy(fixed).reshape(G, 1, 1, 1)
    if mode == "a":
        want_a = torch.stack([plain_levels(
            At, torch.from_numpy(cands[p]).reshape(G, 1, 1, 1), -Q, Q - 1,
            kp) for p in range(P)]).reshape(la.shape)
        want_b = plain_levels(Bt, f4, -Q, Q - 1, kp).reshape(lb.shape)
    else:
        want_b = torch.stack([plain_levels(
            Bt, torch.from_numpy(cands[p]).reshape(G, 1, 1, 1), -Q, Q - 1,
            kp) for p in range(P)]).reshape(lb.shape)
        if mode == "b":
            want_a = plain_levels(At, f4, -Q, Q - 1, kp).reshape(la.shape)
        else:
            split, a_int = np.float32(sos[0]), np.float32(sos[1])
            hi = torch.clamp(torch.round(torch.clamp(At, min=float(split),
                                                     max=1.0) * (Q - 1)),
                             0, Q - 1).to(torch.int8)
            want_a = torch.nn.functional.pad(hi, (0, kp - Ci)) \
                .reshape(la.shape)
            lo = plain_levels(torch.clamp(At, min=0.0, max=float(split)),
                              torch.tensor(a_int), 0, Q - 1, kp)
            assert torch.equal(la2.cpu(), lo.reshape(la2.shape))
    torch.cuda.synchronize()
    assert torch.equal(la.cpu(), want_a)
    assert torch.equal(lb.cpu(), want_b)


@pytest.mark.cuda
def test_matmul_plan_matches_the_library_on_the_card():
    """The wrappers size B3's / B3f's partial sums from the library's
    count, and the library picks the tile width and sizes a block's shared
    memory as matmul_plan does."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from ptq4vit_tpu_torch.ops.build import load
    lib = load()
    calls = set(matmul_calls("vit_base_patch16_384", 32)) | set(
        matmul_calls("swin_base_patch4_window12_384", 32))
    calls |= {shape + (mode,) for shape in MM_EDGES + FOLDED
              for mode in ("a", "b", "b_sos")}
    for S, G, R, Ci, Co, P, mode in calls:
        plan = sk.matmul_plan(S, G, R, Ci, Co, P, mode)
        assert lib.ptq_mm_width(Co) == plan.width
        assert lib.ptq_mm_num_partials(S, R, Co) == plan.per_head
        assert lib.ptq_mm_smem_bytes(("a", "b", "b_sos").index(mode), Ci, Co,
                                     plan.stages) == plan.smem


@pytest.mark.parametrize("name", ["vit_base_patch16_384",
                                  "swin_base_patch4_window12_384"])
@pytest.mark.parametrize("images", [4, 8, 32])
def test_matmul_plans_cover_outputs_and_fit(name, images):
    """Every B3 / B3f plan of the model's calibration: the blocks, decoded
    as the kernel decodes blockIdx (column tiles fastest, then row tiles,
    then the problem), cover each (problem, row, column) output once, and
    each block walks all P candidates, so every (problem, tile, candidate)
    is scored once; the tile width is an s8 wgmma N; shared memory fits
    three blocks an SM at Swin's narrow tiles, two at ViT's matmul1 and
    one at ViT's matmul2, whose SoS tiles at K = 577 take 80 KB, with a
    ring of at least two candidates' K chunks;
    the int32 sums convert without I2F exactly where K < 256."""
    calls = set(matmul_calls(name, images))
    assert {c[-1] for c in calls} == {"a", "b", "b_sos"}
    for S, G, R, Ci, Co, P, mode in calls:
        plan = sk.matmul_plan(S, G, R, Ci, Co, P, mode)
        W = plan.width
        assert W in (8, 16, 24, 32) or (W % 16 == 0 and W <= 256)
        assert plan.row_tiles * sk.MM_ROWS >= R > (plan.row_tiles - 1) \
            * sk.MM_ROWS
        assert plan.col_tiles * W >= Co > (plan.col_tiles - 1) * W
        assert plan.blocks == S * G * plan.row_tiles * plan.col_tiles
        assert plan.per_head == S * plan.row_tiles * plan.col_tiles \
            * sk.MM_WARPS
        seen = np.zeros((plan.row_tiles * sk.MM_ROWS, plan.col_tiles * W),
                        np.int32)
        problems = set()
        for b in range(plan.row_tiles * plan.col_tiles * 3):  # 3 problems
            ct = b % plan.col_tiles
            rt = (b // plan.col_tiles) % plan.row_tiles
            problems.add(b // (plan.col_tiles * plan.row_tiles))
            seen[rt * sk.MM_ROWS:(rt + 1) * sk.MM_ROWS,
                 ct * W:(ct + 1) * W] += 1
        assert problems == {0, 1, 2}
        assert (seen == 3).all()
        chunks = -(-sk.k_pad(Ci) // sk.LQ_KC)
        assert 2 * chunks <= plan.stages <= sk.MM_MAX_STAGES
        assert plan.smem <= sk.SM_SMEM // plan.per_sm - 1024
        assert plan.per_sm == (1 if Ci > 512 and mode == "b_sos" else
                               3 if W <= 48 else 2), (mode, Ci, Co)
        assert plan.per_sm == sk.mm_blocks_per_sm(W, mode)
        assert plan.fast == (Ci < 256)
        assert P == 100


def test_mm_width_fits_the_output_columns():
    """B3's tile width: 32 for Co <= 32, 48 at Swin's 144 columns, 64 at
    ViT's 577 and 64; never a width s8 wgmma refuses."""
    assert [sk.mm_width(c) for c in (1, 8, 32, 33, 49, 63, 64, 65, 96,
                                     144, 577)] == \
        [32, 32, 32, 64, 64, 64, 64, 64, 48, 48, 64]
    with pytest.raises(ValueError):
        sk.matmul_plan(1, 1, 64, 64, 64, 1, "c")
    with pytest.raises(ValueError):
        sk.matmul_plan(1, 1, 64, 4096, 64, 1, "b_sos")


@pytest.mark.cuda
def test_linear_plan_matches_the_library_on_the_card():
    """The wrappers size B1's / B2's partial sums from the library's block
    count, and the library sizes a block's shared memory as linear_plan
    does."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from ptq4vit_tpu_torch.ops.build import load
    lib = load()
    for M, ic, oc, n_V, twin, _ in LINEAR_EDGES + [
            (2308, 768, 3072, 1, False, 100), (18464, 3072, 768, 1, True, 100)]:
        for kind, nl in (("w", 2 if twin else 1), ("a", 1)):
            plan = sk.linear_plan(kind, M, oc, ic, 100,
                                  n_V if kind == "w" else 1, twin)
            assert lib.ptq_linear_num_partials(M, oc) == plan.blocks
            assert lib.ptq_linear_smem_bytes(
                nl, ic, int(plan.resident), plan.stages, plan.pc,
                plan.nbl) == plan.smem


def linear_calls(name, images):
    """(kind, M, N, K, P, n_V, twin) of every B1 / B2 call a PTQ4ViT W8A8
    calibration of ``name`` on ``images`` images makes."""
    from ptq4vit_tpu_torch.configs import ptq4vit
    from ptq4vit_tpu_torch.models import model_config, swin, vit
    cfg = model_config(name)
    mod = swin if name.startswith("swin") else vit
    pol = ptq4vit()
    shapes = mod.op_shapes(cfg)
    for op, mtype in mod.op_inventory(cfg):
        info = shapes[op]
        if info["kind"] != "linear":
            continue
        p = pol.op_policy(mtype)
        M = info["tokens"] * images
        twin = p.quantizer == "postgelu_linear"
        for kind in ("w", "a"):
            yield (kind, M, info["out_features"], info["in_features"],
                   p.eq_n, p.n_V if kind == "w" else 1, twin)


@pytest.mark.parametrize("name", ["vit_base_patch16_384",
                                  "swin_base_patch4_window12_384"])
@pytest.mark.parametrize("images", [8, 32])
def test_linear_plans_fit_shared_memory(name, images):
    """Every B1 / B2 plan of the model's calibration stays within half
    an SM's shared memory (two blocks an SM), so within a block's 232,448
    bytes, with a ring of at least two slots, keeps the fixed tile(s)
    resident exactly where they fit (up to 1024 K bytes of fixed rows:
    qkv, proj, fc1, the head, Swin's stage-1 to 3 reductions and its
    stage-1 fc2 pair; not ViT's fc2 nor Swin's later ones), and runs all
    100 candidates in one launch."""
    calls = set(linear_calls(name, images))
    assert calls
    for kind, M, N, K, P, n_V, twin in calls:
        plan = sk.linear_plan(kind, M, N, K, P, n_V, twin)
        nl = 2 if kind == "w" and twin else 1
        assert plan.smem <= sk.LQ_BLOCK_SMEM < sk.SMEM_LIMIT
        assert plan.stages >= 2
        assert plan.resident == (nl * sk.k_pad(K) <= 1024), \
            (kind, M, N, K, twin)
        assert plan.pc == P == 100
        assert plan.nbl == 1
        if not plan.resident:
            assert sk.linear_smem_bytes(nl, K, True, 2, plan.pc,
                                        plan.nbl) > sk.LQ_BLOCK_SMEM


def test_linear_plan_bins_and_candidate_chunks():
    """Row blocks that straddle the 64-column tiles widen a block's bins;
    many bins split the candidates over launches so that the per-warp sums
    fit; both kinds tile the output 64 x 64."""
    plan = sk.linear_plan("w", 100, 120, 72, 7, 3)
    assert plan.nbl == 2 and plan.pc == 7 and plan.blocks == 2 * 2
    plan = sk.linear_plan("w", 100, 768, 768, 100, 256)
    assert plan.nbl == 22
    assert plan.pc == sk.LQ_WACC_BYTES // (4 * sk.LQ_CWARPS * 22) == 46
    assert sk.linear_plan("w", 200, 120, 96, 20, 120).pc == 16
    assert sk.linear_plan("w", 2308, 2304, 768, 100, 3).nbl == 1
    assert sk.linear_plan("w", 2308, 3072, 768, 100).blocks == 37 * 48
    assert sk.linear_plan("a", 2308, 3072, 768, 100).blocks == 37 * 48
    assert sk.linear_plan("w", 2308, 768, 3072, 100, 1, True).stages == 4
    assert sk.linear_plan("a", 2308, 768, 3072, 100, 1, True).stages \
        == sk.LQ_MAX_STAGES
    with pytest.raises(ValueError):
        sk.linear_plan("x", 1, 1, 1, 1)


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



# ---------------------------------------------------------------------------
# serving kernels: B6 (q8_linear), B7 (fused_attention_qkv), B8
# (fused_attention) against their plain versions
# ---------------------------------------------------------------------------

def q8_modes():
    for mode in ("f", "f_twin", "q8", "q8twin"):
        for ln in ((False, True) if mode in ("f", "f_twin") else (False,)):
            for gelu in (False, True):
                for out in ("float", "residual", "vec", "twin"):
                    yield mode, ln, gelu, out


def q8_case(rng, mode, ln, gelu, out, M, K, N, qmax, dtype):
    """Arguments of q8_linear / q8_linear_ref on the card."""
    dev = "cuda"
    if mode in ("q8", "q8twin"):
        x = T(rng.integers(-qmax, qmax, (M, K)), torch.int8)
        a = 0.03
    else:
        xn = (rng.standard_normal((M, K)) * 2 + 0.3).astype(np.float32)
        if mode == "f_twin":
            xn = np.where(xn > 0, xn, xn * 0.05).astype(np.float32)
        x = T(xn, dtype)
        a = float(np.float32((3.0 if ln else np.abs(xn).max())
                             / (qmax - 0.5)))
    w = T(rng.integers(-qmax, qmax, (K, N)), torch.int8)
    ws = T((rng.random(N) + 0.5) / (a * qmax * qmax * np.sqrt(K) / 3))
    b = T(rng.standard_normal(N) * 0.1)
    twin_in = mode in ("f_twin", "q8twin")
    kw = dict(a_qmax=qmax, postgelu=twin_in,
              epilogue="gelu" if gelu else None,
              in_q=mode if mode in ("q8", "q8twin") else None,
              out_q={"vec": "vec", "twin": "twin"}.get(out), out_qmax=qmax,
              float_dtype=dtype if mode in ("q8", "q8twin") else None)
    if ln:
        kw["ln"] = (T(1 + 0.1 * rng.standard_normal(K)).to(dev),
                    T(0.1 * rng.standard_normal(K)).to(dev), 1e-6)
    if out == "residual":
        kw["residual"] = T(rng.standard_normal((M, N)), dtype).to(dev)
    if out == "vec":
        kw["out_scale"] = T((rng.random(N) + 1.5) / (qmax - 0.5)).to(dev)
    if out == "twin":
        kw["out_scale"] = (torch.tensor(3.0 / (qmax - 0.5), device=dev),
                           torch.tensor(GELU_NEG_CLIP / qmax, device=dev))
    a_neg = torch.tensor(GELU_NEG_CLIP / qmax, device=dev) if twin_in \
        else None
    return (x.to(dev), w.to(dev), ws.to(dev), b.to(dev),
            torch.tensor(a, device=dev), a_neg), kw


def attn_level_step(ph, sos, qmax=128):
    """(H,) the most that one probability level moves an attention output
    of each head: a v level (at most qmax) times b2, times 1 / (qmax - 1)
    (SoS: a level of the upper range) or times a2 (per head)."""
    return qmax * ph[3] * (1.0 / (qmax - 1) if sos else ph[2])


def assert_float_close(got, ref, rtol, step, share=0.005):
    """rtol, atol 2e-5 of max |ref|, except in at most ``share`` of the
    elements, where a probability rounded to the neighbouring level: those
    are off by at most ``step`` (broadcast to the output) more."""
    g, r = got.double(), ref.double()
    err = (g - r).abs()
    tol = 2e-5 * float(r.abs().max()) + rtol * r.abs()
    assert float((err > tol).double().mean()) <= share
    assert bool((err <= tol + step.double()).all())


def assert_levels_close(got, ref, share=0.01):
    d = (got.int() - ref.int()).abs()
    assert int(d.max()) <= 1
    assert float((d > 0).float().mean()) <= share


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_q8_linear_matches_plain_version_on_the_card(dtype):
    """B6 in every mode at qmax 128 and 32, with a ragged row edge (M = 77)
    and N past one 128-column tile: float outputs without the LayerNorm
    are bitwise the plain version's; with it (statistics summed in another
    order, so a row may quantize one input a level the other way) every
    row but at most 5% of them bitwise, and those off by at most one input
    level's contribution (a * max |w[:, n]| * w_scale[n], times 1.13, the
    steepest slope of the GELU, and plus one bf16 step at a bf16 output);
    int8 outputs within one level in at most 1% of the elements."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from ptq4vit_tpu_torch.ops import int8_serve as sv
    rng = np.random.default_rng(43)
    sv.reset_launch_counts()
    n = 0
    for qmax in (128, 32):
        for mode, ln, gelu, out in q8_modes():
            args, kw = q8_case(rng, mode, ln, gelu, out, 77, 200, 150, qmax,
                               dtype)
            got = sv.q8_linear(*args, **kw)
            ref = sv.q8_linear_ref(*args, **kw)
            torch.cuda.synchronize()
            assert got.dtype == ref.dtype and got.shape == ref.shape
            what = f"{mode} ln={ln} gelu={gelu} {out} q{qmax}"
            if got.dtype == torch.int8:
                assert_levels_close(got, ref)
            elif ln:
                rows = (got != ref).any(dim=1)
                assert float(rows.float().mean()) <= 0.05, what
                a = max(float(args[4]), float(args[5] if args[5] is not None
                                              else 0.0))
                step = (a * args[1].abs().amax(0).double()
                        * args[2].double() * (1.13 if gelu else 1.0))
                r = ref.double()
                room = step + (2.0 ** -7 * r.abs() if dtype == torch.bfloat16
                               else 1e-6 * r.abs())
                assert bool(((got.double() - r).abs() <= room).all()), what
            else:
                assert torch.equal(got, ref), what
            n += 1
    assert sv.launch_counts()["q8_linear"] == n


@pytest.mark.cuda
@pytest.mark.parametrize("H,N,hd", [(2, 37, 64), (3, 130, 24),
                                    (12, 577, 64)])
def test_fused_attention_matches_plain_version_on_the_card(H, N, hd):
    """B7 (float or int8 in, float or int8 out) and B8, SoS (split 2^-4;
    0.5, where the hi level of a probability 0 is 64: a padded key wrongly
    let into the levels or the sum would move the output; and 2^-35,
    below the fast division's range: the IEEE division path) and per
    head, against the plain version, int8 out also at a_out = 2^30 (the
    output's IEEE division path): float outputs rtol 1e-5, atol 2e-5
    of max |ref| except in at most 0.5% of the elements (the softmax sums
    in another order, so a probability may round to the neighbouring
    level), and those off by at most one probability level's contribution
    more; int8 outputs within one level in at most 1% of the elements.
    N = 130 spans several 16-row strips and 32-key chunks, with ragged
    last ones (the logits parked in shared memory); hd = 24 is not a
    multiple of 16 (the head dim padded to 32); N = 577, hd = 64 is a
    full-width ViT-B/384 head (37 strips, the last of one row; 19 chunks,
    the last of one key; logits recomputed per pass)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from ptq4vit_tpu_torch.ops import int8_serve as sv
    from ptq4vit_tpu_torch.quant.qparams import MatMulQP
    rng = np.random.default_rng(44)
    dev = "cuda"
    B = 3
    d = H * hd
    qkv = T(rng.standard_normal((B, N, 3 * d))).to(dev)
    t = qkv.reshape(B, N, 3, H, hd).permute(2, 0, 3, 1, 4)
    shape = (1, H, 1, 1, 1, 1, 1)

    def hmax(v):
        return (v.abs().amax((0, 2, 3)) / 127.5).reshape(shape)
    qp1 = MatMulQP(A_interval=hmax(t[0]), B_interval=hmax(t[1]))
    sv.reset_launch_counts()
    for sos, sp in ((True, 2.0 ** -4), (True, 0.5), (True, 2.0 ** -35),
                    (False, 2.0 ** -4)):
        split = torch.tensor(sp, device=dev)
        qp2 = MatMulQP(A_interval=(split / 127 if sos else
                                   torch.full(shape, 1 / 127.5, device=dev)),
                       B_interval=hmax(t[2]), split=split if sos else None)
        ph, _ = sv.attn_scope(qp1, qp2, H)
        step = attn_level_step(ph, sos)
        cols = torch.cat([ph[i].repeat_interleave(hd) for i in (0, 1, 3)])
        lv = torch.clamp(torch.round(qkv / cols), -128, 127).to(torch.int8)
        a_out = torch.tensor(0.02, device=dev)
        for x, in_q8, out_scale in ((qkv, False, None), (qkv, False, a_out),
                                    (lv, True, None), (lv, True, a_out),
                                    (lv, True, torch.tensor(2.0 ** 30,
                                                            device=dev)),
                                    (qkv.bfloat16(), False, None)):
            got = sv.fused_attention_qkv(x, H, qp1, qp2, hd ** -0.5,
                                         in_q8=in_q8, out_scale=out_scale)
            c = x.reshape(B, N, 3, H, hd).permute(2, 0, 3, 1, 4)
            ref = sv.fused_attention_ref(
                c[0], c[1], c[2], ph, split if sos else None, hd ** -0.5,
                out_scale, sos=sos, in_q8=in_q8,
                qmaxes=(128, 128, 128, 128, 128),
                out_dtype=got.dtype if got.is_floating_point() else None)
            ref = ref.transpose(1, 2).reshape(B, N, d)
            torch.cuda.synchronize()
            assert got.dtype == ref.dtype
            if got.dtype == torch.int8:
                assert_levels_close(got, ref)
            else:     # bf16 output: one bf16 step (2^-8) apart at most
                assert_float_close(got, ref, 1e-5 if got.dtype ==
                                   torch.float32 else 2.0 ** -8,
                                   step.repeat_interleave(hd))
        q, k, v = (c.contiguous() for c in t)
        got = sv.fused_attention(q, k, v, qp1, qp2, hd ** -0.5)
        ref = sv.fused_attention_ref(q, k, v, ph, split if sos else None,
                                     hd ** -0.5, None, sos=sos, in_q8=False,
                                     qmaxes=(128,) * 5, out_dtype=q.dtype)
        assert_float_close(got, ref, 1e-5, step.reshape(1, H, 1, 1))
    assert sv.launch_counts() == {"q8_linear": 0, "fused_attention_qkv": 24,
                                  "fused_attention": 4,
                                  "fused_window_attention_qkv": 0,
                                  "q8_win_qkv": 0, "q8_win_proj": 0}


# ---------------------------------------------------------------------------
# Swin serving kernels: B9 (fused_window_attention_qkv), B10 (q8_win_qkv),
# B11 (q8_win_proj) against their plain versions
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("res,ws", [(14, 7), (12, 12)])
def test_window_linears_match_plain_versions_on_the_card(res, ws):
    """B10 and B11 on a grid of 2 x 2 windows of 7 and on one window of 12,
    with float32 and bfloat16 activations, K = 72 (not a whole number of
    32-level chunks) and 216 output columns (past one 128-column tile):
    B11 bitwise; B10's int8 levels within one level in at most 1% of the
    elements (the LayerNorm statistics are summed in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from ptq4vit_tpu_torch.ops import int8_serve as sv
    rng = np.random.default_rng(45)
    dev = "cuda"
    B, C = 3, 72
    nwin = B * (res // ws) ** 2
    sv.reset_launch_counts()
    for dtype in (torch.float32, torch.bfloat16):
        x4 = T(rng.standard_normal((B, res, res, C)) * 2 + 0.3, dtype).to(dev)
        a = float(np.float32(3.0 / (Q - 0.5)))
        w = T(rng.integers(-Q, Q, (C, 3 * C)), torch.int8).to(dev)
        ws_ = T((rng.random(3 * C) + 0.5) / (a * Q * Q * np.sqrt(C) / 3)) \
            .to(dev)
        b = T(rng.standard_normal(3 * C) * 0.1).to(dev)
        ln = (T(1 + 0.1 * rng.standard_normal(C)).to(dev),
              T(0.1 * rng.standard_normal(C)).to(dev), 1e-5)
        cols = T((rng.random(3 * C) + 1.5) / (Q - 0.5)).to(dev)
        args = (x4, w, ws_, b, torch.tensor(a, device=dev), ln, ws, cols)
        got = sv.q8_win_qkv(*args, a_qmax=Q, out_qmax=Q)
        ref = sv.q8_win_qkv_ref(*args, a_qmax=Q, out_qmax=Q)
        torch.cuda.synchronize()
        assert got.shape == ref.shape == (nwin, ws * ws, 3 * C)
        assert_levels_close(got, ref)
        y_q = T(rng.integers(-Q, Q, (nwin, ws * ws, C)), torch.int8).to(dev)
        r4 = T(rng.standard_normal((B, res, res, C)), dtype).to(dev)
        args = (y_q, w[:, :C].contiguous(), ws_[:C].contiguous(),
                b[:C].contiguous(), torch.tensor(0.03, device=dev), ws, res,
                r4)
        got = sv.q8_win_proj(*args, a_qmax=Q)
        ref = sv.q8_win_proj_ref(*args, a_qmax=Q)
        torch.cuda.synchronize()
        assert got.dtype == dtype and torch.equal(got, ref)
    assert sv.launch_counts()["q8_win_qkv"] == 2
    assert sv.launch_counts()["q8_win_proj"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("nW,N,hd,shifted",
                         [(4, 49, 32, False), (1, 144, 32, False),
                          (2, 16, 24, False), (4, 144, 32, True),
                          (2, 196, 32, False)])
def test_window_attention_matches_plain_version_on_the_card(nW, N, hd,
                                                            shifted):
    """B9 (float or int8 in, float or int8 out, float32 or bfloat16), SoS
    (split 2^-4 and 0.5) and per-head, with the rel-pos bias and (nW > 1)
    a mask -- random, or ``shifted``: Swin's shifted-window mask of a
    24 x 24 grid of 12 x 12 windows (N = 144, hd = 32, four windows) --;
    N = 196 (a 14 x 14 window) is past the logits parked in shared memory,
    so the bias and mask are read in each pass --
    against the plain version, under B7's rules: float outputs rtol 1e-5
    (bf16: one bf16 step), atol 2e-5 of max |ref|, except in at most 0.5%
    of the elements, off by at most one probability level's contribution
    more; int8 outputs within one level in at most 1%."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from ptq4vit_tpu_torch.models.swin import shifted_window_mask
    from ptq4vit_tpu_torch.ops import int8_serve as sv
    from ptq4vit_tpu_torch.quant.qparams import MatMulQP
    rng = np.random.default_rng(46)
    dev = "cuda"
    H, images = 3, 3
    C, B_ = H * hd, images * nW
    s = hd ** -0.5
    qkv = T(rng.standard_normal((B_, N, 3 * C))).to(dev)
    bias = T(rng.standard_normal((H, N, N)) * 0.5).to(dev)
    if shifted:
        ws = int(round(N ** 0.5))
        mask = T(shifted_window_mask(2 * ws, ws, ws // 2)).to(dev)
        assert mask.shape == (nW, N, N)
    else:
        mask = (T(np.where(rng.random((nW, N, N)) > 0.7, -100.0, 0.0))
                .to(dev) if nW > 1 else None)
    t = qkv.reshape(B_, N, 3, H, hd).permute(2, 0, 3, 1, 4)
    shape = (1, H, 1, 1, 1, 1, 1)

    def hmax(v):
        return (v.abs().amax((0, 2, 3)) / 127.5).reshape(shape)
    qp1 = MatMulQP(A_interval=hmax(t[0] * s), B_interval=hmax(t[1]))
    sv.reset_launch_counts()
    n = 0
    for sos, sp in ((True, 2.0 ** -4), (True, 0.5), (False, 2.0 ** -4)):
        split = torch.tensor(sp, device=dev)
        qp2 = MatMulQP(A_interval=(split / 127 if sos else
                                   torch.full(shape, 1 / 127.5, device=dev)),
                       B_interval=hmax(t[2]), split=split if sos else None)
        ph, _ = sv.window_attn_scope(qp1, qp2, H, s)
        step = attn_level_step(ph, sos).repeat_interleave(hd)
        cols = torch.cat([ph[i].repeat_interleave(hd) for i in (0, 1, 3)])
        lv = torch.clamp(torch.round(qkv / cols), -128, 127).to(torch.int8)
        a_out = torch.tensor(0.02, device=dev)
        for x, in_q8, out_scale in ((qkv, False, None), (lv, True, a_out),
                                    (lv, True, None),
                                    (qkv.bfloat16(), False, None)):
            got = sv.fused_window_attention_qkv(
                x, H, nW, qp1, qp2, s, bias, mask, in_q8=in_q8,
                out_scale=out_scale)
            ref = sv.fused_window_attention_ref(
                x, H, nW, ph, split if sos else None, s, bias, mask,
                out_scale, sos=sos, in_q8=in_q8, qmaxes=(128,) * 5,
                out_dtype=got.dtype if got.is_floating_point() else None)
            torch.cuda.synchronize()
            assert got.dtype == ref.dtype and got.shape == (B_, N, C)
            if got.dtype == torch.int8:
                assert_levels_close(got, ref)
            else:
                assert_float_close(got, ref, 1e-5 if got.dtype ==
                                   torch.float32 else 2.0 ** -8, step)
            n += 1
    assert sv.launch_counts()["fused_window_attention_qkv"] == n


@pytest.mark.parametrize("name", ["vit_base_patch16_384",
                                  "swin_base_patch4_window12_384"])
@pytest.mark.parametrize("images", [4, 8, 32])
def test_fp32_plans_cover_candidates_and_fill_the_card(name, images):
    """Every B4w / B4a plan of the model's exact-scoring calibration (its
    linears at P = 100, n_V 1 and 3): the candidate groups cover each
    candidate exactly once; a block's shared memory fits its share of an
    SM (two blocks of 128 x 128 outputs an SM, so within 232,448 bytes)
    with a ring of at least two slots (three without the twin's negative
    levels); the grid gives every block slot of the card a block wherever
    tiles x P allows it; every bin of a tile has its thread; and where the
    work spans ten waves or more, the tail wastes at most 10% of the
    slots' time."""
    calls = set(linear_calls(name, images))
    assert {n_V for *_, n_V, _ in calls} == {1, 3}
    assert sk.F_BLOCKS_PER_SM == 2
    slots = sk.NUM_SMS * sk.F_BLOCKS_PER_SM
    for kind, M, N, K, P, n_V, twin in calls:
        assert N % n_V == 0 and n_V <= 256      # one thread a bin
        twin = twin and kind == "a"             # B4a's negative levels
        plan = sk.fp32_plan(kind, M, N, K, P, twin)
        assert plan.smem == sk.fp32_smem_bytes(kind, twin, plan.stages)
        assert plan.smem <= sk.LQ_BLOCK_SMEM <= sk.SMEM_LIMIT
        assert plan.stages >= (2 if twin else 3)
        covered = [p for g in range(plan.groups)
                   for p in range(g * plan.pc, min(P, (g + 1) * plan.pc))]
        assert covered == list(range(P))
        assert plan.tiles == -(-M // 128) * -(-N // 128)
        assert plan.blocks == plan.tiles * plan.groups
        assert plan.blocks >= min(slots, plan.tiles * P)
        assert plan.waves == -(-plan.blocks // slots)
        if plan.tiles * P >= 10 * slots:
            assert plan.fill >= 0.9, (kind, M, N, K, plan)


# ---------------------------------------------------------------------------
# B6 / B10 / B11 on the tensor cores (q8_tc_kernel): the plan on the CPU,
# the kernel at ragged shapes on the card
# ---------------------------------------------------------------------------

def serve_linear_calls(name, images):
    """(M, K, N) of every linear a served forward of ``name`` on
    ``images`` images runs through B6, B10 or B11 (the block paths and
    the per-op paths: qkv, proj, fc1, fc2, Swin's reductions, the head)."""
    from ptq4vit_tpu_torch.models import model_config, swin, vit
    cfg = model_config(name)
    mod = swin if name.startswith("swin") else vit
    for info in mod.op_shapes(cfg).values():
        if info["kind"] == "linear":
            yield (info["tokens"] * images, info["in_features"],
                   info["out_features"])


@pytest.mark.parametrize("name", ["vit_base_patch16_384",
                                  "swin_base_patch4_window12_384"])
@pytest.mark.parametrize("images", [1, 8, 32])
def test_q8_plans_cover_outputs_and_fit(name, images):
    """Every B6 / B10 / B11 plan of the model's serving linears, in each
    input mode, with the residual tile or without: a block's shared memory
    fits its share of an SM (three blocks an SM, two for the twin, one
    where the call has no more tiles than SMs) within 232,448 bytes, with
    the deepest ring of 2 to 6 slots that does; the blocks' contiguous
    runs of the row-major tile sequence, split as the kernel splits it
    (block b takes tiles [T b / G, T (b + 1) / G)), cover every 64 x 128
    output tile exactly once; the grid fills the card's block slots once
    (or holds one block a tile) and stays within a 1-D grid's 2^31 - 1
    blocks."""
    from ptq4vit_tpu_torch.ops import int8_serve as sv
    calls = set(serve_linear_calls(name, images))
    assert calls
    for M, K, N in calls:
        for mode in ("f", "f_twin", "q8", "q8twin"):
            for res_tile in (False, True):
                plan = sv.q8_plan(M, N, mode, res_tile)
                twin = mode in sv.TWIN_MODES
                T = plan.row_tiles * plan.col_tiles
                assert plan.per_sm == (1 if T <= sk.NUM_SMS else
                                       2 if twin else 3)
                assert plan.res_tile == res_tile
                assert plan.smem == sv.q8_smem_bytes(twin, plan.stages,
                                                     res_tile)
                budget = sk.SM_SMEM // plan.per_sm - 1024
                assert plan.smem <= budget <= sk.SMEM_LIMIT
                assert 2 <= plan.stages <= sv.Q_MAX_STAGES == 6
                assert plan.stages == sv.Q_MAX_STAGES or sv.q8_smem_bytes(
                    twin, plan.stages + 1, res_tile) > budget
                assert plan.row_tiles == -(-M // sv.Q_ROWS)
                assert plan.col_tiles == -(-N // sv.Q_COLS)
                G = plan.blocks
                assert G == min(T, sk.NUM_SMS * plan.per_sm) < 2 ** 31 - 1
                runs = [(T * b // G, T * (b + 1) // G) for b in range(G)]
                assert runs[0][0] == 0 and runs[-1][1] == T
                assert all(r[1] == n[0] for r, n in zip(runs, runs[1:]))
                assert all(r[1] - r[0] in (T // G, -(-T // G)) for r in runs)


def test_q8_plan_and_level_pre_pass_at_vit_shapes():
    """ViT-B/384 at 32 images (M = 18,464): two ring slots of 24 KB, three
    blocks an SM, 396 blocks; the twin fc2 two slots of 32 KB, two blocks
    an SM; the head (32 rows, eight tiles) one block a tile, six slots.
    The level pre-pass
    runs for float input and for int8 rows TMA cannot read (K not a
    multiple of 16, or a misaligned start), not for the block's int8
    handoffs; a refused mode or an empty call raises."""
    from ptq4vit_tpu_torch.ops import int8_serve as sv
    M = 32 * 577
    p = sv.q8_plan(M, 2304, "f")
    assert (p.stages, p.per_sm, p.blocks) == (2, 3, 3 * sk.NUM_SMS)
    assert p.smem == 1024 + 2 * 24576 + 9216 + 256 + 32
    p = sv.q8_plan(M, 768, "q8twin")
    assert (p.stages, p.per_sm, p.blocks) == (2, 2, 2 * sk.NUM_SMS)
    p = sv.q8_plan(32, 1000, "f")                           # the head
    assert (p.stages, p.per_sm, p.blocks) == (6, 1, 8)
    x8 = torch.zeros((4, 96), dtype=torch.int8)
    assert not sv.q8_needs_levels(x8, 96, "q8")
    assert sv.q8_needs_levels(x8[:, :95].contiguous(), 95, "q8twin")
    assert sv.q8_needs_levels(x8.view(-1)[1:353].view(11, 32), 32, "q8")
    assert sv.q8_needs_levels(torch.zeros((4, 96)), 96, "f")
    with pytest.raises(ValueError):
        sv.q8_plan(M, 768, "int4")
    with pytest.raises(ValueError):
        sv.q8_plan(0, 768, "f")


@pytest.mark.cuda
def test_q8_plan_matches_the_library_on_the_card():
    """The library sizes a B6 / B10 / B11 block's shared memory as
    q8_plan does, twin or not, with the residual tile or not, at every
    ring depth."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from ptq4vit_tpu_torch.ops import int8_serve as sv
    from ptq4vit_tpu_torch.ops.build import load
    lib = load("serve_kernels")
    for twin in (False, True):
        for stages in range(2, 7):
            for res_tile in (False, True):
                assert lib.ptq_q8_smem_bytes(
                    int(twin), stages, int(res_tile)) == \
                    sv.q8_smem_bytes(twin, stages, res_tile)


# chip_smoke.py's seven B6 cases: (label, input mode, LayerNorm, GELU,
# output); its fp32 engine's qkv is qkv at float32
Q8_SMOKE_MODES = [("qkv", "f", True, False, "vec"),
                  ("proj", "q8", False, False, "residual"),
                  ("fc1", "f", True, True, "twin"),
                  ("fc2", "q8twin", False, False, "residual"),
                  ("head", "f", False, False, "float"),
                  ("per-op fc2", "f_twin", False, False, "float")]


def layer_norm_kernel_order(x, w, b, eps):
    """LayerNorm of the rows of x (M, K) in the kernel's order: 32 lanes
    each sum every 32nd element in turn, then a butterfly of the lanes'
    sums; the mean, then the mean of squared deviations; every step one
    fp32 rounding, the reciprocal square root correctly rounded (the
    kernel's __frsqrt_rn).  Fed to the plain version without its own
    LayerNorm, it makes the kernel's outputs comparable bitwise."""
    x = x.float()
    M, K = x.shape
    kp = -(-K // 32) * 32
    lanes = torch.arange(32, device=x.device)

    def lane_mean(v):
        v = torch.nn.functional.pad(v, (0, kp - K)).reshape(M, kp // 32, 32)
        s = torch.zeros((M, 32), device=x.device)
        for j in range(kp // 32):
            s = s + v[:, j]
        for off in (16, 8, 4, 2, 1):
            s = s + s[:, lanes ^ off]
        # a tensor divisor: PyTorch divides by a Python number through its
        # reciprocal, which is not the kernel's IEEE division
        return s[:, :1] / torch.full_like(s[:, :1], K)
    mu = lane_mean(x)
    d = x - mu
    var = lane_mean(d * d)
    rs = (1.0 / torch.sqrt((var + eps).double())).float()
    return (x - mu) * rs * w.float()[None] + b.float()[None]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_q8_kernel_matches_plain_version_at_ragged_shapes(dtype):
    """The tensor-core kernel in chip_smoke.py's seven B6 modes (qkv in
    float32 is its fp32 engine's) at M 1, 63, 65 and 129 (ragged 64-row
    tiles), K 32, 100 (not a multiple of 16: int8 input through the level
    pre-pass, scalar loads) and 3072 (24 K chunks), N 8, 24 (narrower than
    one wgmma tile), 1000 and 2304:
    bitwise the plain version's, the LayerNorm computed in the kernel's
    order (layer_norm_kernel_order) -- float and int8 outputs alike."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from ptq4vit_tpu_torch.ops import int8_serve as sv
    rng = np.random.default_rng(47)
    sv.reset_launch_counts()
    n = 0
    for label, mode, ln, gelu, out in Q8_SMOKE_MODES:
        for M in (1, 63, 65, 129):
            for K in (32, 100, 3072):
                for N in (8, 24, 1000, 2304):
                    args, kw = q8_case(rng, mode, ln, gelu, out, M, K, N, Q,
                                       dtype)
                    got = sv.q8_linear(*args, **kw)
                    ref_kw = dict(kw, ln=None,
                                  float_dtype=kw["float_dtype"] or dtype)
                    x = args[0]
                    if ln:
                        x = layer_norm_kernel_order(x, *kw["ln"])
                    ref = sv.q8_linear_ref(x, *args[1:], **ref_kw)
                    torch.cuda.synchronize()
                    assert got.dtype == ref.dtype
                    assert torch.equal(got, ref), (label, M, K, N)
                    n += 1
    assert sv.launch_counts()["q8_linear"] == n


@pytest.mark.cuda
@pytest.mark.parametrize("res,ws,C", [(14, 7, 72), (12, 12, 100),
                                      (24, 12, 128)])
def test_q8_row_maps_match_plain_version_on_the_card(res, ws, C):
    """The kernel on its three row maps -- B6's rows as they are, B10's
    input rows gathered from the image layout, B11's output and residual
    rows scattered to it -- in float32 and bfloat16, C = 72 and 100 (no
    16-byte rows) and 128: every output bitwise the plain version's, with
    B10's LayerNorm in the kernel's order; and B6 given the window-ordered
    rows equals B10."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from ptq4vit_tpu_torch.models.swin import window_partition
    from ptq4vit_tpu_torch.ops import int8_serve as sv
    rng = np.random.default_rng(48)
    dev = "cuda"
    B = 3
    nwin = B * (res // ws) ** 2
    sv.reset_launch_counts()
    for dtype in (torch.float32, torch.bfloat16):
        x4 = T(rng.standard_normal((B, res, res, C)) * 2 + 0.3, dtype).to(dev)
        a = torch.tensor(float(np.float32(3.0 / (Q - 0.5))), device=dev)
        w = T(rng.integers(-Q, Q, (C, 3 * C)), torch.int8).to(dev)
        ws_ = T((rng.random(3 * C) + 0.5) / (float(a) * Q * Q * np.sqrt(C)
                                            / 3)).to(dev)
        b = T(rng.standard_normal(3 * C) * 0.1).to(dev)
        ln = (T(1 + 0.1 * rng.standard_normal(C)).to(dev),
              T(0.1 * rng.standard_normal(C)).to(dev), 1e-5)
        cols = T((rng.random(3 * C) + 1.5) / (Q - 0.5)).to(dev)
        got = sv.q8_win_qkv(x4, w, ws_, b, a, ln, ws, cols, a_qmax=Q,
                            out_qmax=Q)
        xw = window_partition(x4, ws)
        ref = sv.q8_linear_ref(
            layer_norm_kernel_order(xw.reshape(-1, C), *ln), w, ws_, b, a,
            None, a_qmax=Q, postgelu=False, out_q="vec", out_scale=cols,
            out_qmax=Q).reshape(got.shape)
        torch.cuda.synchronize()
        assert torch.equal(got, ref)
        same = sv.q8_linear(xw.contiguous(), w, ws_, b, a, None, a_qmax=Q,
                            postgelu=False, ln=ln, out_q="vec",
                            out_scale=cols, out_qmax=Q)
        assert torch.equal(got, same)
        y_q = T(rng.integers(-Q, Q, (nwin, ws * ws, C)), torch.int8).to(dev)
        r4 = T(rng.standard_normal((B, res, res, C)), dtype).to(dev)
        args = (y_q, w[:, :C].contiguous(), ws_[:C].contiguous(),
                b[:C].contiguous(), torch.tensor(0.03, device=dev), ws, res,
                r4)
        got = sv.q8_win_proj(*args, a_qmax=Q)
        ref = sv.q8_win_proj_ref(*args, a_qmax=Q)
        torch.cuda.synchronize()
        assert got.dtype == dtype and torch.equal(got, ref)
    assert sv.launch_counts()["q8_win_qkv"] == 2
    assert sv.launch_counts()["q8_win_proj"] == 2
    assert sv.launch_counts()["q8_linear"] == 2


@pytest.mark.cuda
def test_q8_refuses_what_it_cannot_run_on_the_card():
    """A K-major weight of the wrong shape, a plan beyond shared memory
    and a float input without the level scratch are refused; nothing
    falls back to the plain version on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from ptq4vit_tpu_torch.ops import int8_serve as sv
    from ptq4vit_tpu_torch.ops.build import load
    rng = np.random.default_rng(49)
    args, kw = q8_case(rng, "f", False, False, "float", 70, 40, 24, Q,
                       torch.float32)
    with pytest.raises(ValueError):
        sv.q8_linear(*args, **kw,
                     w_kmaj=torch.zeros((24, 40), dtype=torch.int8,
                                        device="cuda"))
    lib = load("serve_kernels")
    out = torch.empty((70, 24), device="cuda")
    wk = torch.zeros((24, 48), dtype=torch.int8, device="cuda")
    lv = torch.empty((70, 48), dtype=torch.int8, device="cuda")
    scal = torch.ones(4, device="cuda")
    ws = torch.ones(24, device="cuda")

    def call(stages, levels):
        return lib.ptq_q8_linear(
            args[0].data_ptr(), 0, wk.data_ptr(), 48, ws.data_ptr(), None,
            None, None, None, None, out.data_ptr(), 0, scal.data_ptr(), 0.0,
            levels, 70, 40, 24, 0, 0, 0, 0, Q, Q, stages, 0, 1, None)
    assert call(40, lv.data_ptr()) == 9003     # 40 ring slots do not fit
    assert call(2, None) != 0                  # float input, no scratch
    assert call(2, lv.data_ptr()) == 0


def attention_shapes(name):
    """(N, hd, heads) of each attention a served forward of ``name``
    runs: ViT / DeiT one (tokens, with the class and distillation tokens),
    Swin one a stage (window tokens)."""
    from ptq4vit_tpu_torch.models import model_config
    cfg = model_config(name)
    if name.startswith("swin"):
        return [(cfg.window_size ** 2, cfg.embed_dim * 2 ** i // h, h)
                for i, h in enumerate(cfg.num_heads)]
    n = (cfg.img_size // cfg.patch_size) ** 2 + (2 if cfg.distilled else 1)
    return [(n, cfg.embed_dim // cfg.num_heads, cfg.num_heads)]


@pytest.mark.parametrize("name,stage", [
    ("vit_base_patch16_384", 0), ("deit_small_patch16_224", 0),
    ("swin_base_patch4_window12_384", 0),
    ("swin_base_patch4_window12_384", 1),
    ("swin_base_patch4_window12_384", 2),
    ("swin_base_patch4_window12_384", 3)])
def test_attn_plans_fit_at_serving_shapes(name, stage):
    """B7 / B8 / B9's plan at each serving attention: ViT-B/384 (N = 577,
    hd = 64), DeiT-S/224 (N = 197, hd = 64) and Swin-B/384's four stages
    (N = 144, hd = 32; 4, 8, 16 and 32 heads).  k and the transposed v fit
    232,448 bytes of shared memory, and two blocks an SM at these shapes;
    the head dim is padded with zero levels to 32 or 64 and the keys to a
    multiple of 32, both by less than one step; the row strides are 16
    bytes times an odd number (ldmatrix's 8 rows on distinct banks); the
    16-row strips fill a block's warps (one block an image or window and
    head) with fewer idle slots than a warp, 8 warps at most (4 where the
    logits are parked in shared memory, which they are at N <= 160:
    Swin's windows, 10 KB a warp); the 32-image grid of (image or window,
    head) blocks stays within 2^31 - 1."""
    from ptq4vit_tpu_torch.ops import int8_serve as sv
    N, hd, heads = attention_shapes(name)[stage]
    p = sv.attn_plan(N, hd)
    assert p.smem == p.keys * p.kstr + p.hdp * p.vstr + (
        p.warps * p.keys * 16 * 4 if p.parked else 0)
    assert p.smem <= sk.SM_SMEM // 2 - 1024 < sk.SMEM_LIMIT == 232448
    assert p.hdp in (32, 64) and hd <= p.hdp < hd + 32
    assert p.keys % 32 == 0 and N <= p.keys < N + 32
    assert (p.kstr, p.vstr) == (p.hdp + 16, p.keys + 16)
    assert p.kstr // 16 % 2 == 1 and p.vstr // 16 % 2 == 1
    assert p.strips == -(-N // 16)
    assert p.parked == (N <= 160)
    assert 1 <= p.warps <= (4 if p.parked else 8)
    assert -(-p.strips // p.warps) * p.warps - p.strips < p.warps
    windows = (32 * (384 // 4 // 2 ** stage // 12) ** 2
               if name.startswith("swin") else 32)
    assert windows * heads < 2 ** 31 - 1
    expect = {"vit_base_patch16_384": (64, 608, False, 8, 88576),
              "deit_small_patch16_224": (64, 224, False, 7, 33280),
              "swin_base_patch4_window12_384": (32, 160, True, 3, 44032)}
    assert (p.hdp, p.keys, p.parked, p.warps, p.smem) == expect[name]


def test_attn_plan_pads_keys_and_head_dim():
    """Head dims 1-32 pad to 32 and 33-64 to 64; keys to the next multiple
    of 32 (1 -> 32, 32 -> 32, 33 -> 64, 577 -> 608); the logits are
    parked up to N = 160 (five 32-key chunks), at any head dim; one 16-row
    strip runs one warp."""
    from ptq4vit_tpu_torch.ops import int8_serve as sv
    assert [sv.attn_plan(50, hd).hdp for hd in (1, 24, 32, 33, 64)] == \
        [32, 32, 32, 64, 64]
    assert [sv.attn_plan(n, 32).keys for n in (1, 32, 33, 577)] == \
        [32, 32, 64, 608]
    assert sv.attn_plan(160, 32).parked
    assert not sv.attn_plan(161, 32).parked
    assert sv.attn_plan(50, 64).parked
    assert sv.attn_plan(16, 24).warps == 1
    assert sv.attn_plan(49, 32).warps == 4


def test_attn_plan_refuses_what_does_not_fit():
    """A head dim past 64 (or none), no keys, and keys whose k and
    transposed v exceed a block's shared memory raise ValueError: the
    kernel has no other plan and nothing to fall back to.  1,600 keys at
    hd 64 are the most that fit."""
    from ptq4vit_tpu_torch.ops import int8_serve as sv
    for N, hd in ((577, 65), (577, 0), (0, 64), (1601, 64), (4000, 32)):
        with pytest.raises(ValueError):
            sv.attn_plan(N, hd)
    assert sv.attn_plan(1600, 64).smem <= sk.SMEM_LIMIT




@pytest.mark.parametrize("library", ["search_kernels", "serve_kernels"])
def test_ctypes_signatures_match_the_c_entries(library):
    """Every C entry point of the library's source (its extern "C" block)
    has the ctypes argument types ops/build.py gives it, one for one: a
    pointer (and the stream) c_void_p, int c_int, float c_float, long long
    c_longlong; and build.py names no entry the source lacks."""
    import ctypes
    import re
    from ptq4vit_tpu_torch.ops import build
    c_types = {"int": ctypes.c_int, "float": ctypes.c_float,
               "long long": ctypes.c_longlong}
    with open(build.source_path(library)) as f:
        src = f.read()
    block = src[src.index('extern "C" {'):]
    found = {}
    for m in re.finditer(r"^int (ptq_\w+)\(([^)]*)\)\s*\{", block, re.M):
        types = []
        for arg in m.group(2).split(","):
            words = arg.split()
            ctype = " ".join(w for w in words[:-1] if w != "const")
            types.append(ctypes.c_void_p if "*" in arg else c_types[ctype])
        found[m.group(1)] = types
    assert found == build.LIBRARIES[library]


@pytest.mark.cuda
def test_attn_plan_matches_the_library_on_the_card():
    """The library plans an attention as attn_plan does (padded head dim
    and keys, row strides, parking, warps, shared memory) and refuses what
    it refuses."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from ptq4vit_tpu_torch.ops import int8_serve as sv
    from ptq4vit_tpu_torch.ops.build import load
    lib = load("serve_kernels")
    out = torch.zeros(7, dtype=torch.int32)
    for N in (1, 16, 37, 49, 130, 144, 160, 161, 197, 577, 1600, 1601):
        for hd in (24, 32, 64, 65):
            err = lib.ptq_attn_plan(N, hd, out.data_ptr())
            try:
                p = sv.attn_plan(N, hd)
            except ValueError:
                assert err != 0, (N, hd)
                continue
            assert err == 0, (N, hd)
            assert out.tolist() == [p.hdp, p.keys, p.kstr, p.vstr,
                                    int(p.parked), p.warps, p.smem]


def test_fast_division_is_the_ieee_quotient():
    """The attention kernel's ``div_rn_fast`` (csrc/serve_kernels.cu),
    emulated in exact rational arithmetic with float32 rounding: from y =
    RN(1 / b), q = RN(a y) and two Markstein corrections q = RN(q + RN(a -
    b q) y) (each an FMA, one rounding) give RN(a / b), the IEEE quotient
    ``__fdiv_rn`` returns, on the range the kernel takes it (a in [2^-42,
    2^40], quotients above 2^-80): random operands, divisors with all-ones
    significands, and numerators whose quotient lies next to a rounding
    midpoint.  The uncorrected product RN(a y) is wrong on some of them,
    so the cases can tell a weaker sequence from the kernel's."""
    import math
    from fractions import Fraction as Fr

    def rn(x):
        if x == 0:
            return Fr(0)
        sign, x = (-1 if x < 0 else 1), abs(x)
        e = x.numerator.bit_length() - x.denominator.bit_length()
        while Fr(2) ** e > x:
            e -= 1
        while Fr(2) ** (e + 1) <= x:
            e += 1
        assert e >= -126
        m = x * Fr(2) ** (23 - e)
        f = math.floor(m)
        if m - f > Fr(1, 2) or (m - f == Fr(1, 2) and f % 2):
            f += 1
        return sign * Fr(f) / Fr(2) ** (23 - e)

    def fast(a, b, steps=2):
        y = rn(1 / b)
        q = rn(a * y)
        for _ in range(steps):
            q = rn(q + rn(a - b * q) * y)
        return q

    rng = np.random.default_rng(50)

    def mant(lo=2 ** 23, hi=2 ** 24):
        return Fr(int(rng.integers(lo, hi)), 2 ** 23)
    cases = []
    for _ in range(600):      # the sum s and the level scales as divisors
        b = rn(mant() * Fr(2) ** int(rng.integers(-40, 11)))
        cases.append((rn(mant() * Fr(2) ** -int(rng.integers(1, 40))), b))
    for k in range(40):       # all-ones significands
        b = Fr(2 ** 24 - 1 - k, 2 ** 23) * Fr(2) ** int(rng.integers(0, 10))
        cases.append((rn(mant() * Fr(2) ** -int(rng.integers(1, 40))), b))
    one_step_wrong = 0
    for _ in range(1500):     # quotients next to a midpoint
        b = mant() * Fr(2) ** int(rng.integers(0, 10))
        mid = Fr(2 * int(rng.integers(2 ** 23, 2 ** 24)) + 1, 2 ** 24) \
            * Fr(2) ** -int(rng.integers(1, 30))
        a = rn(b * mid)
        if 0 < a <= 1:
            cases.append((a, b))
    for a, b in cases:
        assert fast(a, b) == rn(a / b), (float(a), float(b))
        one_step_wrong += fast(a, b, steps=0) != rn(a / b)
    assert len(cases) > 1500 and one_step_wrong > 0


@pytest.mark.cuda
def test_partial_resume_equals_uninterrupted_on_the_card(tmp_path):
    """A small ViT (embed 128, 2 heads, depth 2) calibrated on the card in
    two parts through a checkpoint directory -- the patch-embed conv and
    block 0, then every op -- equals one uninterrupted calibration in
    every interval slot, bitwise; the second part searches only block 1
    and the head, and ``load_qstate`` lands on the card by default."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from ptq4vit_tpu_torch.calib.calibrator import (HessianQuantCalibrator,
                                                    load_qstate)
    from ptq4vit_tpu_torch.configs import ptq4vit
    from ptq4vit_tpu_torch.models import net_from_config, vit
    from ptq4vit_tpu_torch.models.net_wrap import wrap_certain_modules_in_net
    cfg = vit.ViTConfig(name="card_vit", img_size=64, patch_size=16,
                        embed_dim=128, depth=2, num_heads=2, num_classes=10)
    net = net_from_config(cfg, vit.init_params(
        cfg, np.random.default_rng(0), device="cuda"))
    x = np.random.default_rng(1).standard_normal(
        (8, 3, 64, 64)).astype(np.float32)
    d = str(tmp_path / "ck")

    def calib(**kw):
        c = HessianQuantCalibrator(net, ptq4vit(), x, batch_size=4, **kw)
        return c.batching_quant_calib(), c.report

    part = wrap_certain_modules_in_net(       # the head has no block index
        net, ptq4vit(), layers=[0], modules_to_wrap=list(
            {n.rsplit(".", 1)[-1] for n, _ in net.op_inventory} - {"head"}),
        wrap_embedding=True)
    assert "head" not in part and "blocks.1.attn.qkv" not in part
    calib(checkpoint_dir=d, wrapped_modules=part)
    resumed, report = calib(checkpoint_dir=d)
    assert set(report.search_seconds) == {
        n for n, _ in net.op_inventory if n not in part}
    whole, _ = calib()
    assert list(resumed) == list(whole)
    for n in whole:
        for f, v in vars(whole[n]).items():
            if torch.is_tensor(v):
                assert torch.equal(getattr(resumed[n], f), v), (n, f)
    loaded = load_qstate(d)
    assert loaded["head"].w_interval.is_cuda
