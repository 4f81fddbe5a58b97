"""The candidate scorers of the calibration search.

Each public function takes the arguments of its JAX counterpart in
``ptq4vit_tpu/ops/pallas_search.py`` and returns the same un-normalized
hessian similarity sums ``-Σ (g·(raw − out))²`` per candidate:

  linear_w_hessian_sims_i8  <- linear_w_hessian_sims_i8 (B1)
  linear_a_hessian_sims_i8  <- linear_a_hessian_sims_i8 (B2)
  matmul_hessian_sims       <- matmul_hessian_sims: counted as B3 (body
                               _mm_kernel) where ``mm_fold_factor`` is 1,
                               as B3f (body _mm_kernel_folded) where it is
                               > 1, as the JAX function picks its body; one
                               tensor-core kernel serves both
  linear_w_hessian_sims     <- linear_w_hessian_sims (B4w, exact scoring)
  linear_a_hessian_sims     <- linear_a_hessian_sims (B4a, exact scoring)

For CUDA tensors the kernel wrappers launch the hand-written kernels of
``csrc/search_kernels.cu`` (or raise); for CPU tensors they run the plain
PyTorch version beside them (``*_ref``), which follows the same formulas.
For the int8 scorers the int8 dot is a float64 matmul of the levels, exact
because every sum stays far below 2**53, and the fp32 rescale keeps the
kernels' operation order; the fp32 scorers take fp32 products of the
fake-quant values, as the kernels do, summed in another order.  B3 and B3f
compute the same function, so both have ``matmul_hessian_sims_ref`` as
their plain version.  Each kernel wrapper counts its kernel launches in
``<function>.launches`` and runs inside the span ``ptq.kernel.<function>``
(``utils/tracing.span``: its host preparation and its launches).

Every wrapper takes ``scratch_bound``: the bytes its level buffers,
partial sums and sims may hold at once (None: no bound).  Where one call
of all P candidates would exceed it, the wrapper cuts the candidates into
chunks (``candidate_chunk``), runs the kernel once a chunk and joins the
sims in order (``in_chunks``); a candidate's sim does not depend on the
others of its launch, so the chunked call equals the whole call bitwise.
``*_scratch`` give a call's bytes as (fixed, per candidate); the
calibrator plans with them (``calib/calibrator.kernel_scratch_bytes``).
"""
from __future__ import annotations

import functools

from typing import NamedTuple, Optional, Sequence

import torch

from ..quant.fakequant import exact_div
from ..utils.tracing import spanned

K_PAD = 32   # level rows are K-padded to this many bytes (csrc TK)

# B1 / B2 on the tensor cores (csrc LQ_*): a block holds a 64-row tile of
# the operand no candidate changes and streams 64-row tiles of the
# candidate operand in 128-byte K chunks through a ring of slots
LQ_ROWS, LQ_KC = 64, 128
LQ_TILE = LQ_ROWS * LQ_KC     # one chunk of either tile
LQ_CWARPS = 4                 # consumer warps of a block (one warpgroup)
SMEM_LIMIT = 232448           # dynamic shared memory a block may use
SM_SMEM = 233472              # an SM's; each block's takes 1 KB more
# two blocks share an SM's 228 KB, so that one block's epilogue overlaps
# the other's products
LQ_BLOCK_SMEM = SM_SMEM // 2 - 1024
LQ_MAX_STAGES = 6
LQ_WACC_BYTES = 16384         # per-warp, per-candidate sums of one launch


def k_pad(K: int) -> int:
    """K rounded up to the level buffers' row length."""
    return -(-K // K_PAD) * K_PAD


class LinearPlan(NamedTuple):
    """How B1 (``kind`` "w") or B2 ("a") runs one call on the card.

    resident: the fixed tile(s) stay in shared memory for the whole
    candidate loop (else they stream with every K chunk); stages: ring
    slots; pc: candidates a launch (the per-warp sums of pc candidates and
    nbl bins fit LQ_WACC_BYTES); nbl: row-block bins a block's 64 columns
    span (B1; 1 for B2); blocks: blocks (and partial sums per candidate and
    bin) of a launch; smem: dynamic shared memory of a block, at most
    LQ_BLOCK_SMEM."""
    resident: bool
    stages: int
    pc: int
    nbl: int
    blocks: int
    smem: int


def linear_smem_bytes(nl: int, K: int, resident: bool, stages: int, pc: int,
                      nbl: int) -> int:
    """A block's dynamic shared memory (csrc ``lin_smem_bytes``): 1 KB of
    alignment slack, the resident fixed tile(s), the ring, the per-warp
    sums, the mbarriers."""
    nc = -(-k_pad(K) // LQ_KC)
    slot = LQ_TILE * (1 + (0 if resident else nl))
    return (1024 + (nl * nc * LQ_TILE if resident else 0)
            + stages * slot + 4 * LQ_CWARPS * pc * nbl + 8 * (2 * stages + 1))


def linear_plan(kind: str, M: int, N: int, K: int, P: int, n_V: int = 1,
                twin: bool = False) -> LinearPlan:
    """The plan of a B1 (``kind`` "w": fixed x levels of 64 rows, 64
    weight columns a candidate tile; ``twin``: the post-GELU pair of fixed
    tiles) or B2 ("a": fixed weight levels of 64 columns, 64 input rows a
    candidate tile) call, within LQ_BLOCK_SMEM.  The fixed tile(s) stay
    resident where they fit beside a ring of two slots (up to 1024 K bytes
    of fixed rows here: not ViT's fc2, nor the post-GELU pairs past Swin's
    stage 1, which stream with every chunk); the ring takes what is left,
    up to LQ_MAX_STAGES slots."""
    if kind not in ("w", "a"):
        raise ValueError(f"unknown kind {kind}")
    nl = 2 if kind == "w" and twin else 1
    blocks = -(-M // LQ_ROWS) * -(-N // LQ_ROWS)
    if kind == "w":
        crb = N // n_V
        nbl = max((min(n0 + LQ_ROWS, N) - 1) // crb - n0 // crb + 1
                  for n0 in range(0, N, LQ_ROWS))
    else:
        nbl = 1
    pc = max(1, min(P, LQ_WACC_BYTES // (4 * LQ_CWARPS * nbl)))
    resident = linear_smem_bytes(nl, K, True, 2, pc, nbl) <= LQ_BLOCK_SMEM
    stages = 2
    while (stages < LQ_MAX_STAGES and linear_smem_bytes(
            nl, K, resident, stages + 1, pc, nbl) <= LQ_BLOCK_SMEM):
        stages += 1
    return LinearPlan(resident, stages, pc, nbl, blocks,
                      linear_smem_bytes(nl, K, resident, stages, pc, nbl))


# B4w / B4a on the fp32 CUDA cores (csrc F*): a block owns a 128 x 128
# output tile and a group of candidates, two blocks an SM (each within
# LQ_BLOCK_SMEM), and streams (candidate, 32-k chunk) steps through a ring
# of slots: the fixed fp32 tile k-major, the raw levels (and the post-GELU
# twin's negative levels)
F_TILE, F_KC = 128, 32
F_RED_BYTES = 4 * 17 * F_TILE             # the epilogue's column sums
F_MAX_STAGES = 4
F_BLOCKS_PER_SM = 2
NUM_SMS = 132     # H100 SXM; the wrappers pass the card's own count


class Fp32Plan(NamedTuple):
    """How B4w or B4a runs one call on the card.

    stages: ring slots; pc: candidates a block (the last of the ``groups``
    groups may hold fewer); tiles: output tiles (and partial sums per
    candidate and bin); blocks: tiles x groups; waves: blocks over the
    card's block slots (``num_sms`` x F_BLOCKS_PER_SM), rounded up;
    fill: the share of the waves' slot time that holds candidate work;
    smem: dynamic shared memory of a block."""
    stages: int
    pc: int
    groups: int
    tiles: int
    blocks: int
    waves: int
    fill: float
    smem: int


def fp32_smem_bytes(kind: str, twin: bool, stages: int) -> int:
    """A B4w (``kind`` "w") or B4a ("a"; ``twin``: post-GELU) block's
    dynamic shared memory (csrc ``fp32_smem_bytes``): the ring slots (the
    fixed operand's k-major fp32 tile, the raw levels, the twin's negative
    levels), two expanded level tiles, the epilogue's column sums."""
    tile = 4 * F_KC * (F_TILE + 4)
    raw = F_TILE * F_KC * (2 if kind == "a" and twin else 1)
    return stages * (tile + raw) + 2 * tile + F_RED_BYTES


def fp32_plan(kind: str, M: int, N: int, K: int, P: int,
              twin: bool = False, num_sms: int = NUM_SMS) -> Fp32Plan:
    """The plan of a B4w (``kind`` "w") or B4a ("a"; ``twin``: post-GELU)
    call on a card of ``num_sms`` SMs: the most ring slots (up to
    F_MAX_STAGES) within LQ_BLOCK_SMEM, and the candidate groups.  Each
    group count G gives groups of pc = ceil(P / G); the plan takes the G
    with the least time in block waves, ``ceil(tiles G / slots) (pc + 4 /
    chunks)`` (a block's start and pipeline fill cost about four of its K
    chunks), among those that give every block slot a block where tiles x
    P allows it; ties keep the fewer groups."""
    if kind not in ("w", "a"):
        raise ValueError(f"unknown kind {kind}")
    slots = num_sms * F_BLOCKS_PER_SM
    tiles = -(-M // F_TILE) * -(-N // F_TILE)
    stages = 2
    while (stages < F_MAX_STAGES
           and fp32_smem_bytes(kind, twin, stages + 1) <= LQ_BLOCK_SMEM):
        stages += 1
    chunks = k_pad(K) // F_KC
    need = min(slots, tiles * P)
    best = None
    for groups in range(1, P + 1):
        pc = -(-P // groups)
        if -(-P // pc) != groups or tiles * groups < need:
            continue
        waves = -(-tiles * groups // slots)
        cost = waves * (pc + 4 / chunks)
        if best is None or cost < best[0]:
            best = (cost, pc, groups, waves)
    _, pc, groups, waves = best
    return Fp32Plan(stages, pc, groups, tiles, tiles * groups, waves,
                    tiles * P / (slots * waves * pc),
                    fp32_smem_bytes(kind, twin, stages))


# B3 / B3f on the int8 tensor cores (csrc MM_*): a block owns a 64-row
# output tile of one (sample or window, head) problem, mm_width columns
# wide, keeps the fixed operand's level tile(s) resident and streams the
# candidates' tiles through a ring of slots, one 128-byte K chunk a slot
MM_ROWS, MM_RK, MM_MAX_STAGES = 64, 16, 16
MM_WARPS = 8  # per-warp partial sums of a block: two consumer warpgroups


def mm_width(Co: int) -> int:
    """The column width of a B3 / B3f block's tile, an s8 wgmma's N (8,
    16, 24, 32, then multiples of 16): 32 for Co <= 32, 48 where it divides
    Co and 64 does not (Swin's 144), else 64."""
    if Co <= 32:
        return 32
    return 48 if Co % 48 == 0 and Co % 64 else 64


class MatmulPlan(NamedTuple):
    """How B3 / B3f runs one call on the card.

    width: columns of a block's tile; row_tiles, col_tiles: tiles of one
    problem's R x Co output; blocks: problems x tiles (each walks all P
    candidates); per_head: per-warp partial sums per head and candidate;
    stages: ring slots, one K chunk of a candidate tile each, at least two
    candidates' chunks (a block waits for a pair of candidates at a time);
    per_sm: blocks an SM holds, by shared memory; smem: dynamic shared
    memory of a block, at most SM_SMEM // per_sm - 1024; fast: K < 256, so
    the int32 sums convert without I2F."""
    width: int
    row_tiles: int
    col_tiles: int
    blocks: int
    per_head: int
    stages: int
    per_sm: int
    smem: int
    fast: bool


def mm_blocks_per_sm(W: int, mode: str) -> int:
    """Blocks a B3 / B3f kernel is built to run on one SM (csrc
    ``mm_min_blocks``): three at the narrow tiles (W <= 48, at most 75
    registers a thread), two at W = 64; "b_sos", with two fixed tiles,
    three at W = 32 and one past it."""
    if mode == "b_sos":
        return 3 if W <= 32 else 1
    return 3 if W <= 48 else 2


def matmul_smem_bytes(mode: str, Ci: int, Co: int, stages: int) -> int:
    """A B3 / B3f block's dynamic shared memory (csrc ``mm_smem_bytes``):
    1 KB of alignment slack, the resident fixed tile(s) (two in "b_sos"),
    ``stages`` ring slots of one 128-byte K chunk of a candidate tile, the
    raw product's staging, the mbarriers."""
    W = mm_width(Co)
    nc = -(-k_pad(Ci) // LQ_KC)
    rows_fix, rows_cand = (W, MM_ROWS) if mode == "a" else (MM_ROWS, W)
    nl = 2 if mode == "b_sos" else 1
    return (1024 + nl * nc * rows_fix * LQ_KC
            + stages * rows_cand * LQ_KC
            + 4 * MM_RK * ((MM_ROWS + 4) + (W + 4)) + 8 * (2 * stages + 1))


def matmul_plan(S: int, G: int, R: int, Ci: int, Co: int, P: int,
                mode: str) -> MatmulPlan:
    """The plan of a B3 / B3f call: the most ring slots (up to
    MM_MAX_STAGES, at least two candidates' K chunks) within an SM's shared
    memory shared by ``mm_blocks_per_sm`` blocks, or by fewer where two
    candidates' chunks do not fit beside the fixed tile(s) (ViT's matmul2:
    its two SoS tiles take 80 KB at K = 577, one block an SM)."""
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode}")
    W = mm_width(Co)
    stages = 2 * -(-k_pad(Ci) // LQ_KC)
    need = matmul_smem_bytes(mode, Ci, Co, stages)
    if stages > MM_MAX_STAGES or need > SMEM_LIMIT:
        raise ValueError(f"K = {Ci} does not fit a block's shared memory")
    per_sm = mm_blocks_per_sm(W, mode)
    while need > SM_SMEM // per_sm - 1024:
        per_sm -= 1
    while (stages < MM_MAX_STAGES and matmul_smem_bytes(
            mode, Ci, Co, stages + 1) <= SM_SMEM // per_sm - 1024):
        stages += 1
    nrt, nct = -(-R // MM_ROWS), -(-Co // W)
    return MatmulPlan(W, nrt, nct, S * G * nrt * nct,
                      S * nrt * nct * MM_WARPS, stages, per_sm,
                      matmul_smem_bytes(mode, Ci, Co, stages), Ci < 256)


def mm_fold_factor(G: int, Ci: int, Co: int) -> int:
    """The head fold F of the JAX matmul scorer (pallas_search.py
    ``_mm_fold_factor``, without its environment override): the largest F
    in (8, 4, 2) dividing G that strictly cuts the 128-padded MACs per
    head.  F > 1 at Swin window shapes, 1 at ViT's; the port launches B3f
    exactly where it is > 1."""
    def up(n):
        return -(-n // 128) * 128
    best_cost, best = up(Ci) * up(Co), 1
    for f in (8, 4, 2):
        if G % f:
            continue
        cost = up(f * Ci) * up(f * Co) / f
        if cost < best_cost:
            best_cost, best = cost, f
    return best


# ---------------------------------------------------------------------------
# candidate chunks: the scratch of a call and its bound
# ---------------------------------------------------------------------------

def linear_w_scratch(M: int, ic: int, oc: int, n_V: int = 1,
                     twin: bool = False):
    """B1's scratch as (fixed, per candidate) bytes: the input levels (and
    the twin's negative levels); per candidate the weight levels, the
    per-block partial sums and the sims."""
    kp, parts = k_pad(ic), -(-M // LQ_ROWS) * -(-oc // LQ_ROWS)
    return (2 if twin else 1) * M * kp, oc * kp + 4 * n_V * (parts + 1)


def linear_a_scratch(M: int, ic: int, oc: int, postgelu: bool = False):
    """B2's scratch as (fixed, per candidate) bytes: the weight levels
    (and the post-GELU negative input levels); per candidate the input
    levels, the partial sums and the sim."""
    kp, parts = k_pad(ic), -(-M // LQ_ROWS) * -(-oc // LQ_ROWS)
    return oc * kp + (M * kp if postgelu else 0), M * kp + 4 * (parts + 1)


def linear_w_f32_scratch(M: int, ic: int, oc: int, n_V: int = 1):
    """B4w's scratch as (fixed, per candidate) bytes."""
    parts = -(-M // F_TILE) * -(-oc // F_TILE)
    return 0, oc * k_pad(ic) + 4 * n_V * (parts + 1)


def linear_a_f32_scratch(M: int, ic: int, oc: int, postgelu: bool = False):
    """B4a's scratch as (fixed, per candidate) bytes."""
    kp, parts = k_pad(ic), -(-M // F_TILE) * -(-oc // F_TILE)
    return (M * kp if postgelu else 0), M * kp + 4 * (parts + 1)


def matmul_scratch(S: int, G: int, R: int, Ci: int, Co: int, mode: str):
    """B3's / B3f's scratch as (fixed, per candidate) bytes: the fixed
    side's levels (two sets in "b_sos"); per candidate its side's levels,
    the per-warp partial sums and the sims of G heads."""
    kp, Z = k_pad(Ci), S * G
    parts = S * -(-R // MM_ROWS) * -(-Co // mm_width(Co)) * MM_WARPS
    tail = 4 * G * (parts + 1)
    if mode == "a":
        return Z * Co * kp, Z * R * kp + tail
    return (2 if mode == "b_sos" else 1) * Z * R * kp, Z * Co * kp + tail


def candidate_chunk(P: int, scratch, bound: Optional[int]) -> int:
    """The candidates one launch takes so that its scratch, ``scratch`` =
    (fixed, per candidate) bytes, stays within ``bound`` bytes: all P where
    they fit (or ``bound`` is None), else as many as fit; a bound below
    one candidate's scratch raises."""
    fixed, per = scratch
    if bound is None or fixed + P * per <= bound:
        return P
    if fixed + per > bound:
        raise ValueError(f"a scratch bound of {bound} bytes holds no "
                         f"candidate ({fixed} bytes and {per} a candidate)")
    return (bound - fixed) // per


def in_chunks(fn, cands, chunk: int):
    """``fn`` on the candidates (first axis of ``cands``) in chunks of
    ``chunk``, the results joined in order; one call where they fit.  The
    calls cut into chunks are counted in ``in_chunks.calls``."""
    P = cands.shape[0]
    if chunk >= P:
        return fn(cands)
    in_chunks.calls += 1
    return torch.cat([fn(cands[p0:p0 + chunk].contiguous())
                      for p0 in range(0, P, chunk)])


def chunked_calls() -> int:
    """Wrapper calls cut into candidate chunks since the last
    ``reset_launch_counts``."""
    return in_chunks.calls


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _levels(x, d, lo: int, hi: int):
    """clip(round(x / d), lo, hi) as float64 levels (exact integers)."""
    return torch.clamp(torch.round(x / d), lo, hi).double()


def _dot_nt(a_lv, b_lv):
    """(M, K) @ (N, K)ᵀ of integer levels -> float32 (exact int32 value,
    rounded once to float32 like ``acc.astype(float32)``)."""
    return (a_lv.double() @ b_lv.double().t()).float()


def linear_w_hessian_sims_i8_ref(x_lv, x_neg_lv, a, a_neg, w, cands,
                                 raw_minus_bias, grad, qmax: int):
    """Plain version of B1 (body ``_kernel_i8_ploop``)."""
    squeeze = cands.ndim == 1
    c2 = cands[:, None] if squeeze else cands
    P, n_V = c2.shape
    oc = w.shape[0]
    crb = oc // n_V
    a = torch.as_tensor(a, dtype=torch.float32, device=w.device)
    out = torch.empty(P, n_V, dtype=torch.float32, device=w.device)
    for p in range(P):
        for v in range(n_V):
            delta = c2[p, v]
            rows = slice(v * crb, (v + 1) * crb)
            w_lv = _levels(w[rows], delta, -qmax, qmax - 1)
            acc = _dot_nt(x_lv, w_lv) * (a * delta)
            if x_neg_lv is not None:
                an = torch.as_tensor(a_neg, dtype=torch.float32,
                                     device=w.device)
                acc = acc + _dot_nt(x_neg_lv, w_lv) * (an * delta)
            d = grad[:, rows] * (raw_minus_bias[:, rows] - acc)
            out[p, v] = -torch.sum(d * d)
    return out[:, 0] if squeeze else out


def linear_a_hessian_sims_i8_ref(x, w_lv, w_scale, cands, raw_minus_bias,
                                 grad, a_qmax: int, postgelu: bool = False,
                                 a_neg: float = 0.0):
    """Plain version of B2 (body ``_a_kernel_i8_ploop``); ``x / a_neg`` is
    a true division."""
    P = cands.shape[0]
    ws = w_scale[None, :]
    if postgelu:
        neg = _levels(exact_div(x, a_neg), 1.0, -a_qmax, 0)
        acc_neg = _dot_nt(neg, w_lv) * torch.tensor(
            a_neg, dtype=torch.float32, device=x.device)
    out = torch.empty(P, dtype=torch.float32, device=x.device)
    for p in range(P):
        delta = cands[p]
        if postgelu:
            pos = _levels(x, delta, 0, a_qmax - 1)
            acc = _dot_nt(pos, w_lv) * delta + acc_neg
        else:
            acc = _dot_nt(_levels(x, delta, -a_qmax, a_qmax - 1), w_lv) \
                * delta
        d = grad * (raw_minus_bias - acc * ws)
        out[p] = -torch.sum(d * d)
    return out


def linear_w_hessian_sims_ref(x_sim, w, cands, raw_minus_bias, grad,
                              qmax: int):
    """Plain version of B4w (body ``_kernel_ploop``): per candidate the fp32
    fake-quant weight clip(round(W / Δ)) · Δ of each row block and an fp32
    product with the fake-quant input."""
    squeeze = cands.ndim == 1
    c2 = cands[:, None] if squeeze else cands
    P, n_V = c2.shape
    crb = w.shape[0] // n_V
    out = torch.empty(P, n_V, dtype=torch.float32, device=w.device)
    for p in range(P):
        for v in range(n_V):
            delta = c2[p, v]
            rows = slice(v * crb, (v + 1) * crb)
            w_sim = torch.clamp(torch.round(w[rows] / delta), -qmax,
                                qmax - 1) * delta
            d = grad[:, rows] * (raw_minus_bias[:, rows] - x_sim @ w_sim.t())
            out[p, v] = -torch.sum(d * d)
    return out[:, 0] if squeeze else out


def linear_a_hessian_sims_ref(x, w_sim, cands, raw_minus_bias, grad,
                              a_qmax: int, postgelu: bool = False,
                              a_neg: float = 0.0):
    """Plain version of B4a (body ``_a_kernel_ploop``): per candidate the
    fp32 fake-quant input (signed, or the post-GELU twin with the fixed
    negative scale, ``x / a_neg`` a true division) and an fp32 product with
    the fake-quant weight."""
    if postgelu:
        an = torch.tensor(a_neg, dtype=torch.float32, device=x.device)
        x_neg = torch.clamp(torch.round(x / an), -a_qmax, 0) * an
    out = torch.empty(cands.shape[0], dtype=torch.float32, device=x.device)
    for p in range(cands.shape[0]):
        delta = cands[p]
        if postgelu:
            xq = torch.clamp(torch.round(x / delta), 0, a_qmax - 1) * delta \
                + x_neg
        else:
            xq = torch.clamp(torch.round(x / delta), -a_qmax, a_qmax - 1) \
                * delta
        d = grad * (raw_minus_bias - xq @ w_sim.t())
        out[p] = -torch.sum(d * d)
    return out


def matmul_hessian_sims_ref(A, B, grad, cands, fixed_int, mode: str,
                            cand_qmax: int, fixed_qmax: int,
                            sos: Optional[Sequence] = None):
    """Plain version of B3 and B3f (bodies ``_mm_kernel`` and
    ``_mm_kernel_folded``: the fold changes the order of the sums, not the
    function).  A (S, G, R, Ci),
    B (S, G, Ci, Co), grad (S, G, R, Co) in fp32 or bf16; cands (P, G);
    fixed_int (G,); sos = (split, a_int, s_hi, s_lo) for mode "b_sos".
    Returns (P, G)."""
    a = A.float()
    b = B.float()
    g = grad.float()
    raw = torch.matmul(a, b)
    g2 = g * g
    P, G = cands.shape
    f = fixed_int.float().reshape(1, G, 1, 1)
    if mode == "a":
        fix = (_levels(b, f, -fixed_qmax, fixed_qmax - 1),)
    elif mode == "b":
        fix = (_levels(a, f, -fixed_qmax, fixed_qmax - 1),)
    elif mode == "b_sos":
        split, a_int, s_hi, s_lo = (torch.as_tensor(v, dtype=torch.float32,
                                                    device=a.device)
                                    for v in sos)
        one = torch.ones((), device=a.device)
        zero = torch.zeros((), device=a.device)
        hi = torch.clamp(torch.round(
            torch.minimum(torch.maximum(a, split), one) * (fixed_qmax - 1)),
            0, fixed_qmax - 1).double()
        lo = _levels(torch.minimum(torch.maximum(a, zero), split), a_int,
                     0, fixed_qmax - 1)
        fix = (hi, lo)
    else:
        raise ValueError(f"unknown mode {mode}")
    out = torch.empty(P, G, dtype=torch.float32, device=a.device)
    for p in range(P):
        d = cands[p].float().reshape(1, G, 1, 1)
        if mode == "a":
            c_lv = _levels(a, d, -cand_qmax, cand_qmax - 1)
            o = (c_lv @ fix[0]).float() * (d * f)
        else:
            c_lv = _levels(b, d, -cand_qmax, cand_qmax - 1)
            if mode == "b":
                o = (fix[0] @ c_lv).float() * (f * d)
            else:
                o = ((fix[0] @ c_lv).float() * s_hi
                     + (fix[1] @ c_lv).float() * s_lo) * d
        diff = raw - o
        out[p] = -torch.sum(g2 * diff * diff, dim=(0, 2, 3))
    return out


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(t, name, dtype, shape=None, device=None):
    if not torch.is_tensor(t):
        raise TypeError(f"{name} must be a tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _launch(fn, *args):
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {err}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _num_sms(device) -> int:
    return _sm_count(torch.device(device).index or 0)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _levels_scratch(shape, device):
    """int8 level buffer the kernels' pre-pass fills (K-padded rows)."""
    return torch.empty(shape, dtype=torch.int8, device=device)


@spanned("ptq.kernel.linear_w_hessian_sims_i8")
def linear_w_hessian_sims_i8(x_lv, x_neg_lv, a, a_neg, w, cands,
                             raw_minus_bias, grad, qmax: int,
                             scratch_bound: Optional[int] = None):
    """B1: int8-scored weight-interval search (n_a = 1).

    x_lv, x_neg_lv: (M, ic) int8 input levels (x_neg_lv None unless the
    post-GELU twin); a, a_neg: input scales; w: (oc, ic) fp32;
    cands: (P,) or (P, n_V) with oc % n_V == 0; raw_minus_bias, grad:
    (M, oc) fp32; scratch_bound: see the module docstring.  Returns (P,)
    or (P, n_V)."""
    M, ic = x_lv.shape
    oc = w.shape[0]
    squeeze = cands.ndim == 1
    c2 = (cands[:, None] if squeeze else cands).contiguous()
    P, n_V = c2.shape
    chunk = candidate_chunk(P, linear_w_scratch(
        M, ic, oc, n_V, x_neg_lv is not None), scratch_bound)
    if not w.is_cuda:
        out = in_chunks(lambda c: linear_w_hessian_sims_i8_ref(
            x_lv, x_neg_lv, a, a_neg, w, c, raw_minus_bias, grad, qmax),
            c2, chunk)
        return out[:, 0] if squeeze else out
    if oc % n_V or n_V > 256:
        raise ValueError(f"n_V={n_V} must divide oc={oc} and be <= 256")
    dev = w.device
    _check(x_lv, "x_lv", torch.int8, (M, ic), dev)
    if x_neg_lv is not None:
        _check(x_neg_lv, "x_neg_lv", torch.int8, (M, ic), dev)
    _check(w, "w", torch.float32, (oc, ic), dev)
    _check(c2, "cands", torch.float32, (P, n_V), dev)
    _check(raw_minus_bias, "raw_minus_bias", torch.float32, (M, oc), dev)
    _check(grad, "grad", torch.float32, (M, oc), dev)
    from .build import load
    lib = load()
    kp = lib.ptq_k_pad(ic)
    lx = _levels_scratch((M, kp), dev)
    lxn = _levels_scratch((M, kp), dev) if x_neg_lv is not None else None

    def launch(c):
        Pc = c.shape[0]
        lw = _levels_scratch((Pc, oc, kp), dev)
        plan = linear_plan("w", M, oc, ic, Pc, n_V, x_neg_lv is not None)
        partial = torch.empty(lib.ptq_linear_num_partials(M, oc) * Pc * n_V,
                              dtype=torch.float32, device=dev)
        out = torch.empty(Pc, n_V, dtype=torch.float32, device=dev)
        _launch(lib.ptq_linear_w_sims, _ptr(x_lv), _ptr(x_neg_lv), _ptr(w),
                _ptr(c), _ptr(raw_minus_bias), _ptr(grad), float(a),
                float(a_neg) if a_neg is not None else 1.0, M, ic, oc, Pc,
                n_V, qmax, int(plan.resident), plan.stages, plan.pc,
                plan.nbl, _ptr(lx), _ptr(lxn), _ptr(lw), _ptr(partial),
                _ptr(out), _stream())
        linear_w_hessian_sims_i8.launches += 1
        return out
    out = in_chunks(launch, c2, chunk)
    return out[:, 0] if squeeze else out


@spanned("ptq.kernel.linear_a_hessian_sims_i8")
def linear_a_hessian_sims_i8(x, w_lv, w_scale, cands, raw_minus_bias, grad,
                             a_qmax: int, postgelu: bool = False,
                             a_neg: float = 0.0,
                             scratch_bound: Optional[int] = None):
    """B2: int8-scored input-interval search (n_H = 1).

    x: (M, ic) raw fp32 activations; w_lv: (oc, ic) int8 weight levels;
    w_scale: (oc,) fp32; cands: (P,).  Returns (P,)."""
    M, ic = x.shape
    oc = w_lv.shape[0]
    P = cands.shape[0]
    chunk = candidate_chunk(P, linear_a_scratch(M, ic, oc, postgelu),
                            scratch_bound)
    if not x.is_cuda:
        return in_chunks(lambda c: linear_a_hessian_sims_i8_ref(
            x, w_lv, w_scale, c, raw_minus_bias, grad, a_qmax, postgelu,
            a_neg), cands, chunk)
    dev = x.device
    _check(x, "x", torch.float32, (M, ic), dev)
    _check(w_lv, "w_lv", torch.int8, (oc, ic), dev)
    _check(w_scale, "w_scale", torch.float32, (oc,), dev)
    _check(cands, "cands", torch.float32, (P,), dev)
    _check(raw_minus_bias, "raw_minus_bias", torch.float32, (M, oc), dev)
    _check(grad, "grad", torch.float32, (M, oc), dev)
    from .build import load
    lib = load()
    kp = lib.ptq_k_pad(ic)
    lneg = _levels_scratch((M, kp), dev) if postgelu else None
    lw = _levels_scratch((oc, kp), dev)

    def launch(c):
        Pc = c.shape[0]
        lx = _levels_scratch((Pc, M, kp), dev)
        plan = linear_plan("a", M, oc, ic, Pc)
        partial = torch.empty(lib.ptq_linear_num_partials(M, oc) * Pc,
                              dtype=torch.float32, device=dev)
        out = torch.empty(Pc, dtype=torch.float32, device=dev)
        _launch(lib.ptq_linear_a_sims, _ptr(x), _ptr(w_lv), _ptr(w_scale),
                _ptr(c), _ptr(raw_minus_bias), _ptr(grad), float(a_neg), M,
                ic, oc, Pc, a_qmax, int(postgelu), int(plan.resident),
                plan.stages, plan.pc, _ptr(lx), _ptr(lneg), _ptr(lw),
                _ptr(partial), _ptr(out), _stream())
        linear_a_hessian_sims_i8.launches += 1
        return out
    return in_chunks(launch, cands.contiguous(), chunk)


@spanned("ptq.kernel.linear_w_hessian_sims")
def linear_w_hessian_sims(x_sim, w, cands, raw_minus_bias, grad, qmax: int,
                          scratch_bound: Optional[int] = None):
    """B4w: exact (fp32-scored) weight-interval search, n_H = 1.

    x_sim: (M, ic) already input-quantized activations; w: (oc, ic) fp32;
    cands: (P,) or (P, n_V) with oc % n_V == 0; raw_minus_bias, grad:
    (M, oc) fp32.  Returns (P,) or (P, n_V)."""
    M, ic = x_sim.shape
    oc = w.shape[0]
    squeeze = cands.ndim == 1
    c2 = (cands[:, None] if squeeze else cands).contiguous()
    P, n_V = c2.shape
    chunk = candidate_chunk(P, linear_w_f32_scratch(M, ic, oc, n_V),
                            scratch_bound)
    if not w.is_cuda:
        out = in_chunks(lambda c: linear_w_hessian_sims_ref(
            x_sim, w, c, raw_minus_bias, grad, qmax), c2, chunk)
        return out[:, 0] if squeeze else out
    if oc % n_V or n_V > 256:
        raise ValueError(f"n_V={n_V} must divide oc={oc} and be <= 256")
    dev = w.device
    _check(x_sim, "x_sim", torch.float32, (M, ic), dev)
    _check(w, "w", torch.float32, (oc, ic), dev)
    _check(c2, "cands", torch.float32, (P, n_V), dev)
    _check(raw_minus_bias, "raw_minus_bias", torch.float32, (M, oc), dev)
    _check(grad, "grad", torch.float32, (M, oc), dev)
    from .build import load
    lib = load()

    def launch(c):
        Pc = c.shape[0]
        lw = _levels_scratch((Pc, oc, lib.ptq_k_pad(ic)), dev)
        plan = fp32_plan("w", M, oc, ic, Pc, num_sms=_num_sms(dev))
        partial = torch.empty(lib.ptq_fp32_num_partials(M, oc) * Pc * n_V,
                              dtype=torch.float32, device=dev)
        out = torch.empty(Pc, n_V, dtype=torch.float32, device=dev)
        _launch(lib.ptq_linear_w_sims_f32, _ptr(x_sim), _ptr(w), _ptr(c),
                _ptr(raw_minus_bias), _ptr(grad), M, ic, oc, Pc, n_V, qmax,
                plan.stages, plan.pc, _ptr(lw), _ptr(partial), _ptr(out),
                _stream())
        linear_w_hessian_sims.launches += 1
        return out
    out = in_chunks(launch, c2, chunk)
    return out[:, 0] if squeeze else out


@spanned("ptq.kernel.linear_a_hessian_sims")
def linear_a_hessian_sims(x, w_sim, cands, raw_minus_bias, grad, a_qmax: int,
                          postgelu: bool = False, a_neg: float = 0.0,
                          scratch_bound: Optional[int] = None):
    """B4a: exact (fp32-scored) input-interval search, n_a = 1.

    x: (M, ic) raw fp32 activations; w_sim: (oc, ic) fake-quant weight;
    cands: (P,).  Returns (P,)."""
    M, ic = x.shape
    oc = w_sim.shape[0]
    P = cands.shape[0]
    chunk = candidate_chunk(P, linear_a_f32_scratch(M, ic, oc, postgelu),
                            scratch_bound)
    if not x.is_cuda:
        return in_chunks(lambda c: linear_a_hessian_sims_ref(
            x, w_sim, c, raw_minus_bias, grad, a_qmax, postgelu, a_neg),
            cands, chunk)
    dev = x.device
    _check(x, "x", torch.float32, (M, ic), dev)
    _check(w_sim, "w_sim", torch.float32, (oc, ic), dev)
    _check(cands, "cands", torch.float32, (P,), dev)
    _check(raw_minus_bias, "raw_minus_bias", torch.float32, (M, oc), dev)
    _check(grad, "grad", torch.float32, (M, oc), dev)
    from .build import load
    lib = load()
    kp = lib.ptq_k_pad(ic)
    lneg = _levels_scratch((M, kp), dev) if postgelu else None

    def launch(c):
        Pc = c.shape[0]
        lx = _levels_scratch((Pc, M, kp), dev)
        plan = fp32_plan("a", M, oc, ic, Pc, postgelu, _num_sms(dev))
        partial = torch.empty(lib.ptq_fp32_num_partials(M, oc) * Pc,
                              dtype=torch.float32, device=dev)
        out = torch.empty(Pc, dtype=torch.float32, device=dev)
        _launch(lib.ptq_linear_a_sims_f32, _ptr(x), _ptr(w_sim), _ptr(c),
                _ptr(raw_minus_bias), _ptr(grad), float(a_neg), M, ic, oc,
                Pc, a_qmax, int(postgelu), plan.stages, plan.pc, _ptr(lx),
                _ptr(lneg), _ptr(partial), _ptr(out), _stream())
        linear_a_hessian_sims.launches += 1
        return out
    return in_chunks(launch, cands.contiguous(), chunk)


_MODES = {"a": 0, "b": 1, "b_sos": 2}


def _matmul_args(A, B, grad, cands, fixed_int, mode, sos):
    """Checks of the B3 / B3f wrappers; returns (dims, fixed_int, sos
    scalars)."""
    dev = A.device
    S, G, R, Ci = A.shape
    Co = B.shape[-1]
    P = cands.shape[0]
    if A.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"A: expected float32 or bfloat16, got {A.dtype}")
    _check(A, "A", A.dtype, (S, G, R, Ci), dev)
    _check(B, "B", A.dtype, (S, G, Ci, Co), dev)
    _check(grad, "grad", A.dtype, (S, G, R, Co), dev)
    _check(cands, "cands", torch.float32, (P, G), dev)
    fixed_int = fixed_int.reshape(-1).float().contiguous()
    _check(fixed_int, "fixed_int", torch.float32, (G,), dev)
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode}")
    sv = [float(v) for v in (sos if sos is not None
                             else (0.0, 1.0, 1.0, 1.0))]
    return (S, G, R, Ci, Co, P), fixed_int, sv


def _matmul_launch(A, B, grad, cands, fixed_int, mode, cand_qmax,
                   fixed_qmax, sos, return_levels=False):
    """One B3 / B3f call on the card: the level pre-pass's buffers, the
    plan, the per-warp partials, the kernel.  ``return_levels``: also
    return the pre-pass's level buffers (la, la2, lb), for the card tests
    to hold them to the plain levels bit for bit."""
    from .build import load
    lib = load()
    dims, fixed_int, sv = _matmul_args(A, B, grad, cands, fixed_int, mode,
                                       sos)
    S, G, R, Ci, Co, P = dims
    dev = A.device
    kp, Z = lib.ptq_k_pad(Ci), S * G
    la = _levels_scratch((P if mode == "a" else 1, Z, R, kp), dev)
    la2 = _levels_scratch((Z, R, kp), dev) if mode == "b_sos" else None
    lb = _levels_scratch((1 if mode == "a" else P, Z, Co, kp), dev)
    plan = matmul_plan(S, G, R, Ci, Co, P, mode)
    partial = torch.empty(lib.ptq_mm_num_partials(S, R, Co) * G * P,
                          dtype=torch.float32, device=dev)
    out = torch.empty(P, G, dtype=torch.float32, device=dev)
    _launch(lib.ptq_matmul_sims, _ptr(A), _ptr(B), _ptr(grad),
            int(A.dtype == torch.bfloat16), _ptr(cands), _ptr(fixed_int),
            *sv, S, G, R, Ci, Co, P, _MODES[mode], cand_qmax, fixed_qmax,
            plan.stages, _ptr(la), _ptr(la2), _ptr(lb), _ptr(partial),
            _ptr(out), _stream())
    return (out, (la, la2, lb)) if return_levels else out


def matmul_hessian_sims(A, B, grad, cands, fixed_int, mode: str,
                        cand_qmax: int, fixed_qmax: int,
                        sos: Optional[Sequence] = None,
                        scratch_bound: Optional[int] = None):
    """Per-head attention-matmul scorer (the JAX ``matmul_hessian_sims``).

    A (S, G, R, Ci), B (S, G, Ci, Co), grad (S, G, R, Co): all fp32 or all
    bf16 (the calibration caches' stored dtype); cands (P, G) fp32;
    fixed_int (G,); mode "a" | "b" | "b_sos"; sos = (split, a_int, s_hi,
    s_lo) scalars for "b_sos"; scratch_bound: see the module docstring.
    Returns (P, G).  On the card it counts the launch as B3f where
    ``mm_fold_factor(G, Ci, Co) > 1`` (Swin windows), as the JAX function
    picks its folded body there, and as B3 elsewhere; both run the same
    tensor-core kernel (``matmul_plan``, see csrc/search_kernels.cu)."""
    G, Ci, Co = A.shape[1], A.shape[3], B.shape[-1]
    F = mm_fold_factor(G, Ci, Co)
    kern = matmul_hessian_sims_b3f if F > 1 else matmul_hessian_sims_b3
    return kern(A, B, grad, cands, fixed_int, mode, cand_qmax, fixed_qmax,
                sos, scratch_bound)


def _matmul_chunks(kern, A, B, grad, cands, fixed_int, mode, cand_qmax,
                   fixed_qmax, sos, scratch_bound):
    """A B3 / B3f call in candidate chunks within ``scratch_bound``: the
    plain version on the CPU, else one launch a chunk, counted on
    ``kern``."""
    S, G, R, Ci = A.shape
    chunk = candidate_chunk(cands.shape[0], matmul_scratch(
        S, G, R, Ci, B.shape[-1], mode), scratch_bound)
    if not A.is_cuda:
        return in_chunks(lambda c: matmul_hessian_sims_ref(
            A, B, grad, c, fixed_int, mode, cand_qmax, fixed_qmax, sos),
            cands, chunk)

    def launch(c):
        out = _matmul_launch(A, B, grad, c, fixed_int, mode, cand_qmax,
                             fixed_qmax, sos)
        kern.launches += 1
        return out
    return in_chunks(launch, cands, chunk)


@spanned("ptq.kernel.matmul_hessian_sims_b3")
def matmul_hessian_sims_b3(A, B, grad, cands, fixed_int, mode: str,
                           cand_qmax: int, fixed_qmax: int,
                           sos: Optional[Sequence] = None,
                           scratch_bound: Optional[int] = None):
    """B3: the per-head scorer where the JAX function runs its unfolded
    body ``_mm_kernel`` (ViT); arguments as ``matmul_hessian_sims``."""
    return _matmul_chunks(matmul_hessian_sims_b3, A, B, grad, cands,
                          fixed_int, mode, cand_qmax, fixed_qmax, sos,
                          scratch_bound)


@spanned("ptq.kernel.matmul_hessian_sims_b3f")
def matmul_hessian_sims_b3f(A, B, grad, cands, fixed_int, mode: str,
                            cand_qmax: int, fixed_qmax: int,
                            sos: Optional[Sequence] = None,
                            scratch_bound: Optional[int] = None):
    """B3f: the per-head scorer where the JAX function runs its
    head-folded body ``_mm_kernel_folded`` (Swin's windows).  The card
    needs no fold: the tile's width fits Co instead (``mm_width``).
    Arguments and result as ``matmul_hessian_sims``."""
    return _matmul_chunks(matmul_hessian_sims_b3f, A, B, grad, cands,
                          fixed_int, mode, cand_qmax, fixed_qmax, sos,
                          scratch_bound)


KERNELS = (linear_w_hessian_sims_i8, linear_a_hessian_sims_i8,
           matmul_hessian_sims_b3, matmul_hessian_sims_b3f,
           linear_w_hessian_sims, linear_a_hessian_sims)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
    in_chunks.calls = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


reset_launch_counts()
