"""The three int8-scored candidate scorers of the calibration search.

Each public function takes the arguments of its JAX counterpart in
``ptq4vit_tpu/ops/pallas_search.py`` and returns the same un-normalized
hessian similarity sums ``-Σ (g·(raw − out))²`` per candidate:

  linear_w_hessian_sims_i8  <- linear_w_hessian_sims_i8 (B1)
  linear_a_hessian_sims_i8  <- linear_a_hessian_sims_i8 (B2)
  matmul_hessian_sims       <- matmul_hessian_sims, F = 1 (B3)

For CUDA tensors the function launches the hand-written kernel of
``csrc/search_kernels.cu`` (or raises); for CPU tensors it runs the plain
PyTorch version beside it (``*_ref``), which follows the same formulas: the
int8 dot is a float64 matmul of the levels, exact because every sum stays
far below 2**53, and the fp32 rescale keeps the kernels' operation order.
Each wrapper counts its kernel launches in ``<function>.launches``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..quant.fakequant import exact_div


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


def matmul_hessian_sims_ref(A, B, grad, cands, fixed_int, mode: str,
                            cand_qmax: int, fixed_qmax: int,
                            sos: Optional[Sequence] = None):
    """Plain version of B3 (body ``_mm_kernel``).  A (S, G, R, Ci),
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


def _levels_scratch(shape, device):
    """int8 level buffer the kernels' pre-pass fills (K-padded rows)."""
    return torch.empty(shape, dtype=torch.int8, device=device)


def linear_w_hessian_sims_i8(x_lv, x_neg_lv, a, a_neg, w, cands,
                             raw_minus_bias, grad, qmax: int):
    """B1: int8-scored weight-interval search (n_a = 1).

    x_lv, x_neg_lv: (M, ic) int8 input levels (x_neg_lv None unless the
    post-GELU twin); a, a_neg: input scales; w: (oc, ic) fp32;
    cands: (P,) or (P, n_V) with oc % n_V == 0; raw_minus_bias, grad:
    (M, oc) fp32.  Returns (P,) or (P, n_V)."""
    if not w.is_cuda:
        return linear_w_hessian_sims_i8_ref(x_lv, x_neg_lv, a, a_neg, w,
                                            cands, raw_minus_bias, grad, qmax)
    from .build import load
    lib = load()
    dev = w.device
    M, ic = x_lv.shape
    oc = w.shape[0]
    squeeze = cands.ndim == 1
    c2 = (cands[:, None] if squeeze else cands).contiguous()
    P, n_V = c2.shape
    if oc % n_V or n_V > 256:
        raise ValueError(f"n_V={n_V} must divide oc={oc} and be <= 256")
    _check(x_lv, "x_lv", torch.int8, (M, ic), dev)
    if x_neg_lv is not None:
        _check(x_neg_lv, "x_neg_lv", torch.int8, (M, ic), dev)
    _check(w, "w", torch.float32, (oc, ic), dev)
    _check(c2, "cands", torch.float32, (P, n_V), dev)
    _check(raw_minus_bias, "raw_minus_bias", torch.float32, (M, oc), dev)
    _check(grad, "grad", torch.float32, (M, oc), dev)
    kp = lib.ptq_k_pad(ic)
    lx = _levels_scratch((M, kp), dev)
    lxn = _levels_scratch((M, kp), dev) if x_neg_lv is not None else None
    lw = _levels_scratch((P, oc, kp), dev)
    partial = torch.empty(lib.ptq_num_tiles(M, oc) * P * n_V,
                          dtype=torch.float32, device=dev)
    out = torch.empty(P, n_V, dtype=torch.float32, device=dev)
    _launch(lib.ptq_linear_w_sims, _ptr(x_lv), _ptr(x_neg_lv), _ptr(w),
            _ptr(c2), _ptr(raw_minus_bias), _ptr(grad), float(a),
            float(a_neg) if a_neg is not None else 1.0, M, ic, oc, P, n_V,
            qmax, _ptr(lx), _ptr(lxn), _ptr(lw), _ptr(partial), _ptr(out),
            _stream())
    linear_w_hessian_sims_i8.launches += 1
    return out[:, 0] if squeeze else out


def linear_a_hessian_sims_i8(x, w_lv, w_scale, cands, raw_minus_bias, grad,
                             a_qmax: int, postgelu: bool = False,
                             a_neg: float = 0.0):
    """B2: int8-scored input-interval search (n_H = 1).

    x: (M, ic) raw fp32 activations; w_lv: (oc, ic) int8 weight levels;
    w_scale: (oc,) fp32; cands: (P,).  Returns (P,)."""
    if not x.is_cuda:
        return linear_a_hessian_sims_i8_ref(x, w_lv, w_scale, cands,
                                            raw_minus_bias, grad, a_qmax,
                                            postgelu, a_neg)
    from .build import load
    lib = load()
    dev = x.device
    M, ic = x.shape
    oc = w_lv.shape[0]
    P = cands.shape[0]
    _check(x, "x", torch.float32, (M, ic), dev)
    _check(w_lv, "w_lv", torch.int8, (oc, ic), dev)
    _check(w_scale, "w_scale", torch.float32, (oc,), dev)
    _check(cands, "cands", torch.float32, (P,), dev)
    _check(raw_minus_bias, "raw_minus_bias", torch.float32, (M, oc), dev)
    _check(grad, "grad", torch.float32, (M, oc), dev)
    kp = lib.ptq_k_pad(ic)
    lx = _levels_scratch((P, M, kp), dev)
    lneg = _levels_scratch((M, kp), dev) if postgelu else None
    lw = _levels_scratch((oc, kp), dev)
    partial = torch.empty(lib.ptq_num_tiles(M, oc) * P, dtype=torch.float32,
                          device=dev)
    out = torch.empty(P, dtype=torch.float32, device=dev)
    _launch(lib.ptq_linear_a_sims, _ptr(x), _ptr(w_lv), _ptr(w_scale),
            _ptr(cands), _ptr(raw_minus_bias), _ptr(grad), float(a_neg), M,
            ic, oc, P, a_qmax, int(postgelu), _ptr(lx), _ptr(lneg), _ptr(lw),
            _ptr(partial), _ptr(out), _stream())
    linear_a_hessian_sims_i8.launches += 1
    return out


_MODES = {"a": 0, "b": 1, "b_sos": 2}


def matmul_hessian_sims(A, B, grad, cands, fixed_int, mode: str,
                        cand_qmax: int, fixed_qmax: int,
                        sos: Optional[Sequence] = None):
    """B3: per-head attention-matmul scorer.

    A (S, G, R, Ci), B (S, G, Ci, Co), grad (S, G, R, Co): all fp32 or all
    bf16 (the calibration caches' stored dtype); cands (P, G) fp32;
    fixed_int (G,); mode "a" | "b" | "b_sos"; sos = (split, a_int, s_hi,
    s_lo) scalars for "b_sos".  Returns (P, G)."""
    if not A.is_cuda:
        return matmul_hessian_sims_ref(A, B, grad, cands, fixed_int, mode,
                                       cand_qmax, fixed_qmax, sos)
    from .build import load
    lib = load()
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
    kp, Z = lib.ptq_k_pad(Ci), S * G
    la = _levels_scratch((P if mode == "a" else 1, Z, R, kp), dev)
    la2 = _levels_scratch((Z, R, kp), dev) if mode == "b_sos" else None
    lb = _levels_scratch((1 if mode == "a" else P, Z, Co, kp), dev)
    partial = torch.empty(lib.ptq_num_tiles(R, Co) * S * G * P,
                          dtype=torch.float32, device=dev)
    out = torch.empty(P, G, dtype=torch.float32, device=dev)
    _launch(lib.ptq_matmul_sims, _ptr(A), _ptr(B), _ptr(grad),
            int(A.dtype == torch.bfloat16), _ptr(cands), _ptr(fixed_int),
            *sv, S, G, R, Ci, Co, P, _MODES[mode], cand_qmax, fixed_qmax,
            _ptr(la), _ptr(la2), _ptr(lb), _ptr(partial), _ptr(out),
            _stream())
    matmul_hessian_sims.launches += 1
    return out


KERNELS = (linear_w_hessian_sims_i8, linear_a_hessian_sims_i8,
           matmul_hessian_sims)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


reset_launch_counts()
