"""The exact int8 execution path: quantized ops as int8 x int8 -> int32
products of their levels with one fp32 rescale, instead of fake-quant fp32
products.

The counterpart of ``ptq4vit_tpu/ops/int8.py``, which JAX runs as XLA code,
so here it is plain PyTorch on any device.  The int dot is a float64 matmul
of the levels: every sum stays far below 2**53, so it is the exact int32
value, rounded once to float32 like ``acc.astype(float32)``.  Inputs are
taken in float32 first, as JAX promotes a bfloat16 activation against the
float32 intervals.

Layouts (everything the shipped configs produce): LinearQP with n_H == 1 and
n_a == 1 (per-out-channel scales factor out of the contraction), twin
post-GELU inputs (two level sets), head-wise MatMulQP with the SoS A operand
as two unsigned level sets, channelwise / layerwise ConvQP.  Operand block
grids fall back to the fake-quant semantics.
"""
from __future__ import annotations

import torch

from ..quant import fakequant as fq
from ..quant.qparams import ConvQP, LinearQP, MatMulQP
from .pack import conv_w_scale, linear_w_levels, linear_w_scale


def int_dot(x_lv, w_lv, reduce=None) -> torch.Tensor:
    """(..., k) @ (k, o) of integer levels -> (..., o) float32, exact.
    ``reduce`` (a row-parallel linear's sum over the model axis) takes the
    exact float64 partial dot before its single rounding to float32."""
    acc = torch.matmul(x_lv.double(), w_lv.double())
    return (acc if reduce is None else reduce(acc)).float()


def levels(x, d, lo: int, hi: int):
    """clip(round(x / d), lo, hi), the division exact."""
    return torch.clamp(torch.round(fq.exact_div(x, d)), lo, hi)


def linear_int8(x, w, b, qp: LinearQP, w_intT=None, w_scale=None,
                reduce=None):
    """int8 execution of a calibrated linear (n_H == 1, n_a == 1).
    ``w_intT`` / ``w_scale`` (ops/pack.pack_weights) skip the weight
    requantization.  ``reduce`` sums a row-parallel shard's partial
    products over the model axis: the exact integer dots before their
    rounding, so the result is bitwise the whole linear's."""
    if qp.w_interval.shape[2] != 1 or qp.a_interval.shape[0] != 1:
        raise NotImplementedError("int8 path needs n_H == 1 and n_a == 1")
    oc = w.shape[0]
    if w_intT is None:
        w_intT = linear_w_levels(w, qp).t()
    if w_scale is None:
        w_scale = linear_w_scale(qp, oc)
    x = x.float()
    if qp.a_bit >= 32:
        # activation unquantized: fp32 x @ dequantized int weight
        y = torch.matmul(x, w_intT.float() * w_scale[None, :])
        if reduce is not None:
            y = reduce(y)
        return y + b.float() if b is not None else y
    a = qp.a_interval[0, 0].float()
    if qp.postgelu:
        an = qp.a_neg_interval.float()
        acc = (int_dot(levels(x, a, 0, qp.a_qmax - 1), w_intT, reduce) * a
               + int_dot(levels(x, an, -qp.a_qmax, 0), w_intT, reduce) * an)
    else:
        acc = int_dot(levels(x, a, -qp.a_qmax, qp.a_qmax - 1), w_intT,
                      reduce) * a
    y = acc * w_scale
    return y + b.float() if b is not None else y


def blocked_operand_qp(qp: MatMulQP) -> bool:
    """True when an operand carries n_V / n_H (or sub-head) block grids:
    the scales then do not factor out of the contraction."""
    def blocked(iv):
        return iv.ndim == 7 and (iv.shape[3] != 1 or iv.shape[5] != 1)
    return blocked(qp.A_interval) or blocked(qp.B_interval)


def matmul_int8(a, b, qp: MatMulQP):
    """int8 execution of a calibrated A @ B with head-wise scales."""
    lead = a.shape[:-3]
    a4 = a.float().reshape((-1,) + a.shape[-3:])
    b4 = b.float().reshape((-1,) + b.shape[-3:])
    G = a4.shape[1]
    if blocked_operand_qp(qp):
        # block-grid scales: the fake-quant semantics directly (ablation
        # surface only)
        out = torch.matmul(qp.quant_A(a4), qp.quant_B(b4))
        return out.reshape(lead + out.shape[-3:])
    B_scale = qp.B_interval.float().reshape(1, G, 1, 1)
    b_lv = levels(b4, B_scale, -qp.B_qmax, qp.B_qmax - 1)
    if qp.split is not None:
        # SoS: unsigned level sets of the two ranges
        split = qp.split.float()
        qm = qp.A_qmax
        hi = torch.clamp(torch.round(
            torch.minimum(torch.maximum(a4, split), torch.ones_like(split))
            * (qm - 1)), 0, qm - 1)
        lo = levels(torch.minimum(torch.maximum(a4, torch.zeros_like(split)),
                                   split), qp.A_interval.float(), 0, qm - 1)
        acc = (fq.exact_div(int_dot(hi, b_lv), qm - 1)
               + int_dot(lo, b_lv) * qp.A_interval.float())
        out = acc * B_scale
    else:
        A_scale = qp.A_interval.float().reshape(1, G, 1, 1)
        a_lv = levels(a4, A_scale, -qp.A_qmax, qp.A_qmax - 1)
        out = int_dot(a_lv, b_lv) * (A_scale * B_scale)
    return out.reshape(lead + out.shape[-3:])


def conv_int8(xp, w, b, qp: ConvQP, patch: int, w_intT=None, w_scale=None):
    """int8 patch-embed conv on the patchified input (B, N, ic*p*p)."""
    oc = w.shape[0]
    wm = w.float().reshape(oc, -1)
    xp = xp.float()
    act = not (qp.a_bit >= 32 or qp.a_interval is None)
    if qp.blocked:
        # n_V x n_H grid: column-block scales don't factor out (ablation
        # surface only)
        w_sim = fq.fake_quant_weight_blocked(wm, qp.w_interval, qp.w_qmax)
        x_sim = fq.fake_quant(xp, qp.a_interval, qp.a_qmax) if act else xp
        y = torch.matmul(x_sim, w_sim.t())
        return y + b.float() if b is not None else y
    if w_scale is None:
        w_scale = conv_w_scale(qp, oc)
    if w_intT is None:
        w_intT = fq.int_quant(wm, w_scale[:, None], qp.w_qmax).t()
    if not act:
        y = torch.matmul(xp, w_intT.float() * w_scale[None, :])
    else:
        ai = qp.a_interval.float()
        y = int_dot(levels(xp, ai, -qp.a_qmax, qp.a_qmax - 1), w_intT) \
            * (ai * w_scale)
    return y + b.float() if b is not None else y
