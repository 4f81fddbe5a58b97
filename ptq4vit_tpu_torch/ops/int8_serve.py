"""The fused int8 serving kernels and the dispatch that composes them into
ViT and Swin blocks whose intermediate activations cross device memory as
int8.

The counterpart of ``ptq4vit_tpu/ops/int8_serve.py``:

  q8_linear            <- q8_linear (B6, body _linear_kernel)
  fused_attention_qkv  <- fused_attention_qkv (B7, body _attn_kernel_qkv)
  fused_attention      <- fused_attention (B8, body _attn_kernel): the same
                          kernel as B7, entered with the strides of the
                          (B, H, N, hd) layout
  fused_window_attention_qkv <- fused_window_attention_qkv (B9, body
                          _attn_kernel_win): B7's kernel over Swin windows
                          with the rel-pos bias and shifted mask added
  q8_win_qkv           <- _q8_win_qkv (B10, body _win_qkv_kernel): B6 with
                          its input rows read from the image layout
  q8_win_proj          <- _q8_win_proj (B11, body _win_proj_kernel): B6
                          with its output and residual rows in the image
                          layout
  q8_epilogue          <- B6's epilogue (the same Pallas kernel), split
                          off for a row-parallel linear under tensor
                          parallelism: q8_linear / q8_win_proj store their
                          int32 partial sums (``out_q="acc"``), the caller
                          sums them over "model", q8_epilogue rescales
                          (``row_parallel``)
  fused_linear, fused_vit_block, fused_swin_block and the scope helpers
                       <- their namesakes

Swin V2 (the JAX package has none): ``q8_win_qkv(..., norm_heads=H)``
(B10 with q and k L2-normalized per head in its epilogue) and
``q8_postnorm`` (res-post-norm: residual + LayerNorm of a linear's
rescaled output, on the int32 sums of B11 and B6);
``fused_swinv2_block`` composes them with B9, whose per-head logit scale
τ folds into the q scale.

For CUDA tensors the wrappers launch the hand-written kernels of
``csrc/serve_kernels.cu`` (or raise); for CPU tensors they run the plain
PyTorch versions beside them (the ``*_ref`` functions), which follow the
same formulas with the int8 dot as an exact float64 matmul of the levels.
Each kernel wrapper counts its launches in ``<function>.launches``, and
those of its relaxed variant (below) in ``<function>.relaxed_launches``;
either runs inside the span ``ptq.kernel.<function>``
(``utils/tracing.span``).
B6, B10 and B11 are one tensor-core kernel (``q8_tc_kernel``), after a
pre-pass that quantizes a float input once a row (``q8_levels_kernel``),
and ``q8_epilogue_kernel`` does its epilogue on summed partial sums;
``q8_plan`` sizes it on the host, and it reads the weight levels K-major
(``w_kmaj``, ops/pack.kmajor_levels).  B7, B8 and B9 are one kernel
(``attention_kernel``) with q·kᵀ and p·v on the int8 tensor cores;
``attn_plan`` gives its padding, mode (streaming, parked, team), warps and
shared memory.

Scope (the JAX rules about semantics): LinearQP with n_H == 1, n_a == 1 and
bits <= 8; matmul QPs with per-head scales and no operand block grids; the
block paths need fc2 post-GELU and one qmax for the packed q / k / v
columns.  The JAX rules that are only TPU tiling (K % 128, 128-lane head
groups, VMEM budgets, the attention row tile) are dropped: the port's
kernels take any K, head count and head dim.

``relaxed`` (``int8="fused_relaxed"``, ``ServingEngine(relaxed=True)``):
JAX's opt-in bf16 epilogues of B6 (tanh-GELU, the per-column requant and
the twin pack), B7 / B8 / B9 (the softmax as ``exp`` of bf16 logits times
a bf16 reciprocal of the fp32 sum, the SoS / per-head levels, the output
requant) and B10 (the requant): every value JAX's source casts to bf16 is
rounded to bf16 here, one operation at a time, and each division becomes
a product with a bf16 reciprocal.  Not bitwise the exact path (a level
may move one step); a linear with a float output and no GELU is the same
function in both modes and runs the exact kernel.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from ..quant import fakequant as fq
from ..utils.tracing import spanned
from .int8 import int_dot, levels
from .pack import K_ALIGN, kmajor_levels, linear_w_levels, linear_w_scale
from .search_kernels import (NUM_SMS, SM_SMEM, SMEM_LIMIT, _check, _launch,
                             _num_sms, _ptr, _stream)

_IN_MODES = {"f": 0, "f_twin": 1, "q8": 2, "q8twin": 3}
_OUT_Q = {None: 0, "vec": 1, "twin": 2, "acc": 3}
_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
          torch.int32: 3}
SQRT_HALF = 0.7071067811865476          # 2 ** -0.5, rounded to float32
# the relaxed tanh-GELU's bf16 constants (JAX int8_serve.py:144-145)
GELU_K, GELU_C = 0.7978845608028654, 0.044715


def _f32(v, device) -> torch.Tensor:
    """v as a float32 tensor on ``device``; a Python number as a cached
    constant, so that a wrapper makes no host-to-device copy a call."""
    if isinstance(v, (int, float)):
        return _const(float(v), torch.device(device))
    return torch.as_tensor(v, dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=None)
def _const(v: float, device: torch.device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def bf(x):
    """x rounded to bfloat16 (to nearest, ties to even) and held as
    float32: a value the relaxed epilogues cast to bf16.  A product of two
    such values is exact in float32, so ``bf(a * b)`` is their bf16
    product; a sum is rounded twice (float32, then bf16), as JAX computes
    bf16 arithmetic and as the kernels do."""
    if not torch.is_tensor(x):
        x = torch.tensor(x, dtype=torch.float32)
    return x.float().to(torch.bfloat16).float()


def rcp_bf(v):
    """bf16(1 / v): a relaxed epilogue's reciprocal of a float32 scale
    (the division in float32, then rounded)."""
    v = v.float() if torch.is_tensor(v) else torch.tensor(
        v, dtype=torch.float32)
    return bf(fq.exact_div(torch.ones_like(v), v))


def relaxed_levels(h, r, lo: int, hi: int):
    """clip(round(bf16(h * r)), lo, hi) of a bf16 value h and a bf16
    reciprocal r: the relaxed requantization (JAX ``_rnd32``: the bf16
    product rounded in float32)."""
    return torch.clamp(torch.round(bf(h * r)), lo, hi)


def gelu_relaxed(v):
    """The relaxed epilogue's tanh-GELU of float32 v in bf16 (JAX
    int8_serve.py:141-146): 0.5 h (1 + tanh(k (h + c h h h))), h = bf16(v),
    every operation rounded to bf16 in JAX's order; float32 out."""
    h = bf(v)
    c, k = bf(GELU_C), bf(GELU_K)
    inner = bf(bf(bf(c * h) * h) * h)
    t = bf(torch.tanh(bf(k * bf(h + inner))))
    return bf(bf(0.5 * h) * bf(1.0 + t))


def erf_as(z):
    """float32 erf by Abramowitz & Stegun 7.1.26 (|eps| <= 1.5e-7), the
    polynomial the JAX fused path computes (int8_serve.py:56)."""
    s = torch.sign(z)
    za = torch.abs(z)
    t = fq.exact_div(torch.ones_like(za), 1.0 + 0.3275911 * za)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    return s * (1.0 - poly * torch.exp(-za * za))


def layer_norm_kernel_order(x, w, b, eps):
    """LayerNorm of the rows of x (M, K) in the order B6's level pre-pass
    (csrc ``q8_levels_kernel``) computes it: 32 lanes each sum every 32nd
    element in turn, then a butterfly of the lanes' sums; the mean, then
    the mean of squared deviations; every step one fp32 rounding, the
    reciprocal square root correctly rounded (``__frsqrt_rn``).  Fed to
    the plain version without its own LayerNorm (``ln=None``), it makes
    the kernel's outputs comparable bitwise; the plain version's own
    LayerNorm sums in PyTorch's order, so an input may quantize a level
    the other way there."""
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


def _q8_acc_ref(x, w_intT, a_interval, a_neg_interval, *, a_qmax: int,
                postgelu: bool, ln=None, in_q: str = None):
    """B6's input levels (LayerNorm and quantization of a float input, or
    the int8 / twin-packed levels as given) and their exact integer dots
    with w_intT (K, N): (P, ..., N) int32 planes, P = 2 for a twin input
    (the positive and the negative levels' products), else 1."""
    dev = x.device
    K, N = w_intT.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K)
    a = _f32(a_interval, dev).reshape(())
    mode = in_q if in_q else ("f_twin" if postgelu else "f")
    if mode in ("f", "f_twin"):
        xf = x2.float()
        if ln:
            mu = torch.mean(xf, dim=1, keepdim=True)
            var = torch.mean(torch.square(xf - mu), dim=1, keepdim=True)
            xf = ((xf - mu) * torch.rsqrt(var + _f32(ln[2], dev))
                  * ln[0].float()[None, :] + ln[1].float()[None, :])
        if mode == "f_twin":
            an = _f32(a_neg_interval, dev).reshape(())
            lv = (levels(xf, a, 0, a_qmax - 1), levels(xf, an, -a_qmax, 0))
        else:
            lv = (levels(xf, a, -a_qmax, a_qmax - 1),)
    elif mode == "q8":
        lv = (x2,)
    else:
        lv = (torch.clamp(x2, min=0), torch.clamp(x2, max=0))
    # float64 products of levels are exact integers, far below 2 ** 31
    return torch.stack([torch.matmul(v.double(), w_intT.double())
                        .to(torch.int32) for v in lv]) \
        .reshape((len(lv),) + lead + (N,))


def q8_epilogue_ref(acc, w_scale, b, a_interval, a_neg_interval, *,
                    epilogue: str = None, residual=None, out_q: str = None,
                    out_scale=None, out_qmax: int = 128,
                    out_dtype=torch.float32, window=None,
                    relaxed: bool = False):
    """B6's epilogue on its int32 planes acc (P, ..., N) (``_q8_acc_ref``,
    or a row-parallel linear's partial planes summed over the model
    axis): each plane rounded once to float32, acc*a (+ acc_neg*a_neg),
    *w_scale + b, [GELU], [+ residual], then ``out_dtype`` or int8
    requantized (``out_q`` as in ``q8_linear``).  ``window`` = (ws, res):
    acc's rows are in the window layout (B·nW, ws², N) and the result and
    ``residual`` in the (B, res, res, N) image layout (B11's).
    ``relaxed``: the GELU (``gelu_relaxed``) and the requantization
    (``relaxed_levels`` of the bf16 output at bf16 reciprocals of the
    scales) in bf16, as JAX's relaxed epilogue."""
    dev = acc.device
    N = acc.shape[-1]
    lead = acc.shape[1:-1]
    planes = acc.reshape(acc.shape[0], -1, N)
    out = planes[0].float() * _f32(a_interval, dev).reshape(())
    if acc.shape[0] == 2:
        out = out + planes[1].float() * _f32(a_neg_interval,
                                             dev).reshape(())
    out = out * w_scale.float()[None, :]
    out = out + (b.float()[None, :] if b is not None else 0.0)
    if epilogue == "gelu":
        out = gelu_relaxed(out) if relaxed else \
            0.5 * out * (1.0 + erf_as(out * SQRT_HALF))
    if window is not None:
        from ..models.swin import window_reverse
        ws, res = window
        out = window_reverse(out.reshape(lead + (N,)), ws, res, res)
        return (out + residual.float()).to(residual.dtype)
    if residual is not None:
        out = out + residual.reshape(-1, N).float()
    if out_q == "vec" and relaxed:
        out = relaxed_levels(bf(out), rcp_bf(out_scale)[None, :], -out_qmax,
                             out_qmax - 1).to(torch.int8)
    elif out_q == "vec":
        out = levels(out, out_scale.float()[None, :], -out_qmax,
                     out_qmax - 1).to(torch.int8)
    elif out_q == "twin" and relaxed:
        h = bf(out)
        p = relaxed_levels(h, rcp_bf(_f32(out_scale[0], dev)), 0,
                           out_qmax - 1)
        n = relaxed_levels(h, rcp_bf(_f32(out_scale[1], dev)), -out_qmax, 0)
        out = (p + n).to(torch.int8)
    elif out_q == "twin":
        p = levels(out, _f32(out_scale[0], dev), 0, out_qmax - 1)
        n = levels(out, _f32(out_scale[1], dev), -out_qmax, 0)
        out = (p + n).to(torch.int8)
    else:
        out = out.to(out_dtype)
    return out.reshape(lead + (N,))


def q8_linear_ref(x, w_intT, w_scale, b, a_interval, a_neg_interval, *,
                  a_qmax: int, postgelu: bool, epilogue: str = None,
                  ln=None, in_q: str = None, out_q: str = None,
                  out_scale=None, out_qmax: int = 128, float_dtype=None,
                  residual=None, w_kmaj=None, relaxed: bool = False):
    """Plain version of B6; arguments and result as ``q8_linear``
    (``w_kmaj``, the kernel's copy of the levels, is not read): the exact
    integer dots (``_q8_acc_ref``), returned as they are with
    ``out_q="acc"``, else through the epilogue (``q8_epilogue_ref``)."""
    acc = _q8_acc_ref(x, w_intT, a_interval, a_neg_interval, a_qmax=a_qmax,
                      postgelu=postgelu, ln=ln, in_q=in_q)
    if out_q == "acc":
        return acc
    return q8_epilogue_ref(acc, w_scale, b, a_interval, a_neg_interval,
                           epilogue=epilogue, residual=residual, out_q=out_q,
                           out_scale=out_scale, out_qmax=out_qmax,
                           out_dtype=_float_dtype(x, float_dtype),
                           relaxed=relaxed)


def _scalars(dev, a, a_neg=None, o_pos=1.0, o_neg=1.0):
    """B6's four scalars (a, a_neg, o_pos, o_neg) as a vector on the card:
    reading them on the host would wait for the work queued before."""
    return torch.stack([_f32(v, dev).reshape(()) for v in (
        a, 1.0 if a_neg is None else a_neg, o_pos, o_neg)])


def _float_dtype(x, float_dtype):
    if float_dtype is not None:
        return float_dtype
    return x.dtype if x.is_floating_point() else torch.float32


def fused_attention_ref(q, k, v, ph, split, scale, a_out, *, sos: bool,
                        in_q8: bool, qmaxes, out_dtype, extra=None,
                        relaxed: bool = False):
    """Plain version of the B7 / B8 / B9 kernel body on (B, H, N, hd)
    views.

    ph (4, H): the a1, b1, a2, b2 head scales; qmaxes (A1, B1, A2, B2, O);
    a_out: the requantization scale (int8 out) or None (float out);
    extra: (nW, H, N, N) fp32 added to the logits of image b's window
    b % nW before the softmax (B9), or None.  ``relaxed``: JAX's bf16
    chain after the logits (``_attn_math`` :343-390): e = bf16(exp(bf16(l
    - max))), p = bf16(e · bf16(1 / sum e)), the levels as bf16 products
    with bf16 reciprocals (``relaxed_levels``), the requantized output
    likewise; the sum, the pv rescale and 1 / a_int stay float32."""
    dev = q.device
    A1, B1, A2, B2, O = qmaxes
    H = q.shape[1]
    a1, b1, a2, b2 = (ph[i].float().reshape(1, H, 1, 1) for i in range(4))
    if in_q8:
        qi, ki, vi = q, k, v
    else:
        qi = levels(q.float(), a1, -A1, A1 - 1)
        ki = levels(k.float(), b1, -B1, B1 - 1)
        vi = levels(v.float(), b2, -B2, B2 - 1)
    logits = int_dot(qi, ki.transpose(-2, -1)) * (a1 * b1 * _f32(scale, dev))
    if extra is not None:
        logits = (logits.reshape((-1,) + tuple(extra.shape)) + extra) \
            .reshape(logits.shape)
    m = torch.amax(logits, dim=-1, keepdim=True)
    if relaxed:
        p = bf(torch.exp(bf(logits - m)))
        p = bf(p * rcp_bf(torch.sum(p, dim=-1, keepdim=True)))
    else:
        p = torch.exp(logits - m)
        p = p / torch.sum(p, dim=-1, keepdim=True)
    if sos:
        sp = _f32(split, dev)
        a_int = fq.exact_div(sp, A2 - 1)
        if relaxed:
            spb = bf(sp)
            hi = relaxed_levels(torch.clamp(p, spb, torch.ones_like(spb)),
                                bf(A2 - 1), 0, A2 - 1)
            lo = relaxed_levels(torch.clamp(p, torch.zeros_like(spb), spb),
                                rcp_bf(a_int), 0, A2 - 1)
        else:
            hi = torch.clamp(torch.round(
                torch.minimum(torch.maximum(p, sp), torch.ones_like(sp))
                * (A2 - 1)), 0, A2 - 1)
            lo = levels(torch.minimum(torch.maximum(p, torch.zeros_like(sp)),
                                      sp), a_int, 0, A2 - 1)
        acc = fq.exact_div(int_dot(hi, vi), A2 - 1) + int_dot(lo, vi) * a_int
    else:
        lv = (relaxed_levels(p, rcp_bf(a2), -A2, A2 - 1) if relaxed
              else levels(p, a2, -A2, A2 - 1))
        acc = int_dot(lv, vi) * a2
    out = acc * b2
    if a_out is not None and relaxed:
        return relaxed_levels(bf(out), rcp_bf(_f32(a_out, dev)), -O,
                              O - 1).to(torch.int8)
    if a_out is not None:
        return levels(out, _f32(a_out, dev), -O, O - 1).to(torch.int8)
    return out.to(out_dtype)


def window_term(bias, mask):
    """B9's additive logit term: bias (H, N, N) in fp32, or with the
    shifted mask (nW, N, N) bias[h] + mask[w] (nW, H, N, N) in fp32, in
    that order (JAX's ``extra``, int8_serve.py:625); contiguous.  It is
    fixed for a block: a serving engine builds it once
    (``models/swin.serving_terms``)."""
    bias = bias.float().contiguous()
    if mask is None:
        return bias
    return (bias[None] + mask.float()[:, None]).contiguous()


def fused_window_attention_ref(qkv, heads: int, nW: int, ph, split,
                               prescale, bias, mask, a_out, *, sos: bool,
                               in_q8: bool, qmaxes, out_dtype,
                               relaxed: bool = False, term=None):
    """Plain version of B9 on the (B·nW, N, 3C) qkv: ph[0] holds a1/s and
    ``prescale`` is s; the logits get ``term``, by default
    ``window_term(bias, mask)``.  Returns (B·nW, N, C)."""
    B_, N, c3 = qkv.shape
    C = c3 // 3
    if term is None:
        term = window_term(bias, mask)
    t = qkv.reshape(B_, N, 3, heads, C // heads).permute(2, 0, 3, 1, 4)
    out = fused_attention_ref(t[0], t[1], t[2], ph, split, prescale, a_out,
                              sos=sos, in_q8=in_q8, qmaxes=qmaxes,
                              out_dtype=out_dtype, extra=term,
                              relaxed=relaxed)
    return out.transpose(1, 2).reshape(B_, N, C)


def q8_win_qkv_ref(x4, w_intT, w_scale, b, a_interval, ln, ws: int,
                   col_scales, *, a_qmax: int, out_qmax: int = 128,
                   w_kmaj=None, relaxed: bool = False, norm_heads: int = 0):
    """Plain version of B10: B6's LN / quantize / int8 dot / per-column
    requant (``relaxed``: in bf16) on ``window_partition(x4, ws)``;
    ``ln=None`` quantizes the raw input, ``norm_heads`` L2-normalizes q
    and k per head before the requant (Swin V2, ``qk_norm_ref``)."""
    from ..models.swin import window_partition
    if not norm_heads:
        return q8_linear_ref(window_partition(x4, ws), w_intT, w_scale, b,
                             a_interval, None, a_qmax=a_qmax, postgelu=False,
                             ln=ln, out_q="vec", out_scale=col_scales,
                             out_qmax=out_qmax, relaxed=relaxed)
    acc = q8_linear_ref(window_partition(x4, ws), w_intT, w_scale, b,
                        a_interval, None, a_qmax=a_qmax, postgelu=False,
                        ln=ln, out_q="acc")
    v = q8_epilogue_ref(acc, w_scale, b, a_interval, None,
                        out_dtype=torch.float32)
    return levels(qk_norm_ref(v, norm_heads), col_scales.float(),
                  -out_qmax, out_qmax - 1).to(torch.int8)


NORM_EPS = 1e-12          # F.normalize's


def norm_head_dim(n3: int, heads: int) -> int:
    """The head width of B10's per-head normalization (``norm_heads``) on
    3C = ``n3`` columns; raises unless it divides 32 (the kernel sums a
    head's squares over the lanes of one warp)."""
    hd = n3 // (3 * heads) if heads > 0 and n3 % (3 * heads) == 0 else 0
    if hd < 1 or 32 % hd:
        raise ValueError(f"{n3} columns in 3 x {heads} heads: the head "
                         "width must divide 32")
    return hd


def qk_norm_ref(v, heads: int):
    """q's and k's columns of the rescaled qkv output v (..., 3C) divided
    per head by max(||.||, 1e-12) (F.normalize), the squares summed as
    the kernel's epilogue does: a butterfly over the head's hd lanes
    (hd divides 32), every step one fp32 rounding; v's columns as they
    are."""
    N3 = v.shape[-1]
    hd = norm_head_dim(N3, heads)
    qk = v[..., :2 * N3 // 3]
    s = (qk * qk).reshape(-1, hd)
    lanes = torch.arange(hd, device=v.device)
    off = hd // 2
    while off:
        s = s + s[:, lanes ^ off]
        off //= 2
    d = torch.clamp(torch.sqrt(s), min=NORM_EPS).reshape(qk.shape)
    return torch.cat([qk / d, v[..., 2 * N3 // 3:]], -1)


def q8_postnorm_ref(acc, w_scale, b, a_interval, a_neg_interval, ln,
                    residual, *, window=None):
    """Plain version of Swin V2's res-post-norm (csrc ``postnorm_kernel``)
    on int32 sums acc (P, ..., N): B6's rescale (``q8_epilogue_ref``),
    LayerNorm ``ln`` = (weight, bias, eps) in the kernel's order
    (``layer_norm_kernel_order``), plus ``residual``, in its dtype;
    ``window`` = (ws, res): acc's rows in the window layout, the residual
    and the result in the (B, res, res, N) image layout."""
    N = acc.shape[-1]
    lead = acc.shape[1:-1]
    v = q8_epilogue_ref(acc, w_scale, b, a_interval, a_neg_interval,
                        out_dtype=torch.float32).reshape(-1, N)
    y = layer_norm_kernel_order(v, ln[0], ln[1], ln[2]).reshape(
        lead + (N,))
    if window is not None:
        from ..models.swin import window_reverse
        ws, res = window
        y = window_reverse(y, ws, res, res)
    return (y + residual.float()).to(residual.dtype)


def q8_win_proj_ref(y_q, w_intT, w_scale, b, a_interval, ws: int, res: int,
                    residual4, *, a_qmax: int, w_kmaj=None,
                    out_q: str = None):
    """Plain version of B11: B6's int8-input product in fp32, reversed to
    the image layout, plus the residual, cast to its dtype; with
    ``out_q="acc"`` the (1, B·nW, ws², C) int32 sums in the window layout
    (``residual4`` unused)."""
    acc = _q8_acc_ref(y_q, w_intT, a_interval, None, a_qmax=a_qmax,
                      postgelu=False, in_q="q8")
    if out_q == "acc":
        return acc
    return q8_epilogue_ref(acc, w_scale, b, a_interval, None,
                           residual=residual4, window=(ws, res))


# ---------------------------------------------------------------------------
# B6 / B10 / B11's tile plan (csrc/serve_kernels.cu q8_tc_kernel)
# ---------------------------------------------------------------------------

Q_ROWS, Q_COLS, Q_KC = 64, 128, 128   # a block's rows, a tile's columns,
                                       # the K bytes of a chunk
Q_A_TILE = Q_ROWS * Q_KC               # one K chunk of the input levels
Q_W_TILE = Q_COLS * Q_KC               # one K chunk of the weight levels
Q_STAGE_BYTES = Q_ROWS * 36 * 4        # one epilogue pass's staging
Q_RES_BYTES = Q_ROWS * Q_COLS * 2      # a tile's bf16 residual
Q_ROW_BYTES = Q_ROWS * 4               # the output rows
Q_MAX_STAGES = 6                       # ring slots, at most
Q_PER_SM, Q_TWIN_PER_SM = 3, 2         # blocks an SM (csrc: its registers)
TWIN_MODES = ("f_twin", "q8twin")


def q8_smem_bytes(twin: bool, stages: int, res_tile: bool = False) -> int:
    """A q8_tc_kernel block's dynamic shared memory (csrc
    ``q8_smem_bytes``): 1 KB of alignment slack, ``stages`` ring slots (a
    weight chunk and the input's levels beside it, twice for the twin: c
    and pos), the epilogue's staging (twice for the twin), the tile's bf16
    residual copied ahead (``res_tile``), the output rows, the
    mbarriers."""
    na = 2 if twin else 1
    return (1024 + stages * (Q_W_TILE + na * Q_A_TILE) + na * Q_STAGE_BYTES
            + (Q_RES_BYTES if res_tile else 0) + Q_ROW_BYTES + 8 * 2 * stages)


class Q8Plan(NamedTuple):
    """How B6 / B10 / B11 runs one call on the card.

    stages: ring slots; per_sm: blocks an SM holds (three, two for the
    twin, whose accumulators take more registers); smem: a block's dynamic
    shared memory; row_tiles, col_tiles: 64-row and 128-column tiles of the
    output; blocks: the grid, each block a contiguous run of the row-major
    tile sequence."""
    stages: int
    per_sm: int
    smem: int
    row_tiles: int
    col_tiles: int
    blocks: int
    res_tile: bool


@functools.lru_cache(maxsize=None)
def q8_plan(M: int, N: int, in_mode: str, res_tile: bool = False,
            num_sms: int = NUM_SMS) -> Q8Plan:
    """The plan of a B6 / B10 / B11 call: the blocks an SM holds, the
    deepest ring (2 to Q_MAX_STAGES slots) their shared memory leaves room
    for, and a grid that fills the card (``num_sms`` SMs) once.  A call of
    no more tiles than SMs (the head) runs one block an SM, with the
    deepest ring: nothing else shares its SM, and its K chunks wait on
    TMA.  ``res_tile``: a bf16 residual whose tiles the kernel copies to
    shared memory ahead of the epilogue (``q8_res_tile``)."""
    if in_mode not in _IN_MODES:
        raise ValueError(f"unknown input mode {in_mode}")
    if min(M, N) < 1:
        raise ValueError(f"empty output ({M}, {N})")
    twin = in_mode in TWIN_MODES
    rt, ct = -(-M // Q_ROWS), -(-N // Q_COLS)
    per_sm = (1 if rt * ct <= num_sms else
              Q_TWIN_PER_SM if twin else Q_PER_SM)
    budget = min(SM_SMEM // per_sm - 1024, SMEM_LIMIT)
    stages = max(s for s in range(2, Q_MAX_STAGES + 1)
                 if q8_smem_bytes(twin, s, res_tile) <= budget)
    return Q8Plan(stages, per_sm, q8_smem_bytes(twin, stages, res_tile), rt,
                  ct, min(rt * ct, num_sms * per_sm), res_tile)


def q8_res_tile(residual, N: int) -> bool:
    """Whether the kernel copies the residual's tiles to shared memory
    ahead of the epilogue (16 bytes a copy): a bf16 residual whose rows
    start 16-byte aligned."""
    return (residual is not None and residual.dtype == torch.bfloat16
            and N % 8 == 0 and residual.data_ptr() % 16 == 0)


def q8_needs_levels(x, K: int, in_mode: str) -> bool:
    """Whether a call's input goes through the level pre-pass (csrc
    ``q8_levels_kernel``) into an (M, Kp) int8 scratch: float input
    (LayerNorm and quantization), and int8 rows that TMA cannot read (not
    16-byte aligned)."""
    return (in_mode not in ("q8", "q8twin") or K % K_ALIGN != 0
            or x.data_ptr() % 16 != 0)


def _levels(x, K: int, in_mode: str):
    """The pre-pass's (M, Kp) int8 scratch, or None."""
    if not q8_needs_levels(x, K, in_mode):
        return None
    M = x.numel() // K
    return torch.empty((M, -(-K // K_ALIGN) * K_ALIGN), dtype=torch.int8,
                       device=x.device)


def _kmajor(w_kmaj, w_intT):
    """The (N, Kp) K-major levels the kernel reads: ``w_kmaj`` as given
    (checked), else made from w_intT (K, N) -- a transposed copy each
    call, which the packed weights spare."""
    K, N = w_intT.shape
    if w_kmaj is None:
        w_kmaj = kmajor_levels(w_intT.t())
    _check(w_kmaj, "w_kmaj", torch.int8, (N, -(-K // K_ALIGN) * K_ALIGN),
           w_intT.device)
    return w_kmaj

@spanned("ptq.kernel.q8_linear")
def q8_linear(x, w_intT, w_scale, b, a_interval, a_neg_interval, *,
              a_qmax: int, postgelu: bool, epilogue: str = None,
              ln=None, in_q: str = None, out_q: str = None,
              out_scale=None, out_qmax: int = 128, float_dtype=None,
              residual=None, w_kmaj=None, relaxed: bool = False):
    """B6: fused quantize -> int8 matmul -> rescale linear.

    x:        (..., K) float32 / bfloat16, or int8 when ``in_q`` is set
    w_intT:   (K, N) int8 weight levels (ops/pack.pack_weights)
    w_kmaj:   optional (N, Kp) K-major copy of them (the packed
              ``w_kmaj``), the operand the card's kernel reads; without
              it, on the card, the wrapper makes it on every call
    w_scale:  (N,) per-out-channel dequant scale; b: (N,) or None
    a_interval / a_neg_interval: the input scale(s)
    ln:       optional (weight (K,), bias (K,), eps) LayerNorm prologue
    in_q:     None | "q8" | "q8twin" (x holds levels; twin packed pos + neg)
    epilogue: None | "gelu" (the A&S erf polynomial)
    out_q:    None | "vec" (per-column ``out_scale`` (N,)) | "twin"
              (``out_scale`` = (pos, neg) intervals): int8 output |
              "acc": the int32 sums alone, no epilogue (a row-parallel
              linear's partial products; ``q8_epilogue`` after their sum)
    residual: optional (..., N) float stream added in the epilogue
    relaxed:  the bf16 epilogue (tanh-GELU, requantization at bf16
              reciprocals; ``q8_epilogue_ref``), by the kernel's relaxed
              variant where it changes the function (GELU, "vec" or
              "twin"); any other output is the exact kernel's.  The card
              has no relaxed variant after a post-GELU twin input (no
              serving path runs one) and refuses such a call
    Returns (..., N): int8 when ``out_q`` is "vec" or "twin", else
    ``float_dtype`` (default: x's dtype); with "acc", (P, ..., N) int32,
    P = 2 for a twin input (pos, neg), else 1."""
    if out_q == "acc" and (epilogue or residual is not None):
        raise ValueError("out_q='acc' stores the int32 sums: no epilogue "
                         "or residual")
    if not x.is_cuda:
        return q8_linear_ref(x, w_intT, w_scale, b, a_interval,
                             a_neg_interval, a_qmax=a_qmax,
                             postgelu=postgelu, epilogue=epilogue, ln=ln,
                             in_q=in_q, out_q=out_q, out_scale=out_scale,
                             out_qmax=out_qmax, float_dtype=float_dtype,
                             residual=residual, relaxed=relaxed)
    from .build import load
    lib = load("serve_kernels")
    dev = x.device
    K, N = w_intT.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K).contiguous()
    M = x2.shape[0]
    mode = in_q if in_q else ("f_twin" if postgelu else "f")
    if mode not in _IN_MODES or out_q not in _OUT_Q:
        raise ValueError(f"unknown input mode {mode} or output {out_q}")
    want = (torch.int8,) if in_q else (torch.float32, torch.bfloat16)
    if x2.dtype not in want:
        raise TypeError(f"x: expected one of {want}, got {x2.dtype}")
    _check(w_intT, "w_intT", torch.int8, (K, N), dev)
    wk = _kmajor(w_kmaj, w_intT)
    ws = w_scale.float().contiguous()
    _check(ws, "w_scale", torch.float32, (N,), dev)
    bias = b.float().contiguous() if b is not None else None
    if bias is not None:
        _check(bias, "b", torch.float32, (N,), dev)
    lnw = lnb = None
    if ln:
        lnw, lnb = ln[0].float().contiguous(), ln[1].float().contiguous()
        _check(lnw, "ln weight", torch.float32, (K,), dev)
        _check(lnb, "ln bias", torch.float32, (K,), dev)
    osc = None
    o_pos = o_neg = 1.0
    if out_q == "vec":
        osc = out_scale.float().contiguous()
        _check(osc, "out_scale", torch.float32, (N,), dev)
    elif out_q == "twin":
        o_pos, o_neg = out_scale
    scal = _scalars(dev, a_interval, a_neg_interval, o_pos, o_neg)
    fdt = _float_dtype(x, float_dtype)
    planes = 2 if mode in TWIN_MODES else 1
    out_dtype = (torch.int32 if out_q == "acc" else torch.int8 if out_q
                 else fdt)
    if out_dtype not in _KINDS:
        raise TypeError(f"unsupported output dtype {out_dtype}")
    res = None
    if residual is not None:
        if out_q:
            raise ValueError("a residual needs a float output")
        res = residual.reshape(M, N).contiguous()
        _check(res, "residual", fdt, (M, N), dev)
    shape = (planes, M, N) if out_q == "acc" else (M, N)
    out = torch.empty(shape, dtype=out_dtype, device=dev)
    rel = relaxed_variant(relaxed, epilogue, out_q)
    if rel and mode in TWIN_MODES:
        raise ValueError("the relaxed epilogue after a post-GELU twin input "
                         "is not built: no serving path runs it")
    if M:
        plan = q8_plan(M, N, mode, q8_res_tile(res, N), _num_sms(dev))
        _launch(lib.ptq_q8_linear, _ptr(x2), _KINDS[x2.dtype], _ptr(wk),
                wk.shape[1], _ptr(ws), _ptr(bias), _ptr(lnw), _ptr(lnb),
                _ptr(osc), _ptr(res), _ptr(out), _KINDS[out_dtype],
                _ptr(scal), float(ln[2]) if ln else 0.0,
                _ptr(_levels(x2, K, mode)), M, K, N, _IN_MODES[mode],
                int(bool(ln)), int(epilogue == "gelu"), _OUT_Q[out_q],
                a_qmax, out_qmax, int(rel), plan.stages, int(plan.res_tile),
                plan.blocks, _stream())
    _count(q8_linear, rel)
    return out.reshape(shape[:-2] + lead + (N,))


def relaxed_variant(relaxed: bool, epilogue: str = None,
                    out_q: str = None) -> bool:
    """Whether a B6 / B10 call in the relaxed mode runs the kernel's
    relaxed variant: only where the relaxed epilogue is another function
    (a GELU, a requantized output); a float output without GELU, and the
    int32 sums, are the same in both modes and run the exact kernel."""
    return bool(relaxed) and (epilogue == "gelu" or out_q in ("vec", "twin"))


def _count(fn, relaxed: bool) -> None:
    """One launch of ``fn``'s kernel, or of its relaxed variant."""
    if relaxed:
        fn.relaxed_launches += 1
    else:
        fn.launches += 1


# ---------------------------------------------------------------------------
# B7 / B8 / B9's plan (csrc/serve_kernels.cu attention_kernel, attn_plan)
# ---------------------------------------------------------------------------

AT_ROWS, AT_KEYS = 16, 32     # query rows of a warp's strip, keys of a chunk
AT_PARK_CHUNKS = 5            # N <= 160: a strip's logits parked in shared
                              # memory between the passes
AT_WARPS, AT_PARK_WARPS = 8, 4  # warps a block at most
AT_TEAM_WARPS = 16            # a team's warps at most (one block)
AT_TEAM_CHUNKS = 3            # the most chunks a team lane holds (hdp 32)
AT_MAX_HD = 64


def at_team_smem(warps: int, keys: int) -> int:
    """A team's shared buffers beyond k and vT (csrc ``at_team_smem``):
    the partial sums handed down the team (16 floats a lane), p.v's sums
    (32 ints a lane), the row sums and each warp's row maxima (16 floats
    each), and the strip's 16 rows of the additive term (keys + 8 floats
    apart)."""
    return (16 * 32 * 4 + 32 * 32 * 4 + 16 * 4 + warps * 16 * 4
            + 16 * (keys + 8) * 4)


class AttnPlan(NamedTuple):
    """How B7 / B8 / B9 runs on the card, per (image or window, head)
    block.

    hdp: the head dim padded with zero levels (32 or 64); keys: N padded to
    a multiple of 32 (zero v levels, zero probability levels); kstr, vstr:
    the byte strides of the k rows (hdp + 16) and of the transposed v rows
    (keys + 16), 16 times an odd number so that ldmatrix's 8 rows hit
    distinct banks; parked: a strip's logits wait in shared memory between
    the passes, each lane's in its own places (N <= 160), instead of being
    recomputed; strips: 16-row query strips, which a block's warps take
    in turn (a team: together); warps: a block's; smem: a block's shared
    memory (k, the transposed v, and parked: 64 bytes a key and warp, a
    team: ``at_team_smem``); team: the block's warps share each strip,
    each holding the logits of its run of 32-key chunks in registers
    between the passes (N > 160 at hdp 32, where at most 16 warps of 3
    chunks hold them, N <= 1536, and their buffers fit); chunks: a team
    warp's most chunks (0 unless team)."""
    hdp: int
    keys: int
    kstr: int
    vstr: int
    parked: bool
    strips: int
    warps: int
    smem: int
    team: bool = False
    chunks: int = 0


@functools.lru_cache(maxsize=None)
def attn_plan(N: int, hd: int) -> AttnPlan:
    """The plan of an attention over N keys with head dim ``hd`` (csrc
    ``attn_plan`` computes the same): one block an (image or window, head).
    Up to N = 160 the logits are parked, the block's warps the most the
    mode takes (4) with the fewest idle strip slots, down to half of that;
    past it, at hdp 32, a team holds them where the fewest warps that hold
    every chunk at 3 a lane are at most 16 (N <= 1536) and its buffers
    fit; else they are
    recomputed, on up to 8 warps by the parked rule (at hdp 64 p.v's SoS
    sums leave no registers for a team's chunks).  A head dim past 64 or
    k and v beyond a block's shared memory raise ValueError: there is no
    other kernel."""
    if N < 1 or not 1 <= hd <= AT_MAX_HD:
        raise ValueError(f"attention of {N} keys, head dim {hd}: the kernel "
                         f"takes 1 to {AT_MAX_HD} head dims")
    hdp = 32 if hd <= 32 else 64
    keys = -(-N // AT_KEYS) * AT_KEYS
    parked = N <= AT_KEYS * AT_PARK_CHUNKS
    strips = -(-N // AT_ROWS)
    nc = keys // AT_KEYS
    width = -(-nc // AT_TEAM_CHUNKS)
    smem = keys * (hdp + 16) + hdp * (keys + 16)
    team = (not parked and hdp == 32 and width <= AT_TEAM_WARPS
            and smem + at_team_smem(width, keys) <= SMEM_LIMIT)
    if team:
        warps, chunks = width, -(-nc // width)
        smem += at_team_smem(warps, keys)
    else:
        wmax = AT_PARK_WARPS if parked else AT_WARPS
        hi, lo = min(strips, wmax), max(1, min(strips, wmax // 2))
        warps, chunks = hi, 0
        for w in range(hi - 1, lo - 1, -1):
            if -(-strips // w) * w < -(-strips // warps) * warps:
                warps = w
        if parked:
            smem += warps * keys * AT_ROWS * 4
    if smem > SMEM_LIMIT:
        raise ValueError(f"attention of {N} keys: k and v take {smem} bytes "
                         f"of shared memory, more than {SMEM_LIMIT}")
    return AttnPlan(hdp, keys, hdp + 16, keys + 16, parked, strips, warps,
                    smem, team, chunks)


def _attn_launch(q, k, v, strides, out, ostrides, ph, split, scale, a_out,
                 B, H, N, hd, sos, qmaxes, in_dtype, window=None,
                 relaxed=False):
    """Launch the B7 / B8 kernel, or B9's with ``window`` = (term (H, N,
    N) or (nW, H, N, N), ``window_term``'s, and nW); q, k, v are element
    addresses;
    ``relaxed``: its relaxed variant.  The library plans the call as
    ``attn_plan`` does; a shape it refuses raises here first.  A launch
    in the team mode is counted as ``attention_team`` too."""
    from .build import load
    team = attn_plan(N, hd).team
    lib = load("serve_kernels")
    dev = out.device
    ph = ph.float().contiguous()
    _check(ph, "head scales", torch.float32, (4, H), dev)
    misc = torch.stack([_f32(0.0 if split is None else split, dev)
                        .reshape(()),
                        _f32(1.0 if a_out is None else a_out, dev)
                        .reshape(())])
    head = (q, k, v, _KINDS[in_dtype], *strides, _ptr(out),
            _KINDS[out.dtype], *ostrides, _ptr(ph), _ptr(misc), float(scale))
    tail = (B, H, N, hd, int(sos), *qmaxes, int(bool(relaxed)), _stream())
    if window is None:
        _launch(lib.ptq_fused_attention, *head, *tail)
    else:
        term, nW = window
        # one float a logit: the kernel reads term[w % period][h]
        _check(term, "window term", torch.float32,
               (nW, H, N, N)[-term.ndim:], dev)
        period = nW if term.ndim == 4 else 1
        _launch(lib.ptq_window_attention, *head, _ptr(term), period, *tail)
    if team:
        _attn_launch.team_launches += 1


@spanned("ptq.kernel.fused_attention_qkv")
def fused_attention_qkv(qkv, heads: int, qp1, qp2, scale, *,
                        in_q8: bool = False, out_scale=None,
                        out_qmax: int = 128, relaxed: bool = False):
    """B7: fused int8 attention softmax(q·kᵀ·scale)·v read straight from
    the packed (B, N, 3d) qkv-linear output, written as (B, N, d).

    in_q8: qkv holds int8 levels at the a1 / b1 / b2 head scales (the qkv
    linear's ``out_q="vec"`` epilogue).  out_scale: the context is
    requantized at this scalar and returned int8.  relaxed: the bf16
    softmax and levels (``fused_attention_ref``), by the kernel's relaxed
    variant.  Returns (B, N, d) in qkv's dtype (float32 for int8 in and
    float out, int8 with ``out_scale``), or None when the QPs are out of
    scope."""
    B, N, d3 = qkv.shape
    if d3 % (3 * heads):
        raise ValueError(f"qkv width {d3} is not 3 x {heads} heads")
    d = d3 // 3
    hd = d // heads
    scoped = attn_scope(qp1, qp2, heads)
    if scoped is None:
        return None
    ph, sos = scoped
    qmaxes = attn_qmaxes(qp1, qp2, out_qmax)
    split = qp2.split if sos else None
    fdt = qkv.dtype if qkv.is_floating_point() else torch.float32
    if not qkv.is_cuda:
        t = qkv.reshape(B, N, 3, heads, hd).permute(2, 0, 3, 1, 4)
        out = fused_attention_ref(t[0], t[1], t[2], ph, split, scale,
                                  out_scale, sos=sos, in_q8=in_q8,
                                  qmaxes=qmaxes, out_dtype=fdt,
                                  relaxed=relaxed)
        return out.transpose(1, 2).reshape(B, N, d)
    if (qkv.dtype == torch.int8) != bool(in_q8):
        raise TypeError("qkv must be int8 exactly when in_q8")
    if qkv.dtype not in _KINDS:
        raise TypeError(f"qkv: unsupported dtype {qkv.dtype}")
    _check(qkv, "qkv", qkv.dtype, (B, N, 3 * d), qkv.device)
    out = torch.empty((B, N, d), device=qkv.device,
                      dtype=torch.int8 if out_scale is not None else fdt)
    # (b, n, h, j) of q at b*N*3d + n*3d + h*hd + j; k, v at +d, +2d
    base = qkv.data_ptr()
    es = qkv.element_size()
    _attn_launch(base, base + d * es, base + 2 * d * es,
                 (N * d3, hd, d3), out, (N * d, hd, d), ph, split, scale,
                 out_scale, B, heads, N, hd, sos, qmaxes, qkv.dtype,
                 relaxed=relaxed)
    _count(fused_attention_qkv, relaxed)
    return out


@spanned("ptq.kernel.fused_attention")
def fused_attention(q, k, v, qp1, qp2, scale, relaxed: bool = False):
    """B8: the B7 kernel entered with the strides of the (B, H, N, hd)
    layout; float in, float out (``relaxed`` as in B7).  Returns (B, H, N,
    hd) in q's dtype, or None when the QPs are out of scope."""
    B, H, N, hd = q.shape
    scoped = attn_scope(qp1, qp2, H)
    if scoped is None:
        return None
    ph, sos = scoped
    qmaxes = attn_qmaxes(qp1, qp2, 128)
    split = qp2.split if sos else None
    if not q.is_cuda:
        return fused_attention_ref(q, k, v, ph, split, scale, None, sos=sos,
                                   in_q8=False, qmaxes=qmaxes,
                                   out_dtype=q.dtype, relaxed=relaxed)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q: expected float32 or bfloat16, got {q.dtype}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _check(t, name, q.dtype, (B, H, N, hd), q.device)
    out = torch.empty_like(q)
    st = (H * N * hd, N * hd, hd)
    _attn_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), st, out, st, ph,
                 split, scale, None, B, H, N, hd, sos, qmaxes, q.dtype,
                 relaxed=relaxed)
    _count(fused_attention, relaxed)
    return out


@spanned("ptq.kernel.fused_window_attention_qkv")
def fused_window_attention_qkv(qkv, heads: int, nW: int, qp1, qp2,
                               prescale, bias, mask, *, in_q8: bool = False,
                               out_scale=None, out_qmax: int = 128,
                               relaxed: bool = False, term=None, tau=None):
    """B9: fused Swin window attention softmax(q·s·kᵀ + bias [+ mask])·v
    from the packed (B·nW, N, 3C) qkv-linear output, windows images-major,
    written as (B·nW, N, C).

    The reference pre-scales q by s = ``prescale`` before matmul1, so its
    A operand quantizes q·s: folded into the q scale a1/s (an exact
    division) with the logits rescaled by (a1/s · b1) · s.
    bias: (H, N, N) relative-position bias; mask: (nW, N, N) additive
    shifted-window mask or None (both used in fp32, summed by
    ``window_term``); term: that sum made beforehand (a serving engine's),
    in place of bias and mask, which are then not read.  in_q8: qkv holds
    int8 levels at the (a1/s, b1, b2) head scales (B10's output);
    out_scale: the context is requantized at this scalar and returned
    int8.  relaxed: as in B7.  tau: (H,) float32 per-head logit scale
    (Swin V2's cosine attention, ``prescale`` 1), folded into the q scale:
    the logits are int·(a1·τ_h)·b1.  Returns (B·nW, N, C) in qkv's dtype
    (float32 for int8 in and float out, int8 with ``out_scale``), or None
    when the QPs are out of scope."""
    B_, N, c3 = qkv.shape
    if c3 % (3 * heads) or B_ % nW:
        raise ValueError(f"qkv {tuple(qkv.shape)}: not 3 x {heads} heads "
                         f"over whole images of {nW} windows")
    C = c3 // 3
    hd = C // heads
    scoped = window_attn_scope(qp1, qp2, heads, prescale)
    if scoped is None:
        return None
    ph, sos = scoped
    if tau is not None:
        ph = torch.cat([ph[:1] * tau.float().reshape(1, heads), ph[1:]])
    qmaxes = attn_qmaxes(qp1, qp2, out_qmax)
    split = qp2.split if sos else None
    fdt = qkv.dtype if qkv.is_floating_point() else torch.float32
    if term is None:
        term = window_term(bias, mask)
    if not qkv.is_cuda:
        return fused_window_attention_ref(
            qkv, heads, nW, ph, split, prescale, None, None, out_scale,
            sos=sos, in_q8=in_q8, qmaxes=qmaxes, out_dtype=fdt,
            relaxed=relaxed, term=term)
    if (qkv.dtype == torch.int8) != bool(in_q8):
        raise TypeError("qkv must be int8 exactly when in_q8")
    if qkv.dtype not in _KINDS:
        raise TypeError(f"qkv: unsupported dtype {qkv.dtype}")
    _check(qkv, "qkv", qkv.dtype, (B_, N, c3), qkv.device)
    out = torch.empty((B_, N, C), device=qkv.device,
                      dtype=torch.int8 if out_scale is not None else fdt)
    base = qkv.data_ptr()
    es = qkv.element_size()
    _attn_launch(base, base + C * es, base + 2 * C * es, (N * c3, hd, c3),
                 out, (N * C, hd, C), ph, split, prescale, out_scale, B_,
                 heads, N, hd, sos, qmaxes, qkv.dtype,
                 window=(term, nW), relaxed=relaxed)
    _count(fused_window_attention_qkv, relaxed)
    return out


@spanned("ptq.kernel.q8_win_qkv")
def q8_win_qkv(x4, w_intT, w_scale, b, a_interval, ln, ws: int, col_scales,
               *, a_qmax: int, out_qmax: int = 128, w_kmaj=None,
               relaxed: bool = False, norm_heads: int = 0):
    """B10: the Swin qkv linear over the unshifted window grid of the
    (B, res, res, C) image layout (a shifted block passes its rolled
    stream): LayerNorm ``ln`` = (weight, bias, eps), quantize at
    ``a_interval``, int8 dot with w_intT (C, 3C), rescale, and requantize
    per column at ``col_scales`` (3C,) (the attention's a1/s, b1, b2, each
    repeated hd times).  Windows are read in place, in window_partition's
    order.  ``w_kmaj`` as in ``q8_linear``; ``relaxed``: the requant in
    bf16, by the kernel's relaxed variant.  Returns (B·(res/ws)², ws²,
    3C) int8.  Swin V2: ``ln=None`` quantizes the raw stream (no
    LayerNorm before attention) and ``norm_heads`` > 0 L2-normalizes q's
    and k's columns per head of 3C / (3 ``norm_heads``) columns (which
    must divide 32) before the requantization: B9's q̂, k̂ and v."""
    B, res, res2, C = x4.shape
    if res != res2 or res % ws:
        raise ValueError(f"x4 {tuple(x4.shape)}: not square whole "
                         f"windows of {ws}")
    hd = norm_head_dim(w_intT.shape[1], norm_heads) if norm_heads else 0
    if hd and relaxed:
        raise ValueError("norm_heads has no relaxed variant")
    if not x4.is_cuda:
        return q8_win_qkv_ref(x4, w_intT, w_scale, b, a_interval, ln, ws,
                              col_scales, a_qmax=a_qmax, out_qmax=out_qmax,
                              relaxed=relaxed, norm_heads=norm_heads)
    from .build import load
    lib = load("serve_kernels")
    dev = x4.device
    N3 = w_intT.shape[1]
    if x4.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x4: expected float32 or bfloat16, got {x4.dtype}")
    _check(x4, "x4", x4.dtype, (B, res, res, C), dev)
    _check(w_intT, "w_intT", torch.int8, (C, N3), dev)
    wk = _kmajor(w_kmaj, w_intT)
    wsc = w_scale.float().contiguous()
    _check(wsc, "w_scale", torch.float32, (N3,), dev)
    bias = b.float().contiguous() if b is not None else None
    if bias is not None:
        _check(bias, "b", torch.float32, (N3,), dev)
    lnw = lnb = None
    if ln:
        lnw, lnb = ln[0].float().contiguous(), ln[1].float().contiguous()
        _check(lnw, "ln weight", torch.float32, (C,), dev)
        _check(lnb, "ln bias", torch.float32, (C,), dev)
    osc = col_scales.float().contiguous()
    _check(osc, "col_scales", torch.float32, (N3,), dev)
    scal = _scalars(dev, a_interval)
    M = B * res * res
    out = torch.empty((B * (res // ws) ** 2, ws * ws, N3), dtype=torch.int8,
                      device=dev)
    if M:
        plan = q8_plan(M, N3, "f", num_sms=_num_sms(dev))
        _launch(lib.ptq_q8_win_qkv, _ptr(x4), _KINDS[x4.dtype], _ptr(wk),
                wk.shape[1], _ptr(wsc), _ptr(bias), _ptr(lnw), _ptr(lnb),
                _ptr(osc), _ptr(out), _ptr(scal), float(ln[2]) if ln else 0.0,
                _ptr(_levels(x4, C, "f")), M, C, N3, a_qmax, out_qmax, ws,
                res, int(bool(relaxed)), hd, plan.stages, plan.blocks,
                _stream())
    if hd:
        q8_win_qkv.norm_launches += 1
    else:
        _count(q8_win_qkv, relaxed)
    return out


@spanned("ptq.kernel.q8_win_proj")
def q8_win_proj(y_q, w_intT, w_scale, b, a_interval, ws: int, res: int,
                residual4, *, a_qmax: int, w_kmaj=None, out_q: str = None):
    """B11: the Swin proj linear over the window-layout int8 context
    y_q (B·(res/ws)², ws², C) at ``a_interval``, written to the (B, res,
    res, C) image layout with ``residual4`` (that layout, float32 or
    bfloat16; a shifted block's rolled stream) added in the epilogue.
    ``w_kmaj`` as in ``q8_linear``.  Returns (B, res, res, C) in the
    residual's dtype.  ``out_q="acc"``: the (1, B·(res/ws)², ws², C)
    int32 sums in the window layout (a row-parallel shard's partial
    products), no epilogue; ``residual4`` is then None, and
    ``q8_epilogue(..., window=(ws, res))`` applies the row map, the bias
    and the residual after their sum over the model axis."""
    B_, N, C = y_q.shape
    Co = w_intT.shape[1]
    acc = out_q == "acc"
    if out_q not in (None, "acc") or acc != (residual4 is None):
        raise ValueError("q8_win_proj: a residual exactly without "
                         "out_q='acc'")
    B = B_ // max(res // ws, 1) ** 2 if acc else residual4.shape[0]
    if N != ws * ws or B_ != B * (res // ws) ** 2 or res % ws:
        raise ValueError(f"y_q {tuple(y_q.shape)} is not the window layout "
                         f"of {B} images of {res} x {res} in windows of "
                         f"{ws}")
    if not y_q.is_cuda:
        return q8_win_proj_ref(y_q, w_intT, w_scale, b, a_interval, ws, res,
                               residual4, a_qmax=a_qmax, out_q=out_q)
    from .build import load
    lib = load("serve_kernels")
    dev = y_q.device
    _check(y_q, "y_q", torch.int8, (B_, N, C), dev)
    _check(w_intT, "w_intT", torch.int8, (C, Co), dev)
    wk = _kmajor(w_kmaj, w_intT)
    wsc = w_scale.float().contiguous()
    _check(wsc, "w_scale", torch.float32, (Co,), dev)
    bias = b.float().contiguous() if b is not None else None
    if bias is not None:
        _check(bias, "b", torch.float32, (Co,), dev)
    if acc:
        out = torch.empty((1, B_, N, Co), dtype=torch.int32, device=dev)
    else:
        if residual4.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError("residual4: expected float32 or bfloat16, got "
                            f"{residual4.dtype}")
        _check(residual4, "residual4", residual4.dtype, (B, res, res, Co),
               dev)
        out = torch.empty_like(residual4)
    scal = _scalars(dev, a_interval)
    if B_ * N:
        res_tile = q8_res_tile(residual4, Co)
        plan = q8_plan(B_ * N, Co, "q8", res_tile, _num_sms(dev))
        _launch(lib.ptq_q8_win_proj, _ptr(y_q), _ptr(wk), wk.shape[1],
                _ptr(wsc), _ptr(bias), _ptr(residual4), _ptr(out),
                _KINDS[out.dtype], _ptr(scal), _ptr(_levels(y_q, C, "q8")),
                B_ * N, C, Co, a_qmax, ws, res, _OUT_Q[out_q], plan.stages,
                int(plan.res_tile), plan.blocks, _stream())
    q8_win_proj.launches += 1
    return out


EP_BLOCKS_PER_SM = 8          # q8_epilogue_kernel: 256-thread blocks an SM


@spanned("ptq.kernel.q8_epilogue")
def q8_epilogue(acc, w_scale, b, a_interval, a_neg_interval=None, *,
                residual=None, out_dtype=None, window=None):
    """B6's (and B11's) epilogue split off, for a row-parallel linear under
    tensor parallelism: the summed int32 planes acc (P, ..., N) of
    ``q8_linear(..., out_q="acc")`` (P = 2: a twin input's pos and neg)
    or ``q8_win_proj(..., out_q="acc")``, rounded to float32, acc*a (+
    acc_neg*a_neg), *w_scale + b, + ``residual``, stored as
    ``out_dtype`` (default: the residual's dtype, else float32) -- the
    single device's kernel's outputs bitwise, the bias and the residual
    added once.  ``window`` = (ws, res): acc is in the window layout and
    the result and ``residual`` in the (B, res, res, N) image layout
    (B11's row map).  Returns (..., N), or (B, res, res, N) with
    ``window``."""
    P, N = acc.shape[0], acc.shape[-1]
    lead = acc.shape[1:-1]
    M = acc[0].numel() // N if N else 0
    if out_dtype is None:
        out_dtype = residual.dtype if residual is not None \
            else torch.float32
    if P not in (1, 2) or (P == 2) != (a_neg_interval is not None):
        raise ValueError(f"{P} planes: 1, or 2 with a_neg_interval")
    if window is not None:
        ws, res = window
        if residual is None or len(lead) != 2 or lead[1] != ws * ws or \
                res % ws or lead[0] % ((res // ws) ** 2):
            raise ValueError(f"acc {tuple(acc.shape)} is not the window "
                             f"layout of {res} x {res} in windows of {ws} "
                             "with an image-layout residual")
    if not acc.is_cuda:
        return q8_epilogue_ref(acc, w_scale, b, a_interval, a_neg_interval,
                               residual=residual, out_dtype=out_dtype,
                               window=window)
    from .build import load
    lib = load("serve_kernels")
    dev = acc.device
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"unsupported output dtype {out_dtype}")
    acc = acc.contiguous()
    _check(acc, "acc", torch.int32, (P,) + tuple(lead) + (N,), dev)
    wsc = w_scale.float().contiguous()
    _check(wsc, "w_scale", torch.float32, (N,), dev)
    bias = b.float().contiguous() if b is not None else None
    if bias is not None:
        _check(bias, "b", torch.float32, (N,), dev)
    if window is None:
        oshape = tuple(lead) + (N,)
    else:
        oshape = (lead[0] // (res // ws) ** 2, res, res, N)
    if residual is not None:
        residual = residual.contiguous()
        _check(residual, "residual", out_dtype, oshape, dev)
    scal = _scalars(dev, a_interval, a_neg_interval)
    out = torch.empty(oshape, dtype=out_dtype, device=dev)
    if M:
        win, img = window if window is not None else (0, 0)
        _launch(lib.ptq_q8_epilogue, _ptr(acc), P, _ptr(wsc), _ptr(bias),
                _ptr(residual), _ptr(out), _KINDS[out_dtype], _ptr(scal), M,
                N, win, img, min(M, EP_BLOCKS_PER_SM * _num_sms(dev)),
                _stream())
    q8_epilogue.launches += 1
    return out


@spanned("ptq.kernel.q8_postnorm")
def q8_postnorm(acc, w_scale, b, a_interval, a_neg_interval, ln, residual,
                *, window=None):
    """Swin V2's res-post-norm (csrc ``postnorm_kernel``): residual +
    LayerNorm(acc*a (+ acc_neg*a_neg) * w_scale + b) on the int32 sums acc
    (P, ..., N) of B6 or B11 (``out_q="acc"``; P = 2 after a twin input,
    with ``a_neg_interval``), ``ln`` = (weight, bias, eps) over the whole
    row, in the residual's dtype.  ``window`` = (ws, res): acc is in the
    window layout and ``residual`` and the result in the (B, res, res, N)
    image layout (B11's row map).  Returns the residual's shape."""
    P, N = acc.shape[0], acc.shape[-1]
    lead = acc.shape[1:-1]
    if P not in (1, 2) or (P == 2) != (a_neg_interval is not None):
        raise ValueError(f"{P} planes: 1, or 2 with a_neg_interval")
    if window is not None:
        ws, res = window
        if len(lead) != 2 or lead[1] != ws * ws or res % ws or \
                lead[0] % ((res // ws) ** 2):
            raise ValueError(f"acc {tuple(acc.shape)} is not the window "
                             f"layout of {res} x {res} in windows of {ws}")
    if not acc.is_cuda:
        return q8_postnorm_ref(acc, w_scale, b, a_interval, a_neg_interval,
                               ln, residual, window=window)
    from .build import load
    lib = load("serve_kernels")
    dev = acc.device
    if residual.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"unsupported residual dtype {residual.dtype}")
    acc = acc.contiguous()
    _check(acc, "acc", torch.int32, tuple(acc.shape), dev)
    M = acc[0].numel() // N if N else 0
    wsc = w_scale.float().contiguous()
    _check(wsc, "w_scale", torch.float32, (N,), dev)
    bias = b.float().contiguous() if b is not None else None
    if bias is not None:
        _check(bias, "b", torch.float32, (N,), dev)
    lnw, lnb = ln[0].float().contiguous(), ln[1].float().contiguous()
    _check(lnw, "ln weight", torch.float32, (N,), dev)
    _check(lnb, "ln bias", torch.float32, (N,), dev)
    oshape = (tuple(lead) + (N,) if window is None
              else (lead[0] // (res // ws) ** 2, res, res, N))
    residual = residual.contiguous()
    _check(residual, "residual", residual.dtype, oshape, dev)
    out = torch.empty_like(residual)
    if M:
        win, img = window if window is not None else (0, 0)
        _launch(lib.ptq_q8_postnorm, _ptr(acc), P, _ptr(wsc), _ptr(bias),
                _ptr(lnw), _ptr(lnb), _ptr(residual), _ptr(out),
                _KINDS[out.dtype],
                _ptr(_scalars(dev, a_interval, a_neg_interval)),
                float(ln[2]), M, N, win, img, _stream())
    q8_postnorm.launches += 1
    return out


KERNELS = (q8_linear, fused_attention_qkv, fused_attention,
           fused_window_attention_qkv, q8_win_qkv, q8_win_proj, q8_epilogue,
           q8_postnorm)
# the wrappers whose kernel has a relaxed variant (counted apart, as
# "<name>_relaxed")
RELAXED = (q8_linear, fused_attention_qkv, fused_attention,
           fused_window_attention_qkv, q8_win_qkv)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
    for fn in RELAXED:
        fn.relaxed_launches = 0
    q8_win_qkv.norm_launches = 0
    _attn_launch.team_launches = 0


def launch_counts() -> dict:
    """Launches by wrapper since the last reset; a relaxed variant as
    "<name>_relaxed", Swin V2's normalizing B10 as "q8_win_qkv_norm"; the
    attention launches (B7 / B8 / B9, either variant) in the team mode
    again as "attention_team"."""
    return {**{fn.__name__: fn.launches for fn in KERNELS},
            **{f"{fn.__name__}_relaxed": fn.relaxed_launches
               for fn in RELAXED},
            "q8_win_qkv_norm": q8_win_qkv.norm_launches,
            "attention_team": _attn_launch.team_launches}


reset_launch_counts()


# ---------------------------------------------------------------------------
# dispatch helpers
# ---------------------------------------------------------------------------

def head_scalar(interval, heads: int) -> Optional[torch.Tensor]:
    """Per-head scale vector from a (1, n_G, 1, 1, 1, 1, 1) interval (or a
    scalar, e.g. the SoS A_interval); None when it is not per head."""
    iv = interval.float()
    if iv.ndim == 0:
        return iv.expand(heads)
    if iv.numel() != heads:
        return None
    return iv.reshape(heads)


def attn_scope(qp1, qp2, heads: int):
    """(ph (4, H), sos) of an attention in scope, else None."""
    if qp1.split is not None:
        return None
    for qp in (qp1, qp2):
        for iv in (qp.A_interval, qp.B_interval):
            if iv.ndim == 7 and (iv.shape[3] != 1 or iv.shape[5] != 1):
                return None        # operand block grids: generic path
    if max(qp1.A_bit, qp1.B_bit, qp2.A_bit, qp2.B_bit) > 8:
        return None
    scales = [head_scalar(iv, heads) for iv in (
        qp1.A_interval, qp1.B_interval, qp2.A_interval, qp2.B_interval)]
    if any(s is None for s in scales):
        return None
    return torch.stack(scales), qp2.split is not None


def window_attn_scope(qp1, qp2, heads: int, prescale):
    """``attn_scope`` of a Swin window attention, whose matmul1 quantizes
    the pre-scaled q·s: (ph with a1 divided by s = ``prescale``, exactly,
    sos), else None."""
    scoped = attn_scope(qp1, qp2, heads)
    if scoped is None:
        return None
    ph, sos = scoped
    return torch.cat([fq.exact_div(ph[:1], _f32(prescale, ph.device)),
                      ph[1:]]), sos


def attn_qmaxes(qp1, qp2, out_qmax: int):
    return (qp1.A_qmax, qp1.B_qmax, qp2.A_qmax, qp2.B_qmax, out_qmax)


def linear_scope(qp) -> bool:
    return (qp.w_interval.shape[2] == 1 and qp.a_interval.shape[0] == 1
            and qp.a_bit <= 8 and qp.w_bit <= 8)


class Q8Weights(NamedTuple):
    """A linear's weight as the fused kernels take it: the (K, N) levels,
    the (N,) scale, and the (N, Kp) K-major levels the card reads (None
    where a packed dict lacks them: the kernel wrapper then makes them)."""
    w_intT: torch.Tensor
    w_scale: torch.Tensor
    w_kmaj: Optional[torch.Tensor]


def packed_or_compute(w, qp, pk) -> Q8Weights:
    """The packed dict's levels, scale and K-major levels, else all three
    from the weight, its levels quantized once."""
    w_intT, w_scale = pk.get("w_intT"), pk.get("w_scale")
    if w_intT is None or w_scale is None:
        lv = linear_w_levels(w, qp)
        return Q8Weights(lv.t().contiguous(),
                         linear_w_scale(qp, w.shape[0]).contiguous(),
                         kmajor_levels(lv))
    return Q8Weights(w_intT, w_scale, pk.get("w_kmaj"))


def row_parallel(x, pw: Q8Weights, b, qp, reduce, *, in_q: str = None,
                 residual=None, out_dtype=None, window=None):
    """A row-parallel linear's shard under tensor parallelism: this rank's
    int32 partial sums (B6, or B11 with ``window`` = (ws, res): x is then
    its window-layout context), their sum over the model axis
    (``reduce``, exact in int32), then the epilogue (``q8_epilogue``),
    which adds the bias and the residual once -- the single device's
    outputs bitwise."""
    a, an = qp.a_interval[0, 0], qp.a_neg_interval
    twin = in_q == "q8twin" or (in_q is None and qp.postgelu)
    if window is None:
        acc = q8_linear(x, pw.w_intT, pw.w_scale, None, a, an,
                        a_qmax=qp.a_qmax, postgelu=qp.postgelu, in_q=in_q,
                        out_q="acc", w_kmaj=pw.w_kmaj)
    else:
        acc = q8_win_proj(x, pw.w_intT, pw.w_scale, None, a, *window, None,
                          a_qmax=qp.a_qmax, w_kmaj=pw.w_kmaj, out_q="acc")
    return q8_epilogue(reduce(acc), pw.w_scale, b, a, an if twin else None,
                       residual=residual, out_dtype=out_dtype,
                       window=window)


def fused_linear(x, w, b, qp, pk, epilogue: str = None, reduce=None,
                 relaxed: bool = False):
    """A LinearQP through B6 when in scope; None sends the caller to the
    exact int8 path.  ``reduce``: a row-parallel shard (``row_parallel``),
    with no epilogue of its own (the same in the relaxed mode)."""
    if not linear_scope(qp):
        return None
    pw = packed_or_compute(w, qp, pk)
    if reduce is not None:
        return row_parallel(x, pw, b, qp, reduce, out_dtype=x.dtype)
    return q8_linear(x, pw.w_intT, pw.w_scale, b, qp.a_interval[0, 0],
                     qp.a_neg_interval, a_qmax=qp.a_qmax,
                     postgelu=qp.postgelu, epilogue=epilogue,
                     w_kmaj=pw.w_kmaj, relaxed=relaxed)


# ---------------------------------------------------------------------------
# whole-block fusion: intermediate activations cross memory as int8, once
# ---------------------------------------------------------------------------

BLOCK_OPS = ("qkv", "matmul1", "matmul2", "proj", "fc1", "fc2")


def _block_scope(qps, heads: int):
    """The block's (qkv, matmul1, matmul2, proj, fc1, fc2) QPs when the
    whole-block path takes them, else None: the four linears in scope,
    fc2 post-GELU and the others not, the attention in scope, and one
    qmax for the packed q / k / v columns."""
    qs = tuple(qps.get(k) for k in BLOCK_OPS)
    if any(qp is None for qp in qs):
        return None
    qp_qkv, qp1, qp2, qp_proj, qp_fc1, qp_fc2 = qs
    if not all(linear_scope(qp) for qp in (qp_qkv, qp_proj, qp_fc1, qp_fc2)):
        return None
    if qp_qkv.postgelu or qp_proj.postgelu or qp_fc1.postgelu \
            or not qp_fc2.postgelu:
        return None
    if attn_scope(qp1, qp2, heads) is None:
        return None
    if not (qp1.A_qmax == qp1.B_qmax == qp2.B_qmax):
        return None
    return qs


def _block_weights(blk, qs, pks):
    """Q8Weights of the block's qkv, proj, fc1 and fc2."""
    attn, mlp = blk["attn"], blk["mlp"]
    return [packed_or_compute(p["weight"], qp, pks.get(k) or {})
            for p, qp, k in ((attn["qkv"], qs[0], "qkv"),
                             (attn["proj"], qs[3], "proj"),
                             (mlp["fc1"], qs[4], "fc1"),
                             (mlp["fc2"], qs[5], "fc2"))]


def _head_dim(w_qkv: Q8Weights, heads: int) -> int:
    """The head dim, from the qkv weight's q, k and v columns of ``heads``
    heads (under tensor parallelism the local heads' columns, while the
    residual stream stays whole)."""
    return w_qkv.w_intT.shape[1] // (3 * heads)


def _col_scales(a1, qp1, qp2, heads: int, hd: int):
    """The qkv requantization scales: a1, b1 and b2 per head, each
    repeated hd times."""
    return torch.cat([torch.repeat_interleave(v, hd) for v in (
        a1, head_scalar(qp1.B_interval, heads),
        head_scalar(qp2.B_interval, heads))])


def _fused_mlp(x, blk, qp_fc1, qp_fc2, w_fc1, w_fc2, ln_eps, reduce=None,
               relaxed=False):
    """LN2 -> fc1 / GELU -> twin-packed int8 -> fc2 + residual, two B6
    launches (``reduce``: fc2 row-parallel, ``row_parallel``; ``relaxed``:
    fc1's bf16 epilogue, fc2's float output is the same)."""
    mlp = blk["mlp"]
    z_q = q8_linear(x, w_fc1.w_intT, w_fc1.w_scale, mlp["fc1"]["bias"],
                    qp_fc1.a_interval[0, 0], None, a_qmax=qp_fc1.a_qmax,
                    postgelu=False,
                    ln=(blk["norm2"]["weight"], blk["norm2"]["bias"],
                        ln_eps),
                    epilogue="gelu", out_q="twin",
                    out_scale=(qp_fc2.a_interval[0, 0],
                               qp_fc2.a_neg_interval),
                    out_qmax=qp_fc2.a_qmax, w_kmaj=w_fc1.w_kmaj,
                    relaxed=relaxed)
    if reduce is not None:
        return row_parallel(z_q, w_fc2, mlp["fc2"]["bias"], qp_fc2, reduce,
                            in_q="q8twin", residual=x)
    return q8_linear(z_q, w_fc2.w_intT, w_fc2.w_scale, mlp["fc2"]["bias"],
                     qp_fc2.a_interval[0, 0], qp_fc2.a_neg_interval,
                     a_qmax=qp_fc2.a_qmax, postgelu=True, in_q="q8twin",
                     float_dtype=x.dtype, residual=x, w_kmaj=w_fc2.w_kmaj)


def fused_vit_block(x, blk, qps, pks, heads: int, scale, ln_eps,
                    reduce=None, relaxed: bool = False):
    """One pre-norm ViT block (LN -> qkv -> attention -> proj -> residual
    -> LN -> fc1 / GELU -> fc2 -> residual) in five launches: LN1 / LN2 in
    the qkv / fc1 prologues; qkv emitted int8 at the attention's a1 / b1 /
    b2 head scales; the context emitted int8 at the proj input scale; fc1
    GELU'd and twin-packed int8 for fc2; both residual adds in the
    epilogues.

    x: (B, N, d); blk: the block's params; qps / pks: {op suffix: QP /
    packed entry}.  ``reduce`` (tensor parallelism: blk, qps and pks are
    this rank's shards, ``heads`` its heads): proj and fc2 are
    row-parallel, their int32 partial sums reduced before the epilogue
    (``row_parallel``).  ``relaxed``: qkv's requant, the attention and
    fc1's GELU and twin pack in bf16 (proj and fc2 are the same).  Returns
    the new residual stream, or None when a piece is out of scope (the
    caller runs the generic per-op path)."""
    qs = _block_scope(qps, heads)
    if qs is None:
        return None
    qp_qkv, qp1, qp2, qp_proj, qp_fc1, qp_fc2 = qs
    w_qkv, w_proj, w_fc1, w_fc2 = _block_weights(blk, qs, pks)
    hd = _head_dim(w_qkv, heads)
    attn = blk["attn"]
    qkv_q = q8_linear(x, w_qkv.w_intT, w_qkv.w_scale, attn["qkv"]["bias"],
                      qp_qkv.a_interval[0, 0], None, a_qmax=qp_qkv.a_qmax,
                      postgelu=False,
                      ln=(blk["norm1"]["weight"], blk["norm1"]["bias"],
                          ln_eps),
                      out_q="vec",
                      out_scale=_col_scales(head_scalar(qp1.A_interval,
                                                        heads),
                                            qp1, qp2, heads, hd),
                      out_qmax=qp1.A_qmax, w_kmaj=w_qkv.w_kmaj,
                      relaxed=relaxed)
    y_q = fused_attention_qkv(qkv_q, heads, qp1, qp2, scale, in_q8=True,
                              out_scale=qp_proj.a_interval[0, 0],
                              out_qmax=qp_proj.a_qmax, relaxed=relaxed)
    if reduce is not None:
        x = row_parallel(y_q, w_proj, attn["proj"]["bias"], qp_proj, reduce,
                         in_q="q8", residual=x)
    else:
        x = q8_linear(y_q, w_proj.w_intT, w_proj.w_scale,
                      attn["proj"]["bias"], qp_proj.a_interval[0, 0], None,
                      a_qmax=qp_proj.a_qmax, postgelu=False, in_q="q8",
                      float_dtype=x.dtype, residual=x, w_kmaj=w_proj.w_kmaj)
    return _fused_mlp(x, blk, qp_fc1, qp_fc2, w_fc1, w_fc2, ln_eps, reduce,
                      relaxed)


def fused_swin_block(x, blk, qps, pks, heads: int, ws: int, shift: int,
                     res: int, bias, mask, ln_eps, reduce=None,
                     relaxed: bool = False, term=None):
    """One Swin block with int8 handoffs, the window analogue of
    :func:`fused_vit_block`, in five launches and two rolls:

      * a shifted block rolls the (B, res, res, C) stream by -shift first
        (``torch.roll``, as JAX); the block then runs in rolled
        coordinates and rolls its attention output back, since the
        residual add commutes with the permutation;
      * B10: LN1, quantize, qkv, requantized per column at (a1/s, b1, b2)
        -- the reference quantizes the pre-scaled q·s, so a1 is divided
        by s = hd^-0.5 (exactly) -- read window by window from the image
        layout;
      * B9: window attention with the rel-pos bias and shifted mask,
        context emitted int8 at the proj scale;
      * B11: proj written back to the image layout, plus the (rolled)
        residual;
      * LN2 -> fc1 / GELU -> twin-packed int8 -> fc2 + residual (B6).

    x: (B, res·res, C); bias: (H, N, N); mask: (nW, N, N) or None;
    ``term``: B9's ``window_term`` of them made beforehand, in their place.
    ``reduce``: tensor parallelism, as in :func:`fused_vit_block` (B11's
    partial sums reduced in the window layout, then the row map, bias and
    rolled residual in ``q8_epilogue``).  ``relaxed``: B10's requant, B9
    and fc1's epilogue in bf16 (B11 and fc2 are the same).
    Returns the new residual stream, or None when a piece is out of scope.

    JAX's other branch (int8_serve.py:1115, partition / generic linears /
    reverse) is not ported: JAX takes it when the TPU rules (C % 128, VMEM
    budgets) refuse the band kernels, and the port has no such rules; the
    only geometric condition, res % ws == 0, is what window_partition
    needs on every path of the forward."""
    qs = _block_scope(qps, heads)
    if qs is None:
        return None
    qp_qkv, qp1, qp2, qp_proj, qp_fc1, qp_fc2 = qs
    B, T, C = x.shape
    w_qkv, w_proj, w_fc1, w_fc2 = _block_weights(blk, qs, pks)
    hd = _head_dim(w_qkv, heads)
    s = hd ** -0.5
    a1 = window_attn_scope(qp1, qp2, heads, s)[0][0]      # a1 / s
    attn = blk["attn"]
    x4 = x.reshape(B, res, res, C)
    if shift:
        x4 = torch.roll(x4, (-shift, -shift), dims=(1, 2))
    qkv_q = q8_win_qkv(x4, w_qkv.w_intT, w_qkv.w_scale, attn["qkv"]["bias"],
                       qp_qkv.a_interval[0, 0],
                       (blk["norm1"]["weight"], blk["norm1"]["bias"], ln_eps),
                       ws, _col_scales(a1, qp1, qp2, heads, hd),
                       a_qmax=qp_qkv.a_qmax, out_qmax=qp1.A_qmax,
                       w_kmaj=w_qkv.w_kmaj, relaxed=relaxed)
    y_q = fused_window_attention_qkv(
        qkv_q, heads, (res // ws) ** 2 if shift else 1, qp1, qp2, s, bias,
        mask, in_q8=True, out_scale=qp_proj.a_interval[0, 0],
        out_qmax=qp_proj.a_qmax, relaxed=relaxed, term=term)
    if reduce is not None:
        y4 = row_parallel(y_q, w_proj, attn["proj"]["bias"], qp_proj, reduce,
                          in_q="q8", residual=x4, window=(ws, res))
    else:
        y4 = q8_win_proj(y_q, w_proj.w_intT, w_proj.w_scale,
                         attn["proj"]["bias"], qp_proj.a_interval[0, 0], ws,
                         res, x4, a_qmax=qp_proj.a_qmax, w_kmaj=w_proj.w_kmaj)
    if shift:
        y4 = torch.roll(y4, (shift, shift), dims=(1, 2))
    return _fused_mlp(y4.reshape(B, T, C), blk, qp_fc1, qp_fc2, w_fc1, w_fc2,
                      ln_eps, reduce, relaxed)


def fused_swinv2_block(x, blk, qps, pks, heads: int, ws: int, shift: int,
                       res: int, bias, tau, mask, ln_eps, term=None):
    """One Swin V2 block with int8 handoffs, in seven launches and two
    rolls (a shifted block rolls and rolls back as in
    :func:`fused_swin_block`):

      * B10 with no LayerNorm: the raw (rolled) stream quantized, the qkv
        product rescaled with its bias ([q_bias, 0, v_bias]), q and k
        L2-normalized per head in the epilogue, requantized per column at
        (a1, b1, b2) in the window layout -- matmul1 quantizes q̂ and k̂,
        unscaled;
      * B9: window attention with the per-head τ folded into the q scale
        and the position bias and shifted mask (``term``, or ``bias`` (H,
        N, N) and ``mask`` (nW, N, N) or None), context int8 at the proj
        scale;
      * B11's int32 sums, then ``q8_postnorm``: residual + LN1(proj), in
        the image layout;
      * fc1 on the raw stream (no LayerNorm) with GELU, twin-packed int8;
        fc2's int32 sums; ``q8_postnorm``: residual + LN2(fc2).

    x: (B, res·res, C).  Returns the new residual stream, or None when a
    piece is out of scope, or the head width does not divide 32 (the
    caller runs the generic per-op path)."""
    qs = _block_scope(qps, heads)
    if qs is None:
        return None
    qp_qkv, qp1, qp2, qp_proj, qp_fc1, qp_fc2 = qs
    B, T, C = x.shape
    w_qkv, w_proj, w_fc1, w_fc2 = _block_weights(blk, qs, pks)
    hd = _head_dim(w_qkv, heads)
    if 32 % hd:
        return None
    attn, mlp = blk["attn"], blk["mlp"]
    x4 = x.reshape(B, res, res, C)
    if shift:
        x4 = torch.roll(x4, (-shift, -shift), dims=(1, 2))
    a_qkv = qp_qkv.a_interval[0, 0]
    qkv_q = q8_win_qkv(x4, w_qkv.w_intT, w_qkv.w_scale, attn["qkv"]["bias"],
                       a_qkv, None, ws,
                       _col_scales(head_scalar(qp1.A_interval, heads), qp1,
                                   qp2, heads, hd),
                       a_qmax=qp_qkv.a_qmax, out_qmax=qp1.A_qmax,
                       w_kmaj=w_qkv.w_kmaj, norm_heads=heads)
    y_q = fused_window_attention_qkv(
        qkv_q, heads, (res // ws) ** 2 if shift else 1, qp1, qp2, 1.0, bias,
        mask, in_q8=True, out_scale=qp_proj.a_interval[0, 0],
        out_qmax=qp_proj.a_qmax, term=term, tau=tau)
    acc = q8_win_proj(y_q, w_proj.w_intT, w_proj.w_scale, None,
                      qp_proj.a_interval[0, 0], ws, res, None,
                      a_qmax=qp_proj.a_qmax, w_kmaj=w_proj.w_kmaj,
                      out_q="acc")
    y4 = q8_postnorm(acc, w_proj.w_scale, attn["proj"]["bias"],
                     qp_proj.a_interval[0, 0], None,
                     (blk["norm1"]["weight"], blk["norm1"]["bias"], ln_eps),
                     x4, window=(ws, res))
    if shift:
        y4 = torch.roll(y4, (shift, shift), dims=(1, 2))
    x = y4.reshape(B, T, C)
    z_q = q8_linear(x, w_fc1.w_intT, w_fc1.w_scale, mlp["fc1"]["bias"],
                    qp_fc1.a_interval[0, 0], None, a_qmax=qp_fc1.a_qmax,
                    postgelu=False, epilogue="gelu", out_q="twin",
                    out_scale=(qp_fc2.a_interval[0, 0],
                               qp_fc2.a_neg_interval),
                    out_qmax=qp_fc2.a_qmax, w_kmaj=w_fc1.w_kmaj)
    acc = q8_linear(z_q, w_fc2.w_intT, w_fc2.w_scale, None,
                    qp_fc2.a_interval[0, 0], qp_fc2.a_neg_interval,
                    a_qmax=qp_fc2.a_qmax, postgelu=True, in_q="q8twin",
                    out_q="acc", w_kmaj=w_fc2.w_kmaj)
    return q8_postnorm(acc, w_fc2.w_scale, mlp["fc2"]["bias"],
                       qp_fc2.a_interval[0, 0], qp_fc2.a_neg_interval,
                       (blk["norm2"]["weight"], blk["norm2"]["bias"], ln_eps),
                       x)
