"""Core fake-quantization primitives on torch tensors.

The counterpart of ``ptq4vit_tpu/quant/fakequant.py``; every formula is the
same, element by element, so the tests hold the two bitwise equal.

Numerics kept exactly:
  * ``torch.round`` rounds half to even, like ``jnp.round``;
  * symmetric int range ``[-qmax, qmax-1]`` with ``qmax = 2**(bit-1)``;
  * :func:`exact_div` divides by a float32 tensor that lives on the
    dividend's device: on CUDA a division by a Python scalar (or a CPU
    scalar tensor) is lowered to a multiply by its reciprocal, which is one
    ulp off for divisors like ``qmax - 0.5`` and flips ``round()`` at
    quantization boundaries;
  * the candidate grid is computed in float64, then cast to float32.
"""
from __future__ import annotations

import numpy as np
import torch

# |min GELU(x)| quantization anchor for the fixed negative interval of the
# twin-uniform post-GELU quantizer (reference linear.py:320, linear.py:574).
GELU_NEG_CLIP = 0.16997124254703522


def exact_div(x: torch.Tensor, c) -> torch.Tensor:
    """IEEE true division of ``x`` by ``float32(c)``."""
    if not torch.is_tensor(c):
        c = torch.tensor(c, dtype=torch.float32, device=x.device)
    return x / c


def qmax_for_bit(bit: int) -> int:
    """Symmetric quantization max level: 2**(bit-1)."""
    return 2 ** (bit - 1)


def candidate_grid(eq_alpha: float, eq_beta: float, eq_n: int,
                   device=None) -> torch.Tensor:
    """Scale-multiplier grid ``alpha + i*(beta-alpha)/n`` for ``i in [0, n]``
    (``eq_n + 1`` float32 entries; the searches score only the first eq_n,
    the reference's off-by-one, linear.py:466)."""
    i = np.arange(eq_n + 1, dtype=np.float64)
    return torch.from_numpy((eq_alpha + i * (eq_beta - eq_alpha) / eq_n)
                            .astype(np.float32)).to(device)


def sos_split_grid(n: int = 20, device=None) -> torch.Tensor:
    """Split-point candidates ``2**-i, i in [0, n)`` (reference
    matmul.py:369, matmul.py:636)."""
    return torch.pow(2.0, -torch.arange(n, dtype=torch.float32,
                                        device=device))


# ---------------------------------------------------------------------------
# elementwise fake-quant
# ---------------------------------------------------------------------------

def int_quant(x, interval, qmax: int):
    """round(x/Δ) clipped to [-qmax, qmax-1], in the input dtype."""
    return torch.clamp(torch.round(x / interval), -qmax, qmax - 1)


def fake_quant(x, interval, qmax: int):
    """Symmetric fake-quant round(x/Δ)·Δ (reference linear.py:47)."""
    return int_quant(x, interval, qmax) * interval


def minmax_interval(x, qmax: int):
    """Layerwise min-max scale init absmax/(qmax-0.5) (linear.py:88)."""
    return exact_div(torch.amax(torch.abs(x)), qmax - 0.5)


# ---------------------------------------------------------------------------
# blockwise fake-quant: linear weights / grouped activations
# ---------------------------------------------------------------------------

def blocked_weight_view(w, n_V: int, n_H: int):
    """(oc, ic) -> (n_V, oc//n_V, n_H, ic//n_H) block view."""
    oc, ic = w.shape
    return w.reshape(n_V, oc // n_V, n_H, ic // n_H)


def fake_quant_weight_blocked(w, interval, qmax: int):
    """Blockwise fake-quant of an (oc, ic) weight, interval (n_V,1,n_H,1)."""
    n_V, _, n_H, _ = interval.shape
    w4 = blocked_weight_view(w, n_V, n_H)
    return (int_quant(w4, interval, qmax) * interval).reshape(w.shape)


def blocked_weight_interval_init(w, n_V: int, n_H: int, qmax: int):
    """Blockwise absmax/(qmax-0.5) init, shape (n_V,1,n_H,1)."""
    w4 = blocked_weight_view(w, n_V, n_H)
    return exact_div(torch.amax(torch.abs(w4), dim=(1, 3), keepdim=True),
                     qmax - 0.5)


def grouped_act_view(x, n_a: int):
    """(..., ic) -> (..., n_a, ic//n_a) group view."""
    return x.reshape(*x.shape[:-1], n_a, x.shape[-1] // n_a)


def fake_quant_act_grouped(x, interval, qmax: int):
    """Grouped fake-quant of activations, interval shape (n_a, 1)."""
    n_a = interval.shape[0]
    xg = grouped_act_view(x, n_a)
    return (int_quant(xg, interval, qmax) * interval).reshape(x.shape)


def grouped_act_interval_init(x, n_a: int, qmax: int, signed: bool = True,
                              reduce=None):
    """Per-group amax init over every axis but the group axis, shape
    (n_a, 1).  ``signed=False`` is the post-GELU positive init (amax
    WITHOUT abs, reference linear.py:597).  ``reduce`` (a max over the
    ranks holding the other samples) takes the amax before the division."""
    xg = grouped_act_view(x, n_a)
    v = torch.abs(xg) if signed else xg
    dims = tuple(range(xg.ndim - 2)) + (xg.ndim - 1,)
    m = torch.amax(v, dim=dims)
    return exact_div(m if reduce is None else reduce(m), qmax - 0.5)[:, None]


# ---------------------------------------------------------------------------
# twin-uniform post-GELU quantizer
# ---------------------------------------------------------------------------

def twin_quant_post_gelu(x, pos_interval, neg_interval, qmax: int):
    """Searched positive interval (n_a, 1) plus the fixed negative interval
    ``GELU_NEG_CLIP/qmax`` (reference linear.py:601-607)."""
    n_a = pos_interval.shape[0]
    xg = grouped_act_view(x, n_a)
    x_pos = torch.clamp(torch.round(xg / pos_interval), 0, qmax - 1) \
        * pos_interval
    x_neg = torch.clamp(torch.round(exact_div(xg, neg_interval)), -qmax, 0) \
        * neg_interval
    return (x_pos + x_neg).reshape(x.shape)


# ---------------------------------------------------------------------------
# split-of-softmax (SoS) post-Softmax quantizer
# ---------------------------------------------------------------------------

def sos_quant_softmax(x, split, qmax: int):
    """Twin-range quantization of post-Softmax scores with one split point,
    the reference formula verbatim (matmul.py:595-598)."""
    if not torch.is_tensor(split):
        split = torch.tensor(split, dtype=torch.float32, device=x.device)
    one = torch.ones((), dtype=x.dtype, device=x.device)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    a_interval = exact_div(split, qmax - 1)
    x_high = exact_div(torch.clamp(torch.round(
        torch.minimum(torch.maximum(x, split), one) * (qmax - 1)),
        0, qmax - 1), qmax - 1)
    x_low = torch.clamp(torch.round(exact_div(
        torch.minimum(torch.maximum(x, zero), split), a_interval)),
        0, qmax - 1) * a_interval
    return x_high + x_low


# ---------------------------------------------------------------------------
# blocked 4-D matmul-operand quantizer (with ceil-div padding)
# ---------------------------------------------------------------------------

def matmul_block_shape(shape, n_G: int, n_V: int, n_H: int):
    """Ceil-div block sizes and pad amounts for a (B, G, R, C) operand
    (reference matmul.py:109-122)."""
    _, G, R, C = shape
    crb_g = -(-G // n_G)
    crb_r = -(-R // n_V)
    crb_c = -(-C // n_H)
    return (crb_g, crb_r, crb_c, crb_g * n_G - G, crb_r * n_V - R,
            crb_c * n_H - C)


def _blocked_operand(x, n_G: int, n_V: int, n_H: int):
    B, G, R, C = x.shape
    crb_g, crb_r, crb_c, pad_g, pad_r, pad_c = matmul_block_shape(
        x.shape, n_G, n_V, n_H)
    xp = torch.nn.functional.pad(x, (0, pad_c, 0, pad_r, 0, pad_g))
    return xp.reshape(B, n_G, crb_g, n_V, crb_r, n_H, crb_c)


def fake_quant_matmul_operand(x, interval, qmax: int):
    """Blocked fake-quant of a (B, G, R, C) operand with interval
    (1, n_G, 1, n_V, 1, n_H, 1): pad -> block view -> quant -> unpad."""
    _, n_G, _, n_V, _, n_H, _ = interval.shape
    B, G, R, C = x.shape
    xb = _blocked_operand(x, n_G, n_V, n_H)
    xq = int_quant(xb, interval, qmax) * interval
    xq = xq.reshape(B, xb.shape[1] * xb.shape[2], xb.shape[3] * xb.shape[4],
                    xb.shape[5] * xb.shape[6])
    return xq[:, :G, :R, :C]


def matmul_operand_interval_init(x, n_G: int, n_V: int, n_H: int, qmax: int,
                                 reduce=None):
    """Blockwise absmax/(qmax-0.5) init, shape (1, n_G, 1, n_V, 1, n_H, 1)
    (reference matmul.py:254); ``reduce`` as in
    ``grouped_act_interval_init``."""
    xb = _blocked_operand(x, n_G, n_V, n_H)
    m = torch.amax(torch.abs(xb), dim=(0, 2, 4, 6), keepdim=True)
    return exact_div(m if reduce is None else reduce(m), qmax - 0.5)
