"""Fake quantization of the PTQ4ViT paper, written out plainly.

Every quantizer is symmetric with levels ``[-qmax, qmax - 1]``, ``qmax =
2 ** (bits - 1)``, and rounds half to even.  Divisions take the divisor
as a float32 tensor on the dividend's device: on the card a division by a
Python scalar becomes a product with its reciprocal, which moves
``round()`` at level boundaries.

Interval layouts (the qstate the benchmark hands to both sides):

* linear weight ``(n_V, 1, 1, 1)``: one interval per block of output rows;
* linear input ``(1, 1)``; post-GELU inputs add a fixed negative interval;
* matmul operand ``(G,)``: one interval per head;
* post-softmax operand: a split point (the SoS quantizer);
* patch-embedding conv weight ``(oc,)``: one interval per output channel.
"""
from __future__ import annotations

import numpy as np
import torch

GELU_NEG_CLIP = 0.16997124254703522   # |min GELU(x)|


def div(x, c):
    if not torch.is_tensor(c):
        c = torch.tensor(c, dtype=torch.float32, device=x.device)
    return x / c


def levels(x, d, qmax: int):
    return torch.clamp(torch.round(x / d), -qmax, qmax - 1)


def quant(x, d, qmax: int):
    return levels(x, d, qmax) * d


def quant_rows(w, d, qmax: int):
    """(oc, ic) weight, one interval per block of rows: d (n_V,)."""
    n_v = d.shape[0]
    w3 = w.reshape(n_v, -1, w.shape[-1])
    return quant(w3, d.reshape(n_v, 1, 1), qmax).reshape(w.shape)


def quant_twin_gelu(x, d_pos, d_neg, qmax: int):
    """Post-GELU twin quantizer: positive levels on the searched interval,
    negative levels on the fixed one."""
    pos = torch.clamp(torch.round(x / d_pos), 0, qmax - 1) * d_pos
    neg = torch.clamp(torch.round(x / d_neg), -qmax, 0) * d_neg
    return pos + neg


def quant_sos(x, split, qmax: int):
    """Split-of-softmax quantizer: [split, 1] on 1 / (qmax - 1) steps and
    [0, split] on split / (qmax - 1) steps, summed as the paper's code
    sums them."""
    one = torch.ones((), dtype=x.dtype, device=x.device)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    lo_step = div(split, qmax - 1)
    hi = div(torch.clamp(torch.round(
        torch.minimum(torch.maximum(x, split), one) * (qmax - 1)),
        0, qmax - 1), qmax - 1)
    lo = torch.clamp(torch.round(div(
        torch.minimum(torch.maximum(x, zero), split), lo_step)),
        0, qmax - 1) * lo_step
    return hi + lo


def quant_heads(x, d, qmax: int):
    """(S, G, R, C) operand, one interval per head: d (G,)."""
    return quant(x, d.reshape(1, -1, 1, 1), qmax)


def grid(alpha: float, beta: float, n: int, device=None):
    """The first n multipliers alpha + i (beta - alpha) / n, in float64
    then float32."""
    i = np.arange(n, dtype=np.float64)
    return torch.from_numpy((alpha + i * (beta - alpha) / n)
                            .astype(np.float32)).to(device)


def split_grid(n: int = 20, device=None):
    return torch.pow(2.0, -torch.arange(n, dtype=torch.float32,
                                        device=device))


class OpQuant:
    """One op's intervals as plain tensors, and its forward quantizers.

    kind: "linear", "matmul" or "conv"; fields by kind:
      linear: w (n_V,), a (scalar), a_neg (scalar or None)
      matmul: a (G,) or split (scalar), b (G,)
      conv:   w (oc,)
    """

    def __init__(self, kind, bits=(8, 8), **fields):
        self.kind = kind
        self.w_qmax = 2 ** (bits[0] - 1)
        self.a_qmax = 2 ** (bits[1] - 1)
        self.f = fields

    def weight(self, w):
        if self.kind == "conv":
            return quant(w, self.f["w"].reshape(-1, 1), self.w_qmax)
        return quant_rows(w, self.f["w"], self.w_qmax)

    def input(self, x):
        if self.kind == "conv":
            return x
        if self.f.get("a_neg") is not None:
            return quant_twin_gelu(x, self.f["a"], self.f["a_neg"],
                                   self.a_qmax)
        return quant(x, self.f["a"], self.a_qmax)

    def operands(self, a, b):
        if self.f.get("split") is not None:
            qa = quant_sos(a, self.f["split"], self.a_qmax)
        else:
            qa = quant_heads(a, self.f["a"], self.a_qmax)
        return qa, quant_heads(b, self.f["b"], self.a_qmax)
