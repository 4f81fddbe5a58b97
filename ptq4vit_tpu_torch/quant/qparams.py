"""Calibrated quantization parameters as plain dataclasses of tensors.

The counterpart of ``ptq4vit_tpu/quant/qparams.py``: one
:class:`LinearQP` / :class:`MatMulQP` / :class:`ConvQP` per quantized op,
carried in a ``qstate`` dict that the model forward reads.  A missing entry
(or ``None``) means the op runs in raw FP32.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import fakequant as fq


@dataclasses.dataclass
class LinearQP:
    """Quantization parameters of a linear layer (reference
    PTQSLBatchingQuantLinear / PostGeluPTQSLBatchingQuantLinear)."""

    w_interval: torch.Tensor                       # (n_V, 1, n_H, 1)
    a_interval: torch.Tensor                       # (n_a, 1)
    a_neg_interval: Optional[torch.Tensor] = None  # scalar; post-GELU only
    w_bit: int = 8
    a_bit: int = 8
    postgelu: bool = False

    @property
    def w_qmax(self) -> int:
        return fq.qmax_for_bit(self.w_bit)

    @property
    def a_qmax(self) -> int:
        return fq.qmax_for_bit(self.a_bit)

    def quant_weight(self, w):
        return fq.fake_quant_weight_blocked(w, self.w_interval, self.w_qmax)

    def quant_input(self, x):
        if self.a_bit >= 32:
            return x
        if self.postgelu:
            return fq.twin_quant_post_gelu(x, self.a_interval,
                                           self.a_neg_interval, self.a_qmax)
        return fq.fake_quant_act_grouped(x, self.a_interval, self.a_qmax)


def apply_linear(x, w, b, qp: Optional[LinearQP]):
    """y = x @ w.T + b with optional fake-quant of w and x."""
    if qp is not None:
        w = qp.quant_weight(w)
        x = qp.quant_input(x)
    y = torch.matmul(x, w.t())
    if b is not None:
        y = y + b
    return y


@dataclasses.dataclass
class MatMulQP:
    """Quantization parameters of an A@B op (reference
    PTQSLBatchingQuantMatMul / SoSPTQSLBatchingQuantMatMul).  With ``split``
    set, A is quantized with the split-of-softmax twin formula."""

    A_interval: torch.Tensor          # (1, n_G, 1, n_V, 1, n_H, 1) or scalar
    B_interval: torch.Tensor          # (1, n_G, 1, n_V, 1, n_H, 1)
    split: Optional[torch.Tensor] = None
    A_bit: int = 8
    B_bit: int = 8

    @property
    def A_qmax(self) -> int:
        return fq.qmax_for_bit(self.A_bit)

    @property
    def B_qmax(self) -> int:
        return fq.qmax_for_bit(self.B_bit)

    def quant_A(self, a):
        if self.split is not None:
            return fq.sos_quant_softmax(a, self.split, self.A_qmax)
        return fq.fake_quant_matmul_operand(a, self.A_interval, self.A_qmax)

    def quant_B(self, b):
        return fq.fake_quant_matmul_operand(b, self.B_interval, self.B_qmax)


def apply_matmul(a, b, qp: Optional[MatMulQP]):
    """out = A_sim @ B_sim on 4-D (batch, heads, rows, cols) operands."""
    if qp is not None:
        lead = a.shape[:-3]
        a = qp.quant_A(a.reshape((-1,) + a.shape[-3:])) \
            .reshape(lead + a.shape[-3:])
        b = qp.quant_B(b.reshape((-1,) + b.shape[-3:])) \
            .reshape(lead + b.shape[-3:])
    return torch.matmul(a, b)


@dataclasses.dataclass
class ConvQP:
    """Quantization parameters of the patch-embedding conv.  ``w_interval``
    is (oc, 1, 1, 1) channelwise or a scalar layerwise; ``a_interval`` is
    None when a_bit >= 32 (the shipped configs).  ``blocked=True`` is the
    n_V x n_H grid over the flattened (oc, ic*kh*kw) weight."""

    w_interval: torch.Tensor
    a_interval: Optional[torch.Tensor] = None
    w_bit: int = 8
    a_bit: int = 32
    blocked: bool = False

    @property
    def w_qmax(self) -> int:
        return fq.qmax_for_bit(self.w_bit)

    @property
    def a_qmax(self) -> int:
        return fq.qmax_for_bit(self.a_bit)

    def quant_weight(self, w):
        if self.blocked:
            oc = w.shape[0]
            return fq.fake_quant_weight_blocked(
                w.reshape(oc, -1), self.w_interval, self.w_qmax
            ).reshape(w.shape)
        return fq.fake_quant(w, self.w_interval, self.w_qmax)

    def quant_input(self, x):
        if self.a_bit >= 32 or self.a_interval is None:
            return x
        return fq.fake_quant(x, self.a_interval, self.a_qmax)
