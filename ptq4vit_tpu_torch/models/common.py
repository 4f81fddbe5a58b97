"""Functional building blocks of the ViT / DeiT forward.

The counterpart of ``ptq4vit_tpu/models/common.py``.  A :class:`QuantCtx`
is threaded through every quantizable op call-site:

  * ``qstate.get(name) is None`` -> raw FP32 op;
  * ``qstate[name]`` is a QP     -> fake-quant op;
  * ``capture=True``             -> record (inputs, out) per op in
                                    ``ctx.taps``;
  * ``eps[name]``                -> a zero tensor added to the op output;
                                    with ``requires_grad`` set,
                                    ``torch.autograd.grad`` of the loss with
                                    respect to it is exactly ∂loss/∂(op
                                    output).

Ops are keyed by their timm module path (``blocks.0.attn.qkv`` ...).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..quant.qparams import apply_linear, apply_matmul


class QuantCtx:
    """Per-forward context carrying quantization state, taps and probes."""

    def __init__(self, qstate: Optional[Dict[str, Any]] = None,
                 eps: Optional[Dict[str, torch.Tensor]] = None,
                 capture: bool = False, int8: bool = False):
        if int8:
            raise NotImplementedError(
                "the int8 and fused execution paths are not ported yet")
        self.qstate = qstate or {}
        self.eps = eps
        self.capture = capture
        self.taps: Dict[str, Dict[str, torch.Tensor]] = {}

    def _post(self, name, out, tap):
        if self.eps is not None and name in self.eps:
            out = out + self.eps[name]
        if self.capture:
            tap["out"] = out
            self.taps[name] = tap
        return out

    def linear(self, name, x, w, b):
        """Quantizable linear; the tap records its input and output."""
        out = apply_linear(x, w, b, self.qstate.get(name))
        return self._post(name, out.to(x.dtype), {"x": x})

    def matmul(self, name, a, b):
        """Quantizable A@B; the tap records both operands."""
        out = apply_matmul(a, b, self.qstate.get(name))
        return self._post(name, out.to(a.dtype), {"a": a, "b": b})

    def conv2d_patch(self, name, x, w, b, patch: int):
        """Non-overlapping patch-embedding conv (stride == kernel) as
        patchify + matmul.  x: (B, C, H, W); w: (oc, ic, p, p).  Returns
        (tokens (B, nh*nw, oc), (nh, nw)); the tap records the patchified
        input (B, N, ic*p*p) and the token output."""
        qp = self.qstate.get(name)
        if qp is not None:
            w = qp.quant_weight(w)
            x = qp.quant_input(x)
        B, C, H, W = x.shape
        oc = w.shape[0]
        nh, nw = H // patch, W // patch
        xp = x.reshape(B, C, nh, patch, nw, patch)
        xp = xp.permute(0, 2, 4, 1, 3, 5).reshape(B, nh * nw,
                                                  C * patch * patch)
        out = torch.matmul(xp, w.reshape(oc, -1).t())
        if b is not None:
            out = out + b
        out = self._post(name, out.to(x.dtype), {"x": xp})
        return out, (nh, nw)


def layer_norm(x, weight, bias, eps: float):
    """LayerNorm with fp32 statistics, the JAX package's formula (the
    variance is the mean of squared deviations, not F.layer_norm's)."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * weight + bias


def gelu(x):
    """Exact (erf) GELU."""
    return F.gelu(x, approximate="none")


def softmax_f32(x, dim: int = -1):
    """Softmax accumulated in fp32, result in x.dtype."""
    return torch.softmax(x.float(), dim=dim).to(x.dtype)
