"""Functional building blocks of the ViT / DeiT and Swin forwards.

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
                                    output);
  * ``int8=True``                -> quantized ops as exact int8 products
                                    (ops/int8.py); ``int8="fused"`` adds the
                                    fused serving kernels (ops/int8_serve.py,
                                    still exact); ``int8="fused_relaxed"``
                                    runs their epilogues in bf16 (JAX's
                                    opt-in serving mode: tanh-GELU, the
                                    softmax and the requantizations,
                                    levels within a step of the exact
                                    ones); ``packed`` holds int8 weights
                                    from ops/pack.pack_weights.
  * ``mesh`` with a "model" axis -> tensor parallelism: the params and
                                    the qstate are this rank's shards
                                    (parallel/mesh.shard_params,
                                    shard_qstate), attention runs on the
                                    local heads, and a row-parallel linear
                                    (proj, fc2) sums its partial products
                                    over "model" before its bias: the
                                    exact integer dots (int8=True), or
                                    the fused kernels' int32 sums before
                                    their epilogue (int8="fused",
                                    ops/int8_serve.row_parallel), so
                                    either int8 mode gives the single
                                    device's logits bitwise.

Ops are keyed by their timm module path (``blocks.0.attn.qkv`` ...).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..ops import int8 as i8
from ..ops import int8_serve as serve
from ..quant.qparams import apply_linear, apply_matmul

INT8_MODES = (False, True, "fused", "fused_relaxed")


def cast_params(tree, dtype):
    """The param tree with every tensor cast to ``dtype`` (the serving
    mode's compute dtype, LN weights and biases included)."""
    if torch.is_tensor(tree):
        return tree.to(dtype)
    if isinstance(tree, dict):
        return {k: cast_params(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [cast_params(v, dtype) for v in tree]
    return tree


class QuantCtx:
    """Per-forward context carrying quantization state, taps and probes."""

    def __init__(self, qstate: Optional[Dict[str, Any]] = None,
                 eps: Optional[Dict[str, torch.Tensor]] = None,
                 capture: bool = False, int8=False,
                 packed: Optional[Dict[str, Any]] = None, mesh=None):
        if int8 not in INT8_MODES:
            raise NotImplementedError(
                f"int8={int8!r}: the port runs int8 in {INT8_MODES}")
        self.qstate = qstate or {}
        self.eps = eps
        self.capture = capture
        self.int8 = int8
        self.fused = int8 in ("fused", "fused_relaxed")
        self.relaxed = int8 == "fused_relaxed"
        self.packed = packed or {}
        self.taps: Dict[str, Dict[str, torch.Tensor]] = {}
        self.tp, self._reduce = 1, None
        if mesh is not None:
            # imported here: the parallel package imports the models
            from ..parallel import mesh as pm
            self.tp = pm.axis_size(mesh, "model")
            self._tp_role = pm.tp_role
            self._reduce = lambda t: pm.psum(t, mesh, "model")

    def local_heads(self, heads: int) -> int:
        """The heads of this rank's shard (all of them without tensor
        parallelism)."""
        if heads % self.tp:
            raise ValueError(f"{heads} heads do not divide over "
                             f"model={self.tp}")
        return heads // self.tp

    def _row_reduce(self):
        """The row-parallel linears' sum over "model" under tensor
        parallelism, else None."""
        return self._reduce if self.tp > 1 else None

    def _serving(self) -> bool:
        """The fused hooks apply: fused mode, no taps and no probes."""
        return self.fused and not self.capture and self.eps is None

    def _post(self, name, out, tap):
        if self.eps is not None and name in self.eps:
            out = out + self.eps[name]
        if self.capture:
            tap["out"] = out
            self.taps[name] = tap
        return out

    def linear(self, name, x, w, b):
        """Quantizable linear; the tap records its input and output."""
        qp = self.qstate.get(name)
        if self.tp > 1 and self._tp_role(name) == "row":
            out = None
            if qp is not None and self.fused:
                out = serve.fused_linear(x, w, b, qp,
                                         self.packed.get(name) or {},
                                         reduce=self._reduce)
            if out is None:
                if qp is not None and self.int8:
                    out = i8.linear_int8(x, w, None, qp,
                                         reduce=self._reduce)
                else:
                    out = self._reduce(apply_linear(x, w, None, qp))
                if b is not None:
                    out = out + (b.float() if self.int8 and qp is not None
                                 else b)
        elif qp is not None and self.int8:
            pk = self.packed.get(name) or {}
            out = serve.fused_linear(x, w, b, qp, pk, relaxed=self.relaxed) \
                if self.fused else None
            if out is None:
                out = i8.linear_int8(x, w, b, qp, w_intT=pk.get("w_intT"),
                                     w_scale=pk.get("w_scale"))
        else:
            out = apply_linear(x, w, b, qp)
        return self._post(name, out.to(x.dtype), {"x": x})

    def matmul(self, name, a, b):
        """Quantizable A@B; the tap records both operands."""
        qp = self.qstate.get(name)
        if qp is not None and self.int8:
            out = i8.matmul_int8(a, b, qp)
        else:
            out = apply_matmul(a, b, qp)
        return self._post(name, out.to(a.dtype), {"a": a, "b": b})

    def linear_gelu(self, name, x, w, b):
        """gelu(linear(x)), with the GELU in B6's epilogue on the fused
        path (the same function; capture and probes take the generic path
        so the tap records the pre-GELU output)."""
        qp = self.qstate.get(name)
        if self._serving() and qp is not None:
            out = serve.fused_linear(x, w, b, qp, self.packed.get(name) or {},
                                     epilogue="gelu", relaxed=self.relaxed)
            if out is not None:
                return out.to(x.dtype)
        return gelu(self.linear(name, x, w, b))

    def _block_ops(self, prefix):
        keys = {k: f"{prefix}.{'mlp' if k.startswith('fc') else 'attn'}.{k}"
                for k in serve.BLOCK_OPS}
        return ({k: self.qstate.get(n) for k, n in keys.items()},
                {k: self.packed.get(n) or {} for k, n in keys.items()})

    def vit_block(self, prefix, x, blk, heads, scale, ln_eps):
        """The whole-block fused path (ops/int8_serve.fused_vit_block):
        returns the new residual stream, or None (the caller runs the
        generic per-op path)."""
        if not self._serving():
            return None
        qps, pks = self._block_ops(prefix)
        return serve.fused_vit_block(x, blk, qps, pks, heads, scale, ln_eps,
                                     self._row_reduce(), self.relaxed)

    def attention_qkv(self, name1, name2, qkv, heads, scale):
        """Fused int8 attention (B7) on the (B, N, 3d) qkv output; returns
        the (B, N, d) context, or None for the generic matmul1 / softmax /
        matmul2 sequence."""
        if not self._serving():
            return None
        qp1, qp2 = self.qstate.get(name1), self.qstate.get(name2)
        if qp1 is None or qp2 is None:
            return None
        return serve.fused_attention_qkv(qkv, heads, qp1, qp2, scale,
                                         relaxed=self.relaxed)

    def swin_block(self, prefix, x, blk, heads, ws, shift, res, bias, mask,
                   ln_eps, term=None):
        """The whole-Swin-block fused path (ops/int8_serve.fused_swin_block:
        B10, B9, B11 and two B6): returns the new residual stream, or None
        (the caller runs the generic per-op path).  ``term``: B9's term of
        bias and mask, made once by a serving engine (bias and mask are
        then None)."""
        if not self._serving():
            return None
        qps, pks = self._block_ops(prefix)
        return serve.fused_swin_block(x, blk, qps, pks, heads, ws, shift, res,
                                      bias, mask, ln_eps, self._row_reduce(),
                                      self.relaxed, term=term)

    def swinv2_block(self, prefix, x, blk, heads, ws, shift, res, bias, tau,
                     mask, ln_eps, term=None):
        """The whole-Swin-V2-block fused path
        (ops/int8_serve.fused_swinv2_block): returns the new residual
        stream, or None (the caller runs the generic per-op path)."""
        if not self._serving():
            return None
        qps, pks = self._block_ops(prefix)
        return serve.fused_swinv2_block(x, blk, qps, pks, heads, ws, shift,
                                        res, bias, tau, mask, ln_eps,
                                        term=term)

    def window_attention_qkv(self, name1, name2, qkv, heads, nW, prescale,
                             bias, mask, term=None):
        """Fused Swin window attention (B9) on the float (B·nW, N, 3C) qkv
        output, bias and shifted mask (or their ``term``) in-kernel;
        returns the (B·nW, N, C) context, or None for the generic matmul1
        / softmax / matmul2 sequence."""
        if not self._serving():
            return None
        qp1, qp2 = self.qstate.get(name1), self.qstate.get(name2)
        if qp1 is None or qp2 is None:
            return None
        return serve.fused_window_attention_qkv(qkv, heads, nW, qp1, qp2,
                                                prescale, bias, mask,
                                                relaxed=self.relaxed,
                                                term=term)

    def conv2d_patch(self, name, x, w, b, patch: int):
        """Non-overlapping patch-embedding conv (stride == kernel) as
        patchify + matmul.  x: (B, C, H, W); w: (oc, ic, p, p).  Returns
        (tokens (B, nh*nw, oc), (nh, nw)); the tap records the patchified
        input (B, N, ic*p*p) and the token output."""
        qp = self.qstate.get(name)
        if qp is not None and not self.int8:
            w = qp.quant_weight(w)
            x = qp.quant_input(x)
        B, C, H, W = x.shape
        oc = w.shape[0]
        nh, nw = H // patch, W // patch
        xp = x.reshape(B, C, nh, patch, nw, patch)
        xp = xp.permute(0, 2, 4, 1, 3, 5).reshape(B, nh * nw,
                                                  C * patch * patch)
        if qp is not None and self.int8:
            pk = self.packed.get(name) or {}
            out = i8.conv_int8(xp, w, b, qp, patch, w_intT=pk.get("w_intT"),
                               w_scale=pk.get("w_scale"))
        else:
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
