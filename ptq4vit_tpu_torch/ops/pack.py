"""Serving-time weight packing: calibrated weights baked to int8 levels.

The counterpart of ``ptq4vit_tpu/ops/pack.py``.  ``pack_weights`` computes
once, from the fp32 weights, what the int8 paths would otherwise derive on
every forward:

    packed[name] = {"w_intT": int8 (ic_flat, oc), "w_scale": f32 (oc,)}

for every LinearQP with n_H == 1 and every ConvQP that is not blocked.  The
levels are stored transposed, (in, out), as the JAX package stores them;
those two entries equal its bytes.  A linear's entry also holds
``"w_kmaj"``: the same levels K-major, (out, in) with ``in`` padded by
zero levels to a multiple of ``K_ALIGN``, the operand the fused linear's
tensor-core kernel reads (``ops/int8_serve.q8_linear``).  It is the
port's own: no export (``utils/integer.py``) reads it.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..quant import fakequant as fq
from ..quant.qparams import ConvQP, LinearQP


def _weight(params: Dict[str, Any], name: str):
    node = params
    for part in name.split("."):
        node = node[int(part)] if isinstance(node, list) else node[part]
    return node["weight"]


def conv_w_scale(qp: ConvQP, oc: int) -> torch.Tensor:
    """(oc,) per-out-channel scale of a channelwise or layerwise conv."""
    iv = qp.w_interval.float()
    if iv.ndim:
        iv = iv.reshape(-1, 1, 1, 1)[:, 0, 0, 0]
    return iv.expand(oc).contiguous()


def linear_w_scale(qp: LinearQP, oc: int) -> torch.Tensor:
    """(oc,) per-out-channel scale: row block v's interval."""
    n_V = qp.w_interval.shape[0]
    return qp.w_interval[:, :, 0, 0].float().expand(n_V, oc // n_V) \
        .reshape(oc)


K_ALIGN = 16    # bytes: a TMA row stride is a multiple of 16


def kmajor_levels(levels: torch.Tensor) -> torch.Tensor:
    """(oc, ic) int8 levels as the contiguous (oc, Kp) K-major operand of
    the fused linear: Kp = ic rounded up to K_ALIGN, the padding zero
    levels (their products are 0)."""
    oc, ic = levels.shape
    kp = -(-ic // K_ALIGN) * K_ALIGN
    out = torch.zeros((oc, kp), dtype=torch.int8, device=levels.device)
    out[:, :ic] = levels
    return out


def linear_w_levels(w, qp: LinearQP) -> torch.Tensor:
    """(oc, ic) int8 levels of a linear weight with n_H == 1."""
    n_V = qp.w_interval.shape[0]
    oc, ic = w.shape
    w4 = w.float().reshape(n_V, oc // n_V, ic)
    return fq.int_quant(w4, qp.w_interval[:, :, 0], qp.w_qmax) \
        .to(torch.int8).reshape(oc, ic)


def pack_weights(params: Dict[str, Any],
                 qstate: Dict[str, Any]) -> Dict[str, Any]:
    """int8 weight levels and per-out-channel dequant scales of every
    packable op in ``qstate``, on the weights' device.  Returns the
    ``packed`` dict of ``net.apply(..., int8=..., packed=packed)``."""
    packed: Dict[str, Any] = {}
    for name, qp in qstate.items():
        if isinstance(qp, LinearQP):
            if qp.w_interval.shape[2] != 1:
                continue          # column-block scales don't factor out
            w = _weight(params, name)
            lv = linear_w_levels(w, qp)
            packed[name] = {
                "w_intT": lv.t().contiguous(),
                "w_scale": linear_w_scale(qp, w.shape[0]).contiguous(),
                "w_kmaj": kmajor_levels(lv)}
        elif isinstance(qp, ConvQP) and not qp.blocked:
            w = _weight(params, name)
            oc = w.shape[0]
            w_scale = conv_w_scale(qp, oc)
            w_int = fq.int_quant(w.float().reshape(oc, -1), w_scale[:, None],
                                 qp.w_qmax).to(torch.int8)
            packed[name] = {"w_intT": w_int.t().contiguous(),
                            "w_scale": w_scale}
    return packed
