"""Integer export, bit-compatible with the reference's utils/integer.py.

The counterpart of ``ptq4vit_tpu/utils/integer.py`` (numpy only there; a
copy here, with tensors read to numpy first):

  * weights: int8 ``round(w/Δ).clamp(-qmax, qmax-1)`` per block;
  * post-GELU twin inputs: ``uint8 = (pos_levels + 128) + |neg_levels|``
    (the MSB acts as the sign bit);
  * SoS post-Softmax inputs: ``uint8 = (high_levels + 128) + low_levels``
    (the MSB selects the large interval);
  * plain int8 for everything else.

Activations come from one capture pass of the port (calib/capture.py).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..quant import fakequant as fq
from ..quant.qparams import ConvQP, LinearQP, MatMulQP


def _np(v) -> np.ndarray:
    if torch.is_tensor(v):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def quantize_int_weight(w, qp) -> np.ndarray:
    """int8 weight levels of a calibrated linear / conv op (w_bit 8)."""
    if qp.w_bit != 8:
        raise AssertionError(
            f"weight is quantized with {qp.w_bit} bits; int8 export needs 8")
    qmax = qp.w_qmax
    w = _np(w).astype(np.float32)
    interval = _np(qp.w_interval)
    if isinstance(qp, LinearQP):
        n_V, _, n_H, _ = interval.shape
        oc, ic = w.shape
        w4 = w.reshape(n_V, oc // n_V, n_H, ic // n_H)
        lv = np.clip(np.round(w4 / interval), -qmax, qmax - 1)
        return lv.reshape(oc, ic).astype(np.int8)
    # conv: interval (oc,1,1,1) or scalar broadcasts over OIHW
    lv = np.clip(np.round(w / interval), -qmax, qmax - 1)
    return lv.astype(np.int8)


def dequantize_int_weight(w_int, qp) -> np.ndarray:
    """Inverse of :func:`quantize_int_weight`."""
    w_int = _np(w_int).astype(np.float32)
    interval = _np(qp.w_interval)
    if isinstance(qp, LinearQP):
        n_V, _, n_H, _ = interval.shape
        oc, ic = w_int.shape
        w4 = w_int.reshape(n_V, oc // n_V, n_H, ic // n_H)
        return (w4 * interval).reshape(oc, ic)
    return w_int * interval


def quantize_matmul_operand_int(x: np.ndarray, interval,
                                qmax: int) -> np.ndarray:
    """Blocked int levels of a matmul operand, padding-aware."""
    interval = _np(interval)
    _, n_G, _, n_V, _, n_H, _ = interval.shape
    B, G, R, C = x.shape
    crb_g, crb_r, crb_c, pg, pr, pc = fq.matmul_block_shape(
        x.shape, n_G, n_V, n_H)
    xp = np.pad(x, ((0, 0), (0, pg), (0, pr), (0, pc)))
    xb = xp.reshape(B, n_G, crb_g, n_V, crb_r, n_H, crb_c)
    lv = np.clip(np.round(xb / interval), -qmax, qmax - 1)
    lv = lv.reshape(B, n_G * crb_g, n_V * crb_r, n_H * crb_c)
    return lv[:, :G, :R, :C]


def quantize_int_activation(op_inputs: Dict[str, Any], qp,
                            mtype: str) -> Dict[str, np.ndarray]:
    """uint8 / int8 payload of one op's input activations."""
    if isinstance(qp, LinearQP):
        if qp.a_bit != 8:
            raise AssertionError(
                f"activation quantized with {qp.a_bit} bits; export needs 8")
        x = _np(op_inputs["x"]).astype(np.float32)
        qmax = qp.a_qmax
        a_interval = _np(qp.a_interval)
        n_a = a_interval.shape[0]
        xg = x.reshape(*x.shape[:-1], n_a, x.shape[-1] // n_a)
        if qp.postgelu:
            pos = np.clip(np.round(xg / a_interval),
                          0, qmax - 1).astype(np.uint8) + 128
            neg = np.abs(np.clip(np.round(
                xg / float(qp.a_neg_interval)), -qmax + 1, 0)).astype(np.uint8)
            return {"x": (pos + neg).reshape(x.shape)}
        lv = np.clip(np.round(xg / a_interval), -qmax, qmax - 1)
        return {"x": lv.reshape(x.shape).astype(np.int8)}

    if isinstance(qp, MatMulQP):
        if qp.A_bit != 8 or qp.B_bit != 8:
            raise AssertionError("matmul export needs 8-bit A and B")
        A = _np(op_inputs["a"]).astype(np.float32)
        B = _np(op_inputs["b"]).astype(np.float32)
        lead = A.shape[:-3]
        A4 = A.reshape((-1,) + A.shape[-3:])
        B4 = B.reshape((-1,) + B.shape[-3:])
        qmax = qp.A_qmax
        if qp.split is not None:
            split = float(qp.split)
            hi = np.clip(np.round(np.clip(A4, split, 1) * (qmax - 1)),
                         0, qmax - 1).astype(np.uint8) + 128
            lo = np.clip(np.round(np.clip(A4, 0, split)
                                  / float(qp.A_interval)),
                         0, qmax - 1).astype(np.uint8)
            A_int = (hi + lo).reshape(lead + A.shape[-3:])
        else:
            A_int = quantize_matmul_operand_int(
                A4, qp.A_interval, qmax).astype(np.int8) \
                .reshape(lead + A.shape[-3:])
        B_int = quantize_matmul_operand_int(
            B4, qp.B_interval, qp.B_qmax).astype(np.int8) \
            .reshape(lead + B.shape[-3:])
        return {"a": A_int, "b": B_int}

    if isinstance(qp, ConvQP):
        x = _np(op_inputs["x"]).astype(np.float32)
        if qp.a_bit >= 32 or qp.a_interval is None:
            raise AssertionError(
                "conv activation quantization is off (a_bit=32): no int "
                "activation to export")
        qmax = qp.a_qmax
        lv = np.clip(np.round(x / float(qp.a_interval)), -qmax, qmax - 1)
        return {"x": lv.astype(np.int8)}
    raise NotImplementedError(mtype)


def get_model_int_weight(net, qstate: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """int8 weights of every weighted op with w_bit == 8 (ops that fail the
    8-bit check are skipped, as the reference skips them)."""
    from ..calib.calibrator import params_for_op
    out = {}
    for name, mtype in net.op_inventory:
        if "qmatmul" in mtype:
            continue  # no weights
        qp = qstate.get(name)
        if qp is None:
            continue
        w, _ = params_for_op(net.params, name)
        try:
            out[name] = quantize_int_weight(w, qp)
        except AssertionError:
            pass
    return out


def get_model_int_activations(net, qstate: Dict[str, Any], x,
                              batch_size: int = 8) -> Dict[str, Dict]:
    """One capture pass of the port -> per-op int activation payloads."""
    from ..calib.capture import capture
    raw = capture(net, np.asarray(x, np.float32), batch_size=batch_size,
                  need_grad=False)
    out = {}
    for name, mtype in net.op_inventory:
        qp = qstate.get(name)
        if qp is None:
            continue
        try:
            out[name] = quantize_int_activation(raw[name].inputs, qp, mtype)
        except AssertionError:
            continue
    return out
