"""Synthetic inputs and quantization state for tests, benchmarks and
smoke runs (no dataset or calibration needed).

The counterpart of ``ptq4vit_tpu/utils/synthetic.py``: the same image
bytes, and the same qstate fields built from the port's params.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..calib.calibrator import params_for_op
from ..configs.policy import QuantConfig
from ..quant import fakequant as fq
from ..quant.qparams import ConvQP, LinearQP, MatMulQP


def synthetic_images(n: int, img_size: int, seed: int = 0) -> np.ndarray:
    """Normalized-image-like gaussian inputs (NCHW float32)."""
    return np.random.default_rng(seed).standard_normal(
        (n, 3, img_size, img_size)).astype(np.float32)


def synthetic_qstate(net, quant_cfg: QuantConfig) -> Dict[str, Any]:
    """A structurally correct qstate from weight statistics alone, on the
    net's device (activation intervals are placeholders).  It runs the
    quantized forward without a calibration: for smoke runs and kernel
    benchmarks, not for accuracy."""
    dev = net.params["head"]["weight"].device

    def full(shape, v):
        return torch.full(shape, v, dtype=torch.float32, device=dev)

    def scalar(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    qstate: Dict[str, Any] = {}
    for name, mtype in net.op_inventory:
        pol = quant_cfg.op_policy(mtype)
        if "qmatmul" in mtype:
            shape = (1, net.op_shapes[name]["heads"], 1, 1, 1, 1, 1)
            A_qmax = fq.qmax_for_bit(pol.a_bit)
            sos = pol.quantizer == "sos_matmul"
            split = scalar(2.0 ** -10) if sos else None
            qstate[name] = MatMulQP(
                A_interval=(fq.exact_div(split, A_qmax - 1) if sos
                            else full(shape, 0.05)),
                B_interval=full(shape, 0.05), split=split,
                A_bit=pol.a_bit, B_bit=pol.b_bit)
            continue
        w, _ = params_for_op(net.params, name)
        w_qmax = fq.qmax_for_bit(pol.w_bit)
        if mtype == "qconv":
            wi = (fq.exact_div(torch.amax(torch.abs(w), dim=(1, 2, 3),
                                          keepdim=True), w_qmax - 0.5)
                  if pol.quantizer == "conv_channelwise"
                  else fq.minmax_interval(w, w_qmax))
            qstate[name] = ConvQP(w_interval=wi, a_interval=None,
                                  w_bit=pol.w_bit, a_bit=32)
            continue
        postgelu = pol.quantizer == "postgelu_linear"
        a_qmax = fq.qmax_for_bit(pol.a_bit)
        qstate[name] = LinearQP(
            w_interval=fq.blocked_weight_interval_init(w, pol.n_V, pol.n_H,
                                                       w_qmax),
            a_interval=full((pol.n_a, 1), 0.05),
            a_neg_interval=(scalar(fq.GELU_NEG_CLIP / a_qmax)
                            if postgelu else None),
            w_bit=pol.w_bit, a_bit=pol.a_bit, postgelu=postgelu)
    return qstate
