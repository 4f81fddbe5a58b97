"""One-call API of the port.

    from ptq4vit_tpu_torch import quantize
    net, qstate = quantize("vit_base_patch16_384", calib_images,
                           config="PTQ4ViT", device="cuda")
    logits = net.apply(x, qstate=qstate)      # fake-quant forward
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from .calib.calibrator import HessianQuantCalibrator
from .configs import get_config
from .models import Net, get_net


def quantize(model: str, calib_x, *, config="PTQ4ViT",
             bits: Tuple[int, int] = (8, 8),
             params: Optional[Dict[str, Any]] = None,
             batch_size: int = 4, device=None, probe_u=None, seed: int = 0,
             verbose: bool = False, return_report: bool = False,
             **calib_kwargs):
    """Calibrate ``model`` (a MODEL_ZOO name or a built ``Net``) on
    ``calib_x`` (N, 3, H, W float32) and return
    (net, qstate).  ``params=None`` random-initializes from ``seed``;
    ``device`` defaults to CUDA when available.  ``probe_u`` (N, classes)
    fixes the hessian probe noise (see calib/capture.py).
    ``return_report=True`` returns (net, qstate, CalibReport)."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    if isinstance(model, Net):
        net = model
    else:
        net = get_net(model, params=params, seed=seed, device=device)
    cfg = (get_config(config) if isinstance(config, str) else config) \
        .set_bits(*bits)
    calibrator = HessianQuantCalibrator(net, cfg, calib_x,
                                        batch_size=batch_size, device=device,
                                        probe_u=probe_u, **calib_kwargs)
    qstate = calibrator.batching_quant_calib(verbose=verbose)
    if return_report:
        return net, qstate, calibrator.report
    return net, qstate
