"""One-call API of the port.

    from ptq4vit_tpu_torch import quantize
    net, qstate = quantize("vit_base_patch16_384", calib_images,
                           config="PTQ4ViT")          # on the card
    logits = net.apply(x, qstate=qstate)      # fake-quant forward

Any MODEL_ZOO row works the same way, the Swin rows included
("swin_base_patch4_window12_384"); ``config`` is "PTQ4ViT", "BasePTQ" or a
``QuantConfig``, ``bits`` (8, 8) or (6, 6), ``sequential=True`` the
sequential paradigm, ``int8_score=False`` exact scoring,
``checkpoint_dir=`` a resumable calibration.  ``params=None`` takes a
converted timm checkpoint from ``$PTQ4VIT_TPU_CKPT_DIR`` when there is one.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from .calib.calibrator import HessianQuantCalibrator
from .configs import get_config
from .models import Net, get_net
from .models.registry import resolve_device
from .utils.timm_port import load_timm_checkpoint_if_any


def quantize(model, calib_x, *, config="PTQ4ViT",
             bits: Tuple[int, int] = (8, 8),
             params: Optional[Dict[str, Any]] = None,
             batch_size: int = 4, checkpoint_dir: Optional[str] = None,
             device=None, probe_u=None, seed: int = 0,
             sequential: bool = False, int8_score: Optional[bool] = None,
             verbose: bool = False, return_report: bool = False,
             **calib_kwargs):
    """Calibrate ``model`` (a MODEL_ZOO name or a built ``Net``) on
    ``calib_x`` (N, 3, H, W float32) and return (net, qstate).
    ``params=None`` loads a converted timm checkpoint from
    ``$PTQ4VIT_TPU_CKPT_DIR`` if there is one, else random-initializes from
    ``seed``; ``checkpoint_dir`` makes the calibration resumable (see
    calib/calibrator.py); ``device`` defaults to the card and raises when
    there is none (``device="cpu"`` runs on the CPU).  ``probe_u`` (N,
    classes) fixes the hessian probe noise (see calib/capture.py);
    ``int8_score`` defaults to int8 scoring on the card and exact scoring
    on the CPU.  Other keywords go to ``HessianQuantCalibrator``.
    ``return_report=True`` returns (net, qstate, CalibReport)."""
    device = resolve_device(device)
    if isinstance(model, Net):
        net = model
    else:
        if params is None:
            params = load_timm_checkpoint_if_any(model)
        net = get_net(model, params=params, seed=seed, device=device)
    cfg = (get_config(config) if isinstance(config, str) else config) \
        .set_bits(*bits)
    calibrator = HessianQuantCalibrator(net, cfg, calib_x,
                                        sequential=sequential,
                                        batch_size=batch_size,
                                        checkpoint_dir=checkpoint_dir,
                                        device=device,
                                        probe_u=probe_u,
                                        int8_score=int8_score, **calib_kwargs)
    qstate = calibrator.batching_quant_calib(verbose=verbose)
    if return_report:
        return net, qstate, calibrator.report
    return net, qstate
