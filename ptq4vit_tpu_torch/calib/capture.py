"""Calibration data capture: per-op FP32 inputs, outputs and probe
gradients in one forward + backward per micro-batch (the sequential
paradigm runs the ops calibrated so far in fake-quant).

The counterpart of ``ptq4vit_tpu/calib/capture.py`` ``capture()``.  The
hessian metric needs ∂loss/∂(op output); the loss is the reference's
``KL(log_softmax(pred) ‖ target)`` with the probe target
``softmax(logits + σ·u)`` for gaussian u.  The JAX package draws u with its
threefry generator, which torch cannot reproduce, so u is an explicit input
here (``probe_u``, shape (num, classes)); when it is absent, u comes from a
``torch.Generator`` seeded with ``probe_seed``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

TAP_FIELDS = {"linear": ("x",), "conv": ("x",), "matmul": ("a", "b")}


@dataclasses.dataclass
class OpCapture:
    """Raw calibration data of one op, sample axis leading."""
    kind: str
    inputs: Dict[str, torch.Tensor]   # linear/conv: {"x"}; matmul: {"a","b"}
    out: Optional[torch.Tensor] = None   # None when not stored (recomputed
                                         # from the inputs in the search)
    grad: Optional[torch.Tensor] = None


def op_kinds(net) -> Dict[str, str]:
    return {n: ("conv" if t == "qconv" else
                "matmul" if "qmatmul" in t else "linear")
            for n, t in net.op_inventory}


def draw_probe_u(num: int, classes: int, probe_seed: int) -> torch.Tensor:
    """Gaussian probe noise (num, classes) from a seeded torch generator."""
    gen = torch.Generator(device="cpu").manual_seed(probe_seed)
    return torch.randn((num, classes), generator=gen, dtype=torch.float32)


def _kl_batchmean(logits, target):
    """F.kl_div(log_softmax(logits), target, reduction="batchmean"), the
    JAX package's formula (log of the target clamped at 1e-30)."""
    logp = torch.log_softmax(logits, dim=-1)
    logt = torch.log(torch.clamp(target, min=1e-30))
    return torch.sum(target * (logt - logp)) / logits.shape[0]


def probe_target(raw_logits, probe_u, probe_sigma: float):
    """The probe target softmax(logits + σ·u) (capture.py:64-70)."""
    return torch.softmax(raw_logits + probe_sigma * probe_u, dim=-1)


def capture(net, calib_x, *, batch_size: int = 8, need_grad: bool = True,
            probe_seed: int = 3, probe_sigma: float = 1e-3,
            probe_u=None, ops: Optional[Sequence[str]] = None,
            store_raw_out: bool = True, cache_dtype=None,
            device=None, qstate=None,
            target_probs: Optional[torch.Tensor] = None
            ) -> Dict[str, OpCapture]:
    """Run the capture pass over ``calib_x`` (num, 3, H, W).

    Returns {op name: OpCapture} with every cache on ``device`` (the net's
    params' device by default), concatenated over the micro-batches, in
    ``cache_dtype`` (default: float32).  ``store_raw_out=False`` drops the
    op outputs (the searches recompute them).  Swin's window-matmul caches
    are (images x windows)-major, since the forward emits them so.

    ``qstate`` runs the ops it holds in fake-quant (sequential mode); the
    probe gradient dies at their ``round`` (its derivative is 0, with no
    straight-through estimator), as in the reference.  ``target_probs``
    (num, classes) is the probe target; without it the target comes from
    the pass's own logits and ``probe_u``."""
    params, cfg, fwd = net.params, net.cfg, net.forward
    if device is None:
        device = net.params["head"]["weight"].device
    device = torch.device(device)
    x_all = torch.from_numpy(np.array(calib_x, np.float32)).to(device)
    num = x_all.shape[0]
    if num % batch_size != 0:
        batch_size = next(b for b in range(min(batch_size, num), 0, -1)
                          if num % b == 0)
    names = [n for n, _ in net.op_inventory]
    if ops is not None:
        names = [n for n in names if n in set(ops)]
    kinds = op_kinds(net)
    dtype = cache_dtype or torch.float32

    u_all = None
    if need_grad and target_probs is None:
        if probe_u is None:
            probe_u = draw_probe_u(num, cfg.num_classes, probe_seed)
        u_all = torch.from_numpy(np.array(probe_u, np.float32)).to(device)

    chunks: Dict[str, Dict[str, list]] = {n: {} for n in names}

    def keep(n, field, t):
        chunks[n].setdefault(field, []).append(t.detach().to(dtype)
                                              .contiguous())

    for s0 in range(0, num, batch_size):
        xb = x_all[s0:s0 + batch_size]
        if need_grad:
            with torch.no_grad():
                raw_logits, taps = fwd(params, xb, cfg, qstate=qstate,
                                       capture=True)
                target = (target_probs[s0:s0 + batch_size]
                          if target_probs is not None else
                          probe_target(raw_logits, u_all[s0:s0 + batch_size],
                                       probe_sigma))
                shapes = {n: taps[n]["out"].shape for n in names}
                del taps
            eps = {n: torch.zeros(sh, dtype=torch.float32, device=device,
                                  requires_grad=True)
                   for n, sh in shapes.items()}
            with torch.enable_grad():
                logits, taps = fwd(params, xb, cfg, qstate=qstate, eps=eps,
                                   capture=True)
                loss = _kl_batchmean(logits, target)
                grads = torch.autograd.grad(loss, [eps[n] for n in names])
            for n, g in zip(names, grads):
                keep(n, "grad", g)
        else:
            with torch.no_grad():
                _, taps = fwd(params, xb, cfg, qstate=qstate, capture=True)
        for n in names:
            for field in TAP_FIELDS[kinds[n]]:
                keep(n, field, taps[n][field])
            if store_raw_out:
                keep(n, "out", taps[n]["out"])
        del taps

    result: Dict[str, OpCapture] = {}
    for n in names:
        cat = {k: torch.cat(v, dim=0) for k, v in chunks.pop(n).items()}
        result[n] = OpCapture(
            kind=kinds[n],
            inputs={k: cat[k] for k in TAP_FIELDS[kinds[n]]},
            out=cat.get("out"), grad=cat.get("grad"))
    return result
