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

Over a mesh (``parallel/mesh.make_mesh``) each rank captures its block of
every micro-batch (JAX's ``P(None, "data")`` micro-batches), with the
probe noise of those samples' global rows and the KL mean over the whole
micro-batch, so its caches hold exactly the single-device caches' rows;
the caches stay on the rank, and ``OpCapture.shard`` says which rows they
are.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..parallel.mesh import SampleShard, axis_rank, axis_size
from ..utils.tracing import span

TAP_FIELDS = {"linear": ("x",), "conv": ("x",), "matmul": ("a", "b")}


@dataclasses.dataclass
class OpCapture:
    """Raw calibration data of one op, sample axis leading."""
    kind: str
    inputs: Dict[str, torch.Tensor]   # linear/conv: {"x"}; matmul: {"a","b"}
    out: Optional[torch.Tensor] = None   # None when not stored (recomputed
                                         # from the inputs in the search)
    grad: Optional[torch.Tensor] = None
    shard: Optional[SampleShard] = None  # over a mesh: this rank's rows


def op_kinds(net) -> Dict[str, str]:
    return {n: ("conv" if t == "qconv" else
                "matmul" if "qmatmul" in t else "linear")
            for n, t in net.op_inventory}


def draw_probe_u(num: int, classes: int, probe_seed: int) -> torch.Tensor:
    """Gaussian probe noise (num, classes) from a seeded torch generator."""
    gen = torch.Generator(device="cpu").manual_seed(probe_seed)
    return torch.randn((num, classes), generator=gen, dtype=torch.float32)


def _kl_batchmean(logits, target, batch: Optional[int] = None):
    """F.kl_div(log_softmax(logits), target, reduction="batchmean"), the
    JAX package's formula (log of the target clamped at 1e-30).  ``batch``
    is the whole micro-batch's size when ``logits`` holds one rank's block
    of it, so each row's gradient is the single device's."""
    logp = torch.log_softmax(logits, dim=-1)
    logt = torch.log(torch.clamp(target, min=1e-30))
    return torch.sum(target * (logt - logp)) / (batch or logits.shape[0])


def probe_target(raw_logits, probe_u, probe_sigma: float):
    """The probe target softmax(logits + σ·u) (capture.py:64-70)."""
    return torch.softmax(raw_logits + probe_sigma * probe_u, dim=-1)


def capture(net, calib_x, *, batch_size: int = 8, need_grad: bool = True,
            probe_seed: int = 3, probe_sigma: float = 1e-3,
            probe_u=None, ops: Optional[Sequence[str]] = None,
            store_raw_out: bool = True, cache_dtype=None,
            device=None, qstate=None,
            target_probs: Optional[torch.Tensor] = None,
            to_host: bool = False, mesh=None) -> Dict[str, OpCapture]:
    """Run the capture pass over ``calib_x`` (num, 3, H, W).

    Returns {op name: OpCapture} with every cache on ``device`` (the net's
    params' device by default), the micro-batches in order, in
    ``cache_dtype`` (default: float32).  ``store_raw_out=False`` drops the
    op outputs (the searches recompute them).  Swin's window-matmul caches
    are (images x windows)-major, since the forward emits them so.

    ``qstate`` runs the ops it holds in fake-quant (sequential mode); the
    probe gradient dies at their ``round`` (its derivative is 0, with no
    straight-through estimator), as in the reference.  ``target_probs``
    (num, classes) is the probe target; without it the target comes from
    the pass's own logits and ``probe_u``.  ``to_host=True`` keeps the
    caches in host memory (pinned when ``device`` is the card), copied
    there micro-batch by micro-batch.

    ``mesh``: the micro-batch must divide over its "data" axis; when
    ``batch_size`` does not, the largest micro-batch that divides both the
    calibration set and the axis is taken (JAX capture.py:415-424), and
    there being none raises ``ValueError``."""
    params, cfg, fwd = net.params, net.cfg, net.forward
    if device is None:
        device = net.params["head"]["weight"].device
    device = torch.device(device)
    calib_x = np.asarray(calib_x, np.float32)
    num = calib_x.shape[0]
    if num % batch_size != 0:
        batch_size = next(b for b in range(min(batch_size, num), 0, -1)
                          if num % b == 0)
    dp = axis_size(mesh, "data")
    if batch_size % dp != 0:
        # micro-batches shard evenly over "data"; the KL mean's 1/batch
        # scales every gradient alike, which no argmax sees
        batch_size = next(
            (b for b in range(min(max(batch_size, dp), num), 0, -1)
             if num % b == 0 and b % dp == 0), None)
        if batch_size is None:
            raise ValueError(f"calib size {num} not shardable over "
                             f"data={dp}")
    # this rank's block of every micro-batch, in micro-batch order
    loc, r = batch_size // dp, axis_rank(mesh, "data")
    rows = np.concatenate([np.arange(s0 + r * loc, s0 + (r + 1) * loc)
                           for s0 in range(0, num, batch_size)])
    x_all = torch.from_numpy(calib_x[rows]).to(device)
    names = [n for n, _ in net.op_inventory]
    if ops is not None:
        names = [n for n in names if n in set(ops)]
    kinds = op_kinds(net)
    dtype = cache_dtype or torch.float32

    u_all = None
    if need_grad and target_probs is None:
        if probe_u is None:
            probe_u = draw_probe_u(num, cfg.num_classes, probe_seed)
        u_all = torch.from_numpy(
            np.array(probe_u, np.float32)[rows]).to(device)
    if target_probs is not None and dp > 1:
        target_probs = target_probs[torch.from_numpy(rows).to(
            target_probs.device)]

    n_micro = num // batch_size
    pin = to_host and device.type == "cuda"
    bufs: Dict[str, Dict[str, torch.Tensor]] = {n: {} for n in names}

    def keep(n, field, t, mb):
        """Copy micro-batch ``mb``'s tap into its slot of the full cache
        (a micro-batch's leading dim is bs, or bs x windows for Swin)."""
        t = t.detach().to(dtype)
        buf = bufs[n].get(field)
        if buf is None:
            buf = bufs[n][field] = torch.empty(
                (n_micro * t.shape[0],) + tuple(t.shape[1:]), dtype=dtype,
                device="cpu" if to_host else device, pin_memory=pin)
        m = t.shape[0]
        buf[mb * m:(mb + 1) * m].copy_(t, non_blocking=pin)

    for mb, s0 in enumerate(range(0, n_micro * loc, loc)):
        xb = x_all[s0:s0 + loc]
        if need_grad:
            with span("ptq.capture.forward"):
                with torch.no_grad():
                    raw_logits, taps = fwd(params, xb, cfg, qstate=qstate,
                                           capture=True)
                    target = (target_probs[s0:s0 + loc]
                              if target_probs is not None else
                              probe_target(raw_logits, u_all[s0:s0 + loc],
                                           probe_sigma))
                    shapes = {n: taps[n]["out"].shape for n in names}
                    del taps
                eps = {n: torch.zeros(sh, dtype=torch.float32, device=device,
                                      requires_grad=True)
                       for n, sh in shapes.items()}
                with torch.enable_grad():
                    logits, taps = fwd(params, xb, cfg, qstate=qstate,
                                       eps=eps, capture=True)
                    loss = _kl_batchmean(logits, target, batch_size)
            with span("ptq.capture.backward"), torch.enable_grad():
                grads = torch.autograd.grad(loss, [eps[n] for n in names])
            for n, g in zip(names, grads):
                keep(n, "grad", g, mb)
        else:
            with span("ptq.capture.forward"), torch.no_grad():
                _, taps = fwd(params, xb, cfg, qstate=qstate, capture=True)
        for n in names:
            for field in TAP_FIELDS[kinds[n]]:
                keep(n, field, taps[n][field], mb)
            if store_raw_out:
                keep(n, "out", taps[n]["out"], mb)
        del taps

    shard = SampleShard(mesh, batch_size, n_micro) if dp > 1 else None
    result: Dict[str, OpCapture] = {}
    for n in names:
        full = bufs.pop(n)
        result[n] = OpCapture(
            kind=kinds[n],
            inputs={k: full[k] for k in TAP_FIELDS[kinds[n]]},
            out=full.get("out"), grad=full.get("grad"), shard=shard)
    return result
