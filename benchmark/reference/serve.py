"""The served model's logits, worked out plainly, and the comparison that
judges served logits.

The served model is the W8A8 net: every quantized op runs on its
fake-quantized operands (levels times intervals), in float32 with TF32
off, from the float weights and the qstate the benchmark made; nothing
the program packed or prepared is read.  The control rounds every float
tensor that an op or a residual sum hands on to float8 (e4m3), the
precision below the configuration's bfloat16.
"""
from __future__ import annotations

import torch

from .models import Hooks, forward


def fp8(t):
    return t.to(torch.float8_e4m3fn).to(t.dtype)


def logits(params, cfg, qstate, images, *, block=8, control=False):
    """(N, classes) float32 logits of host or device images, ``block``
    images at a time on the params' device."""
    dev = params["head"]["weight"].device
    out = []
    with torch.no_grad():
        for s0 in range(0, images.shape[0], block):
            x = torch.as_tensor(images[s0:s0 + block]).to(dev).float()
            hk = Hooks(qstate=qstate, act=fp8 if control else None)
            out.append(forward(params, x, cfg, hk).float())
    return torch.cat(out)


def judge(served, ref):
    """The numbers that decide ``correct`` for one request: ``logit_rms``,
    the root mean square of the served logits' error over that of the
    reference's logits, and ``logit_err``, the widest error of an image's
    logit over that image's largest reference logit magnitude."""
    served = served.float().to(ref.device)
    scale = ref.abs().amax(1).clamp(min=1e-30)
    err = ((served - ref).abs().amax(1) / scale).max()
    rms = ((served - ref) ** 2).mean().sqrt() / (ref ** 2).mean().sqrt()
    return {"logit_rms": float(rms), "logit_err": float(err)}
