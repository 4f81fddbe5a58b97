"""Similarity metrics used to score scale-factor candidates.

The counterpart of ``ptq4vit_tpu/quant/metrics.py`` (the reference's six
metrics plus hessian, quant_layers/linear.py:399-424).  Norm-style metrics
reduce the feature axis with a mean; cosine-style metrics reduce it inside
the cosine.
"""
from __future__ import annotations

import torch

_COS_EPS = 1e-8

METRICS = (
    "cosine",
    "pearson",
    "L1_norm",
    "L2_norm",
    "linear_weighted_L2_norm",
    "square_weighted_L2_norm",
    "hessian",
)


def cosine_similarity(a, b, axis: int = -1):
    """dot / max(|a|*|b|, eps) along ``axis`` (F.cosine_similarity)."""
    dot = torch.sum(a * b, dim=axis)
    na = torch.sqrt(torch.sum(a * a, dim=axis))
    nb = torch.sqrt(torch.sum(b * b, dim=axis))
    return dot / torch.clamp(na * nb, min=_COS_EPS)


def similarity(raw, sim, metric: str, raw_grad=None, axis: int = -1,
               reduce_feature: bool = True):
    """Candidate-scoring similarity along feature ``axis``; with
    ``reduce_feature=False`` the norm-style metrics return the elementwise
    map."""
    if metric == "cosine":
        return cosine_similarity(raw, sim, axis=axis)
    if metric == "pearson":
        ra = raw - torch.mean(raw, dim=axis, keepdim=True)
        sa = sim - torch.mean(sim, dim=axis, keepdim=True)
        return cosine_similarity(ra, sa, axis=axis)
    if metric == "L1_norm":
        s = -torch.abs(raw - sim)
    elif metric == "L2_norm":
        s = -((raw - sim) ** 2)
    elif metric == "linear_weighted_L2_norm":
        s = -torch.abs(raw) * (raw - sim) ** 2
    elif metric == "square_weighted_L2_norm":
        s = -((raw * (raw - sim)) ** 2)
    elif metric == "hessian":
        if raw_grad is None:
            raise ValueError("hessian metric requires raw_grad")
        s = -((raw_grad * (raw - sim)) ** 2)
    else:
        raise NotImplementedError(f"metric {metric} not implemented!")
    if reduce_feature:
        return torch.mean(s, dim=axis)
    return s
