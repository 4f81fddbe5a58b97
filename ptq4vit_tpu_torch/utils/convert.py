"""Carry weights and calibrated state across from the JAX package.

Both functions duck-type their input, so this module imports no JAX: the
param tree is nested dicts and lists of array-likes, and a qstate entry is
any dataclass named ``LinearQP``, ``MatMulQP`` or ``ConvQP`` whose array
fields convert with ``numpy.asarray``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from ..quant.qparams import ConvQP, LinearQP, MatMulQP

QP_KINDS = {"LinearQP": LinearQP, "MatMulQP": MatMulQP, "ConvQP": ConvQP}


def params_from_numpy(tree, device="cpu"):
    """Nested dict/list of arrays (numpy, JAX or torch) -> the same
    structure of float32 tensors on ``device``."""
    if torch.is_tensor(tree):
        return tree.to(device=device, dtype=torch.float32)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    return torch.from_numpy(np.array(tree, np.float32)).to(device)


def qp_from_fields(kind: str, fields: Dict[str, Any], device="cpu"):
    """Build a port QP of class ``kind`` from field values; arrays become
    float32 tensors, other values pass through."""
    kw = {}
    for k, v in fields.items():
        if v is not None and (hasattr(v, "shape")
                              or isinstance(v, (np.ndarray, np.generic))):
            v = torch.from_numpy(np.array(v, np.float32)).to(device)
        kw[k] = v
    return QP_KINDS[kind](**kw)


def qstate_from_numpy(qstate: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """A JAX-package qstate ({op: LinearQP | MatMulQP | ConvQP}) -> the
    port's qstate on ``device``."""
    out = {}
    for name, qp in qstate.items():
        if qp is None:
            out[name] = None
            continue
        fields = {f.name: getattr(qp, f.name) for f in dataclasses.fields(qp)}
        out[name] = qp_from_fields(type(qp).__name__, fields, device)
    return out


def qstate_to(qstate: Dict[str, Any], device) -> Dict[str, Any]:
    """A copy of a port qstate with every tensor moved to ``device``."""
    return {name: None if qp is None else dataclasses.replace(
        qp, **{f.name: getattr(qp, f.name).to(device)
               for f in dataclasses.fields(qp)
               if torch.is_tensor(getattr(qp, f.name))})
            for name, qp in qstate.items()}


def packed_to(packed: Dict[str, Any], device) -> Dict[str, Any]:
    """A copy of a ``packed`` dict (ops/pack.pack_weights) with every
    tensor moved to ``device``."""
    return {name: {k: v.to(device) for k, v in entry.items()}
            for name, entry in packed.items()}
