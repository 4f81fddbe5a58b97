"""Calibration orchestration, parallel paradigm.

The counterpart of ``ptq4vit_tpu/calib/calibrator.py``
``HessianQuantCalibrator.batching_quant_calib``: every op is calibrated
against the FP32 net's own inputs, outputs and probe gradients.  Ops are
grouped so that each group's capture caches fit the device memory that
``torch.cuda.mem_get_info()`` reports; one capture pass per group collects
the caches, then each op's search runs on them and its caches are freed.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..configs.policy import QuantConfig
from ..utils.convert import qp_from_fields
from . import search as S
from .capture import capture


def params_for_op(params: Dict[str, Any], name: str):
    """(weight, bias) of a linear/conv op by its dotted timm path."""
    node = params
    for part in name.split("."):
        node = node[int(part)] if isinstance(node, list) else node[part]
    return node.get("weight"), node.get("bias")


def tap_bytes(net, calib_n: int, need_grad: bool, store_raw_out: bool,
              elem_bytes: int) -> Dict[str, int]:
    """Bytes of each op's full-calibration-set caches, from the static
    op shapes."""
    sizes = {}
    for name, info in net.op_shapes.items():
        if info["kind"] == "matmul":
            h, r, i, c = (info["heads"], info["rows"], info["inner"],
                          info["cols"])
            ins, out = h * r * i + h * i * c, h * r * c
        else:
            t = info["tokens"]
            ins, out = t * info["in_features"], t * info["out_features"]
        n = ins + (out if store_raw_out else 0) + (out if need_grad else 0)
        sizes[name] = n * elem_bytes * calib_n
    return sizes


def resolve_cache_dtype(cache_dtype, device: torch.device):
    """The JAX package's rule: bf16 caches on the accelerator, fp32 on the
    CPU; "float32" / "bfloat16" / a torch dtype override it."""
    if cache_dtype in (None, "auto"):
        return torch.bfloat16 if device.type == "cuda" else torch.float32
    if isinstance(cache_dtype, str):
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[
            cache_dtype]
    return cache_dtype


@dataclasses.dataclass
class CalibReport:
    """Wall-clock breakdown of one calibration (host clock, each phase
    ending in a device synchronize)."""
    model: str
    config: str
    capture_seconds: float = 0.0
    num_groups: int = 0
    search_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)


class HessianQuantCalibrator:
    """Parallel-paradigm calibrator; ``batching_quant_calib`` returns the
    calibrated qstate dict."""

    def __init__(self, net, quant_cfg: QuantConfig, calib_x, *,
                 batch_size: int = 4, device=None,
                 probe_seed: int = 3, probe_sigma: float = 1e-3,
                 probe_u=None, cache_dtype=None,
                 int8_score: Optional[bool] = None,
                 use_kernels: Optional[bool] = None):
        self.net = net
        self.cfg = quant_cfg
        self.calib_x = np.asarray(calib_x, np.float32)
        self.batch_size = batch_size
        self.device = torch.device(
            device if device is not None
            else net.params["head"]["weight"].device)
        self.cache_dtype = resolve_cache_dtype(cache_dtype, self.device)
        self.probe_seed = probe_seed
        self.probe_sigma = probe_sigma
        self.probe_u = probe_u
        self.int8_score = int8_score
        self.use_kernels = use_kernels
        self.report = CalibReport(model=net.name, config=quant_cfg.name)

    def _group_budget(self, need_grad: bool) -> int:
        """Cache bytes one capture group may hold: the free device memory
        less the largest search working set (its caches in fp32 plus the
        candidate-chunk scratch) and 1 GiB for the capture forward and
        backward."""
        if self.device.type != "cuda":
            return 8 << 30
        free, _ = torch.cuda.mem_get_info(self.device)
        work = tap_bytes(self.net, len(self.calib_x), need_grad, True, 4)
        reserve = max(work.values()) + S.DEFAULT_BUDGET + (1 << 30)
        return max(1 << 30, int(0.85 * free) - reserve)

    def batching_quant_calib(self, verbose: bool = False) -> Dict[str, Any]:
        net, cfg = self.net, self.cfg
        mtypes = dict(net.op_inventory)
        policies = {n: cfg.op_policy(t) for n, t in net.op_inventory}
        need_grad = any(p.metric == "hessian" for p in policies.values())
        elem = torch.tensor([], dtype=self.cache_dtype).element_size()
        sizes = tap_bytes(net, len(self.calib_x), need_grad, False, elem)
        budget = self._group_budget(need_grad)
        groups: List[List[str]] = [[]]
        acc = 0
        for name, _ in net.op_inventory:
            if groups[-1] and acc + sizes[name] > budget:
                groups.append([])
                acc = 0
            groups[-1].append(name)
            acc += sizes[name]
        self.report.num_groups = len(groups)

        qstate: Dict[str, Any] = {}
        for group in groups:
            t0 = time.time()
            raw = capture(net, self.calib_x, batch_size=self.batch_size,
                          need_grad=need_grad, probe_seed=self.probe_seed,
                          probe_sigma=self.probe_sigma, probe_u=self.probe_u,
                          ops=group, store_raw_out=False,
                          cache_dtype=self.cache_dtype, device=self.device)
            self._sync()
            self.report.capture_seconds += time.time() - t0
            for name in group:
                t0 = time.time()
                qstate[name] = self._search_one(name, mtypes[name],
                                                policies[name], raw.pop(name))
                self._sync()
                self.report.search_seconds[name] = time.time() - t0
                if verbose:
                    print(f"[calib] {name}: "
                          f"{self.report.search_seconds[name]:.2f}s",
                          flush=True)
        return qstate

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _search_one(self, name: str, mtype: str, policy, cap):
        if "qmatmul" in mtype:
            return S.search_matmul(cap, policy, int8_score=self.int8_score,
                                   use_kernels=self.use_kernels)
        w, b = params_for_op(self.net.params, name)
        if mtype == "qconv":
            return S.search_conv(w, b, cap, policy)
        return S.search_linear(w, b, cap, policy, int8_score=self.int8_score,
                               use_kernels=self.use_kernels)


# ---------------------------------------------------------------------------
# qstate persistence: the JAX package's npz format, one file per op
# (calibrator.py:762-798), so the two packages load each other's qstates
# ---------------------------------------------------------------------------

def save_op_qp(path: str, qp) -> None:
    arrays = {}
    meta = {"kind": type(qp).__name__}
    for f in dataclasses.fields(qp):
        v = getattr(qp, f.name)
        if v is None:
            continue
        if torch.is_tensor(v):
            arrays[f.name] = v.detach().cpu().numpy()
        else:
            meta[f.name] = v
    np.savez(path, __meta__=np.asarray(json.dumps(meta)), **arrays)


def load_op_qp(path: str, device="cpu"):
    with np.load(path) as data:
        meta = json.loads(str(data["__meta__"]))
        meta.pop("scope", None)
        kind = meta.pop("kind")
        fields = dict(meta)
        for k in data.files:
            if k != "__meta__":
                fields[k] = data[k]
    return qp_from_fields(kind, fields, device)


def save_qstate(dirpath: str, qstate: Dict[str, Any]) -> None:
    os.makedirs(dirpath, exist_ok=True)
    for name, qp in qstate.items():
        save_op_qp(os.path.join(dirpath, name.replace("/", "_") + ".npz"), qp)


def load_qstate(dirpath: str, device="cpu") -> Dict[str, Any]:
    out = {}
    for fn in sorted(os.listdir(dirpath)):
        if fn.endswith(".npz"):
            out[fn[:-4]] = load_op_qp(os.path.join(dirpath, fn), device)
    return out

