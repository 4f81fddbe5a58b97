"""Calibration orchestration.

The counterpart of ``ptq4vit_tpu/calib/calibrator.py``
``HessianQuantCalibrator.batching_quant_calib``.

Parallel paradigm (the default): every op is calibrated against the FP32
net's own inputs, outputs and probe gradients.  Ops are grouped so that
each group's capture caches fit the device memory that
``torch.cuda.mem_get_info()`` reports; one capture pass per group collects
the caches, then each op's search runs on them and its caches are freed.

Sequential paradigm (``sequential=True``, reference quant_calib.py:369):
the ops are walked in the reference's module order
(``models/net_wrap.reference_wrap_order``) and each is captured with every
op before it already in fake-quant, then searched.  The probe target comes
from the raw net, once (calibrator.py:267-279).  The JAX package shares
one compiled capture between the steps (``SequentialCapturePlan``,
``GatedQP``) only to avoid recompiles; eager PyTorch needs a plain loop.

Either paradigm resumes from a ``checkpoint_dir``: one npz per op in the
JAX package's format, stamped with the net, the config and the op's
policy, so each package resumes from the other's directory.
``minmax_calib`` (no search) and ``apply_bias_correction`` (opt-in) are
the module's other entries.
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
from ..models.net_wrap import reference_wrap_order
from ..models.registry import resolve_device
from ..ops import search_kernels as K
from ..quant import fakequant as fq
from ..quant.qparams import ConvQP, LinearQP, MatMulQP
from ..utils.convert import qp_from_fields
from . import search as S
from .capture import OpCapture, capture, draw_probe_u, probe_target


def params_for_op(params: Dict[str, Any], name: str):
    """(weight, bias) of a linear/conv op by its dotted timm path."""
    node = params
    for part in name.split("."):
        node = node[int(part)] if isinstance(node, list) else node[part]
    return node.get("weight"), node.get("bias")


def tap_bytes(net, calib_n: int, need_grad: bool, store_raw_out: bool,
              elem_bytes: int) -> Dict[str, int]:
    """Bytes of each op's full-calibration-set caches, from the static
    op shapes (a window matmul holds ``windows`` samples per image)."""
    sizes = {}
    for name, info in net.op_shapes.items():
        if info["kind"] == "matmul":
            h, r, i, c = (info["heads"], info["rows"], info["inner"],
                          info["cols"])
            nw = info.get("windows", 1)
            ins, out = nw * (h * r * i + h * i * c), nw * h * r * c
        else:
            t = info["tokens"]
            ins, out = t * info["in_features"], t * info["out_features"]
        n = ins + (out if store_raw_out else 0) + (out if need_grad else 0)
        sizes[name] = n * elem_bytes * calib_n
    return sizes


def kernel_scratch_bytes(info, calib_n: int, policy) -> int:
    """Device bytes that one call of the op's search kernel allocates
    beyond its caches (``ops/search_kernels.py``): the int8 level buffers
    of B1, B2, B4w or B4a for a linear (B2's and B4a's per-candidate input
    levels dominate) with the fp32 operand B4w / B4a take (the fake-quant
    input, the fake-quant weight), B3 / B3f for a matmul (mode "a" only
    without the SoS quantizer) with its per-warp partial sums; 0 for the
    conv, whose search is plain tensor code."""
    P = policy.eq_n
    if info["kind"] == "linear":
        ic, oc = info["in_features"], info["out_features"]
        M, kp = info["tokens"] * calib_n, K.k_pad(ic)
        return max(P * M * kp + M * kp + oc * kp,              # B2
                   P * oc * kp + 2 * M * kp,                   # B1
                   P * oc * kp + 4 * M * ic,                   # B4w
                   P * M * kp + M * kp + 4 * oc * ic)          # B4a
    if info["kind"] == "matmul":
        G, S = info["heads"], info.get("windows", 1) * calib_n
        Z = G * S
        R, C, kp = info["rows"], info["cols"], K.k_pad(info["inner"])
        partial = 4 * P * G * S * -(-R // K.MM_ROWS) \
            * -(-C // K.mm_width(C)) * K.MM_WARPS
        mode_b = 2 * Z * R * kp + P * Z * C * kp               # b, b_sos
        if policy.quantizer == "sos_matmul":
            return mode_b + partial
        return max(P * Z * R * kp + Z * C * kp, mode_b) + partial  # a, b
    return 0


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
    ending in a device synchronize), with the JAX package's fields in its
    order (calibrator.py:109-131)."""
    model: str
    config: str
    capture_seconds: float = 0.0
    # the probe target from the raw net, computed once by the sequential
    # paradigm; the parallel capture computes it inside its own
    # forward+backward pass, so it stays 0.0 there
    target_seconds: float = 0.0
    # always 0.0: every capture and search ends in its own synchronize,
    # so no device time is left to wait for at a group's end
    sync_seconds: float = 0.0
    # checkpoint loading and group planning, before the first capture
    setup_seconds: float = 0.0
    num_groups: int = 0             # capture passes (one per op when
                                    # sequential)
    search_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)
    capture_peak_bytes: int = 0     # CUDA: peak allocated by the end of a
                                    # capture pass (0 on the CPU)

    @property
    def total_seconds(self) -> float:
        return (self.capture_seconds + self.target_seconds +
                self.sync_seconds + self.setup_seconds +
                sum(self.search_seconds.values()))


class HessianQuantCalibrator:
    """Calibrator of the parallel (default) or the sequential paradigm;
    ``batching_quant_calib`` returns the calibrated qstate dict.

    The arguments up to ``mesh`` are the JAX package's, in its order
    (calibrator.py:139-150); the port's own follow as keywords.
    ``checkpoint_dir`` saves each op's QP as soon as its search ends and
    loads, instead of searching, every op found there under the same
    scope; ``wrapped_modules`` ({op: module type}) is the op subset and
    its order; ``cache_budget_bytes`` caps a capture group's caches;
    ``search_budget_bytes`` bounds a search's candidate-chunk scratch;
    ``device_resident=False`` holds the captured caches in host memory
    (pinned), each op's going to the device only for its search;
    ``profile_dir`` runs the calibration under ``torch.profiler`` and
    writes a Chrome trace there; ``mesh`` waits for multi-GPU."""

    def __init__(self, net, quant_cfg: QuantConfig, calib_x,
                 sequential: bool = False, batch_size: int = 4,
                 cache_budget_bytes: Optional[int] = None,
                 search_budget_bytes: int = S.DEFAULT_BUDGET,
                 probe_seed: int = 3, probe_sigma: float = 1e-3,
                 checkpoint_dir: Optional[str] = None,
                 wrapped_modules: Optional[Dict[str, str]] = None,
                 device_resident: bool = True, cache_dtype=None,
                 profile_dir: Optional[str] = None, mesh=None, *,
                 device=None, probe_u=None,
                 int8_score: Optional[bool] = None,
                 use_kernels: Optional[bool] = None):
        if mesh is not None:
            raise NotImplementedError("calibration over a device mesh needs "
                                      "multi-GPU (ROADMAP A12)")
        self.net = net
        self.cfg = quant_cfg
        self.calib_x = np.asarray(calib_x, np.float32)
        self.sequential = sequential
        self.batch_size = batch_size
        self.device = torch.device(
            device if device is not None
            else net.params["head"]["weight"].device)
        self.cache_dtype = resolve_cache_dtype(cache_dtype, self.device)
        self.cache_budget = cache_budget_bytes
        self.search_budget = search_budget_bytes
        self.device_resident = device_resident
        self.probe_seed = probe_seed
        self.probe_sigma = probe_sigma
        self.probe_u = probe_u
        self.checkpoint_dir = checkpoint_dir
        self.profile_dir = profile_dir
        self.int8_score = int8_score
        self.use_kernels = use_kernels
        self.wrapped_modules = (list(wrapped_modules.items())
                                if wrapped_modules is not None
                                else list(net.op_inventory))
        if sequential:
            self.wrapped_modules = reference_wrap_order(self.wrapped_modules)
        self.report = CalibReport(model=net.name, config=quant_cfg.name)

    # -- checkpoint / resume (calibrator.py:207-235) ------------------------
    def _ckpt_path(self, name: str) -> Optional[str]:
        if self.checkpoint_dir is None:
            return None
        return os.path.join(self.checkpoint_dir,
                            name.replace("/", "_") + ".npz")

    def _ckpt_scope(self, mtype: str) -> str:
        """Identity stamp of a checkpoint: a directory reused across models
        or configs (bits, n_V, ...) must not return stale QPs."""
        return f"{self.net.name}|{self.cfg.name}|{self.cfg.op_policy(mtype)}"

    def _load_ckpt(self, name: str, mtype: str):
        p = self._ckpt_path(name)
        if p is None or not os.path.exists(p):
            return None
        with np.load(p) as data:
            meta = json.loads(str(data["__meta__"]))
        if meta.get("scope") != self._ckpt_scope(mtype):
            return None                      # another model or config
        return load_op_qp(p, self.device)

    def _save_ckpt(self, name: str, mtype: str, qp) -> None:
        p = self._ckpt_path(name)
        if p is None:
            return
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        save_op_qp(p, qp, scope=self._ckpt_scope(mtype))

    def _group_budget(self, need_grad: bool, policies, need: int = 0) -> int:
        """Cache bytes one capture group may hold: an explicit
        ``cache_budget_bytes``; 48 GiB of host memory for host-held caches;
        else the free device memory less the largest search working set
        (its caches in fp32, its kernel's level buffers, the candidate-chunk
        scratch) and 1 GiB for the capture forward and backward.  When that
        cannot hold the ``need`` bytes of caches in one group and
        PyTorch's caching allocator holds blocks with no tensor in them (an
        earlier calibration in this process leaves them, and the driver
        counts them as used), they go back to the driver and the free
        memory is read again."""
        if self.cache_budget is not None:
            return self.cache_budget
        if not self.device_resident:
            return 48 << 30
        if self.device.type != "cuda":
            return 8 << 30
        n = len(self.calib_x)
        work = tap_bytes(self.net, n, need_grad, True, 4)
        reserve = max(work[name] + kernel_scratch_bytes(
            self.net.op_shapes[name], n, policies[name])
            for name in policies) + self.search_budget + (1 << 30)

        def budget():
            free, _ = torch.cuda.mem_get_info(self.device)
            return max(1 << 30, int(0.85 * free) - reserve)
        out = budget()
        if out < need and torch.cuda.memory_reserved(self.device) > \
                torch.cuda.memory_allocated(self.device):
            torch.cuda.empty_cache()
            out = budget()
        return out

    def quant_calib(self, verbose: bool = False) -> Dict[str, Any]:
        """The reference's non-batching entry (quant_calib.py:95-104): it
        differs from the batching one only in memory staging, which the
        group planner covers."""
        return self.batching_quant_calib(verbose=verbose)

    def batching_quant_calib(self, verbose: bool = False) -> Dict[str, Any]:
        if self.profile_dir is None:
            return self._batching_quant_calib(verbose)
        from ..utils.tracing import device_trace
        with device_trace(self.profile_dir, self.device, "calibration"):
            return self._batching_quant_calib(verbose)

    def _batching_quant_calib(self, verbose: bool) -> Dict[str, Any]:
        t_setup = time.time()
        policies = {n: self.cfg.op_policy(t) for n, t in self.wrapped_modules}
        need_grad = any(p.metric == "hessian" for p in policies.values())
        qstate: Dict[str, Any] = {}
        todo = []
        for name, mtype in self.wrapped_modules:
            qp = self._load_ckpt(name, mtype)
            if qp is None:
                todo.append((name, mtype))
            else:
                qstate[name] = qp
        if self.sequential:
            self.report.setup_seconds = time.time() - t_setup
            return self._sequential_calib(qstate, todo, policies, need_grad,
                                          verbose)
        elem = torch.tensor([], dtype=self.cache_dtype).element_size()
        sizes = tap_bytes(self.net, len(self.calib_x), need_grad, False, elem)
        budget = self._group_budget(need_grad, policies,
                                    sum(sizes[name] for name, _ in todo))
        groups: List[List[str]] = []
        acc = 0
        for name, _ in todo:
            if not groups or acc + sizes[name] > budget:
                groups.append([])
                acc = 0
            groups[-1].append(name)
            acc += sizes[name]
        self.report.num_groups = len(groups)
        self.report.setup_seconds = time.time() - t_setup

        mtypes = dict(todo)
        for group in groups:
            raw = self._capture(group, need_grad, probe_seed=self.probe_seed,
                                probe_u=self.probe_u)
            if self.device.type == "cuda":
                # the capture's freed blocks go back to the driver before
                # the searches: left cached, they fragmented the card so
                # that B3's 50 GiB mode-a scratch of ViT-B/384 BasePTQ at
                # 128 images found no room (ROADMAP C7)
                torch.cuda.empty_cache()
            for name in group:
                qp = self._search_one(name, mtypes[name], policies[name],
                                      raw.pop(name), verbose)
                qstate[name] = qp
                self._save_ckpt(name, mtypes[name], qp)
        return {n: qstate[n] for n, _ in self.wrapped_modules}

    def _sequential_calib(self, qstate, todo, policies, need_grad: bool,
                          verbose: bool):
        """One capture and one search per op still to calibrate, in the
        reference's module order, each capture with every op calibrated
        or loaded so far in fake-quant."""
        net = self.net
        target = None
        if need_grad and todo:
            # the probe target from the RAW net, once, in chunks of 8
            # (calibrator.py:267-279)
            t0 = time.time()
            x = torch.from_numpy(self.calib_x).to(self.device)
            with torch.no_grad():
                logits = torch.cat([net.forward(net.params, x[s0:s0 + 8],
                                                net.cfg)
                                    for s0 in range(0, len(x), 8)])
            u = (self.probe_u if self.probe_u is not None else
                 draw_probe_u(len(x), logits.shape[-1], self.probe_seed))
            target = probe_target(
                logits, torch.as_tensor(np.array(u, np.float32),
                                        device=self.device),
                self.probe_sigma)
            self._sync()
            self.report.target_seconds = time.time() - t0
        for name, mtype in todo:
            raw = self._capture([name], need_grad, qstate=dict(qstate),
                                target_probs=target)
            qp = self._search_one(name, mtype, policies[name], raw.pop(name),
                                  verbose)
            qstate[name] = qp
            self._save_ckpt(name, mtype, qp)
        self.report.num_groups = len(todo)
        return {n: qstate[n] for n, _ in self.wrapped_modules}

    def _capture(self, ops, need_grad: bool, **kw):
        """One capture pass over ``ops``; its seconds and the peak device
        memory by its end go to the report."""
        t0 = time.time()
        raw = capture(self.net, self.calib_x, batch_size=self.batch_size,
                      need_grad=need_grad, probe_sigma=self.probe_sigma,
                      ops=ops, store_raw_out=False,
                      cache_dtype=self.cache_dtype, device=self.device,
                      to_host=not self.device_resident, **kw)
        self._sync()
        self.report.capture_seconds += time.time() - t0
        if self.device.type == "cuda":
            self.report.capture_peak_bytes = max(
                self.report.capture_peak_bytes,
                torch.cuda.max_memory_allocated(self.device))
        return raw

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _search_one(self, name: str, mtype: str, policy, cap, verbose: bool):
        """Search one op (its host-held caches moved to the device first);
        its seconds go to the report."""
        t0 = time.time()
        if not self.device_resident:
            cap = cap_to(cap, self.device)
        if "qmatmul" in mtype:
            qp = S.search_matmul(cap, policy, self.search_budget,
                                 int8_score=self.int8_score,
                                 use_kernels=self.use_kernels)
        else:
            w, b = params_for_op(self.net.params, name)
            if mtype == "qconv":
                qp = S.search_conv(w, b, cap, policy, self.search_budget)
            else:
                qp = S.search_linear(w, b, cap, policy, self.search_budget,
                                     calib_bs=self.batch_size,
                                     int8_score=self.int8_score,
                                     use_kernels=self.use_kernels)
        self._sync()
        self.report.search_seconds[name] = time.time() - t0
        if verbose:
            print(f"[calib] {name}: {self.report.search_seconds[name]:.2f}s",
                  flush=True)
        return qp


# the reference's base class name (quant_calib.py:9)
QuantCalibrator = HessianQuantCalibrator


def cap_to(cap: OpCapture, device) -> OpCapture:
    """An OpCapture with every cache on ``device`` (asynchronous from
    pinned host memory)."""
    def move(t):
        return None if t is None else t.to(device, non_blocking=True)
    return OpCapture(cap.kind, {k: move(v) for k, v in cap.inputs.items()},
                     out=move(cap.out), grad=move(cap.grad))


def minmax_calib(net, quant_cfg: QuantConfig, calib_x,
                 batch_size: int = 8) -> Dict[str, Any]:
    """Plain min-max calibration, no search (reference MinMaxQuant*
    calibration_step2, linear.py:86-92, matmul.py:54-60; JAX
    calibrator.py:679-715), on the net's device."""
    raw = capture(net, calib_x, batch_size=batch_size, need_grad=False)
    qstate: Dict[str, Any] = {}
    for name, mtype in net.op_inventory:
        pol = quant_cfg.op_policy(mtype)
        cap = raw.pop(name)
        if "qmatmul" in mtype:
            A, B = cap.inputs["a"], cap.inputs["b"]
            G = A.shape[1]
            qstate[name] = MatMulQP(
                A_interval=fq.matmul_operand_interval_init(
                    A, G, 1, 1, fq.qmax_for_bit(pol.a_bit)),
                B_interval=fq.matmul_operand_interval_init(
                    B, G, 1, 1, fq.qmax_for_bit(pol.b_bit)),
                A_bit=pol.a_bit, B_bit=pol.b_bit)
            continue
        w, _ = params_for_op(net.params, name)
        if mtype == "qconv":
            qstate[name] = ConvQP(
                w_interval=fq.minmax_interval(w, fq.qmax_for_bit(pol.w_bit)),
                a_interval=None, w_bit=pol.w_bit, a_bit=32)
            continue
        qmax_a = fq.qmax_for_bit(pol.a_bit)
        qstate[name] = LinearQP(
            w_interval=fq.minmax_interval(
                w, fq.qmax_for_bit(pol.w_bit)).reshape(1, 1, 1, 1),
            a_interval=fq.exact_div(torch.amax(torch.abs(cap.inputs["x"])),
                                    qmax_a - 0.5).reshape(1, 1),
            w_bit=pol.w_bit, a_bit=pol.a_bit)
    return qstate


def _copy_tree(node):
    """The param tree's dicts and lists copied, its tensors shared."""
    if isinstance(node, dict):
        return {k: _copy_tree(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_copy_tree(v) for v in node]
    return node


def apply_bias_correction(net, qstate: Dict[str, Any], calib_x,
                          batch_size: int = 8) -> Dict[str, Any]:
    """One-shot bias correction (reference _bias_correction_quant_forward,
    linear.py:69-77; JAX calibrator.py:718-751): subtract the mean
    quantization-induced output error from each calibrated linear's bias.
    Opt-in, as the reference's flag is inert in its shipped pipeline.

    Returns a NEW param tree; ``net.params`` and ``qstate`` are untouched."""
    ops = [n for n, t in net.op_inventory
           if t.startswith("qlinear") and qstate.get(n) is not None
           and params_for_op(net.params, n)[1] is not None]
    raw = capture(net, calib_x, batch_size=batch_size, need_grad=False,
                  ops=ops, store_raw_out=False)
    params = _copy_tree(net.params)
    for name in ops:
        qp = qstate[name]
        w, b = params_for_op(net.params, name)
        x = raw.pop(name).inputs["x"]
        x_sim = qp.quant_input(x.reshape(-1, x.shape[-1]))
        eps = torch.mean(torch.matmul(x_sim, (qp.quant_weight(w) - w).t()),
                         dim=0)
        node = params
        for part in name.split("."):
            node = node[int(part)] if isinstance(node, list) else node[part]
        node["bias"] = b - eps
    return params


# ---------------------------------------------------------------------------
# qstate persistence: the JAX package's npz format, one file per op
# (calibrator.py:762-798), so the two packages load each other's qstates
# ---------------------------------------------------------------------------

def save_op_qp(path: str, qp, scope: Optional[str] = None) -> None:
    """One op's QP as an npz: its arrays, and a JSON ``__meta__`` with the
    kind, the resume ``scope`` when given and the other fields, in the JAX
    package's key order."""
    arrays = {}
    meta = {"kind": type(qp).__name__}
    if scope is not None:
        meta["scope"] = scope
    for f in dataclasses.fields(qp):
        v = getattr(qp, f.name)
        if v is None:
            continue
        if torch.is_tensor(v):
            arrays[f.name] = v.detach().cpu().numpy()
        else:
            meta[f.name] = v
    np.savez(path, __meta__=np.asarray(json.dumps(meta)), **arrays)


def load_op_qp(path: str, device=None):
    """One op's QP from an npz of either package, on ``device`` (default:
    the card; ``device="cpu"`` off it)."""
    device = resolve_device(device)
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


def load_qstate(dirpath: str, device=None) -> Dict[str, Any]:
    """Every op's QP in ``dirpath``, on ``device`` (default: the card)."""
    device = resolve_device(device)
    out = {}
    for fn in sorted(os.listdir(dirpath)):
        if fn.endswith(".npz"):
            out[fn[:-4]] = load_op_qp(os.path.join(dirpath, fn), device)
    return out

