"""The ("data", "model") device mesh, its collectives, and classification
evaluation on one device or over a mesh.

The counterpart of ``ptq4vit_tpu/parallel/mesh.py``.  JAX annotates
shardings and lets XLA place the collectives; here every rank is a
process of its own (``parallel/launch.py``) that runs the same code on the
same full host inputs, takes its own rows or weight shards, and calls the
collectives itself, so that every rank ends with the same results:

  * ``data`` axis: the batch (or the calibration samples) splits into
    contiguous blocks, one a rank (``P("data")``); counts and similarity
    sums are ``all_reduce``-d over it;
  * ``model`` axis: Megatron-style tensor parallelism of the big linears
    (qkv and fc1 column-parallel, proj and fc2 row-parallel, ``_tp_spec``);
    a row-parallel op reduces its partial products over it before its
    bias, which is added once.

Rank r sits at (r // model_parallel, r % model_parallel), JAX's row-major
device grid, so data shard i holds the rows JAX's device i does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..quant.fakequant import exact_div
from ..quant.qparams import LinearQP, MatMulQP
from ..utils.convert import params_from_numpy, qstate_to
from .launch import rank_device

AXES = ("data", "model")


def make_mesh(n_devices: Optional[int] = None,
              model_parallel: int = 1) -> DeviceMesh:
    """The (n // model_parallel, model_parallel) ("data", "model") mesh
    over the initialized world, on this rank's device type;
    ``n_devices`` must be the world size."""
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"a mesh of {n} devices over a world of {world} "
                         "ranks")
    if n % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide "
                         f"{n} devices")
    return init_device_mesh(rank_device().type,
                            (n // model_parallel, model_parallel),
                            mesh_dim_names=AXES)


def check_mesh(mesh) -> Optional[DeviceMesh]:
    """``mesh`` itself when it is None or a ("data", "model") DeviceMesh."""
    if mesh is None:
        return None
    if not isinstance(mesh, DeviceMesh) or \
            tuple(mesh.mesh_dim_names or ()) != AXES:
        raise TypeError("mesh must be a ('data', 'model') DeviceMesh "
                        f"(make_mesh), not {type(mesh).__name__}")
    return mesh


def axis_size(mesh, axis: str) -> int:
    return 1 if mesh is None else mesh.size(AXES.index(axis))


def axis_rank(mesh, axis: str) -> int:
    return 0 if mesh is None else mesh.get_local_rank(axis)


def _all_reduce(t, mesh, axis: str, op):
    if mesh is None:
        return t
    t = t.contiguous().clone()
    dist.all_reduce(t, op=op, group=mesh.get_group(axis))
    return t


def psum(t, mesh, axis: str = "data"):
    """The sum of ``t`` over the ranks of ``axis`` (a copy; a collective
    on every mesh, one rank along ``axis`` included)."""
    return _all_reduce(t, mesh, axis, dist.ReduceOp.SUM)


def pmax(t, mesh, axis: str = "data"):
    return _all_reduce(t, mesh, axis, dist.ReduceOp.MAX)


def pmin(t, mesh, axis: str = "data"):
    return _all_reduce(t, mesh, axis, dist.ReduceOp.MIN)


def all_gather(t, mesh, axis: str = "data"):
    """Every rank's ``t`` (all of one shape) concatenated on axis 0 in the
    ranks' order along ``axis``.  NCCL gathers; gloo, which gathers no
    device tensors, sums each rank's bytes placed at its offset of a zero
    buffer (exact: the other ranks add zeros)."""
    if mesh is None:
        return t
    n = axis_size(mesh, axis)
    group = mesh.get_group(axis)
    t = t.contiguous()
    shape = (n * t.shape[0],) + tuple(t.shape[1:])
    if dist.get_backend(group) == "nccl":
        out = t.new_empty(shape)
        dist.all_gather_into_tensor(out, t, group=group)
        return out
    raw = t.reshape(-1).view(torch.uint8)
    k = raw.numel()
    buf = torch.zeros(n * k, dtype=torch.uint8, device=t.device)
    r = axis_rank(mesh, axis)
    buf[r * k:(r + 1) * k] = raw
    dist.all_reduce(buf, group=group)
    return buf.view(t.dtype).reshape(shape)


def shard_batch(x, mesh):
    """This rank's contiguous block of ``x``'s leading axis (``P("data")``);
    the axis must divide by the mesh's data axis."""
    dp = axis_size(mesh, "data")
    if x.shape[0] % dp:
        raise ValueError(f"a batch of {x.shape[0]} does not divide over "
                         f"data={dp}")
    n = x.shape[0] // dp
    r = axis_rank(mesh, "data")
    return x[r * n:(r + 1) * n]


def replicate(tree, mesh):
    """A param tree (numpy or torch) whole on this rank's device."""
    return params_from_numpy(tree, rank_device())


class SampleShard:
    """How a capture's sample axis splits over the mesh's "data" axis:
    each micro-batch of ``micro`` samples gives every rank its contiguous
    block of ``micro // data`` samples, micro-batch after micro-batch, so a
    rank's caches hold ``n_micro`` such blocks in order (a Swin window
    matmul's rows are those samples' windows)."""

    def __init__(self, mesh, micro: int, n_micro: int):
        self.mesh, self.micro, self.n_micro = mesh, micro, n_micro
        self.size = axis_size(mesh, "data")

    def sum(self, t):
        return psum(t, self.mesh, "data")

    def max(self, t):
        return pmax(t, self.mesh, "data")

    def gather(self, t):
        """Every rank's rows of ``t`` in the samples' global order."""
        g = all_gather(t, self.mesh, "data")
        per = t.shape[0] // self.n_micro
        g = g.reshape((self.size, self.n_micro, per) + tuple(t.shape[1:]))
        return g.transpose(0, 1).reshape((-1,) + tuple(t.shape[1:]))


# -- Megatron-style tensor-parallel layout ----------------------------------
# column-parallel (shard out-features): qkv (by head within each of q, k
#   and v), fc1 -- activations stay sharded on the feature axis into the
#   next op;
# row-parallel (shard in-features): proj, fc2 -- partial products are
#   summed over "model" before the bias.
_COL_SUFFIX = ("attn.qkv", "mlp.fc1")
_ROW_SUFFIX = ("attn.proj", "mlp.fc2")
_HEAD_TABLE = "relative_position_bias_table"


def tp_role(op: str) -> Optional[str]:
    """"col", "row" or None (replicated) for an op path."""
    if op.endswith(_COL_SUFFIX):
        return "col"
    if op.endswith(_ROW_SUFFIX):
        return "row"
    return None


def local_features(n: int, mesh, parts: int = 1) -> torch.Tensor:
    """Indices of this rank's features out of ``n``: each of ``parts``
    equal parts (q, k and v of qkv) split contiguously over "model"."""
    mp = axis_size(mesh, "model")
    if n % (parts * mp):
        raise ValueError(f"a width of {n} ({parts} parts) does not divide "
                         f"over model={mp}")
    per, m = n // parts, axis_rank(mesh, "model")
    loc = per // mp
    return torch.cat([torch.arange(p * per + m * loc, p * per + (m + 1) * loc)
                      for p in range(parts)])


def _op_features(op: str, n: int, mesh) -> torch.Tensor:
    return local_features(n, mesh, 3 if op.endswith("attn.qkv") else 1)


def _tp_spec(path: str):
    """(axis, op) of a param leaf that shards over "model", else None
    (``op`` None: split by head)."""
    if path.endswith(_HEAD_TABLE):
        return 1, None                      # (table, heads): by head
    op, _, leaf = path.rpartition(".")
    role = tp_role(op)
    if role == "col":
        return 0, op                        # weight (out, in), bias (out,)
    if role == "row" and leaf == "weight":
        return 1, op                        # weight sharded on in
    return None


def shard_params(params: Dict[str, Any], mesh, device=None):
    """This rank's shard of a param tree (numpy, as carried across from the
    JAX package, or torch) under the tensor-parallel layout, on its
    device; everything outside ``_tp_spec`` is replicated."""
    device = device or rank_device()

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}.{k}" if path else k)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, f"{path}.{i}") for i, v in enumerate(node)]
        t = params_from_numpy(node, device)
        spec = _tp_spec(path)
        if spec is None:
            return t
        axis, op = spec
        n = t.shape[axis]
        idx = (local_features(n, mesh) if op is None
               else _op_features(op, n, mesh))
        return t.index_select(axis, idx.to(t.device)).contiguous()
    return walk(params, "")


def check_tensor_parallel(cfg, mesh) -> None:
    """The model axis must divide every head count and hidden width (a
    scope rule of the port: GSPMD splits any size)."""
    mp = axis_size(mesh, "model")
    heads = cfg.num_heads if isinstance(cfg.num_heads, tuple) \
        else (cfg.num_heads,)
    dims = ([cfg.layer_dim(i) for i in range(len(heads))]
            if hasattr(cfg, "layer_dim") else [cfg.embed_dim])
    for h, d in zip(heads, dims):
        hid = int(d * cfg.mlp_ratio)
        if h % mp or hid % mp:
            raise ValueError(f"tensor parallelism over model={mp} needs it "
                             f"to divide the head count ({h}) and the hidden "
                             f"width ({hid})")


def _local_linear_qp(op: str, qp: LinearQP, info, mesh) -> LinearQP:
    """A LinearQP restricted to this rank's rows (column-parallel) or
    columns (row-parallel): a block grid that the split cuts is expanded
    to one interval a row / column first, so every element keeps its
    interval."""
    role = tp_role(op)
    w_iv, a_iv = qp.w_interval, qp.a_interval
    if role == "col" and w_iv.shape[0] > 1:
        oc = info["out_features"]
        idx = _op_features(op, oc, mesh).to(w_iv.device)
        w_iv = w_iv.repeat_interleave(oc // w_iv.shape[0], 0)[idx]
    if role == "row":
        ic = info["in_features"]
        idx = local_features(ic, mesh).to(w_iv.device)
        if w_iv.shape[2] > 1:
            w_iv = w_iv.repeat_interleave(ic // w_iv.shape[2], 2)[:, :, idx]
        if a_iv.shape[0] > 1:
            a_iv = a_iv.repeat_interleave(ic // a_iv.shape[0], 0)[idx]
    return dataclasses.replace(qp, w_interval=w_iv.contiguous(),
                               a_interval=a_iv.contiguous())


def _local_heads_interval(iv, heads: int, mesh):
    """A (1, n_G, 1, n_V, 1, n_H, 1) operand interval restricted to this
    rank's heads (group blocks expanded to one a head first)."""
    if iv.ndim != 7 or iv.shape[1] == 1:
        return iv
    crb = -(-heads // iv.shape[1])
    per_head = iv.repeat_interleave(crb, 1)[:, :heads]
    idx = local_features(heads, mesh).to(iv.device)
    return per_head[:, idx].contiguous()


def shard_qstate(qstate: Optional[Dict[str, Any]], mesh, op_shapes,
                 device=None):
    """This rank's view of a qstate under the tensor-parallel layout: the
    linears' intervals of its rows or columns, the attention matmuls'
    intervals of its heads; everything else whole."""
    if not qstate:
        return qstate
    qstate = qstate_to(qstate, device or rank_device())
    out = {}
    for op, qp in qstate.items():
        if isinstance(qp, LinearQP) and tp_role(op) is not None:
            qp = _local_linear_qp(op, qp, op_shapes[op], mesh)
        elif isinstance(qp, MatMulQP):
            h = op_shapes[op]["heads"]
            qp = dataclasses.replace(
                qp, A_interval=_local_heads_interval(qp.A_interval, h, mesh),
                B_interval=_local_heads_interval(qp.B_interval, h, mesh))
        out[op] = qp
    return out


# -- evaluation -------------------------------------------------------------

class Evaluator:
    """(Optionally quantized) classification accuracy: raw FP32 forward
    without a qstate, fake-quant with one, int8 with ``int8=True``,
    ``"fused"`` or ``"fused_relaxed"``.  ``data_config`` normalizes uint8 images on the device.

    ``mesh`` (``make_mesh``): the batch is padded to a multiple of the data
    axis with label -1 (never a prediction), each rank counts its rows and
    the counts are summed over "data".  ``tensor_parallel=True`` shards
    the weights over "model" (``shard_params``) for every forward: raw,
    fake-quant, ``int8=True`` and ``int8="fused"`` (whose row-parallel
    proj and fc2 sum their kernels' int32 partial products over "model"
    before the epilogue, so both int8 modes give the single device's
    logits bitwise; ``"fused_relaxed"`` likewise: its row-parallel linears
    are float outputs without GELU, the same in both modes)."""

    def __init__(self, net, qstate: Optional[Dict[str, Any]] = None,
                 mesh=None, tensor_parallel: bool = False, int8=False,
                 data_config=None, device=None):
        self.mesh = check_mesh(mesh)
        if tensor_parallel and mesh is None:
            raise ValueError("tensor_parallel=True needs a mesh")
        self.net = net
        self.int8 = int8
        self.device = torch.device(device) if device is not None else \
            net.params["head"]["weight"].device
        self._tp_mesh = None
        if tensor_parallel and axis_size(mesh, "model") > 1:
            check_tensor_parallel(net.cfg, mesh)
            self._tp_mesh = mesh
            self._params = shard_params(net.params, mesh, self.device)
            self._qstate = shard_qstate(qstate, mesh, net.op_shapes,
                                        self.device)
        else:
            self._params = params_from_numpy(net.params, self.device)
            self._qstate = qstate_to(qstate, self.device) if qstate \
                else qstate
        self._norm = None
        if data_config is not None:
            self._norm = tuple(
                torch.tensor(np.asarray(v, np.float32).reshape(1, 3, 1, 1),
                             device=self.device)
                for v in (data_config.mean, data_config.std))

    def _forward(self, x) -> torch.Tensor:
        x = torch.as_tensor(x).to(self.device)
        if self._norm is not None:
            mean, std = self._norm
            x = exact_div(exact_div(x.float(), 255.0) - mean, std)
        kw = {} if self._tp_mesh is None else {"mesh": self._tp_mesh}
        with torch.no_grad():
            return self.net.forward(self._params, x, self.net.cfg,
                                    qstate=self._qstate, int8=self.int8,
                                    **kw)

    def _pad(self, x, y=None):
        """x (and y) padded to a multiple of the data axis (y with -1)."""
        pad = (-len(x)) % axis_size(self.mesh, "data")
        x = torch.as_tensor(x)
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
            if y is not None:
                y = torch.as_tensor(y)
                y = torch.cat([y, y.new_full((pad,), -1)])
        return x, y

    def logits(self, x) -> torch.Tensor:
        """The forward's logits of a batch (uint8 images normalized on the
        device first when ``data_config`` was given); over a mesh, every
        rank returns the whole batch's."""
        if self.mesh is None:
            return self._forward(x)
        n = len(x)
        x, _ = self._pad(x)
        out = self._forward(shard_batch(x, self.mesh))
        return all_gather(out, self.mesh, "data")[:n]

    def _n_correct_dev(self, x, y) -> torch.Tensor:
        """The count of correct predictions as a device scalar (no sync)."""
        if self.mesh is not None:
            x, y = self._pad(x, y)
            x, y = shard_batch(x, self.mesh), shard_batch(y, self.mesh)
        y = torch.as_tensor(y).to(self.device)
        count = torch.sum(torch.argmax(self._forward(x), -1) == y)
        return psum(count, self.mesh, "data")

    def n_correct(self, x, y) -> int:
        return int(self._n_correct_dev(x, y))

    def evaluate(self, loader, max_iteration: Optional[int] = None,
                 verbose: bool = False) -> float:
        """Accuracy over ``loader`` ((x, y) batches).  The per-batch counts
        stay on the device and are read once at the end, so the host never
        waits for a batch."""
        counts, tot = [], 0
        for i, (x, y) in enumerate(loader):
            counts.append(self._n_correct_dev(x, y))
            tot += len(y)
            if verbose:
                print(f"\r[eval] batch {i + 1}, {tot} images", end="",
                      flush=True)
            if max_iteration is not None and i + 1 >= max_iteration:
                break
        pos = int(torch.stack(counts).sum()) if counts else 0
        if verbose:
            print(f"\r[eval] {pos}/{tot} acc={pos / max(tot, 1):.4f}")
        return pos / max(tot, 1)


def test_classification(net, loader, qstate=None, mesh=None,
                        max_iteration=None, description=None) -> float:
    """The reference's helper (example/test_vit.py:26-45)."""
    acc = Evaluator(net, qstate=qstate, mesh=mesh).evaluate(
        loader, max_iteration=max_iteration, verbose=description is not None)
    print(acc)
    return acc


test_classification.__test__ = False      # not a pytest test
