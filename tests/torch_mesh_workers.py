"""Rank workers of the port's mesh tests (tests/test_torch_parallel*.py).

The pytest process writes one job file (numpy params, images, tasks) and
starts the ranks with ``ptq4vit_tpu_torch.parallel.launch.spawn``; every
rank runs this module's ``run`` on the same job and writes its results to
``rank{r}.pt`` in the output directory, so several tests read one spawn.
This module imports neither JAX nor the JAX package.
"""
import dataclasses
import os
import pickle
import time

import numpy as np
import torch
import torch.distributed as dist

from ptq4vit_tpu_torch.calib.calibrator import HessianQuantCalibrator
from ptq4vit_tpu_torch.calib.capture import capture
from ptq4vit_tpu_torch.configs import get_config
from ptq4vit_tpu_torch.models import net_from_config
from ptq4vit_tpu_torch.models import swin as pswin
from ptq4vit_tpu_torch.models import vit as pvit
from ptq4vit_tpu_torch.parallel import (Evaluator, ServingEngine, make_mesh,
                                        shard_params, spawn)
from ptq4vit_tpu_torch.parallel.mesh import axis_rank
from ptq4vit_tpu_torch.utils.convert import params_from_numpy, qp_from_fields

CFG_CLASSES = {"vit": pvit.ViTConfig, "swin": pswin.SwinConfig}


def build_net(spec):
    """(kind, config fields, numpy params) -> the port's net on the CPU."""
    kind, fields, params = spec
    cfg = CFG_CLASSES[kind](**fields)
    return net_from_config(cfg, params_from_numpy(params, "cpu"))


def qstate_to_np(qstate):
    """{op: (kind, {field: numpy array or value})}."""
    out = {}
    for op, qp in qstate.items():
        fields = {}
        for f in dataclasses.fields(qp):
            v = getattr(qp, f.name)
            fields[f.name] = v.detach().cpu().numpy() if torch.is_tensor(v) \
                else v
        out[op] = (type(qp).__name__, fields)
    return out


def qstate_from_np(q):
    return None if q is None else {
        op: qp_from_fields(kind, fields, "cpu")
        for op, (kind, fields) in q.items()}


def quant_config(spec):
    """(name, eq_n, rounds, bits[, updates]) -> a shrunk QuantConfig;
    ``updates`` holds "conv" / "linear" / "matmul" kwargs and config
    "attrs"."""
    name, eq_n, rounds, bits = spec[:4]
    updates = spec[4] if len(spec) > 4 else {}
    cfg = get_config(name).set_bits(*bits)
    for key, kw in (("conv", cfg.ptqsl_conv2d_kwargs),
                    ("linear", cfg.ptqsl_linear_kwargs),
                    ("matmul", cfg.ptqsl_matmul_kwargs)):
        kw["eq_n"], kw["search_round"] = eq_n, rounds
        kw.update(updates.get(key, {}))
    for k, v in updates.get("attrs", {}).items():
        setattr(cfg, k, v)
    return cfg


def task_calib(mesh, t):
    net = build_net(t["net"])
    kw = dict(t.get("kw", {}))
    cal = HessianQuantCalibrator(net, quant_config(t["config"]), t["x"],
                                 mesh=mesh, device="cpu", **kw)
    q = cal.batching_quant_calib(verbose=False)
    return {"qstate": qstate_to_np(q), "equals_rank0": equals_rank0(q),
            "searched": sorted(cal.report.search_seconds)}


def equals_rank0(qstate) -> bool:
    """Every tensor of this rank's qstate equals rank 0's, broadcast."""
    same = True
    for op in sorted(qstate):
        for f in dataclasses.fields(qstate[op]):
            v = getattr(qstate[op], f.name)
            if torch.is_tensor(v):
                r0 = v.clone()
                dist.broadcast(r0, src=0)
                same &= torch.equal(r0, v)
    return same


def task_capture(mesh, t):
    net = build_net(t["net"])
    raw = capture(net, t["x"], batch_size=t["batch_size"], need_grad=True,
                  probe_u=t["probe_u"], mesh=mesh)
    out = {}
    for op in t["ops"]:
        cap = raw[op]
        rows = {"x" if "x" in cap.inputs else "a": next(iter(
            cap.inputs.values())), "grad": cap.grad}
        out[op] = {k: (v if cap.shard is None else cap.shard.gather(v))
                   .numpy() for k, v in rows.items()}
    return out


SPIED = ("fused_vit_block", "fused_swin_block", "row_parallel")


def task_eval(mesh, t):
    """The counts and logits; under ``int8="fused"`` also how many whole
    blocks took the fused path and how many row-parallel linears ran
    (spies on ops.int8_serve, the counts of one ``logits`` call)."""
    from ptq4vit_tpu_torch.ops import int8_serve
    net = build_net(t["net"])
    ev = Evaluator(net, qstate=qstate_from_np(t.get("qstate")), mesh=mesh,
                   tensor_parallel=t.get("tp", False),
                   int8=t.get("int8", False), device="cpu")
    out = {"n_correct": ev.n_correct(t["x"], t["y"])}
    hits = dict.fromkeys(SPIED, 0)
    origs = {k: getattr(int8_serve, k) for k in SPIED}

    def spy(key):
        def run(*a, **kw):
            res = origs[key](*a, **kw)
            hits[key] += res is not None
            return res
        return run
    for k in SPIED:
        setattr(int8_serve, k, spy(k))
    try:
        out["logits"] = ev.logits(t["x"]).numpy()
    finally:
        for k, fn in origs.items():
            setattr(int8_serve, k, fn)
    out["hits"] = hits
    if "loader" in t:
        out["accuracy"] = ev.evaluate(t["loader"])
    return out


def task_serve(mesh, t):
    """The engine's fp32 logits, and how many whole Swin blocks took the
    fused path (a spy on ops.int8_serve.fused_swin_block)."""
    from ptq4vit_tpu_torch.ops import int8_serve
    net = build_net(t["net"])
    eng = ServingEngine(net, qstate_from_np(t["qstate"]), mesh=mesh,
                        compute_dtype=torch.float32, device="cpu")
    hits = [0]
    orig = int8_serve.fused_swin_block

    def spy(*a, **kw):
        out = orig(*a, **kw)
        hits[0] += out is not None
        return out
    int8_serve.fused_swin_block = spy
    try:
        logits = eng(t["x"]).numpy()
    finally:
        int8_serve.fused_swin_block = orig
    return {"logits": logits, "fused_swin_blocks": hits[0]}


def task_shard_params(mesh, t):
    net = build_net(t["net"])
    local = shard_params(t["net"][2], mesh, "cpu")
    blk = local["blocks"][0]
    return {"coord": (axis_rank(mesh, "data"), axis_rank(mesh, "model")),
            "qkv": blk["attn"]["qkv"]["weight"].numpy(),
            "qkv_bias": blk["attn"]["qkv"]["bias"].numpy(),
            "proj": blk["attn"]["proj"]["weight"].numpy(),
            "proj_bias": blk["attn"]["proj"]["bias"].numpy(),
            "fc1": blk["mlp"]["fc1"]["weight"].numpy(),
            "fc2": blk["mlp"]["fc2"]["weight"].numpy(),
            "head": local["head"]["weight"].numpy(),
            "full_head": net.params["head"]["weight"].numpy()}


def task_errors(mesh, t):
    """{case: (exception type, message) or None} of the scope rules."""
    net = build_net(t["net"])
    q = qstate_from_np(t["qstate"])
    x = t["x"]
    out = {}

    def catch(key, fn):
        try:
            fn()
            out[key] = None
        except Exception as e:          # recorded for the test to judge
            out[key] = (type(e).__name__, str(e))

    catch("tp_heads", lambda: Evaluator(net, mesh=mesh, tensor_parallel=True,
                                        device="cpu"))
    catch("serve_batch", lambda: ServingEngine(net, q, mesh=mesh,
                                               device="cpu")(x[:3]))
    catch("capture", lambda: capture(net, x[:3], batch_size=4,
                                     need_grad=False, mesh=mesh))
    return out


TASKS = {"calib": task_calib, "capture": task_capture, "eval": task_eval,
         "serve": task_serve, "shard_params": task_shard_params,
         "errors": task_errors}


def fail_on_rank1(rank):
    """Rank 1 raises; rank 0 waits in a collective for it."""
    if rank == 1:
        raise RuntimeError("rank 1 failed on purpose")
    dist.barrier()


def hang_on_rank1(rank):
    """Rank 1 never joins rank 0's collective."""
    if rank == 1:
        time.sleep(120)
    dist.all_reduce(torch.ones(1))


def run(rank, job_path, out_dir):
    torch.set_num_threads(1)
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    mesh = make_mesh(job["world"], job.get("model_parallel", 1))
    results = {key: TASKS[t["task"]](mesh, t)
               for key, t in job["tasks"].items()}
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))


def run_job(tmp_path, world, tasks, model_parallel=1):
    """Every rank's results ([rank 0's, rank 1's, ...]) of ``tasks`` run on
    ``world`` gloo ranks of the CPU, rendezvous through a file under
    ``tmp_path``."""
    tmp_path = str(tmp_path)
    job = os.path.join(tmp_path, "job.pkl")
    with open(job, "wb") as f:
        pickle.dump({"world": world, "model_parallel": model_parallel,
                     "tasks": tasks}, f)
    spawn(run, world, devices=["cpu"] * world,
          init_method="file://" + os.path.join(tmp_path, "rendezvous"),
          args=(job, tmp_path))
    return [torch.load(os.path.join(tmp_path, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def np_tree(tree):
    """A param tree (JAX arrays, numpy) as numpy float32 arrays."""
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [np_tree(v) for v in tree]
    return np.asarray(tree, np.float32)


def net_spec(jnet):
    """(kind, config fields, numpy params) of a JAX-package net: the same
    weights carried across, for ``build_net``."""
    kind = "swin" if hasattr(jnet.cfg, "depths") else "vit"
    fields = {f.name: getattr(jnet.cfg, f.name)
              for f in dataclasses.fields(jnet.cfg)}
    return kind, fields, np_tree(jnet.params)


def assert_same_qstates(got, want, rtol=1e-5):
    assert set(got) == set(want)
    for op, (kind, fields) in want.items():
        assert got[op][0] == kind
        for f, v in fields.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_allclose(got[op][1][f], v, rtol=rtol,
                                           atol=0, err_msg=f"{op}.{f}")
            else:
                assert got[op][1][f] == v, (op, f)


def assert_rank_identical(results, key):
    """Every rank's qstate is rank 0's, byte for byte: broadcast from rank
    0 in the ranks, and compared here."""
    assert all(r[key]["equals_rank0"] for r in results)
    q0 = results[0][key]["qstate"]
    for r in results[1:]:
        for op, (_, fields) in r[key]["qstate"].items():
            for f, v in fields.items():
                if isinstance(v, np.ndarray):
                    assert v.tobytes() == q0[op][1][f].tobytes(), (op, f)
