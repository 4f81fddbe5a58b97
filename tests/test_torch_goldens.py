"""The port against the literal reference's goldens.

For ``ref_tinyvit_PTQ4ViT_w8a8_hessian`` the port searches every op on the
golden's own ``raw::<op>::*`` caches (no probe RNG involved) and must land
on the reference's calibrated ``mod::*`` intervals, exactly or as a tie
proven by the f64 oracles of tests/test_reference_goldens.py.  A JAX qstate
saved with the JAX package's ``save_qstate`` must load into the port and
give the same fake-quant logits as in JAX.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptq4vit_tpu.calib.calibrator import save_qstate as jax_save_qstate
from ptq4vit_tpu.quant.qparams import ConvQP, LinearQP, MatMulQP
from ptq4vit_tpu_torch.calib import search as psearch
from ptq4vit_tpu_torch.calib.calibrator import load_qstate
from ptq4vit_tpu_torch.calib.capture import OpCapture
from ptq4vit_tpu_torch.configs import apply_modifier, ptq4vit
from ptq4vit_tpu_torch.models.vit import op_inventory
from tests import test_reference_goldens as G
from tests.torch_port_helpers import (assert_logits_close,
                                      assert_qstate_matches, port_net)

CELL = os.path.join(G.GOLDEN_DIR, "ref_tinyvit_PTQ4ViT_w8a8_hessian.npz")


@pytest.fixture(scope="module")
def golden():
    z, meta, sd, mods = G._load(CELL)
    jnet = G._build_net(meta, sd)
    for name, m in meta["modules"].items():
        if "a_neg_interval" in m:
            mods[name]["a_neg_interval"] = np.float32(m["a_neg_interval"])
    return z, meta, jnet, mods


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def port_caps(z, jnet):
    """The golden's per-op caches as port OpCaptures (conv: NCHW images
    patchified, NCHW outputs as tokens)."""
    p = jnet.cfg.patch_size
    caps = {}
    for name, mtype in jnet.op_inventory:
        raw = {k.split("::")[2]: z[k] for k in z.files
               if k.startswith(f"raw::{name}::")}
        if mtype == "qconv":
            x = raw["x"]
            S, C, H, W = x.shape
            xp = x.reshape(S, C, H // p, p, W // p, p) \
                .transpose(0, 2, 4, 1, 3, 5).reshape(S, -1, C * p * p)

            def tokens(a):
                return a.reshape(a.shape[0], a.shape[1], -1).transpose(0, 2, 1)
            caps[name] = OpCapture("conv", {"x": t(xp)},
                                   out=t(tokens(raw["out"])),
                                   grad=t(tokens(raw["grad"])))
        elif "qmatmul" in mtype:
            caps[name] = OpCapture("matmul", {"a": t(raw["A"]),
                                              "b": t(raw["B"])},
                                   out=t(raw["out"]), grad=t(raw["grad"]))
        else:
            caps[name] = OpCapture("linear", {"x": t(raw["x"])},
                                   out=t(raw["out"]), grad=t(raw["grad"]))
    return caps


def port_cfg(meta):
    cfg = ptq4vit()
    apply_modifier(cfg, bit_setting=tuple(meta["bit_setting"]),
                   metric=meta["metric"])
    return cfg


def test_policy_matches_reference(golden):
    _, meta, jnet, _ = golden
    cfg = port_cfg(meta)
    for kind, kw in (("conv", cfg.ptqsl_conv2d_kwargs),
                     ("linear", cfg.ptqsl_linear_kwargs),
                     ("matmul", cfg.ptqsl_matmul_kwargs)):
        for k in G.SEARCH_KW:
            assert kw[k] == meta["ref_kwargs"][kind][k], (kind, k)
    for name, mtype in op_inventory(port_net(jnet).cfg):
        ref_cls = meta["modules"][name]["class"]
        assert cfg.op_policy(mtype).quantizer == \
            G.REF_CLASS_TO_QUANTIZER[ref_cls], name


def test_port_search_reproduces_reference_intervals(golden):
    z, meta, jnet, mods = golden
    cfg = port_cfg(meta)
    caps = port_caps(z, jnet)
    pq = {}
    for name, mtype in jnet.op_inventory:
        pol = cfg.op_policy(mtype)
        cap = caps[name]
        if mtype == "qconv":
            pq[name] = psearch.search_conv(t(z[f"sd::{name}.weight"]),
                                           t(z[f"sd::{name}.bias"]), cap, pol)
        elif "qmatmul" in mtype:
            pq[name] = psearch.search_matmul(cap, pol)
        else:
            pq[name] = psearch.search_linear(t(z[f"sd::{name}.weight"]),
                                             t(z[f"sd::{name}.bias"]), cap,
                                             pol)
    kws = meta["ref_kwargs"]
    assert_qstate_matches(pq, mods, z, meta, jnet.op_inventory, kws)


def jax_qstate_from_golden(jnet, mods):
    """The reference's calibrated intervals as a JAX-package qstate."""
    q = {}
    for name, mtype in jnet.op_inventory:
        m = {k: jnp.asarray(v) for k, v in mods[name].items()}
        if mtype == "qconv":
            q[name] = ConvQP(w_interval=m["w_interval"])
        elif "qmatmul" in mtype:
            q[name] = MatMulQP(A_interval=m["A_interval"],
                               B_interval=m["B_interval"],
                               split=m.get("split"))
        else:
            pg = "a_neg_interval" in m
            q[name] = LinearQP(w_interval=m["w_interval"],
                               a_interval=m["a_interval"],
                               a_neg_interval=m.get("a_neg_interval"),
                               postgelu=pg)
    return q


def test_jax_qstate_cross_loads_into_the_port(golden, tmp_path):
    z, _, jnet, mods = golden
    jq = jax_qstate_from_golden(jnet, mods)
    jax_save_qstate(str(tmp_path), jq)
    pq = load_qstate(str(tmp_path))
    assert set(pq) == set(jq)
    assert pq["blocks.0.mlp.fc2"].postgelu
    assert pq["blocks.1.attn.matmul2"].split is not None
    pnet = port_net(jnet)
    for key in ("calib_x", "eval_x"):
        x = z[key]
        with torch.no_grad():
            got = pnet.apply(t(x), qstate=pq)
        assert_logits_close(got, jnet.apply(jnp.asarray(x), qstate=jq))
