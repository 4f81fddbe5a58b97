"""The port against the literal reference's goldens.

For ``ref_tinyvit_PTQ4ViT_w8a8_hessian`` and the Swin cells
``ref_tinyswin_PTQ4ViT_w8a8_hessian`` and ``ref_tinyswin3_...`` (odd
heads) the port searches every op on the golden's own ``raw::<op>::*``
caches (no probe RNG involved) and must land on the reference's calibrated
``mod::*`` intervals, exactly or as a tie proven by the f64 oracles of
tests/test_reference_goldens.py.  A JAX qstate saved with the JAX package's
``save_qstate`` must load into the port and give the same fake-quant logits
as in JAX.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptq4vit_tpu.calib.calibrator import save_qstate as jax_save_qstate
from ptq4vit_tpu.quant.qparams import ConvQP, LinearQP, MatMulQP
from ptq4vit_tpu_torch.calib.calibrator import load_qstate
from ptq4vit_tpu_torch.models.vit import op_inventory
from tests import test_reference_goldens as G
from tests.torch_port_helpers import (assert_logits_close,
                                      assert_qstate_matches, load_golden,
                                      port_cfg, port_net, search_golden, t32)


# the cells this file holds; the other calibrated cells are in
# tests/test_torch_goldens_{metrics,ablation,policies,exact,seq}.py
CELLS = ["ref_tinyvit_PTQ4ViT_w8a8_hessian",
         "ref_tinyswin_PTQ4ViT_w8a8_hessian",
         "ref_tinyswin3_PTQ4ViT_w8a8_hessian"]


@pytest.fixture(scope="module")
def golden():
    return load_golden("ref_tinyvit_PTQ4ViT_w8a8_hessian")


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
    pq = search_golden(z, meta, jnet)
    kws = meta["ref_kwargs"]
    assert_qstate_matches(pq, mods, z, meta, jnet.op_inventory, kws)


@pytest.mark.parametrize("cell", CELLS[1:])
@pytest.mark.parametrize("scoring", ["fp32", "int8"])
def test_port_search_reproduces_swin_golden(cell, scoring):
    """The Swin cells (window attention with shifts, patch-merging
    reduction, 2-D head input; tinyswin3 has odd heads), scored in fp32 (the
    CPU default) and in int8 through the kernels' plain versions (B1, B2
    and, at these fold shapes, B3f's)."""
    z, meta, jnet, mods = load_golden(cell)
    int8 = scoring == "int8"
    pq = search_golden(z, meta, jnet, int8_score=int8, use_kernels=int8)
    assert_qstate_matches(pq, mods, z, meta, jnet.op_inventory,
                          meta["ref_kwargs"])


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
    pq = load_qstate(str(tmp_path), device="cpu")
    assert set(pq) == set(jq)
    assert pq["blocks.0.mlp.fc2"].postgelu
    assert pq["blocks.1.attn.matmul2"].split is not None
    pnet = port_net(jnet)
    for key in ("calib_x", "eval_x"):
        x = z[key]
        with torch.no_grad():
            got = pnet.apply(t32(x), qstate=pq)
        assert_logits_close(got, jnet.apply(jnp.asarray(x), qstate=jq))
