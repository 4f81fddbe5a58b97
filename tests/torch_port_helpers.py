"""Shared fixtures of the port's tests (tests/test_torch_*.py).

One ViT is built in both packages from the same JAX-initialized params
(carried across with ``params_from_numpy``), the probe noise is the one the
JAX package draws, and interval mismatches are adjudicated with the f64 tie
oracles of tests/test_reference_goldens.py, fed through a golden-shaped
view of the caches.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ptq4vit_tpu.models import vit as jvit
from ptq4vit_tpu.models.registry import DataConfig, Net as JNet
from ptq4vit_tpu_torch.calib.calibrator import params_for_op
from ptq4vit_tpu_torch.models import net_from_config
from ptq4vit_tpu_torch.models import vit as pvit
from ptq4vit_tpu_torch.utils.convert import params_from_numpy
from tests import test_reference_goldens as G

# tests/test_capture.py CFG (the JAX package's tiny test net)
TINY = dict(img_size=32, patch_size=8, embed_dim=24, depth=2, num_heads=3,
            num_classes=10)
# wide enough for the JAX Pallas linear scorers to engage on every linear
# (pallas_tile_ok: (oc / n_V) % 128 == 0 for qkv)
WIDE = dict(img_size=32, patch_size=8, embed_dim=128, depth=1, num_heads=2,
            num_classes=10)


def jax_net(shape, seed=0):
    cfg = jvit.ViTConfig(name="test_vit", **shape)
    params = jvit.init_params(jax.random.PRNGKey(seed), cfg)
    return JNet(name=cfg.name, cfg=cfg, params=params, forward=jvit.forward,
                op_inventory=jvit.op_inventory(cfg),
                op_shapes=jvit.op_shapes(cfg),
                data_config=DataConfig(cfg.img_size, 1.0, (0.5,) * 3,
                                       (0.5,) * 3))


def port_net(jnet, device="cpu"):
    """The port's net with the JAX net's config and params."""
    cfg = pvit.ViTConfig(**{f.name: getattr(jnet.cfg, f.name)
                            for f in dataclasses.fields(jnet.cfg)})
    return net_from_config(cfg, params_from_numpy(
        jax.tree.map(np.asarray, jnet.params), device))


def jax_probe_u(num, classes, seed):
    """The probe noise the JAX capture draws (capture.py:474)."""
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                        (num, classes), jnp.float32))


def images(n, size, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (n, 3, size, size)).astype(np.float32)


def shrink(cfg, eq_n=8, rounds=1):
    """tests/test_calibrator.small_cfg for either package's QuantConfig."""
    for kw in (cfg.ptqsl_conv2d_kwargs, cfg.ptqsl_linear_kwargs,
               cfg.ptqsl_matmul_kwargs):
        kw["eq_n"] = eq_n
        kw["search_round"] = rounds
    return cfg


def np_fields(qp):
    """{field: numpy array} of a QP's array fields (either package)."""
    out = {}
    for f in dataclasses.fields(qp):
        v = getattr(qp, f.name)
        if torch.is_tensor(v):
            out[f.name] = v.detach().cpu().numpy()
        elif v is not None and hasattr(v, "shape"):
            out[f.name] = np.asarray(v)
    return out


class Caches(dict):
    """A dict that reads like an npz golden (``z[key]``, ``z.files``)."""

    @property
    def files(self):
        return list(self.keys())


def golden_view(params, caps, mods, patch_size):
    """Golden-shaped view of captured caches for the tie oracles.

    params: numpy param tree; caps: {op: OpCapture} with numpy or tensor
    arrays (conv input patchified); mods: {op: {field: array}} — the
    intervals the oracles call "ref"."""
    z = Caches()

    def arr(a):
        return a.detach().cpu().numpy() if torch.is_tensor(a) \
            else np.asarray(a)

    for name, cap in caps.items():
        kind = cap.kind
        if kind != "matmul":
            w, b = params_for_op(params, name)
            z[f"sd::{name}.weight"] = np.asarray(w)
            if b is not None:
                z[f"sd::{name}.bias"] = np.asarray(b)
        if kind == "matmul":
            z[f"raw::{name}::A"] = arr(cap.inputs["a"])
            z[f"raw::{name}::B"] = arr(cap.inputs["b"])
            z[f"raw::{name}::out"] = arr(cap.out)
            z[f"raw::{name}::grad"] = arr(cap.grad)
        elif kind == "conv":
            # (S, N, C*p*p) patches / (S, N, oc) tokens -> NCHW
            x = arr(cap.inputs["x"])
            S, N, _ = x.shape
            nh = int(round(N ** 0.5))
            c = x.shape[-1] // (patch_size * patch_size)
            img = x.reshape(S, nh, nh, c, patch_size, patch_size) \
                .transpose(0, 3, 1, 4, 2, 5) \
                .reshape(S, c, nh * patch_size, nh * patch_size)
            z[f"raw::{name}::x"] = img
            for f, v in (("out", cap.out), ("grad", cap.grad)):
                t = arr(v)
                z[f"raw::{name}::{f}"] = t.reshape(S, nh, nh, -1) \
                    .transpose(0, 3, 1, 2)
        else:
            z[f"raw::{name}::x"] = arr(cap.inputs["x"])
            z[f"raw::{name}::out"] = arr(cap.out)
            z[f"raw::{name}::grad"] = arr(cap.grad)
        for f, v in mods[name].items():
            z[f"mod::{name}::{f}"] = np.asarray(v)
    return z


def bits_meta(cfg, patch_size):
    """The golden ``meta`` fields the tie oracles read."""
    return {"w_bit": dict(cfg.w_bit), "a_bit": dict(cfg.a_bit),
            "A_bit": dict(cfg.A_bit), "B_bit": dict(cfg.B_bit),
            "cfg": {"patch_size": patch_size}}


def assert_qstate_matches(port_q, ref_mods, z, meta, inventory, kws):
    """Every interval slot of the port qstate equals the reference's
    (rtol 1e-5), or both picks are proven f64 argmax ties by the golden
    tie oracles (tests/test_reference_goldens.py, TIE_TOL)."""
    def check(repo_arr, ref_arr, name, tie):
        repo_flat = np.asarray(repo_arr, np.float64).reshape(-1)
        ref_flat = np.asarray(ref_arr, np.float64).reshape(-1)
        bad = np.nonzero(~np.isclose(repo_flat, ref_flat, rtol=1e-5))[0]
        if bad.size:
            tie(list(bad), repo_flat)

    for name, mtype in inventory:
        qp = np_fields(port_q[name])
        ref = ref_mods[name]
        if mtype == "qconv":
            check(qp["w_interval"], ref["w_interval"], name,
                  lambda b, r, n=name: G._conv_tie_check(
                      z, meta, n, b, r, kws["conv"]))
            assert port_q[name].a_interval is None
        elif "qmatmul" in mtype:
            kw = kws["matmul"]
            if "split" in qp:
                np.testing.assert_allclose(float(qp["split"]),
                                           float(ref["split"]), rtol=1e-6,
                                           err_msg=name)
                rs = float(qp["split"])
                check(qp["B_interval"], ref["B_interval"], name,
                      lambda b, r, n=name, t=mtype: G._sos_b_tie_check(
                          z, meta, n, t, b, r, kw, rs))
            else:
                ra = qp["A_interval"].reshape(-1)
                for which in ("A", "B"):
                    check(qp[f"{which}_interval"], ref[f"{which}_interval"],
                          name, lambda b, r, n=name, t=mtype, w=which:
                          G._matmul_tie_check(z, meta, n, t, w, b, r, kw,
                                              ra))
        else:
            kw = kws["linear"]
            pg = port_q[name].postgelu
            rw = qp["w_interval"].reshape(-1)
            for which in ("w", "a"):
                check(qp[f"{which}_interval"], ref[f"{which}_interval"],
                      name, lambda b, r, n=name, t=mtype, w=which:
                      G._linear_tie_check(z, meta, n, t, w, b, r, kw, rw,
                                          False, pg))
            if pg and "a_neg_interval" in ref:
                np.testing.assert_allclose(float(qp["a_neg_interval"]),
                                           float(ref["a_neg_interval"]),
                                           rtol=1e-6, err_msg=name)


def assert_logits_close(port_logits, jax_logits, raw=False):
    """Raw logits: rtol 1e-5, atol 1e-6.  Fake-quant logits: max abs diff
    <= 1e-3 * max|logit| (a last-ulp matmul difference can flip one
    quantization level)."""
    p = port_logits.detach().cpu().numpy() if torch.is_tensor(port_logits) \
        else np.asarray(port_logits)
    j = np.asarray(jax_logits)
    assert p.shape == j.shape
    if raw:
        np.testing.assert_allclose(p, j, rtol=1e-5, atol=1e-6)
    else:
        assert np.abs(p - j).max() <= 1e-3 * np.abs(j).max()
