"""Shared fixtures of the port's tests (tests/test_torch_*.py).

One ViT is built in both packages from the same JAX-initialized params
(carried across with ``params_from_numpy``), the probe noise is the one the
JAX package draws, and interval mismatches are adjudicated with the f64 tie
oracles of tests/test_reference_goldens.py, fed through a golden-shaped
view of the caches.  The golden helpers load a cell, build its port
config, search every op on its own caches and hold the result to the
reference's calibrated intervals.
"""
import dataclasses
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ptq4vit_tpu.models import swin as jswin
from ptq4vit_tpu.models import vit as jvit
from ptq4vit_tpu.models.registry import DataConfig, Net as JNet
from ptq4vit_tpu_torch.calib import search as psearch
from ptq4vit_tpu_torch.calib.calibrator import params_for_op
from ptq4vit_tpu_torch.calib.capture import OpCapture
from ptq4vit_tpu_torch.configs import apply_modifier, base_ptq, ptq4vit
from ptq4vit_tpu_torch.models import net_from_config
from ptq4vit_tpu_torch.models import swin as pswin
from ptq4vit_tpu_torch.models import vit as pvit
from ptq4vit_tpu_torch.utils.convert import params_from_numpy
from tests import test_reference_goldens as G

def jax_native_available(timeout=120.0, settle=0.5):
    """``ptq4vit_tpu.native.available()``, steadied against a concurrent
    build.

    The JAX loader has g++ write straight into its library's path
    (ptq4vit_tpu/native/__init__.py ``_build``), loads whatever file it
    finds there and caches a failure (``_tried``): a process whose first
    call meets another process's half-written library reports False for
    good.  Where the port's own library loads -- so g++ and libjpeg are
    there; the port builds into a temporary file and renames it -- this
    waits for the JAX library to settle (present, no older than its
    source, size and mtime unchanged for ``settle`` seconds), clears the
    cached failure under the loader's lock and loads once more.  A settled
    library that still fails to load is broken: False.  Past ``timeout``
    one last load, which builds a missing library itself."""
    from ptq4vit_tpu import native as jn
    from ptq4vit_tpu_torch import native as pn

    def retry():
        with jn._lock:
            jn._tried = False
        return jn.available()

    if jn.available():
        return True
    if not pn.available():
        return False
    deadline, last = time.monotonic() + timeout, None
    while time.monotonic() < deadline:
        try:
            st = os.stat(jn._SO)
            sig = (st.st_size, st.st_mtime_ns) \
                if st.st_mtime >= os.path.getmtime(jn._SRC) else None
        except OSError:
            sig = None
        if sig is not None and sig == last:
            return retry()
        last = sig
        time.sleep(settle)
    return retry()


# One intra-op thread per process: the suite runs in several pytest-xdist
# workers at once, and PyTorch's OpenMP threads (one per core in every
# worker) oversubscribe the cores and slow the CPU searches several-fold.
torch.set_num_threads(1)

# tests/test_capture.py CFG (the JAX package's tiny test net)
TINY = dict(img_size=32, patch_size=8, embed_dim=24, depth=2, num_heads=3,
            num_classes=10)
# wide enough for the JAX Pallas linear scorers to engage on every linear
# (pallas_tile_ok: (oc / n_V) % 128 == 0 for qkv)
WIDE = dict(img_size=32, patch_size=8, embed_dim=128, depth=1, num_heads=2,
            num_classes=10)
# tests/test_models.py tiny Swin: 32 px, patch 2 -> res 16, window 4
# (shifted windows in layer 0; layer 1 at res 8 keeps its shift), heads
# 2 and 4 (fold shapes); SWIN3 has odd heads, as the tinyswin3 golden
TINY_SWIN = dict(img_size=32, patch_size=2, embed_dim=12, depths=(2, 2),
                 num_heads=(2, 4), window_size=4, num_classes=7)
SWIN3 = dict(TINY_SWIN, num_heads=(3, 6))
# tests/test_int8_serve.py:256, the JAX fused Swin block's in-scope shape:
# res 8 in windows of 4 (stage 0, its second block shifted), then res 4,
# one unshifted window; heads of 64.  WIDE_SWIN32 has Swin-B's heads of 32
WIDE_SWIN = dict(img_size=32, patch_size=4, embed_dim=128, depths=(2, 1),
                 num_heads=(2, 4), window_size=4, num_classes=10)
WIDE_SWIN32 = dict(WIDE_SWIN, num_heads=(4, 8))


def jax_net(shape, seed=0):
    cfg = jvit.ViTConfig(name="test_vit", **shape)
    params = jvit.init_params(jax.random.PRNGKey(seed), cfg)
    return JNet(name=cfg.name, cfg=cfg, params=params, forward=jvit.forward,
                op_inventory=jvit.op_inventory(cfg),
                op_shapes=jvit.op_shapes(cfg),
                data_config=DataConfig(cfg.img_size, 1.0, (0.5,) * 3,
                                       (0.5,) * 3))


def jax_swin_net(shape, seed=1):
    cfg = jswin.SwinConfig(name="test_swin", **shape)
    params = jswin.init_params(jax.random.PRNGKey(seed), cfg)
    return JNet(name=cfg.name, cfg=cfg, params=params, forward=jswin.forward,
                op_inventory=jswin.op_inventory(cfg),
                op_shapes=jswin.op_shapes(cfg),
                data_config=DataConfig(cfg.img_size, 1.0, (0.5,) * 3,
                                       (0.5,) * 3))


def port_net(jnet, device="cpu"):
    """The port's net with the JAX net's config (ViT or Swin) and
    params."""
    cls = (pswin.SwinConfig if isinstance(jnet.cfg, jswin.SwinConfig)
           else pvit.ViTConfig)
    cfg = cls(**{f.name: getattr(jnet.cfg, f.name)
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
                if v is not None:
                    z[f"raw::{name}::{f}"] = arr(v).reshape(S, nh, nh, -1) \
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


def split_tie_check(z, meta, name, mtype, kw, port_split, ref_split):
    """f64 replay of the SoS split search (matmul.py:600-631: B raw, the
    metric over the last axis, the mean over heads and rows, summed over
    the batch; independent of B, so one curve serves both sides): both
    splits must score within TIE_TOL of the curve's range of its optimum.
    At the smallest splits nearly every softmax value sits above the split
    and the fp32 scores of neighbouring splits differ in the last ulp."""
    def f64(key):
        return torch.from_numpy(np.array(z[key], np.float64))

    A, B, raw = (f64(f"raw::{name}::{k}") for k in ("A", "B", "out"))
    grad = (f64(f"raw::{name}::grad") if kw["metric"] == "hessian"
            else None)
    qA = 2 ** (meta["A_bit"][mtype] - 1)
    splits = 2.0 ** -np.arange(20)

    def score(split):
        ai = split / (qA - 1)
        hi = (A.clamp(split, 1.0) * (qA - 1)).round().clamp(0, qA - 1) \
            / (qA - 1)
        lo = (A.clamp(0.0, split) / ai).round().clamp(0, qA - 1) * ai
        sim = G._slot_sim(raw, (hi + lo) @ B, kw["metric"], grad)
        return float(sim.mean((1, 2)).sum())

    curve = torch.tensor([score(s) for s in splits], dtype=torch.float64)
    for side, v in (("repo", port_split), ("ref", ref_split)):
        G._tie_assert(curve, v, torch.from_numpy(splits), name,
                      ("split", side))


def assert_qstate_matches(port_q, ref_mods, z, meta, inventory, kws,
                          seq=False, split_ties=()):
    """Every interval slot of the port qstate equals the reference's
    (rtol 1e-5), or both picks are proven f64 argmax ties by the golden
    tie oracles (tests/test_reference_goldens.py, TIE_TOL), chosen as
    ``test_reference_golden`` chooses them: the channelwise conv, the
    head-wise matmul and SoS B intervals, the scalar-n_H/n_a linear (the
    post-GELU twin included) and, outside sequential mode, the fully
    blocked linear; every other slot must match exactly.  The SoS split
    must match exactly too, except in the ops named in ``split_ties``,
    where both splits must be f64 ties (``split_tie_check``).  ``seq``
    scores the port's activation picks on the reference's curve
    (sequential cells)."""
    def check(repo_arr, ref_arr, name, tie):
        repo_flat = np.asarray(repo_arr, np.float64).reshape(-1)
        ref_flat = np.asarray(ref_arr, np.float64).reshape(-1)
        bad = np.nonzero(~np.isclose(repo_flat, ref_flat, rtol=1e-5))[0]
        if bad.size == 0:
            return
        if tie is None:
            np.testing.assert_allclose(repo_flat, ref_flat, rtol=1e-5,
                                       err_msg=name)
        tie(list(bad), repo_flat)

    for name, mtype in inventory:
        qp = np_fields(port_q[name])
        ref = ref_mods[name]
        if mtype == "qconv":
            channelwise = (not port_q[name].blocked
                           and qp["w_interval"].size > 1)
            check(qp["w_interval"], ref["w_interval"], name,
                  (lambda b, r, n=name: G._conv_tie_check(
                      z, meta, n, b, r, kws["conv"])) if channelwise
                  else None)
            assert port_q[name].a_interval is None
        elif "qmatmul" in mtype:
            kw = kws["matmul"]
            if "split" in qp:
                rs = float(qp["split"])
                if name in split_ties:
                    if not np.isclose(rs, float(ref["split"]), rtol=1e-6):
                        split_tie_check(z, meta, name, mtype, kw, rs,
                                        float(ref["split"]))
                else:
                    np.testing.assert_allclose(rs, float(ref["split"]),
                                               rtol=1e-6, err_msg=name)
                head_wise = (qp["B_interval"].size
                             == z[f"raw::{name}::A"].shape[1])
                check(qp["B_interval"], ref["B_interval"], name,
                      (lambda b, r, n=name, t=mtype: G._sos_b_tie_check(
                          z, meta, n, t, b, r, kw, rs, seq))
                      if head_wise else None)
            else:
                ra = qp["A_interval"].reshape(-1)
                for which in ("A", "B"):
                    check(qp[f"{which}_interval"], ref[f"{which}_interval"],
                          name, lambda b, r, n=name, t=mtype, w=which:
                          G._matmul_tie_check(z, meta, n, t, w, b, r, kw,
                                              ra, seq))
        else:
            kw = kws["linear"]
            pg = port_q[name].postgelu
            rw = qp["w_interval"].reshape(-1)
            lin_ok = (kw.get("n_H", 1) == 1 and kw.get("n_a", 1) == 1
                      and qp["a_interval"].size == 1)
            for which in ("w", "a"):
                if lin_ok:
                    tie = (lambda b, r, n=name, t=mtype, w=which:
                           G._linear_tie_check(z, meta, n, t, w, b, r, kw,
                                               rw, seq, pg))
                elif not pg and not seq:
                    tie = (lambda b, r, n=name, t=mtype, w=which:
                           G._blocked_linear_tie_check(z, meta, n, t, w, b,
                                                       r, kw))
                else:
                    tie = None
                check(qp[f"{which}_interval"], ref[f"{which}_interval"],
                      name, tie)
            if pg and "a_neg_interval" in ref:
                np.testing.assert_allclose(float(qp["a_neg_interval"]),
                                           float(ref["a_neg_interval"]),
                                           rtol=1e-6, err_msg=name)


def t32(a):
    return torch.from_numpy(np.array(a, np.float32))


def load_golden(cell):
    """(z, meta, JAX net, mods) of a golden cell by name, the twin
    post-GELU fixed interval added to mods as the reference records it."""
    z, meta, sd, mods = G._load(os.path.join(G.GOLDEN_DIR, f"{cell}.npz"))
    jnet = G._build_net(meta, sd)
    for name, m in meta["modules"].items():
        if "a_neg_interval" in m:
            mods[name]["a_neg_interval"] = np.float32(m["a_neg_interval"])
    return z, meta, jnet, mods


def port_cfg(meta):
    """The port's QuantConfig of a golden cell (the port's counterpart of
    tests/test_reference_goldens.py _build_quant_cfg)."""
    cfg = ptq4vit() if meta["config"] == "PTQ4ViT" else base_ptq()
    apply_modifier(cfg, bit_setting=tuple(meta["bit_setting"]),
                   metric=meta["metric"],
                   linear_ptq_setting=tuple(
                       meta.get("linear_ptq_setting", (1, 1, 1))),
                   no_softmax=meta.get("no_softmax") or None,
                   no_postgelu=meta.get("no_postgelu") or None)
    if meta.get("matmul_blocks"):
        cfg.ptqsl_matmul_kwargs.update(meta["matmul_blocks"])
    if meta.get("conv_metric"):
        cfg.ptqsl_conv2d_kwargs["metric"] = meta["conv_metric"]
    if meta.get("linear_metric"):
        cfg.ptqsl_linear_kwargs["metric"] = meta["linear_metric"]
    return cfg


def assert_policy_matches(cfg, meta, inventory):
    """The port policy resolves the reference's search kwargs and quantizer
    classes."""
    for kind, kw in (("conv", cfg.ptqsl_conv2d_kwargs),
                     ("linear", cfg.ptqsl_linear_kwargs),
                     ("matmul", cfg.ptqsl_matmul_kwargs)):
        for k in G.SEARCH_KW:
            assert kw[k] == meta["ref_kwargs"][kind][k], (kind, k)
    for name, mtype in inventory:
        assert cfg.op_policy(mtype).quantizer == \
            G.REF_CLASS_TO_QUANTIZER[meta["modules"][name]["class"]], name


def port_caps(z, jnet):
    """The golden's per-op caches as port OpCaptures (conv: NCHW images
    patchified, NCHW outputs as tokens)."""
    p = jnet.cfg.patch_size
    caps = {}
    for name, mtype in jnet.op_inventory:
        raw = {k.split("::")[2]: z[k] for k in z.files
               if k.startswith(f"raw::{name}::")}
        grad = t32(raw["grad"]) if "grad" in raw else None
        if mtype == "qconv":
            x = raw["x"]
            S, C, H, W = x.shape
            xp = x.reshape(S, C, H // p, p, W // p, p) \
                .transpose(0, 2, 4, 1, 3, 5).reshape(S, -1, C * p * p)

            def tokens(a):
                return a.reshape(a.shape[0], a.shape[1], -1).transpose(0, 2, 1)
            caps[name] = OpCapture("conv", {"x": t32(xp)},
                                   out=t32(tokens(raw["out"])),
                                   grad=(None if grad is None else
                                         t32(tokens(raw["grad"]))))
        elif "qmatmul" in mtype:
            caps[name] = OpCapture("matmul", {"a": t32(raw["A"]),
                                              "b": t32(raw["B"])},
                                   out=t32(raw["out"]), grad=grad)
        else:
            caps[name] = OpCapture("linear", {"x": t32(raw["x"])},
                                   out=t32(raw["out"]), grad=grad)
    return caps


def search_golden(z, meta, jnet, **kw):
    """Every op of the golden searched by the port on the golden's
    caches (the pearson linear's batch chunk pinned to the cell's batch
    size, as the calibrator pins it)."""
    cfg = port_cfg(meta)
    caps = port_caps(z, jnet)
    pq = {}
    for name, mtype in jnet.op_inventory:
        pol = cfg.op_policy(mtype)
        cap = caps[name]
        b = (t32(z[f"sd::{name}.bias"]) if f"sd::{name}.bias" in z.files
             else None)
        if mtype == "qconv":
            pq[name] = psearch.search_conv(t32(z[f"sd::{name}.weight"]), b,
                                           cap, pol)
        elif "qmatmul" in mtype:
            pq[name] = psearch.search_matmul(cap, pol, **kw)
        else:
            pq[name] = psearch.search_linear(t32(z[f"sd::{name}.weight"]), b,
                                             cap, pol,
                                             calib_bs=meta["batch_size"],
                                             **kw)
    return pq


def check_golden_cell(cell, split_ties=(), **kw):
    """Search every op of ``cell`` on its own caches and hold the port's
    intervals to the reference's ``mod::*`` (``split_ties``: see
    ``assert_qstate_matches``)."""
    z, meta, jnet, mods = load_golden(cell)
    assert_policy_matches(port_cfg(meta), meta, jnet.op_inventory)
    pq = search_golden(z, meta, jnet, **kw)
    assert_qstate_matches(pq, mods, z, meta, jnet.op_inventory,
                          meta["ref_kwargs"], split_ties=split_ties)


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


def minmax_qstate(jnet, x, bits=8, postgelu=True):
    """A JAX qstate at ``bits`` (W = A) with every main-path quantizer kind
    (channelwise conv, n_V = 3 qkv, twin post-GELU fc2, head-wise matmul1,
    SoS matmul2), its intervals from min-max over a capture of ``x``; ViT
    or Swin (whose reduction linears get the plain kind).
    ``postgelu=False`` gives fc2 the plain kind (``no_postgelu``)."""
    from ptq4vit_tpu.calib.capture import capture as jcapture
    from ptq4vit_tpu.quant import fakequant as jfq
    from ptq4vit_tpu.quant.qparams import ConvQP, LinearQP, MatMulQP
    q_ = 2 ** (bits - 1)
    caps = jcapture(jnet, x, batch_size=len(x), need_grad=False)
    q = {}
    for name, mtype in jnet.op_inventory:
        cap = caps[name]
        if mtype == "qconv":
            w = np.asarray(jnet.params["patch_embed"]["proj"]["weight"])
            wi = np.abs(w).reshape(w.shape[0], -1).max(1) / (q_ - 0.5)
            q[name] = ConvQP(w_interval=jnp.asarray(
                wi.reshape(-1, 1, 1, 1), jnp.float32), w_bit=bits)
        elif "qmatmul" in mtype:
            G = cap.inputs["a"].shape[1]
            bi = jfq.matmul_operand_interval_init(
                jnp.asarray(cap.inputs["b"]), G, 1, 1, q_)
            if mtype == "qmatmul_scorev":
                split = jnp.float32(2.0 ** -5)
                q[name] = MatMulQP(A_interval=split / (q_ - 1),
                                   B_interval=bi, split=split, A_bit=bits,
                                   B_bit=bits)
            else:
                q[name] = MatMulQP(A_interval=jfq.matmul_operand_interval_init(
                    jnp.asarray(cap.inputs["a"]), G, 1, 1, q_),
                    B_interval=bi, A_bit=bits, B_bit=bits)
        else:
            node = jnet.params
            for part in name.split("."):
                node = node[int(part)] if isinstance(node, list) else node[part]
            n_V = 3 if mtype == "qlinear_qkv" else 1
            pg = postgelu and mtype == "qlinear_MLP_2"
            x_in = jnp.asarray(cap.inputs["x"])
            q[name] = LinearQP(
                w_interval=jfq.blocked_weight_interval_init(
                    node["weight"], n_V, 1, q_),
                a_interval=jfq.grouped_act_interval_init(x_in, 1, q_,
                                                         signed=not pg),
                a_neg_interval=(jnp.float32(jfq.GELU_NEG_CLIP / q_)
                                if pg else None),
                w_bit=bits, a_bit=bits, postgelu=pg)
    return q
