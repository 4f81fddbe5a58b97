"""Window 7 (N = 49: a row and key tail in every 16- and 64-row tile) and
three heads, the 224-px Swins' shapes, against the JAX package on the CPU.

W7 is a small window-7 Swin: 28 px in patches of 2, embed 24, depths
(2, 2), heads (3, 6).  Stage 1 is res 14: 4 windows of 49, its second
block shifted by 3; stage 2 is res 7: one window, clamped, no shift (the
224-px models' stage 4).  Checked:

  * B3's plain version (``matmul_hessian_sims_ref``) against the JAX
    ``matmul_hessian_sims`` in interpret mode at (S, G, 49, 32) window
    shapes, modes a, b and b_sos: at 3 heads (fold 1, JAX's unfolded body,
    B3 on the card: Swin-T / S stage 1) and at 4 (fold 4, the folded body,
    B3f: Swin-B/224 stage 1); sims rtol 1e-5, argmax equal unless a 1e-5
    tie;
  * ``mm_fold_factor`` against the JAX ``_mm_fold_factor`` at every op
    shape of every zoo Swin;
  * W7's geometry, raw logits and capture taps against JAX's;
  * the PTQ4ViT W8A8 qstate (eq_n 8, one round, the JAX probe noise)
    against the JAX calibrator's, intervals equal (rtol 1e-5) or both
    picks f64 argmax ties (the tie oracles of the other Swin tests);
  * under JAX's calibrated qstate: fake-quant logits within 1e-2 of max
    |logit| (level flips compound through the quantizers, as in
    tests/test_torch_swin.py), exact int8 within 1e-3
    (``assert_logits_close``).

The fused and relaxed window-7 paths: tests/test_torch_window7_fused.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ptq4vit_tpu_torch
from ptq4vit_tpu.calib.calibrator import HessianQuantCalibrator
from ptq4vit_tpu.calib.capture import capture as jcapture
from ptq4vit_tpu.configs import ptq4vit as jptq4vit
from ptq4vit_tpu.ops import pallas_search as jps
from ptq4vit_tpu_torch.configs import ptq4vit as pptq4vit
from ptq4vit_tpu_torch.models import MODEL_ZOO, model_config
from ptq4vit_tpu_torch.models.registry import _model_module
from ptq4vit_tpu_torch.ops import search_kernels as sk
from ptq4vit_tpu_torch.utils.convert import qstate_from_numpy
from tests.test_torch_cuda import Q, T, matmul_case
from tests.test_torch_swin_search import close_sims
from tests.torch_port_helpers import (assert_logits_close,
                                      assert_qstate_matches, bits_meta,
                                      golden_view, images, jax_probe_u,
                                      jax_swin_net, np_fields, port_net,
                                      shrink)

W7 = dict(img_size=28, patch_size=2, embed_dim=24, depths=(2, 2),
          num_heads=(3, 6), window_size=7, num_classes=10)
PROBE_SEED = 3
SWINS = sorted(n for n, z in MODEL_ZOO.items() if z["kind"] == "swin")


@pytest.mark.parametrize("heads", [3, 4], ids=["B3", "B3f"])
@pytest.mark.parametrize("mode", ["a", "b", "b_sos"])
def test_window7_ref_matches_pallas(monkeypatch, heads, mode):
    """At (2 windows, ``heads``, 49 rows, head dim 32) in bf16 (the card's
    cache dtype): 3 heads do not fold (JAX's ``_mm_kernel``, B3), 4 fold
    by 4 (``_mm_kernel_folded``, B3f)."""
    monkeypatch.delenv("PTQ4VIT_TPU_MM_FOLD", raising=False)
    rng = np.random.default_rng(70 + heads)
    A, B, g, cands, fixed, sos = matmul_case(
        rng, mode, "bf16", (2, heads, 49, 32, 49, 6))
    F = jps._mm_fold_factor(A.shape[1], A.shape[3], B.shape[3])
    assert F == sk.mm_fold_factor(A.shape[1], A.shape[3], B.shape[3])
    assert F == (1 if heads == 3 else 4)
    sv = None if sos is None else [float(v) for v in sos]
    got = sk.matmul_hessian_sims(T(A, torch.bfloat16), T(B, torch.bfloat16),
                                 T(g, torch.bfloat16), T(cands), T(fixed),
                                 mode, Q, Q, sv)
    ref = jps.matmul_hessian_sims(
        jnp.asarray(A, jnp.bfloat16), jnp.asarray(B, jnp.bfloat16),
        jnp.asarray(g, jnp.bfloat16), jnp.asarray(cands), jnp.asarray(fixed),
        mode, Q, Q,
        sos=None if sos is None else tuple(jnp.float32(v) for v in sos),
        interpret=True)
    close_sims(got, ref)


@pytest.mark.parametrize("name", SWINS)
def test_mm_fold_factor_matches_jax_at_every_zoo_swin(monkeypatch, name):
    """Every matmul shape of the zoo Swin folds as JAX folds it; the
    224-px Swin-T / S run stage 1 (3 heads) unfolded, the rest folded."""
    monkeypatch.delenv("PTQ4VIT_TPU_MM_FOLD", raising=False)
    cfg = model_config(name)
    folds = {}
    for op, info in _model_module(cfg).op_shapes(cfg).items():
        if info["kind"] != "matmul":
            continue
        G, Ci, Co = info["heads"], info["inner"], info["cols"]
        f = sk.mm_fold_factor(G, Ci, Co)
        assert f == jps._mm_fold_factor(G, Ci, Co), (op, G, Ci, Co)
        folds.setdefault(int(op.split(".")[1]), set()).add(f)
    if cfg.num_heads[0] == 3:
        assert folds[0] == {1} and all(1 not in folds[i] for i in (1, 2, 3))
    else:
        assert all(1 not in f for f in folds.values())


def test_window7_geometry_and_logits_match_jax():
    """Stage 1 (res 14): windows of 7, the odd block shifted by 3; stage 2
    (res 7): the window clamped to the resolution, no shift; raw logits,
    op inventory and shapes, and every capture tap equal JAX's."""
    jnet = jax_swin_net(W7)
    pnet = port_net(jnet)
    cfg = pnet.cfg
    assert [cfg.block_geometry(i, j) for i in range(2) for j in range(2)] \
        == [(7, 0), (7, 3), (7, 0), (7, 0)]
    x = images(2, 28)
    assert_logits_close(pnet.apply(torch.from_numpy(x)),
                        jnet.apply(jnp.asarray(x)), raw=True)
    assert pnet.op_inventory == jnet.op_inventory
    assert pnet.op_shapes == jnet.op_shapes
    _, ptaps = pnet.apply(torch.from_numpy(x), capture=True)
    _, jtaps = jnet.apply(jnp.asarray(x), capture=True)
    assert list(ptaps) == list(jtaps)
    for name in ptaps:
        for field in ptaps[name]:
            np.testing.assert_allclose(
                ptaps[name][field].numpy(), np.asarray(jtaps[name][field]),
                rtol=1e-5, atol=1e-6 * float(np.abs(jtaps[name][field])
                                             .max()), err_msg=name)
    assert ptaps["layers.0.blocks.1.attn.matmul1"]["a"].shape == \
        (2 * 4, 3, 49, 8)
    assert ptaps["layers.1.blocks.1.attn.matmul2"]["a"].shape == \
        (2, 6, 49, 49)


@pytest.fixture(scope="module")
def calibrated():
    jnet = jax_swin_net(W7)
    pnet = port_net(jnet)
    x = images(8, 28)
    jcfg = shrink(jptq4vit())
    jq = HessianQuantCalibrator(jnet, jcfg, x, batch_size=4,
                                probe_seed=PROBE_SEED) \
        .batching_quant_calib(verbose=False)
    _, pq = ptq4vit_tpu_torch.quantize(
        pnet, x, config=shrink(pptq4vit()), batch_size=4, device="cpu",
        probe_u=jax_probe_u(8, W7["num_classes"], PROBE_SEED))
    return jnet, pnet, x, jcfg, jq, pq


def test_window7_quantize_matches_jax(calibrated):
    jnet, _, x, jcfg, jq, pq = calibrated
    assert set(pq) == set(jq) == {n for n, _ in jnet.op_inventory}
    assert pq["layers.0.blocks.1.attn.matmul2"].split is not None
    caps = jcapture(jnet, x, batch_size=4, need_grad=True,
                    probe_seed=PROBE_SEED)
    mods = {n: np_fields(q) for n, q in jq.items()}
    z = golden_view(jax.tree.map(np.asarray, jnet.params), caps, mods,
                    W7["patch_size"])
    kws = {"conv": jcfg.ptqsl_conv2d_kwargs,
           "linear": jcfg.ptqsl_linear_kwargs,
           "matmul": jcfg.ptqsl_matmul_kwargs}
    assert_qstate_matches(pq, mods, z, bits_meta(jcfg, W7["patch_size"]),
                          jnet.op_inventory, kws)


def test_window7_fake_quant_and_int8_logits_match_jax(calibrated):
    """Under JAX's calibrated qstate: fake-quant within 1e-2 of max
    |logit|, exact int8 within 1e-3 (``assert_logits_close``)."""
    jnet, pnet, x, _, jq, _ = calibrated
    pq = qstate_from_numpy(jq)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    jl = np.asarray(jnet.apply(xj, qstate=jq))
    assert np.abs(pnet.apply(xt, qstate=pq).numpy() - jl).max() <= \
        1e-2 * np.abs(jl).max()
    assert_logits_close(pnet.apply(xt, qstate=pq, int8=True),
                        np.asarray(jnet.apply(xj, qstate=jq, int8=True)))
