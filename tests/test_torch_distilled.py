"""A distilled DeiT (a distillation token beside the class token, N =
patches + 2, and a second classifier ``head_dist`` on token 1, averaged
with ``head``) against the JAX package on the CPU.

DEIT is the tiny ViT of tests/test_capture.py (32 px, patches of 8,
embed 24, depth 2, 3 heads) with the distilled head: 18 tokens.
Checked:

  * the PTQ4ViT W8A8 calibration (eq_n 8, one round, the JAX probe noise):
    every op's intervals, ``head_dist`` searched as a
    ``qlinear_classifier`` too, equal to the JAX calibrator's (rtol 1e-5)
    or both picks f64 argmax ties (tests/test_reference_goldens.py's
    oracles);
  * under JAX's calibrated qstate, the exact int8 logits within 1e-3 of
    max |logit| (``assert_logits_close``) and the fused int8 logits
    (``head_dist`` through B6's plain version on token 1) at JAX's fused
    tolerance (rtol 1e-3, atol 2e-3 of max |logit|, argmax equal) against
    JAX's; the relaxed forward within JAX's relaxed bound (10% of max
    |exact fused logit|);
  * ``ServingEngine`` on ``device="cpu"`` (bf16 and fp32, exact and
    relaxed): the port's own fused forward on the packed weights,
    bitwise.
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
from ptq4vit_tpu.ops.pack import pack_weights as jpack
from ptq4vit_tpu_torch import ServingEngine
from ptq4vit_tpu_torch.configs import ptq4vit as pptq4vit
from ptq4vit_tpu_torch.ops import int8_serve as pserve
from ptq4vit_tpu_torch.ops.pack import pack_weights
from ptq4vit_tpu_torch.quant.qparams import LinearQP
from ptq4vit_tpu_torch.utils.convert import qstate_from_numpy
from tests.test_torch_int8_serve_block import close
from tests.torch_port_helpers import (TINY, assert_logits_close,
                                      assert_qstate_matches, bits_meta,
                                      golden_view, images, jax_net,
                                      jax_probe_u, np_fields, port_net,
                                      shrink)

DEIT = dict(TINY, distilled=True)
PROBE_SEED = 3


@pytest.fixture(scope="module")
def calibrated():
    jnet = jax_net(DEIT)
    pnet = port_net(jnet)
    x = images(8, 32)
    jcfg = shrink(jptq4vit())
    jq = HessianQuantCalibrator(jnet, jcfg, x, batch_size=4,
                                probe_seed=PROBE_SEED) \
        .batching_quant_calib(verbose=False)
    _, pq = ptq4vit_tpu_torch.quantize(
        pnet, x, config=shrink(pptq4vit()), batch_size=4, device="cpu",
        probe_u=jax_probe_u(8, DEIT["num_classes"], PROBE_SEED))
    return jnet, pnet, x, jcfg, jq, pq


def test_distilled_net_shape():
    """18 tokens (16 patches, cls, dist), the second head last in the
    inventory, as a classifier."""
    pnet = port_net(jax_net(DEIT))
    assert pnet.cfg.seq_len == 18
    assert pnet.op_inventory[-2:] == [("head", "qlinear_classifier"),
                                      ("head_dist", "qlinear_classifier")]
    assert pnet.op_shapes["head_dist"] == pnet.op_shapes["head"]


def test_distilled_quantize_matches_jax(calibrated):
    jnet, _, x, jcfg, jq, pq = calibrated
    assert set(pq) == set(jq) == {n for n, _ in jnet.op_inventory}
    assert isinstance(pq["head_dist"], LinearQP)
    assert not torch.equal(pq["head_dist"].w_interval,
                           pq["head"].w_interval)
    caps = jcapture(jnet, x, batch_size=4, need_grad=True,
                    probe_seed=PROBE_SEED)
    mods = {n: np_fields(q) for n, q in jq.items()}
    z = golden_view(jax.tree.map(np.asarray, jnet.params), caps, mods,
                    DEIT["patch_size"])
    kws = {"conv": jcfg.ptqsl_conv2d_kwargs,
           "linear": jcfg.ptqsl_linear_kwargs,
           "matmul": jcfg.ptqsl_matmul_kwargs}
    assert_qstate_matches(pq, mods, z, bits_meta(jcfg, DEIT["patch_size"]),
                          jnet.op_inventory, kws)


def test_distilled_int8_logits_match_jax(calibrated, monkeypatch):
    """Exact int8 and fused int8 (each block fused: 4 B6 and one B7 a
    block, then the two heads through B6) under JAX's qstate against
    JAX's, and the relaxed mode against JAX's relaxed mode."""
    jnet, pnet, x, _, jq, _ = calibrated
    pq = qstate_from_numpy(jq)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    assert_logits_close(pnet.apply(xt, qstate=pq, int8=True),
                        np.asarray(jnet.apply(xj, qstate=jq, int8=True)))
    jpk, ppk = jpack(jnet.params, jq), pack_weights(pnet.params, pq)
    rows = []
    ref_fn = pserve.q8_linear_ref

    def counted(x, *a, **kw):
        rows.append(x.numel() // x.shape[-1])
        return ref_fn(x, *a, **kw)
    monkeypatch.setattr(pserve, "q8_linear_ref", counted)
    ref = np.asarray(jnet.apply(xj, qstate=jq, int8="fused", packed=jpk))
    got = pnet.apply(xt, qstate=pq, int8="fused", packed=ppk)
    # 4 linears a block over 8 x 18 token rows, then head and head_dist on
    # one token an image each
    assert rows == [8 * 18] * 4 * DEIT["depth"] + [8, 8]
    assert (got.argmax(-1).numpy() == ref.argmax(-1)).all()
    close(got, ref)
    jrel = np.asarray(jnet.apply(xj, qstate=jq, int8="fused_relaxed",
                                 packed=jpk))
    rel = pnet.apply(xt, qstate=pq, int8="fused_relaxed", packed=ppk)
    assert float(np.abs(rel.numpy() - jrel).max()) < \
        0.10 * float(got.abs().max())
    assert (rel.numpy().argmax(-1) == jrel.argmax(-1)).all()


@pytest.mark.parametrize("relaxed", [False, True], ids=["exact", "relaxed"])
def test_distilled_serving_engine_is_the_fused_forward(calibrated, relaxed):
    """ServingEngine(device="cpu") serves both heads: its logits are the
    fused (relaxed) forward's on the packed weights, bitwise, in bf16 and
    fp32."""
    _, pnet, x, _, _, pq = calibrated
    packed = pack_weights(pnet.params, pq)
    mode = "fused_relaxed" if relaxed else "fused"
    for dtype in (torch.bfloat16, torch.float32):
        got = ServingEngine(pnet, pq, compute_dtype=dtype, relaxed=relaxed,
                            device="cpu")(x)
        want = pnet.apply(torch.from_numpy(x), qstate=pq, int8=mode,
                          packed=packed, compute_dtype=dtype)
        assert got.shape == (8, DEIT["num_classes"]) and got.dtype == dtype
        assert torch.equal(got, want)
