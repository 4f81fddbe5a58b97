"""The slice as a whole: the port's ``quantize`` against the JAX package's
calibrator on the tiny net (tests/test_capture.py) with small_cfg
(tests/test_calibrator.py) and the probe noise the JAX package draws.
Every qstate slot must match up to the f64 tie class, and the quantized
logits must agree as in tests/test_torch_models.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ptq4vit_tpu_torch
from ptq4vit_tpu.calib.calibrator import HessianQuantCalibrator
from ptq4vit_tpu.calib.capture import capture as jcapture
from ptq4vit_tpu.configs import ptq4vit as jptq4vit
from ptq4vit_tpu_torch.calib.calibrator import load_qstate, save_qstate
from ptq4vit_tpu_torch.configs import ptq4vit as pptq4vit
from ptq4vit_tpu_torch.quant.qparams import ConvQP, LinearQP, MatMulQP
from tests.torch_port_helpers import (TINY, assert_logits_close,
                                      assert_qstate_matches, bits_meta,
                                      golden_view, images, jax_net,
                                      jax_probe_u, np_fields, port_net,
                                      shrink)

PROBE_SEED = 3


@pytest.fixture(scope="module")
def calibrated():
    jnet = jax_net(TINY)
    pnet = port_net(jnet)
    x = images(8, 32)
    jcfg = shrink(jptq4vit())
    jq = HessianQuantCalibrator(jnet, jcfg, x, batch_size=4,
                                probe_seed=PROBE_SEED) \
        .batching_quant_calib(verbose=False)
    pnet_out, pq, report = ptq4vit_tpu_torch.quantize(
        pnet, x, config=shrink(pptq4vit()), batch_size=4, device="cpu",
        probe_u=jax_probe_u(8, 10, PROBE_SEED), return_report=True)
    assert pnet_out is pnet
    return jnet, pnet, x, jcfg, jq, pq, report


def test_qstate_matches_jax(calibrated):
    jnet, _, x, jcfg, jq, pq, _ = calibrated
    assert set(pq) == set(jq)
    caps = jcapture(jnet, x, batch_size=4, need_grad=True,
                    probe_seed=PROBE_SEED)
    mods = {n: np_fields(q) for n, q in jq.items()}
    z = golden_view(jax.tree.map(np.asarray, jnet.params), caps, mods,
                    TINY["patch_size"])
    kws = {"conv": jcfg.ptqsl_conv2d_kwargs,
           "linear": jcfg.ptqsl_linear_kwargs,
           "matmul": jcfg.ptqsl_matmul_kwargs}
    assert_qstate_matches(pq, mods, z, bits_meta(jcfg, TINY["patch_size"]),
                          jnet.op_inventory, kws)


def test_qstate_kinds_and_shapes(calibrated):
    _, _, _, _, _, pq, report = calibrated
    assert isinstance(pq["patch_embed.proj"], ConvQP)
    assert pq["patch_embed.proj"].w_interval.shape == (24, 1, 1, 1)
    assert pq["blocks.0.attn.qkv"].w_interval.shape == (3, 1, 1, 1)
    assert isinstance(pq["blocks.1.mlp.fc2"], LinearQP)
    assert pq["blocks.1.mlp.fc2"].postgelu
    assert isinstance(pq["blocks.0.attn.matmul2"], MatMulQP)
    assert pq["blocks.0.attn.matmul2"].split is not None
    assert pq["blocks.0.attn.matmul1"].A_interval.shape == \
        (1, 3, 1, 1, 1, 1, 1)
    assert set(report.search_seconds) == set(pq)
    assert report.num_groups == 1


def test_quantized_logits_match_jax(calibrated):
    jnet, pnet, x, _, jq, pq, _ = calibrated
    with torch.no_grad():
        got = pnet.apply(torch.from_numpy(x), qstate=pq)
    assert_logits_close(got, jnet.apply(jnp.asarray(x), qstate=jq))


def test_qstate_save_load_roundtrip(calibrated, tmp_path):
    _, pnet, x, _, _, pq, _ = calibrated
    save_qstate(str(tmp_path), pq)
    back = load_qstate(str(tmp_path))
    assert set(back) == set(pq)
    for n in pq:
        assert type(back[n]) is type(pq[n])
        a, b = np_fields(pq[n]), np_fields(back[n])
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    with torch.no_grad():
        torch.testing.assert_close(
            pnet.apply(torch.from_numpy(x[:2]), qstate=back),
            pnet.apply(torch.from_numpy(x[:2]), qstate=pq), rtol=0, atol=0)


@pytest.mark.parametrize("sequential", [False, True])
def test_baseptq_w6a6_quantize_matches_jax(sequential):
    """``quantize(config="BasePTQ", bits=(6, 6))`` (cosine metric, one
    round, layerwise conv, no twins), parallel and sequential, against the
    JAX calibrator on the same tiny net and images."""
    from ptq4vit_tpu.configs import base_ptq as jbase_ptq
    from ptq4vit_tpu.configs import get_config as jget_config
    jnet = jax_net(TINY)
    pnet = port_net(jnet)
    x = images(8, 32)
    jcfg = shrink(jbase_ptq()).set_bits(6, 6)
    jq = HessianQuantCalibrator(jnet, jcfg, x, batch_size=4,
                                sequential=sequential) \
        .batching_quant_calib(verbose=False)
    pcfg = shrink(ptq4vit_tpu_torch.configs.get_config("BasePTQ"))
    _, pq = ptq4vit_tpu_torch.quantize(pnet, x, config=pcfg, bits=(6, 6),
                                       batch_size=4, device="cpu",
                                       sequential=sequential)
    assert jget_config("BasePTQ").name == pcfg.name == "BasePTQ"
    assert pq["patch_embed.proj"].w_interval.shape == ()
    assert pq["blocks.0.attn.matmul2"].split is None
    assert not pq["blocks.1.mlp.fc2"].postgelu
    assert pq["blocks.0.attn.qkv"].w_bit == pq["blocks.0.attn.qkv"].a_bit == 6
    mods = {n: np_fields(q) for n, q in jq.items()}
    if sequential:
        # each op was captured under its own prefix: hold the picks equal
        for n in mods:
            for k, v in np_fields(pq[n]).items():
                np.testing.assert_allclose(v.reshape(-1),
                                           mods[n][k].reshape(-1),
                                           rtol=1e-5, err_msg=f"{n}.{k}")
        return
    caps = jcapture(jnet, x, batch_size=4, need_grad=False)
    z = golden_view(jax.tree.map(np.asarray, jnet.params), caps, mods,
                    TINY["patch_size"])
    kws = {"conv": jcfg.ptqsl_conv2d_kwargs,
           "linear": jcfg.ptqsl_linear_kwargs,
           "matmul": jcfg.ptqsl_matmul_kwargs}
    assert_qstate_matches(pq, mods, z, bits_meta(jcfg, TINY["patch_size"]),
                          jnet.op_inventory, kws)
