"""B9's plain version (``fused_window_attention_ref``, what
``fused_window_attention_qkv`` runs on the CPU) against the JAX package's
``fused_window_attention_qkv`` in Pallas interpret mode: Swin window
attention on the packed (B·nW, N, 3C) qkv with the pre-scaled q folded in
as a1/s, the rel-pos bias and (or not) the shifted-window mask, SoS and
per-head post-softmax quantization, int8 in / int8 out (the block path)
and float in / float out (the per-op path), at Swin-B's head dim 32
(s = 32^-0.5 is not a power of two, so an inexact a1/s would show) and at
64.

Tolerance: float outputs rtol 1e-5, atol 2e-5 of max |ref| (JAX's own,
tests/test_int8_serve.py:228); int8 outputs within one level in at most
0.1% of the elements (JAX's SoS accumulate is reciprocal-and-FMA on the
CPU, ROADMAP C5, so a requantized context on a .5 boundary may round the
other way)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptq4vit_tpu.ops import int8_serve as jserve
from ptq4vit_tpu.quant.qparams import MatMulQP as JMatMulQP
from ptq4vit_tpu_torch.ops import int8_serve as pserve
from ptq4vit_tpu_torch.utils.convert import qstate_from_numpy

IMAGES, NW, N, C = 2, 3, 16, 128       # 2 images of 3 windows of 4 x 4


def case(hd, sos, masked, seed):
    """(qkv, bias, mask, JAX QPs, port QPs, s, per-column level scales)."""
    H = C // hd
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((IMAGES * NW, N, 3 * C)).astype(np.float32)
    bias = (rng.standard_normal((H, N, N)) * 0.1).astype(np.float32)
    mask = (np.where(rng.random((NW, N, N)) > 0.7, -100.0, 0.0)
            .astype(np.float32) if masked else None)
    t = qkv.reshape(IMAGES * NW, N, 3, H, hd).transpose(2, 0, 3, 1, 4)
    s = hd ** -0.5
    shape = (1, H, 1, 1, 1, 1, 1)

    def hmax(v):
        return (np.abs(v).max((0, 2, 3)) / 127.5).astype(np.float32)
    # matmul1's A operand is the pre-scaled q
    a1, b1, b2 = hmax(t[0] * np.float32(s)), hmax(t[1]), hmax(t[2])
    split = np.float32(2.0 ** -4)
    qp1 = JMatMulQP(A_interval=jnp.asarray(a1.reshape(shape)),
                    B_interval=jnp.asarray(b1.reshape(shape)))
    qp2 = JMatMulQP(
        A_interval=(jnp.float32(split / 127.0) if sos
                    else jnp.full(shape, 1 / 127.5, jnp.float32)),
        B_interval=jnp.asarray(b2.reshape(shape)),
        split=jnp.float32(split) if sos else None)
    port = qstate_from_numpy({"1": qp1, "2": qp2})
    cols = np.concatenate([np.repeat(v, hd) for v in (
        a1 / np.float32(s), b1, b2)]).astype(np.float32)
    return qkv, bias, mask, (qp1, qp2), (port["1"], port["2"]), s, cols


def check(got, ref):
    got = got.numpy()
    ref = np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    if ref.dtype == np.int8:
        d = np.abs(got.astype(np.int32) - ref.astype(np.int32))
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5,
                                   atol=2e-5 * np.abs(ref).max())


@pytest.mark.parametrize("masked", [True, False], ids=["mask", "no-mask"])
@pytest.mark.parametrize("sos", [True, False], ids=["sos", "per-head"])
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("mode", ["int8", "float"])
def test_b9_matches_jax(mode, hd, sos, masked):
    qkv, bias, mask, jq, pq, s, cols = case(hd, sos, masked,
                                            60 + hd + 2 * sos + masked)
    H = C // hd
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)
    if mode == "int8":
        # the block path: qkv levels at (a1/s, b1, b2), context requantized
        # at the proj scale
        lv = np.clip(np.round(qkv / cols), -128, 127).astype(np.int8)
        a_out = np.float32(0.02)
        ref = jserve.fused_window_attention_qkv(
            jnp.asarray(lv), H, NW, *jq, s, jnp.asarray(bias), jmask,
            in_q8=True, out_scale=jnp.asarray(a_out))
        got = pserve.fused_window_attention_qkv(
            torch.from_numpy(lv), H, NW, *pq, s, torch.from_numpy(bias),
            tmask, in_q8=True, out_scale=torch.tensor(a_out))
        assert got.dtype == torch.int8
    else:
        ref = jserve.fused_window_attention_qkv(
            jnp.asarray(qkv), H, NW, *jq, s, jnp.asarray(bias), jmask)
        got = pserve.fused_window_attention_qkv(
            torch.from_numpy(qkv), H, NW, *pq, s, torch.from_numpy(bias),
            tmask)
        assert got.dtype == torch.float32
    assert ref is not None
    check(got, ref)


def test_b9_checks_its_geometry():
    """Windows that are not whole images of nW raise; matmul QPs out of
    scope (a split on matmul1) return None for the generic path."""
    qkv, bias, mask, _, pq, s, _ = case(32, True, True, 70)
    H = C // 32
    with pytest.raises(ValueError):
        pserve.fused_window_attention_qkv(
            torch.from_numpy(qkv[:5]), H, NW, *pq, s, torch.from_numpy(bias),
            torch.from_numpy(mask))
    split1 = pq[0].__class__(A_interval=pq[0].A_interval,
                             B_interval=pq[0].B_interval,
                             split=torch.tensor(0.1))
    assert pserve.fused_window_attention_qkv(
        torch.from_numpy(qkv), H, NW, split1, pq[1], s,
        torch.from_numpy(bias), torch.from_numpy(mask)) is None
