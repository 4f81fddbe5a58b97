"""The B7 / B8 plain version (``fused_attention_ref``, what the wrappers
run on the CPU) against the JAX package's ``fused_attention_qkv`` (B7) and
``fused_attention`` (B8) in Pallas interpret mode: SoS and per-head
post-softmax quantization, float or int8 (``in_q8``) input, float or int8
(``out_scale``) output.

Tolerance: float outputs rtol 1e-5, atol 2e-5 of max |ref| (JAX's own
fused-attention tolerance, tests/test_int8_serve.py:79); int8 outputs
within one level in at most 1% of the elements (the softmax sums in
another order, so a probability can round to the neighbouring level)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptq4vit_tpu.ops import int8_serve as jserve
from ptq4vit_tpu.quant.qparams import MatMulQP as JMatMulQP
from ptq4vit_tpu_torch.ops import int8_serve as pserve
from ptq4vit_tpu_torch.utils.convert import qstate_from_numpy

B, N, HD = 2, 37, 64


def qps(q, k, v, H, sos, bits=8):
    qm = 2 ** (bits - 1)
    shape = (1, H, 1, 1, 1, 1, 1)

    def hmax(t):
        return jnp.asarray((np.abs(t).max((0, 2, 3)) / (qm - 0.5))
                           .reshape(shape).astype(np.float32))
    qp1 = JMatMulQP(A_interval=hmax(q), B_interval=hmax(k), A_bit=bits,
                    B_bit=bits)
    split = jnp.float32(2.0 ** -4)
    qp2 = JMatMulQP(
        A_interval=(split / (qm - 1) if sos
                    else jnp.full(shape, 1 / (qm - 0.5), jnp.float32)),
        B_interval=hmax(v), split=split if sos else None, A_bit=bits,
        B_bit=bits)
    port = qstate_from_numpy({"1": qp1, "2": qp2})
    return (qp1, qp2), (port["1"], port["2"])


def check(got, ref):
    got = got.numpy()
    ref = np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    if ref.dtype == np.int8:
        d = np.abs(got.astype(np.int32) - ref.astype(np.int32))
        assert d.max() <= 1 and (d > 0).mean() <= 0.01
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5,
                                   atol=2e-5 * np.abs(ref).max())


def qkv_case(H, sos, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B, N, 3 * H * HD)).astype(np.float32)
    t = qkv.reshape(B, N, 3, H, HD).transpose(2, 0, 3, 1, 4)
    return qkv, qps(t[0], t[1], t[2], H, sos)


@pytest.mark.parametrize("sos", [True, False], ids=["sos", "per-head"])
def test_b8_layout_entry_matches_jax(sos):
    H = 3
    qkv, (jq, pq) = qkv_case(H, sos, 21)
    t = np.ascontiguousarray(
        qkv.reshape(B, N, 3, H, HD).transpose(2, 0, 3, 1, 4))
    ref = jserve.fused_attention(*(jnp.asarray(a) for a in t), *jq,
                                 HD ** -0.5)
    got = pserve.fused_attention(*(torch.from_numpy(a) for a in t), *pq,
                                 HD ** -0.5)
    check(got, ref)


@pytest.mark.parametrize("out_q8", [False, True], ids=["float-out",
                                                       "int8-out"])
@pytest.mark.parametrize("sos", [True, False], ids=["sos", "per-head"])
def test_b7_float_input_matches_jax(sos, out_q8):
    H = 2
    qkv, (jq, pq) = qkv_case(H, sos, 22)
    a_out = np.float32(0.02) if out_q8 else None
    ref = jserve.fused_attention_qkv(
        jnp.asarray(qkv), H, *jq, HD ** -0.5,
        out_scale=None if a_out is None else jnp.asarray(a_out))
    got = pserve.fused_attention_qkv(
        torch.from_numpy(qkv), H, *pq, HD ** -0.5,
        out_scale=None if a_out is None else torch.tensor(a_out))
    check(got, ref)


def levels_of(qkv, jq, H, qmax):
    """The qkv linear's int8 handoff: per-column levels at a1 / b1 / b2,
    and the same levels dequantized to float."""
    cols = np.concatenate([np.repeat(np.asarray(iv).reshape(H), HD)
                           for iv in (jq[0].A_interval, jq[0].B_interval,
                                      jq[1].B_interval)]).astype(np.float32)
    lv = np.clip(np.round(qkv / cols), -qmax, qmax - 1).astype(np.int8)
    return lv, (lv.astype(np.float32) * cols).astype(np.float32)


@pytest.mark.parametrize("bits", [8, 6])
@pytest.mark.parametrize("sos", [True, False], ids=["sos", "per-head"])
def test_b7_int8_input_matches_jax(sos, bits):
    """in_q8 with the context requantized at the proj scale (the block's
    handoff) against JAX's in_q8 kernel; in_q8 with a float context
    against JAX's float-input kernel on the dequantized levels (which
    quantize back to the same levels)."""
    H, qmax = 2, 2 ** (bits - 1)
    rng = np.random.default_rng(23)
    qkv = rng.standard_normal((B, N, 3 * H * HD)).astype(np.float32)
    t = qkv.reshape(B, N, 3, H, HD).transpose(2, 0, 3, 1, 4)
    jq, pq = qps(t[0], t[1], t[2], H, sos, bits)
    lv, deq = levels_of(qkv, jq, H, qmax)
    a_out = np.float32(0.02)
    ref = jserve.fused_attention_qkv(jnp.asarray(lv), H, *jq, HD ** -0.5,
                                     in_q8=True, out_scale=jnp.asarray(a_out),
                                     out_qmax=qmax)
    got = pserve.fused_attention_qkv(torch.from_numpy(lv), H, *pq,
                                     HD ** -0.5, in_q8=True,
                                     out_scale=torch.tensor(a_out),
                                     out_qmax=qmax)
    check(got, ref)
    ref = jserve.fused_attention_qkv(jnp.asarray(deq), H, *jq, HD ** -0.5)
    got = pserve.fused_attention_qkv(torch.from_numpy(lv), H, *pq,
                                     HD ** -0.5, in_q8=True)
    assert got.dtype == torch.float32
    check(got, ref)


def test_attention_scope():
    """Operand block grids and a split on matmul1 are out of scope (the
    generic path runs); the TPU's 128-lane head grouping is not a rule of
    the port: 3 heads of 8 (JAX: None) run."""
    H = 3
    rng = np.random.default_rng(24)
    qkv = rng.standard_normal((1, 5, 3 * H * 8)).astype(np.float32)
    t = qkv.reshape(1, 5, 3, H, 8).transpose(2, 0, 3, 1, 4)
    jq, pq = qps(t[0], t[1], t[2], H, True)
    assert jserve.fused_attention_qkv(jnp.asarray(qkv), H, *jq, 0.3) is None
    out = pserve.fused_attention_qkv(torch.from_numpy(qkv), H, *pq, 0.3)
    assert out.shape == (1, 5, H * 8)
    blocked = pq[0].__class__(A_interval=torch.ones(1, H, 1, 2, 1, 1, 1),
                              B_interval=pq[0].B_interval)
    assert pserve.attn_scope(blocked, pq[1], H) is None
    split1 = pq[0].__class__(A_interval=pq[0].A_interval,
                             B_interval=pq[0].B_interval,
                             split=torch.tensor(0.1))
    assert pserve.attn_scope(split1, pq[1], H) is None
