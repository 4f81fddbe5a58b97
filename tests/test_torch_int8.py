"""The port's exact int8 path (ops/int8.py), weight packing (ops/pack.py)
and ``int8=True`` forwards against the JAX package on the same inputs.

Tolerance: the int8 products are exact in both packages and every
elementwise step is the same formula, so the ops must agree to rtol 1e-6
(the fp32 matmul of the a_bit >= 32 paths sums in another order); packed
bytes must be equal; the tiny nets' int8 logits must match JAX's to the
fake-quant tolerance of ``assert_logits_close`` (1e-3 of max |logit|: a
last-ulp difference upstream can flip one level)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptq4vit_tpu.ops import int8 as ji8
from ptq4vit_tpu.ops.pack import pack_weights as jpack
from ptq4vit_tpu.quant.fakequant import GELU_NEG_CLIP
from ptq4vit_tpu.quant.qparams import ConvQP as JConvQP
from ptq4vit_tpu.quant.qparams import LinearQP as JLinearQP
from ptq4vit_tpu.quant.qparams import MatMulQP as JMatMulQP
from ptq4vit_tpu_torch.ops import int8 as pi8
from ptq4vit_tpu_torch.ops.pack import pack_weights
from ptq4vit_tpu_torch.quant.qparams import LinearQP
from ptq4vit_tpu_torch.utils.convert import packed_to, qstate_from_numpy
from tests.torch_port_helpers import (TINY, assert_logits_close, images,
                                      jax_net, minmax_qstate, port_net)

RTOL = 1e-6


def port_qp(jqp):
    return qstate_from_numpy({"op": jqp})["op"]


def close(port, jax_out, rtol=RTOL):
    j = np.asarray(jax_out)
    np.testing.assert_allclose(port.numpy(), j, rtol=rtol,
                               atol=rtol * np.abs(j).max())


def linear_qp(rng, w, x, n_V, postgelu, a_bit):
    oc, ic = w.shape
    w4 = w.reshape(n_V, oc // n_V, 1, ic)
    return JLinearQP(
        w_interval=jnp.asarray(np.abs(w4).max((1, 3), keepdims=True) / 127.5),
        a_interval=jnp.asarray([[np.float32(np.abs(x).max() / 127.5)]]),
        a_neg_interval=(jnp.float32(GELU_NEG_CLIP / 128) if postgelu
                        else None),
        a_bit=a_bit, postgelu=postgelu)


@pytest.mark.parametrize("n_V,postgelu,a_bit,bias", [
    (1, False, 8, True), (3, False, 8, True), (1, True, 8, False),
    (3, False, 32, True)], ids=["signed", "n_V=3", "twin", "a_bit=32"])
def test_linear_int8_matches_jax(n_V, postgelu, a_bit, bias):
    rng = np.random.default_rng(11)
    oc, ic = 12, 40
    w = rng.standard_normal((oc, ic)).astype(np.float32)
    b = rng.standard_normal((oc,)).astype(np.float32) if bias else None
    x = rng.standard_normal((3, 7, ic)).astype(np.float32)
    if postgelu:
        x = np.where(x > 0, x, x * 0.05).astype(np.float32)
    jqp = linear_qp(rng, w, x, n_V, postgelu, a_bit)
    ref = ji8.linear_int8(jnp.asarray(x), jnp.asarray(w),
                          None if b is None else jnp.asarray(b), jqp)
    got = pi8.linear_int8(torch.from_numpy(x), torch.from_numpy(w),
                          None if b is None else torch.from_numpy(b),
                          port_qp(jqp))
    close(got, ref, RTOL if a_bit == 8 else 1e-5)


@pytest.mark.parametrize("kind", ["per-head", "sos", "blocked"])
def test_matmul_int8_matches_jax(kind):
    rng = np.random.default_rng(12)
    G = 3
    if kind == "sos":
        A = rng.random((2, G, 6, 6)).astype(np.float32)
        A = A / A.sum(-1, keepdims=True)
    else:
        A = rng.standard_normal((2, G, 6, 5)).astype(np.float32)
    B = rng.standard_normal((2, G, A.shape[-1], 7)).astype(np.float32)
    shape = (1, G, 1, 1, 1, 1, 1)
    b_iv = np.abs(B).max((0, 2, 3)).reshape(shape) / 127.5
    if kind == "sos":
        split = jnp.float32(2.0 ** -3)
        jqp = JMatMulQP(A_interval=split / 127, B_interval=jnp.asarray(b_iv),
                        split=split)
    elif kind == "per-head":
        jqp = JMatMulQP(
            A_interval=jnp.asarray(
                np.abs(A).max((0, 2, 3)).reshape(shape) / 127.5),
            B_interval=jnp.asarray(b_iv))
    else:       # n_V = 2 row blocks of A: the fake-quant fallback
        a_iv = np.abs(A).reshape(2, G, 2, 3, 5).max((0, 3, 4)) / 127.5
        jqp = JMatMulQP(A_interval=jnp.asarray(
            a_iv.reshape(1, G, 1, 2, 1, 1, 1).astype(np.float32)),
            B_interval=jnp.asarray(b_iv))
    ref = ji8.matmul_int8(jnp.asarray(A), jnp.asarray(B), jqp)
    got = pi8.matmul_int8(torch.from_numpy(A), torch.from_numpy(B),
                          port_qp(jqp))
    close(got, ref, 1e-5 if kind == "blocked" else RTOL)


@pytest.mark.parametrize("layout", ["channelwise", "layerwise", "blocked",
                                    "a_bit=8"])
def test_conv_int8_matches_jax(layout):
    rng = np.random.default_rng(13)
    oc, ic, p = 6, 3, 4
    w = rng.standard_normal((oc, ic, p, p)).astype(np.float32)
    b = rng.standard_normal((oc,)).astype(np.float32)
    xp = rng.standard_normal((2, 5, ic * p * p)).astype(np.float32)
    wm = np.abs(w.reshape(oc, -1))
    if layout == "blocked":
        iv = wm.reshape(2, 3, 2, 24).max((1, 3)).reshape(2, 1, 2, 1) / 127.5
        jqp = JConvQP(w_interval=jnp.asarray(iv.astype(np.float32)),
                      blocked=True)
    elif layout == "layerwise":
        jqp = JConvQP(w_interval=jnp.float32(wm.max() / 127.5))
    else:
        jqp = JConvQP(w_interval=jnp.asarray(
            (wm.max(1) / 127.5).reshape(-1, 1, 1, 1).astype(np.float32)))
    if layout == "a_bit=8":
        jqp = JConvQP(w_interval=jqp.w_interval, a_bit=8,
                      a_interval=jnp.float32(np.abs(xp).max() / 127.5))
    ref = ji8.conv_int8(jnp.asarray(xp), jnp.asarray(w), jnp.asarray(b), jqp,
                        p)
    got = pi8.conv_int8(torch.from_numpy(xp), torch.from_numpy(w),
                        torch.from_numpy(b), port_qp(jqp), p)
    close(got, ref, 1e-5)


@pytest.mark.parametrize("bits", [8, 6])
def test_pack_weights_bytes_equal_jax(bits):
    """Every packable op (conv, n_V = 3 qkv, twin fc2, head), byte for
    byte; the packed int8 forward equals the unpacked one exactly."""
    jnet = jax_net(TINY)
    pnet = port_net(jnet)
    x = images(2, TINY["img_size"])
    jq = minmax_qstate(jnet, x, bits)
    pq = qstate_from_numpy(jq)
    jpk, ppk = jpack(jnet.params, jq), pack_weights(pnet.params, pq)
    assert set(jpk) == set(ppk) and "patch_embed.proj" in ppk
    for name, entry in jpk.items():
        for k, v in entry.items():
            got = ppk[name][k]
            assert got.dtype == (torch.int8 if k == "w_intT"
                                 else torch.float32)
            np.testing.assert_array_equal(got.numpy(), np.asarray(v),
                                          err_msg=f"{name}.{k}")
    xt = torch.from_numpy(x)
    moved = packed_to(ppk, "cpu")
    assert torch.equal(pnet.apply(xt, qstate=pq, int8=True, packed=moved),
                       pnet.apply(xt, qstate=pq, int8=True))


@pytest.mark.parametrize("bits", [8, 6])
def test_packed_kmajor_levels_pad_w_intT(bits):
    """Each linear's packed entry keeps JAX's two entries and adds the
    K-major copy the tensor-core kernel reads: w_intT transposed, (out,
    in) with ``in`` padded by zero levels to a multiple of 16 bytes; conv
    entries keep JAX's keys only.  packed_or_compute hands the packed
    copy on, and without a packed entry computes the same three tensors
    from the weight."""
    from ptq4vit_tpu_torch.ops.int8_serve import packed_or_compute
    from ptq4vit_tpu_torch.ops.pack import K_ALIGN, kmajor_levels
    jnet = jax_net(TINY)
    pnet = port_net(jnet)
    pq = qstate_from_numpy(minmax_qstate(jnet, images(2, TINY["img_size"]),
                                         bits))
    packed = pack_weights(pnet.params, pq)
    linears = [n for n, qp in pq.items() if isinstance(qp, LinearQP)]
    assert linears
    for name, entry in packed.items():
        if name not in linears:
            assert set(entry) == {"w_intT", "w_scale"}, name
            continue
        assert set(entry) == {"w_intT", "w_scale", "w_kmaj"}, name
        K, N = entry["w_intT"].shape
        kp = -(-K // K_ALIGN) * K_ALIGN
        wk = entry["w_kmaj"]
        assert wk.dtype == torch.int8 and tuple(wk.shape) == (N, kp)
        assert wk.is_contiguous()
        assert torch.equal(wk[:, :K], entry["w_intT"].t())
        assert not wk[:, K:].any()
        node = pnet.params
        for part in name.split("."):
            node = node[int(part)] if isinstance(node, list) else node[part]
        pw = packed_or_compute(node["weight"], pq[name], entry)
        assert pw.w_kmaj is entry["w_kmaj"]
        fresh = packed_or_compute(node["weight"], pq[name], {})
        for got, want in zip(fresh, (entry["w_intT"], entry["w_scale"], wk)):
            assert torch.equal(got, want), name
    lv = torch.arange(-60, 60, dtype=torch.int8).reshape(3, 40)
    wk = kmajor_levels(lv)
    assert tuple(wk.shape) == (3, 48) and torch.equal(wk[:, :40], lv)
    assert not wk[:, 40:].any()


def test_int8_forward_of_tiny_vit_matches_jax():
    jnet = jax_net(TINY)
    pnet = port_net(jnet)
    x = images(4, TINY["img_size"])
    jq = minmax_qstate(jnet, x)
    pq = qstate_from_numpy(jq)
    got = pnet.apply(torch.from_numpy(x), qstate=pq, int8=True)
    assert_logits_close(got, jnet.apply(jnp.asarray(x), qstate=jq,
                                        int8=True))
    # the int8 engine realizes the fake-quant semantics
    assert_logits_close(got, pnet.apply(torch.from_numpy(x), qstate=pq))


def test_compute_dtype_casts_every_param():
    """compute_dtype=bf16 casts the params the way JAX's tree.map does;
    the int8 logits come back in bf16 and stay close to fp32's."""
    jnet = jax_net(TINY)
    pnet = port_net(jnet)
    x = images(4, TINY["img_size"])
    jq = minmax_qstate(jnet, x)
    pq = qstate_from_numpy(jq)
    xt = torch.from_numpy(x)
    f32 = pnet.apply(xt, qstate=pq, int8=True)
    bf = pnet.apply(xt, qstate=pq, int8=True, compute_dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16
    jbf = np.asarray(jnet.forward(jnet.params, jnp.asarray(x), jnet.cfg,
                                  qstate=jq, int8=True,
                                  compute_dtype=jnp.bfloat16)
                     .astype(jnp.float32))
    rel = (bf.float() - f32).abs().max() / f32.abs().max()
    assert rel < 0.1                     # JAX's own bf16 bound
    assert np.abs(bf.float().numpy() - jbf).max() < 0.1 * np.abs(jbf).max()
