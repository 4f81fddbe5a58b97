"""Port quant core (fakequant, metrics, qparams, policy) against the JAX
package on the same numpy inputs.  Fakequant is held to exactly equal
values, including x/Δ values that sit exactly on .5 boundaries."""
import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptq4vit_tpu.configs import policy as jpolicy
from ptq4vit_tpu.quant import fakequant as jfq
from ptq4vit_tpu.quant import metrics as jmetrics
from ptq4vit_tpu.quant import qparams as jqp
from ptq4vit_tpu_torch.configs import policy as ppolicy
from ptq4vit_tpu_torch.quant import fakequant as pfq
from ptq4vit_tpu_torch.quant import metrics as pmetrics
from ptq4vit_tpu_torch.quant import qparams as pqp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def T(a):
    return torch.from_numpy(np.array(a, np.float32))


def J(a):
    return jnp.asarray(np.asarray(a, np.float32))


def bitwise(port, ref):
    """Exactly equal float32 values (the sign of a zero may differ: torch's
    clamp keeps -0.0 where XLA's max returns +0.0)."""
    p, r = port.numpy(), np.asarray(ref)
    assert p.dtype == r.dtype == np.float32 and p.shape == r.shape
    np.testing.assert_array_equal(p, r)


def half_boundaries(rng, shape, delta):
    """x with x/Δ exactly k + 0.5 on half the entries (Δ a power of two)."""
    k = rng.integers(-140, 140, shape).astype(np.float32)
    x = (k + 0.5) * delta
    noise = rng.standard_normal(shape).astype(np.float32) * delta * 50
    return np.where(rng.random(shape) < 0.5, x, noise).astype(np.float32)


def test_candidate_and_split_grids():
    for a, b, n in ((0.01, 1.2, 100), (0.5, 1.2, 100), (0.01, 1.2, 8)):
        bitwise(pfq.candidate_grid(a, b, n), jfq.candidate_grid(a, b, n))
    bitwise(pfq.sos_split_grid(20), jfq.sos_split_grid(20))


@pytest.mark.parametrize("qmax", [128, 32])
def test_elementwise_quant_bitwise_on_half_boundaries(qmax):
    rng = np.random.default_rng(0)
    delta = np.float32(2.0 ** -7)
    x = half_boundaries(rng, (64, 48), delta)
    assert (np.abs(x / delta - np.round(x / delta)) == 0.5).any()
    bitwise(pfq.int_quant(T(x), T(delta), qmax),
            jfq.int_quant(J(x), J(delta), qmax))
    bitwise(pfq.fake_quant(T(x), T(delta), qmax),
            jfq.fake_quant(J(x), J(delta), qmax))
    bitwise(pfq.minmax_interval(T(x), qmax), jfq.minmax_interval(J(x), qmax))
    # a non-power-of-two interval: the true division matters
    d2 = np.float32(np.abs(x).max() / (qmax - 0.5))
    bitwise(pfq.fake_quant(T(x), T(d2), qmax),
            jfq.fake_quant(J(x), J(d2), qmax))


def test_blocked_and_grouped_quantizers_bitwise():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((12, 16)).astype(np.float32)
    for n_V, n_H in ((1, 1), (3, 1), (3, 2)):
        pi = pfq.blocked_weight_interval_init(T(w), n_V, n_H, 128)
        ji = jfq.blocked_weight_interval_init(J(w), n_V, n_H, 128)
        bitwise(pi, ji)
        bitwise(pfq.fake_quant_weight_blocked(T(w), pi, 128),
                jfq.fake_quant_weight_blocked(J(w), ji, 128))
    x = half_boundaries(rng, (4, 5, 16), np.float32(2.0 ** -6))
    for n_a, signed in ((1, True), (2, True), (1, False)):
        pi = pfq.grouped_act_interval_init(T(x), n_a, 128, signed)
        ji = jfq.grouped_act_interval_init(J(x), n_a, 128, signed)
        bitwise(pi, ji)
        bitwise(pfq.fake_quant_act_grouped(T(x), pi, 128),
                jfq.fake_quant_act_grouped(J(x), ji, 128))


def test_twin_quantizers_bitwise():
    rng = np.random.default_rng(2)
    qmax = 128
    neg = np.float32(jfq.GELU_NEG_CLIP / qmax)
    assert pfq.GELU_NEG_CLIP == jfq.GELU_NEG_CLIP
    x = rng.standard_normal((3, 7, 32)).astype(np.float32)
    x = x * 0.5 * (1 + np.tanh(0.79788456 * (x + 0.044715 * x ** 3)))
    x[0, 0, :8] = (np.arange(8) - 4 + 0.5) * neg      # neg half boundaries
    pos = np.float32(x.max() / (qmax - 0.5)).reshape(1, 1)
    bitwise(pfq.twin_quant_post_gelu(T(x), T(pos), T(neg), qmax),
            jfq.twin_quant_post_gelu(J(x), J(pos), J(neg), qmax))
    a = rng.random((2, 3, 9, 9)).astype(np.float32)
    a = a / a.sum(-1, keepdims=True)
    for split in (2.0 ** -3, 2.0 ** -7, 0.01):
        bitwise(pfq.sos_quant_softmax(T(a), T(split), qmax),
                jfq.sos_quant_softmax(J(a), J(split), qmax))


def test_matmul_operand_quantizer_bitwise():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 4, 9, 10)).astype(np.float32)
    for n_G, n_V, n_H in ((4, 1, 1), (2, 2, 3)):
        pi = pfq.matmul_operand_interval_init(T(x), n_G, n_V, n_H, 128)
        ji = jfq.matmul_operand_interval_init(J(x), n_G, n_V, n_H, 128)
        bitwise(pi, ji)
        bitwise(pfq.fake_quant_matmul_operand(T(x), pi, 128),
                jfq.fake_quant_matmul_operand(J(x), ji, 128))


@pytest.mark.parametrize("metric", jmetrics.METRICS)
def test_metrics_match(metric):
    rng = np.random.default_rng(4)
    raw = rng.standard_normal((3, 5, 16)).astype(np.float32)
    sim = raw + 0.1 * rng.standard_normal((3, 5, 16)).astype(np.float32)
    g = rng.standard_normal((3, 5, 16)).astype(np.float32)
    p = pmetrics.similarity(T(raw), T(sim), metric, T(g))
    j = jmetrics.similarity(J(raw), J(sim), metric, J(g))
    np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=1e-5,
                               atol=1e-7)


def test_qparams_apply_match():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, 24)).astype(np.float32)
    w = rng.standard_normal((12, 24)).astype(np.float32)
    b = rng.standard_normal((12,)).astype(np.float32)
    wi = np.abs(w).reshape(3, -1).max(1).reshape(3, 1, 1, 1) / 127.5
    ai = np.array([[np.abs(x).max() / 127.5]], np.float32)
    for pg in (False, True):
        kw = dict(w_interval=wi.astype(np.float32), a_interval=ai,
                  a_neg_interval=np.float32(jfq.GELU_NEG_CLIP / 128)
                  if pg else None, postgelu=pg)
        jq = jqp.LinearQP(**{k: (J(v) if isinstance(v, np.ndarray)
                                 or isinstance(v, np.floating) else v)
                             for k, v in kw.items()})
        pq = pqp.LinearQP(**{k: (T(v) if isinstance(v, np.ndarray)
                                 or isinstance(v, np.floating) else v)
                             for k, v in kw.items()})
        np.testing.assert_allclose(
            pqp.apply_linear(T(x), T(w), T(b), pq).numpy(),
            np.asarray(jqp.apply_linear(J(x), J(w), J(b), jq)),
            rtol=1e-5, atol=1e-6)
    a = rng.random((2, 3, 6, 6)).astype(np.float32)
    bm = rng.standard_normal((2, 3, 6, 4)).astype(np.float32)
    Bi = (np.abs(bm).max((0, 2, 3)) / 127.5).reshape(1, 3, 1, 1, 1, 1, 1)
    split = np.float32(2.0 ** -4)
    jm = jqp.MatMulQP(A_interval=J(split / 127), B_interval=J(Bi),
                      split=J(split))
    pm = pqp.MatMulQP(A_interval=T(split / 127), B_interval=T(Bi),
                      split=T(split))
    np.testing.assert_allclose(pqp.apply_matmul(T(a), T(bm), pm).numpy(),
                               np.asarray(jqp.apply_matmul(J(a), J(bm), jm)),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("factory", ["ptq4vit", "base_ptq"])
def test_policies_equal_field_by_field(factory):
    jc = getattr(jpolicy, factory)()
    pc = getattr(ppolicy, factory)()
    for name in jpolicy.CONV_FC_NAMES + jpolicy.MATMUL_NAMES:
        assert dataclasses.asdict(pc.op_policy(name)) == \
            dataclasses.asdict(jc.op_policy(name)), name
    jc.set_bits(6, 6)
    pc.set_bits(6, 6)
    assert dataclasses.asdict(pc.op_policy("qlinear_qkv")) == \
        dataclasses.asdict(jc.op_policy("qlinear_qkv"))


def test_port_imports_no_jax():
    code = ("import sys\n"
            "import ptq4vit_tpu_torch\n"
            "import ptq4vit_tpu_torch.calib.search, "
            "ptq4vit_tpu_torch.calib.calibrator, "
            "ptq4vit_tpu_torch.ops.search_kernels, "
            "ptq4vit_tpu_torch.ops.build, ptq4vit_tpu_torch.utils.convert\n"
            "assert 'jax' not in sys.modules\n"
            "assert not any(m == 'ptq4vit_tpu' or "
            "m.startswith('ptq4vit_tpu.') for m in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
