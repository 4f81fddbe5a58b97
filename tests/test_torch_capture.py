"""Port capture (parallel paradigm) against ptq4vit_tpu.calib.capture on
the same net and the same probe noise u: every op's inputs, output and
probe gradient, rtol 1e-4 with atol 1e-6 * max|.|."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptq4vit_tpu.calib.capture import _kl_batchmean as j_kl
from ptq4vit_tpu.calib.capture import capture as jcapture
from ptq4vit_tpu_torch.calib.capture import _kl_batchmean as p_kl
from ptq4vit_tpu_torch.calib.capture import capture as pcapture
from ptq4vit_tpu_torch.calib.capture import draw_probe_u
from tests.torch_port_helpers import (TINY, images, jax_net, jax_probe_u,
                                      port_net)

# The probe gradient is softmax(l) - softmax(l + σu) backpropagated: its
# fp32 rounding is a cancellation error ~1/σ (σ = 1e-2 leaves 1.7e-5 of
# max|g| between the frameworks, σ = 1e-1 leaves 1.5e-6).  The hessian
# metric is invariant to the scale of g, so σ = 0.1 tests the same thing.
SEED, SIGMA = 7, 1e-1


@pytest.fixture(scope="module")
def caps():
    jnet = jax_net(TINY)
    pnet = port_net(jnet)
    x = images(8, 32)
    jc = jcapture(jnet, x, batch_size=4, need_grad=True, probe_seed=SEED,
                  probe_sigma=SIGMA)
    pc = pcapture(pnet, x, batch_size=4, need_grad=True,
                  probe_u=jax_probe_u(8, 10, SEED), probe_sigma=SIGMA)
    return jnet, jc, pc


def close(p, j, what):
    p = p.numpy()
    j = np.asarray(j)
    assert p.shape == j.shape, what
    np.testing.assert_allclose(p, j, rtol=1e-4, atol=1e-6 * np.abs(j).max(),
                               err_msg=what)


def test_every_op_captured(caps):
    jnet, jc, pc = caps
    assert list(pc) == [n for n, _ in jnet.op_inventory]
    for n in pc:
        assert pc[n].kind == jc[n].kind
        assert set(pc[n].inputs) == set(jc[n].inputs)


@pytest.mark.parametrize("field", ["inputs", "out", "grad"])
def test_caches_match_jax(caps, field):
    _, jc, pc = caps
    for n in pc:
        if field == "inputs":
            for k in pc[n].inputs:
                close(pc[n].inputs[k], jc[n].inputs[k], f"{n}.{k}")
        else:
            close(getattr(pc[n], field), getattr(jc[n], field),
                  f"{n}.{field}")
    if field == "grad":
        assert np.abs(pc["blocks.0.attn.qkv"].grad.numpy()).max() > 0


def test_kl_batchmean_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((4, 10)).astype(np.float32)
    t = rng.random((4, 10)).astype(np.float32)
    t /= t.sum(-1, keepdims=True)
    np.testing.assert_allclose(
        float(p_kl(torch.from_numpy(logits), torch.from_numpy(t))),
        float(j_kl(jnp.asarray(logits), jnp.asarray(t))), rtol=1e-6)


def test_store_raw_out_and_cache_dtype():
    pnet = port_net(jax_net(TINY))
    x = images(4, 32)
    pc = pcapture(pnet, x, batch_size=2, store_raw_out=False,
                  cache_dtype=torch.bfloat16)
    qkv = pc["blocks.0.attn.qkv"]
    assert qkv.out is None and qkv.grad.dtype == torch.bfloat16
    assert qkv.inputs["x"].shape == (4, 17, 24)
    # the default probe noise comes from a seeded torch generator
    assert torch.equal(draw_probe_u(4, 10, 3), draw_probe_u(4, 10, 3))
