"""The port's fused ViT block and ``int8="fused"`` forward against the JAX
package, with the JAX fused path's tolerances (tests/test_int8_serve.py:161:
rtol 1e-3, atol 2e-3 of max |logit|, argmax equal).

WIDE (embed 128, 2 heads of 64) is in the JAX kernels' TPU tiling, so both
packages take the fused block path; TINY (embed 24, 3 heads of 8) is not,
so JAX runs its exact XLA int8 path while the port, which drops the tiling
rules, still takes the fused one."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptq4vit_tpu.models.common import QuantCtx as JQuantCtx
from ptq4vit_tpu.ops.pack import pack_weights as jpack
from ptq4vit_tpu_torch.models.common import QuantCtx
from ptq4vit_tpu_torch.ops import int8_serve as pserve
from ptq4vit_tpu_torch.ops.pack import pack_weights
from ptq4vit_tpu_torch.utils.convert import qstate_from_numpy
from tests.torch_port_helpers import (WIDE, images, jax_net, minmax_qstate,
                                      port_net)


@pytest.fixture
def ref_calls(monkeypatch):
    """Counts of the plain versions the wrappers run on the CPU."""
    calls = {"q8_linear": 0, "attention": 0}

    def counted(fn, key):
        def run(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return run
    monkeypatch.setattr(pserve, "q8_linear_ref",
                        counted(pserve.q8_linear_ref, "q8_linear"))
    monkeypatch.setattr(pserve, "fused_attention_ref",
                        counted(pserve.fused_attention_ref, "attention"))
    return calls


def close(got, ref, tol=(1e-3, 2e-3)):
    got = got.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got, ref, rtol=tol[0],
                               atol=tol[1] * np.abs(ref).max())


def setup(shape, bits):
    jnet = jax_net(shape)
    pnet = port_net(jnet)
    x = images(4, shape["img_size"])
    jq = minmax_qstate(jnet, x, bits)
    pq = qstate_from_numpy(jq)
    return (jnet, jq, jpack(jnet.params, jq)), \
        (pnet, pq, pack_weights(pnet.params, pq)), x


@pytest.mark.parametrize("bits", [8, 6])
def test_fused_vit_block_matches_jax(bits, ref_calls):
    (jnet, jq, jpk), (pnet, pq, ppk), _ = setup(WIDE, bits)
    cfg = pnet.cfg
    xs = np.random.default_rng(5).standard_normal(
        (2, cfg.seq_len, cfg.embed_dim)).astype(np.float32)
    args = ("blocks.0", cfg.num_heads, cfg.head_dim ** -0.5, cfg.ln_eps)
    ref = JQuantCtx(qstate=jq, int8="fused", packed=jpk).vit_block(
        args[0], jnp.asarray(xs), jnet.params["blocks"][0], *args[1:])
    got = QuantCtx(qstate=pq, int8="fused", packed=ppk).vit_block(
        args[0], torch.from_numpy(xs), pnet.params["blocks"][0], *args[1:])
    assert ref is not None and got is not None
    assert ref_calls == {"q8_linear": 4, "attention": 1}
    close(got, ref)


@pytest.mark.parametrize("bits", [8, 6])
def test_fused_forward_of_wide_vit_matches_jax(bits, ref_calls):
    (jnet, jq, jpk), (pnet, pq, ppk), x = setup(WIDE, bits)
    ref = np.asarray(jnet.apply(jnp.asarray(x), qstate=jq, int8="fused",
                                packed=jpk))
    got = pnet.apply(torch.from_numpy(x), qstate=pq, int8="fused",
                     packed=ppk)
    # one block: qkv, proj, fc1, fc2 and the head through B6, one B7
    assert ref_calls == {"q8_linear": 5, "attention": 1}
    assert (got.argmax(-1).numpy() == ref.argmax(-1)).all()
    close(got, ref)
    # and the port's own exact int8 path, as JAX holds its fused path
    close(got, pnet.apply(torch.from_numpy(x), qstate=pq, int8=True)
          .numpy())
