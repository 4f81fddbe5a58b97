"""The port's Swin under the int8 paths, against the JAX package:
``int8=True`` matches JAX's exact int8 forward (to the fake-quant
tolerance of ``assert_logits_close``, 1e-3 of max |logit|), and
``int8="fused"`` matches it to JAX's fused tolerance (rtol 1e-3, atol
2e-3 of max |logit|, argmax equal).  TINY_SWIN's heads of 6 are outside
JAX's TPU tiling, so JAX's fused forward is its exact int8 one here; the
port, which drops the tiling rules, runs its fused blocks (B10, B9, B11)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptq4vit_tpu_torch.ops import int8_serve as pserve
from ptq4vit_tpu_torch.ops.pack import pack_weights
from ptq4vit_tpu_torch.utils.convert import qstate_from_numpy
from tests.torch_port_helpers import (TINY_SWIN, assert_logits_close, images,
                                      jax_swin_net, minmax_qstate, port_net)


def test_int8_forward_of_tiny_swin_matches_jax(monkeypatch):
    jnet = jax_swin_net(TINY_SWIN)
    pnet = port_net(jnet)
    x = images(2, TINY_SWIN["img_size"])
    jq = minmax_qstate(jnet, x)
    pq = qstate_from_numpy(jq)
    xt = torch.from_numpy(x)
    got = pnet.apply(xt, qstate=pq, int8=True)
    ref = np.asarray(jnet.apply(jnp.asarray(x), qstate=jq, int8=True))
    assert_logits_close(got, ref)
    packed = pack_weights(pnet.params, pq)
    assert torch.equal(pnet.apply(xt, qstate=pq, int8=True, packed=packed),
                       got)
    proj_ref, blocks = pserve.q8_win_proj_ref, []

    def counted(*a, **kw):
        blocks.append(1)
        return proj_ref(*a, **kw)
    monkeypatch.setattr(pserve, "q8_win_proj_ref", counted)
    fused = pnet.apply(xt, qstate=pq, int8="fused", packed=packed)
    assert len(blocks) == sum(TINY_SWIN["depths"])    # each block fused
    assert (fused.argmax(-1).numpy() == ref.argmax(-1)).all()
    np.testing.assert_allclose(fused.numpy(), ref, rtol=1e-3,
                               atol=2e-3 * np.abs(ref).max())
    # the relaxed mode runs the same fused blocks with bf16 epilogues:
    # engaged (not the exact fused logits), within JAX's own relaxed bound
    # of them (tests/test_int8_serve.py:341), the same argmax
    blocks.clear()
    relaxed = pnet.apply(xt, qstate=pq, int8="fused_relaxed", packed=packed)
    assert len(blocks) == sum(TINY_SWIN["depths"])
    assert not torch.equal(relaxed, fused)
    assert float((relaxed - fused).abs().max()) < \
        0.10 * float(fused.abs().max())
    assert torch.equal(relaxed.argmax(-1), fused.argmax(-1))
    # capture and probes keep the generic path in fused mode, as in JAX
    _, taps = pnet.apply(xt, qstate=pq, int8="fused", capture=True)
    assert "layers.0.blocks.0.attn.matmul2" in taps
