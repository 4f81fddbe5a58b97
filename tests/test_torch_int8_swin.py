"""The port's Swin under the int8 paths, against the JAX package:
``int8=True`` matches JAX's exact int8 forward (to the fake-quant
tolerance of ``assert_logits_close``, 1e-3 of max |logit|), and
``int8="fused"`` raises until the window kernels B9-B11 are ported (the
JAX package runs that path in Pallas, so the port may not quietly run the
generic path in its place)."""
import jax.numpy as jnp
import pytest
import torch

from ptq4vit_tpu_torch.ops.pack import pack_weights
from ptq4vit_tpu_torch.utils.convert import qstate_from_numpy
from tests.torch_port_helpers import (TINY_SWIN, assert_logits_close, images,
                                      jax_swin_net, minmax_qstate, port_net)


def test_int8_forward_of_tiny_swin_matches_jax():
    jnet = jax_swin_net(TINY_SWIN)
    pnet = port_net(jnet)
    x = images(2, TINY_SWIN["img_size"])
    jq = minmax_qstate(jnet, x)
    pq = qstate_from_numpy(jq)
    xt = torch.from_numpy(x)
    got = pnet.apply(xt, qstate=pq, int8=True)
    assert_logits_close(got, jnet.apply(jnp.asarray(x), qstate=jq,
                                        int8=True))
    packed = pack_weights(pnet.params, pq)
    assert torch.equal(pnet.apply(xt, qstate=pq, int8=True, packed=packed),
                       got)
    with pytest.raises(NotImplementedError, match="B9-B11"):
        pnet.apply(xt, qstate=pq, int8="fused", packed=packed)
    with pytest.raises(NotImplementedError, match="relaxed"):
        pnet.apply(xt, qstate=pq, int8="fused_relaxed")
    # capture and probes keep the generic path in fused mode, as in JAX
    _, taps = pnet.apply(xt, qstate=pq, int8="fused", capture=True)
    assert "layers.0.blocks.0.attn.matmul2" in taps
