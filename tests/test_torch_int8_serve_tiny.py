"""The port's ``int8="fused"`` forward outside the JAX kernels' TPU
tiling (TINY: embed 24, 3 heads of 8), against JAX's exact XLA int8
forward, with the fixtures and tolerances of
tests/test_torch_int8_serve_block.py."""
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_int8_serve_block import close, ref_calls, setup  # noqa: F401
from tests.torch_port_helpers import TINY


def test_fused_forward_outside_the_tpu_tiling(ref_calls):
    """TINY: JAX falls back to its XLA int8 path (K = 24 is not a multiple
    of 128); the port runs the fused kernels' plain versions on every
    block and matches JAX's int8 logits."""
    (jnet, jq, jpk), (pnet, pq, ppk), x = setup(TINY, 8)
    ref = np.asarray(jnet.apply(jnp.asarray(x), qstate=jq, int8=True))
    got = pnet.apply(torch.from_numpy(x), qstate=pq, int8="fused",
                     packed=ppk)
    assert ref_calls == {"q8_linear": 9, "attention": 2}
    assert (got.argmax(-1).numpy() == ref.argmax(-1)).all()
    close(got, ref)


def test_block_scope_falls_back_per_op(ref_calls):
    """A block out of scope (here fc2 without the post-GELU twin) runs per
    op: B7 and the in-scope linears still go through the fused wrappers,
    the rest through the exact int8 path."""
    (jnet, jq, jpk), (pnet, pq, ppk), x = setup(TINY, 8)
    for q in (jq, pq):
        fc2 = q["blocks.0.mlp.fc2"]
        q["blocks.0.mlp.fc2"] = fc2.__class__(
            w_interval=fc2.w_interval, a_interval=fc2.a_interval * 4)
    ref = np.asarray(jnet.apply(jnp.asarray(x), qstate=jq, int8=True))
    got = pnet.apply(torch.from_numpy(x), qstate=pq, int8="fused")
    # block 0: qkv, proj, fc1 (GELU fused), fc2 per op + one B7; block 1
    # fused (4 + 1); the head
    assert ref_calls == {"q8_linear": 9, "attention": 2}
    close(got, ref)
