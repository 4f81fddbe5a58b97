"""The relaxed serving mode end to end: a tiny ViT and a tiny Swin
(tests/test_int8_serve.py:354 and :396, the JAX package's own relaxed
cases) with the weights carried across and a min-max qstate.  The port's
``int8="fused_relaxed"`` logits hold JAX's own bound against JAX's (max
difference under 10% of max |exact fused logit|, the same argmax), every
block through the relaxed fused path, and differ from the port's exact
fused logits (the chain engaged); ``ServingEngine(relaxed=True)`` is the
relaxed forward bitwise; the per-op fused path runs the relaxed kernels
too.  The kernel bodies: tests/test_torch_relaxed.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptq4vit_tpu.ops.pack import pack_weights as jpack
from ptq4vit_tpu_torch import ServingEngine
from ptq4vit_tpu_torch.ops import int8_serve as P
from ptq4vit_tpu_torch.ops.pack import pack_weights
from ptq4vit_tpu_torch.utils.convert import qstate_from_numpy
from tests.torch_port_helpers import (WIDE, WIDE_SWIN, images, jax_net,
                                      jax_swin_net, minmax_qstate, port_net)

# tests/test_int8_serve.py:354 (WIDE at depth 2) and :396 (WIDE_SWIN)
VIT = dict(WIDE, depth=2)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module", params=["vit", "swin"])
def tiny(request):
    if request.param == "vit":
        jnet, x = jax_net(VIT), images(4, VIT["img_size"], seed=5)
    else:
        jnet, x = jax_swin_net(WIDE_SWIN), images(2, 32, seed=6)
    jq = minmax_qstate(jnet, x)
    return request.param, jnet, port_net(jnet), jq, qstate_from_numpy(jq), x


def test_relaxed_forward_holds_jax_bound(tiny, monkeypatch):
    """The port's fused_relaxed logits against JAX's: max difference under
    10% of max |exact fused logit|, the argmax equal; every block through
    the relaxed fused path; not the exact fused logits, and within the
    same bound of them."""
    kind, jnet, pnet, jq, pq, x = tiny
    jpk, ppk = jpack(jnet.params, jq), pack_weights(pnet.params, pq)
    jrel = np.asarray(jnet.apply(jnp.asarray(x), qstate=jq,
                                 int8="fused_relaxed", packed=jpk))
    seen = []
    block = "fused_swin_block" if kind == "swin" else "fused_vit_block"
    orig = getattr(P, block)

    def spy(*a, **kw):
        out = orig(*a, **kw)
        seen.append((kw.get("relaxed", a[-1]), out is not None))
        return out
    monkeypatch.setattr(P, block, spy)
    xt = T(x)
    got = pnet.apply(xt, qstate=pq, int8="fused_relaxed", packed=ppk)
    monkeypatch.undo()
    depth = (sum(jnet.cfg.depths) if kind == "swin" else jnet.cfg.depth)
    assert seen == [(True, True)] * depth
    # the exact fused logits' scale (the port's: tests/test_torch_int8*
    # hold them to JAX's)
    exact = pnet.apply(xt, qstate=pq, int8="fused", packed=ppk)
    scale = float(exact.abs().max())
    diff = float(np.abs(got.numpy() - jrel).max())
    print(f"{kind}: port vs JAX relaxed {diff:.3e}, port relaxed vs exact "
          f"{float((got - exact).abs().max()):.3e}, max |exact| {scale:.3e}")
    assert diff < 0.10 * scale
    assert (got.numpy().argmax(-1) == jrel.argmax(-1)).all()
    assert not torch.equal(got, exact)
    assert float((got - exact).abs().max()) < 0.10 * scale


def test_relaxed_engine_is_the_relaxed_forward(tiny):
    """ServingEngine(relaxed=True) on the CPU: the forward in
    int8="fused_relaxed" on its packed weights, bitwise (fp32 and bf16)."""
    _, _, pnet, _, pq, x = tiny
    packed = pack_weights(pnet.params, pq)
    for dtype in (torch.float32, torch.bfloat16):
        got = ServingEngine(pnet, pq, compute_dtype=dtype, relaxed=True,
                            device="cpu")(x)
        want = pnet.apply(T(x), qstate=pq, int8="fused_relaxed",
                          packed=packed, compute_dtype=dtype)
        assert got.dtype == dtype and torch.equal(got, want)


def test_relaxed_per_op_path_engages(tiny):
    """The per-op fused path (a plain fc2, ``no_postgelu``: no block in
    the whole-block path) in the relaxed mode: B6's relaxed GELU in
    linear_gelu and the relaxed attention, within 10% of the exact per-op
    logits, not equal to them."""
    kind, jnet, pnet, _, _, x = tiny
    pq = qstate_from_numpy(minmax_qstate(jnet, x, postgelu=False))
    xt = T(x)
    exact = pnet.apply(xt, qstate=pq, int8="fused")
    got = pnet.apply(xt, qstate=pq, int8="fused_relaxed")
    assert torch.isfinite(got).all() and not torch.equal(got, exact)
    assert float((got - exact).abs().max()) < 0.10 * float(exact.abs().max())


def test_divergence_script_on_the_cpu():
    """scripts/torch_relaxed_divergence.py on the CPU, one instance of
    each family: every block fused in both modes (the script raises
    otherwise), the shift inside JAX's relaxed bound, its JSON fields."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "torch_relaxed_divergence.py")
    spec = importlib.util.spec_from_file_location("torch_relaxed_div", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.run(2, "cpu")
    assert out["device"] == "cpu" and out["top1_total"] == 64
    assert [i["net"] for i in out["instances"]] == ["vit", "swin"]
    assert 0 < out["max_logit_shift_rel"] < 0.10
    assert 0 < out["mean_logit_shift_rel"] <= out["max_logit_shift_rel"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.run(1, None)                  # the card by default
