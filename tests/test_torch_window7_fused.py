"""The fused window-7 paths (B10, B9, B11 and B6 through their plain
versions) against the JAX package on the CPU, on tests/test_torch_window7.py's
W7 and on W7_WIDE, W7 at C 128 with heads of 32 (Swin-B/224's stage 1),
which JAX's band kernels take at window 7.  Tolerances: JAX's fused ones
(rtol 1e-3, atol 2e-3 of max |logit| or output, argmax equal) and its
relaxed bound (10% of max |exact fused logit| or output)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptq4vit_tpu.models.common import QuantCtx as JQuantCtx
from ptq4vit_tpu.ops.pack import pack_weights as jpack
from ptq4vit_tpu_torch.models.common import QuantCtx
from ptq4vit_tpu_torch.models.swin import (relative_position_index,
                                           shifted_window_mask)
from ptq4vit_tpu_torch.ops import int8_serve as pserve
from ptq4vit_tpu_torch.ops.pack import pack_weights
from ptq4vit_tpu_torch.utils.convert import qstate_from_numpy
from tests.test_torch_int8_serve_block import close
from tests.test_torch_window7 import W7
from tests.torch_port_helpers import (images, jax_swin_net, minmax_qstate,
                                      port_net)

# W7 at C 128 with heads of 32 (Swin-B/224's stage 1): in JAX's band scope
W7_WIDE = dict(W7, embed_dim=128, num_heads=(4, 8))


def test_window7_fused_and_relaxed_logits_match_jax(monkeypatch):
    """Under a min-max qstate (as the other fused Swin tests): every block
    through the fused window path (B10, B9, B11: one call of each plain
    version a block, the shifted and the clamped ones too) at JAX's
    fused tolerance and argmax against JAX's ``int8="fused"`` -- its
    exact int8 path at C = 24 --; the relaxed mode within JAX's relaxed
    bound of JAX's.  (Under a calibrated qstate the port's fused logits
    move off the exact ones by the a1/s rounding class, 0.85% of max
    |logit| here: JAX's own fused path rounds so too, ROADMAP Queue C's
    "not faults"; the blocks below hold the fused paths to each other.)"""
    jnet = jax_swin_net(W7)
    pnet = port_net(jnet)
    x = images(2, 28)
    jq = minmax_qstate(jnet, x)
    pq = qstate_from_numpy(jq)
    jpk, ppk = jpack(jnet.params, jq), pack_weights(pnet.params, pq)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    calls = {"q8_win_qkv_ref": 0, "fused_window_attention_ref": 0,
             "q8_win_proj_ref": 0}

    def counted(name):
        fn = getattr(pserve, name)

        def run(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return run
    for name in calls:
        monkeypatch.setattr(pserve, name, counted(name))
    ref = np.asarray(jnet.apply(xj, qstate=jq, int8="fused", packed=jpk))
    got = pnet.apply(xt, qstate=pq, int8="fused", packed=ppk)
    assert calls == dict.fromkeys(calls, sum(W7["depths"]))
    assert (got.argmax(-1).numpy() == ref.argmax(-1)).all()
    close(got, ref)
    jrel = np.asarray(jnet.apply(xj, qstate=jq, int8="fused_relaxed",
                                 packed=jpk))
    rel = pnet.apply(xt, qstate=pq, int8="fused_relaxed", packed=ppk)
    assert calls == dict.fromkeys(calls, 2 * sum(W7["depths"]))
    scale = float(got.abs().max())
    assert not torch.equal(rel, got)
    assert float(np.abs(rel.numpy() - jrel).max()) < 0.10 * scale
    assert (rel.numpy().argmax(-1) == jrel.argmax(-1)).all()


@pytest.fixture(scope="module")
def wide():
    jnet = jax_swin_net(W7_WIDE)
    jq = minmax_qstate(jnet, images(2, 28))
    pnet, pq = port_net(jnet), qstate_from_numpy(jq)
    return (jnet, jq, jpack(jnet.params, jq)), \
        (pnet, pq, pack_weights(pnet.params, pq))


@pytest.mark.parametrize("i,j", [(0, 0), (0, 1), (1, 0)],
                         ids=["unshifted", "shifted", "clamped"])
def test_window7_fused_blocks_match_jax_fused_blocks(wide, i, j):
    """W7_WIDE's blocks (C 128 and 256, heads of 32: in JAX's band scope at
    window 7) through both packages' fused block path on the same input:
    B10 / B9 / B11 and B6 against JAX's band kernels in interpret mode, at
    JAX's fused tolerance (rtol 1e-3, atol 2e-3 of max |output|); the
    relaxed blocks within JAX's relaxed bound (10% of max |exact
    output|).  At the forward level both packages' exact and fused logits
    part here by one-level flips of upstream ulps compounding (1.1% of max
    |logit|), so the fused path is held block by block, as
    tests/test_torch_int8_serve_swin_block.py holds window 4."""
    (jnet, jq, jpk), (pnet, pq, ppk) = wide
    cfg = pnet.cfg
    ws, shift = cfg.block_geometry(i, j)
    assert (ws, shift) == ((7, 3) if (i, j) == (0, 1) else (7, 0))
    res, C, heads = (cfg.layer_resolution(i), cfg.layer_dim(i),
                     cfg.num_heads[i])
    N = ws * ws
    table = np.asarray(jnet.params["layers"][i]["blocks"][j]["attn"]
                       ["relative_position_bias_table"])
    bias = table[relative_position_index(ws).reshape(-1)] \
        .reshape(N, N, heads).transpose(2, 0, 1)
    mask = shifted_window_mask(res, ws, shift)
    xs = np.random.default_rng(5).standard_normal(
        (2, res * res, C)).astype(np.float32)
    p = f"layers.{i}.blocks.{j}"
    outs = {}
    for mode in ("fused", "fused_relaxed"):
        ref = JQuantCtx(qstate=jq, int8=mode, packed=jpk).swin_block(
            p, jnp.asarray(xs), jnet.params["layers"][i]["blocks"][j],
            heads, ws, shift, res, jnp.asarray(bias), mask, cfg.ln_eps)
        got = QuantCtx(qstate=pq, int8=mode, packed=ppk).swin_block(
            p, torch.from_numpy(xs), pnet.params["layers"][i]["blocks"][j],
            heads, ws, shift, res, torch.from_numpy(bias),
            None if mask is None else torch.from_numpy(mask), cfg.ln_eps)
        assert ref is not None and got is not None
        outs[mode] = (got, np.asarray(ref))
    close(*outs["fused"])
    got, ref = outs["fused_relaxed"]
    scale = float(outs["fused"][0].abs().max())
    assert not torch.equal(got, outs["fused"][0])
    assert float(np.abs(got.numpy() - ref).max()) < 0.10 * scale
