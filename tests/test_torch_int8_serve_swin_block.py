"""The port's fused Swin block, ``int8="fused"`` Swin forward and per-op
window path against the JAX package, with the JAX fused path's
tolerances (tests/test_int8_serve.py:325: rtol 1e-3, atol 2e-3 of max
|logit|, argmax equal).

WIDE_SWIN (embed 128, heads of 64) and WIDE_SWIN32 (Swin-B's heads of 32)
are in the JAX kernels' TPU tiling, so both packages take the fused block
path on every block: stage 0 at res 8 in windows of 4, its second block
shifted, and stage 1 at res 4, one unshifted window.  With a plain
(not post-GELU) fc2 the block path is out of scope in both, and the
per-op path runs: B6 linears and B9 on the float qkv.  The qstates are
min-max ones (``minmax_qstate``), at bits 8 and 6.  The plain versions
the wrappers run on the CPU are counted, so the tests show which path
ran."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptq4vit_tpu.models.common import QuantCtx as JQuantCtx
from ptq4vit_tpu.ops.pack import pack_weights as jpack
from ptq4vit_tpu_torch import ServingEngine
from ptq4vit_tpu_torch.models import swin as pswin
from ptq4vit_tpu_torch.models.common import QuantCtx
from ptq4vit_tpu_torch.models.swin import (relative_position_index,
                                           shifted_window_mask)
from ptq4vit_tpu_torch.ops import int8_serve as pserve
from ptq4vit_tpu_torch.ops.pack import pack_weights
from ptq4vit_tpu_torch.utils.convert import qstate_from_numpy
from tests.test_torch_window7 import W7
from tests.torch_port_helpers import (WIDE_SWIN, WIDE_SWIN32, images,
                                      jax_swin_net, minmax_qstate, port_net)

SHAPES = {"hd64": WIDE_SWIN, "hd32": WIDE_SWIN32, "w7": W7}
REFS = {"q8_linear": "q8_linear_ref", "attention": "fused_attention_ref",
        "window_attention": "fused_window_attention_ref",
        "win_qkv": "q8_win_qkv_ref", "win_proj": "q8_win_proj_ref"}


@pytest.fixture
def ref_calls(monkeypatch):
    """Counts of the plain versions the wrappers run on the CPU (the
    outermost call only: B10's and B11's plain versions run B6's, B9's
    runs B7's)."""
    calls = dict.fromkeys(REFS, 0)
    depth = [0]

    def counted(fn, key):
        def run(*a, **kw):
            calls[key] += depth[0] == 0
            depth[0] += 1
            try:
                return fn(*a, **kw)
            finally:
                depth[0] -= 1
        return run
    for key, name in REFS.items():
        monkeypatch.setattr(pserve, name, counted(getattr(pserve, name), key))
    return calls


@pytest.fixture(scope="module")
def nets():
    """(JAX net, qstate, packed), (port net, qstate, packed), images of a
    shape at a bit width, built once per module."""
    built, quant = {}, {}

    def get(shape, bits, postgelu=True):
        if shape not in built:
            jnet = jax_swin_net(SHAPES[shape])
            built[shape] = (jnet, port_net(jnet),
                            images(2, SHAPES[shape]["img_size"]))
        jnet, pnet, x = built[shape]
        key = (shape, bits, postgelu)
        if key not in quant:
            jq = minmax_qstate(jnet, x, bits, postgelu=postgelu)
            pq = qstate_from_numpy(jq)
            quant[key] = ((jnet, jq, jpack(jnet.params, jq)),
                          (pnet, pq, pack_weights(pnet.params, pq)), x)
        return quant[key]
    return get


def close(got, ref):
    got = got.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got, ref, rtol=1e-3,
                               atol=2e-3 * np.abs(ref).max())


@pytest.mark.parametrize("bits", [8, 6])
@pytest.mark.parametrize("shape", ["hd64", "hd32"])
@pytest.mark.parametrize("j", [1, 0], ids=["shifted", "unshifted"])
def test_fused_swin_block_matches_jax(j, shape, bits, nets, ref_calls):
    (jnet, jq, jpk), (pnet, pq, ppk), _ = nets(shape, bits)
    cfg = pnet.cfg
    ws, shift = cfg.block_geometry(0, j)
    assert (shift > 0) == (j == 1)
    res, C, heads = cfg.layer_resolution(0), cfg.embed_dim, cfg.num_heads[0]
    N = ws * ws
    table = np.asarray(jnet.params["layers"][0]["blocks"][j]["attn"]
                       ["relative_position_bias_table"])
    bias = table[relative_position_index(ws).reshape(-1)] \
        .reshape(N, N, heads).transpose(2, 0, 1)
    mask = shifted_window_mask(res, ws, shift)
    xs = np.random.default_rng(5).standard_normal(
        (2, res * res, C)).astype(np.float32)
    p = f"layers.0.blocks.{j}"
    ref = JQuantCtx(qstate=jq, int8="fused", packed=jpk).swin_block(
        p, jnp.asarray(xs), jnet.params["layers"][0]["blocks"][j], heads, ws,
        shift, res, jnp.asarray(bias), mask, cfg.ln_eps)
    got = QuantCtx(qstate=pq, int8="fused", packed=ppk).swin_block(
        p, torch.from_numpy(xs), pnet.params["layers"][0]["blocks"][j], heads,
        ws, shift, res, torch.from_numpy(bias),
        None if mask is None else torch.from_numpy(mask), cfg.ln_eps)
    assert ref is not None and got is not None
    # B10, B9, B11, then fc1 and fc2 through B6
    assert ref_calls == {"q8_linear": 2, "attention": 0, "window_attention": 1,
                         "win_qkv": 1, "win_proj": 1}
    close(got, ref)


@pytest.mark.parametrize("bits", [8, 6])
@pytest.mark.parametrize("shape", ["hd64", "hd32"])
def test_fused_forward_of_wide_swin_matches_jax(shape, bits, nets,
                                                ref_calls):
    (jnet, jq, jpk), (pnet, pq, ppk), x = nets(shape, bits)
    ref = np.asarray(jnet.apply(jnp.asarray(x), qstate=jq, int8="fused",
                                packed=jpk))
    got = pnet.apply(torch.from_numpy(x), qstate=pq, int8="fused",
                     packed=ppk)
    # three blocks (B10, B9, B11, two B6 each), the reduction and the head
    assert ref_calls == {"q8_linear": 8, "attention": 0, "window_attention": 3,
                         "win_qkv": 3, "win_proj": 3}
    assert (got.argmax(-1).numpy() == ref.argmax(-1)).all()
    close(got, ref)
    # and the port's own exact int8 path, as JAX holds its fused path, where
    # s = hd^-0.5 is a power of two: at hd 32, q / (a1/s) and q·s / a1
    # round apart on some .5 boundaries, and JAX's own fused and exact
    # forwards differ here by as much (1.5% of max |logit|)
    if shape == "hd64":
        close(got, pnet.apply(torch.from_numpy(x), qstate=pq, int8=True)
              .numpy())


def test_per_op_window_path_matches_jax(nets, ref_calls):
    """``no_postgelu``: fc2 is a plain linear, so no block is in scope and
    each runs its four linears through B6 and its attention through B9 on
    the float qkv (``QuantCtx.window_attention_qkv``)."""
    (jnet, jq, jpk), (pnet, pq, ppk), x = nets("hd32", 8, postgelu=False)
    ref = np.asarray(jnet.apply(jnp.asarray(x), qstate=jq, int8="fused",
                                packed=jpk))
    got = pnet.apply(torch.from_numpy(x), qstate=pq, int8="fused",
                     packed=ppk)
    assert ref_calls == {"q8_linear": 3 * 4 + 2, "attention": 0,
                         "window_attention": 3, "win_qkv": 0, "win_proj": 0}
    assert (got.argmax(-1).numpy() == ref.argmax(-1)).all()
    close(got, ref)


# -- the serving engine's window terms ----------------------------------------

def per_call_geometry(monkeypatch):
    """The forward's device geometry made anew each call from numpy, as
    before it was cached."""
    monkeypatch.setattr(pswin, "device_relative_position_index",
                        lambda ws, device: torch.from_numpy(
                            relative_position_index(ws).reshape(-1))
                        .to(device))
    monkeypatch.setattr(pswin, "device_shifted_window_mask",
                        lambda res, ws, shift, device, dtype:
                        torch.from_numpy(shifted_window_mask(res, ws, shift))
                        .to(device=device, dtype=dtype))


def blocks_of(cfg):
    return [(i, j) for i, d in enumerate(cfg.depths) for j in range(d)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("mode", ["fused", "fused_relaxed"])
@pytest.mark.parametrize("case", ["hd32", "w7", "per_op"])
def test_engine_logits_equal_per_call_geometry(case, mode, dtype, nets,
                                               ref_calls, monkeypatch):
    """``ServingEngine`` builds B9's terms once (one a block) and a request
    builds no geometry; its logits are bitwise those of the same forward
    building the geometry and summing the term in every call, exact and
    relaxed, on the fused block path (window 4 and window 7) and on the
    per-op window path (``per_op``: fc2 not post-GELU)."""
    shape = "hd32" if case == "per_op" else case
    _, (pnet, pq, ppk), x = nets(shape, 8, postgelu=case != "per_op")
    n = len(blocks_of(pnet.cfg))
    pswin.reset_geometry_counts()
    engine = ServingEngine(pnet, pq, compute_dtype=dtype,
                           relaxed=mode == "fused_relaxed", device="cpu")
    assert pswin.geometry_counts()["term_builds"] == n
    engine(x)
    pswin.reset_geometry_counts()
    got = engine(x)
    # the per-op path gathers the bias for the generic ops it falls back
    # to; B9 takes the engine's term all the same
    shifted = sum(pnet.cfg.block_geometry(i, j)[1] > 0
                  for i, j in blocks_of(pnet.cfg))
    per_op = case == "per_op"
    assert pswin.geometry_counts() == {
        "index_builds": 0, "index_hits": n if per_op else 0,
        "mask_builds": 0, "mask_hits": shifted if per_op else 0,
        "term_builds": 0, "term_hits": n}
    assert ref_calls["window_attention"] == 2 * n
    with monkeypatch.context() as m:
        per_call_geometry(m)
        want = pnet.apply(torch.from_numpy(x), qstate=pq, int8=mode,
                          packed=pack_weights(pnet.params, pq),
                          compute_dtype=dtype)
    assert ref_calls["window_attention"] == 3 * n
    assert got.dtype == want.dtype == dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", ["hd32", "w7"])
def test_engine_term_is_bias_plus_mask(shape, dtype, nets, monkeypatch):
    """The term a request hands B9 is the engine's, and bitwise
    bias[None] + mask[:, None] in fp32 (bias alone unshifted) of the
    table cast to the compute dtype and the mask in it."""
    _, (pnet, pq, _), x = nets(shape, 8)
    cfg = pnet.cfg
    engine = ServingEngine(pnet, pq, compute_dtype=dtype, device="cpu")
    seen = []
    orig = pserve.fused_window_attention_qkv

    def spy(*a, **kw):
        seen.append(kw["term"])
        return orig(*a, **kw)
    monkeypatch.setattr(pserve, "fused_window_attention_qkv", spy)
    engine(x)
    blocks = blocks_of(cfg)
    assert len(seen) == len(blocks)
    for (i, j), term in zip(blocks, seen):
        assert term is engine._packed[f"layers.{i}.blocks.{j}.attn"][
            "window_term"]
        ws, shift = cfg.block_geometry(i, j)
        N, heads = ws * ws, cfg.num_heads[i]
        table = pnet.params["layers"][i]["blocks"][j]["attn"][
            "relative_position_bias_table"].to(dtype)
        bias = table[torch.from_numpy(relative_position_index(ws)
                                      .reshape(-1))] \
            .reshape(N, N, heads).permute(2, 0, 1).float()
        if shift:
            mask = torch.from_numpy(shifted_window_mask(
                cfg.layer_resolution(i), ws, shift)).to(dtype).float()
            want = bias[None] + mask[:, None]
        else:
            want = bias
        assert term.dtype == torch.float32 and term.is_contiguous()
        assert torch.equal(term, want)
    assert any(t.ndim == 4 for t in seen) and any(t.ndim == 3 for t in seen)
