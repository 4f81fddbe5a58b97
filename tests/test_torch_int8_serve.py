"""B6's plain version (``q8_linear_ref``, what the wrapper runs on the
CPU) against the JAX package's ``q8_linear`` (Pallas, interpret mode) in
every mode: input float / post-GELU twin / int8 levels / twin-packed int8,
with and without the LayerNorm prologue and the GELU epilogue, output
float (with and without the residual) / per-column requantized / twin
packed, at qmax 128 and 32.

Tolerance: float outputs rtol 1e-5, atol 1e-5 of max |ref| (JAX's own
fused-vs-XLA tolerance, tests/test_int8_serve.py:40); int8 outputs within
one level, in at most 1% of the elements (the LayerNorm statistics and the
GELU's exp are computed by another library and may round a level the
other way at a boundary).

Also B6's split for a row-parallel linear under tensor parallelism: the
int32 partial sums of two shards of K (``out_q="acc"``, plain version
``_q8_acc_ref``) summed and put through the epilogue (``q8_epilogue``,
plain version ``q8_epilogue_ref``) equal the whole linear bitwise, B11's
row map included."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptq4vit_tpu.ops.int8_serve import q8_linear as jq8
from ptq4vit_tpu.quant.fakequant import GELU_NEG_CLIP
from ptq4vit_tpu_torch.ops.int8_serve import (_q8_acc_ref, q8_epilogue,
                                              q8_epilogue_ref, q8_linear,
                                              q8_linear_ref, q8_win_proj,
                                              q8_win_proj_ref)

M, K, N = 37, 128, 96


def cases():
    for mode, ln, gelu, out, qmax in itertools.product(
            ("f", "f_twin", "q8", "q8twin"), (False, True), (False, True),
            ("float", "residual", "vec", "twin"), (128, 32)):
        if ln and mode in ("q8", "q8twin"):
            continue          # the LayerNorm prologue reads a float input
        yield pytest.param(mode, ln, gelu, out, qmax,
                           id=f"{mode}-{'ln' if ln else 'noln'}-"
                              f"{'gelu' if gelu else 'id'}-{out}-q{qmax}")


def inputs(mode, ln, qmax, seed):
    rng = np.random.default_rng(seed)
    if mode in ("q8", "q8twin"):
        x = rng.integers(-qmax, qmax, (M, K)).astype(np.int8)
        a = np.float32(0.03)
    else:
        x = (rng.standard_normal((M, K)) * 2 + 0.3).astype(np.float32)
        if mode == "f_twin":
            x = np.where(x > 0, x, x * 0.05).astype(np.float32)
        a = np.float32((3.0 if ln else np.abs(x).max()) / (qmax - 0.5))
    w = rng.integers(-qmax, qmax, (K, N)).astype(np.int8)
    # per-column scales that bring the output to about unit size
    ws = (rng.random(N) + 0.5).astype(np.float32) \
        / np.float32(a * qmax * qmax * np.sqrt(K) / 3)
    b = (rng.standard_normal(N) * 0.1).astype(np.float32)
    lnp = ((1 + 0.1 * rng.standard_normal(K)).astype(np.float32),
           (0.1 * rng.standard_normal(K)).astype(np.float32), 1e-6)
    res = rng.standard_normal((M, N)).astype(np.float32)
    osc = ((rng.random(N) + 1.5) / (qmax - 0.5)).astype(np.float32)
    return x, a, w, ws, b, lnp, res, osc


def tensor(v):
    return torch.from_numpy(np.asarray(v))


def flips_ok(got, ref, what):
    d = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert d.max() <= 1, f"{what}: off by {d.max()} levels"
    assert (d > 0).mean() <= 0.01, f"{what}: {(d > 0).mean():.2%} flips"


@pytest.mark.parametrize("mode,ln,gelu,out,qmax", list(cases()))
def test_q8_linear_ref_matches_jax(mode, ln, gelu, out, qmax):
    x, a, w, ws, b, lnp, res, osc = inputs(mode, ln, qmax, seed=qmax + K)
    a_neg = np.float32(GELU_NEG_CLIP / qmax) if mode in ("f_twin",
                                                         "q8twin") else None
    twin_scale = (np.float32(3.0 / (qmax - 0.5)),
                  np.float32(GELU_NEG_CLIP / qmax))
    kw = dict(a_qmax=qmax, postgelu=mode in ("f_twin", "q8twin"),
              epilogue="gelu" if gelu else None,
              in_q=mode if mode in ("q8", "q8twin") else None,
              out_q={"vec": "vec", "twin": "twin"}.get(out), out_qmax=qmax)
    q8 = mode in ("q8", "q8twin")

    def run(conv, fn):
        # the block passes the residual stream's dtype for int8 inputs
        f32 = jnp.float32 if conv is jnp.asarray else torch.float32
        return fn(conv(x), conv(w), conv(ws), conv(b), conv(a),
                  None if a_neg is None else conv(a_neg),
                  ln=(conv(lnp[0]), conv(lnp[1]), lnp[2]) if ln else None,
                  out_scale=(conv(osc) if out == "vec" else
                             tuple(conv(v) for v in twin_scale)
                             if out == "twin" else None),
                  residual=conv(res) if out == "residual" else None,
                  float_dtype=f32 if q8 else None, **kw)

    ref = np.asarray(run(jnp.asarray, jq8))
    got = run(tensor, q8_linear_ref)
    # on a CPU tensor the wrapper is the plain version
    assert torch.equal(run(tensor, q8_linear), got)
    got = got.numpy()
    assert got.dtype == ref.dtype and got.shape == ref.shape == (M, N)
    if out in ("vec", "twin"):
        flips_ok(got, ref, "int8 output")
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())


def test_q8_linear_ref_bf16_input_and_residual():
    """x and the residual in bf16 (the serving compute dtype): the float
    output takes x's dtype, as in JAX."""
    x, a, w, ws, b, lnp, res, _ = inputs("f", True, 128, seed=7)
    kw = dict(a_qmax=128, postgelu=False)
    ref = jq8(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), jnp.asarray(ws),
              jnp.asarray(b), jnp.asarray(a), None,
              ln=(jnp.asarray(lnp[0]), jnp.asarray(lnp[1]), lnp[2]),
              residual=jnp.asarray(res, jnp.bfloat16), **kw)
    got = q8_linear_ref(torch.from_numpy(x).bfloat16(), torch.from_numpy(w),
                        torch.from_numpy(ws), torch.from_numpy(b),
                        torch.tensor(a), None,
                        ln=(torch.from_numpy(lnp[0]),
                            torch.from_numpy(lnp[1]), lnp[2]),
                        residual=torch.from_numpy(res).bfloat16(), **kw)
    assert got.dtype == torch.bfloat16
    r = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), r, rtol=1e-2,
                               atol=1e-2 * np.abs(r).max())


@pytest.mark.parametrize("residual", [False, True],
                         ids=["no_residual", "residual"])
@pytest.mark.parametrize("mode", ["f", "f_twin", "q8", "q8twin"])
def test_k_shards_summed_before_the_epilogue_give_the_whole_linear(
        mode, residual):
    """Two shards of K (a row-parallel linear over model=2): each shard's
    int32 planes (pos and neg for a twin input), summed, then the epilogue
    with the bias and the residual added once, equal ``q8_linear_ref`` of
    the whole K bitwise."""
    x, a, w, ws, b, _, res, _ = inputs(mode, False, 128, seed=11)
    twin, q8 = mode in ("f_twin", "q8twin"), mode in ("q8", "q8twin")
    a_neg = tensor(np.float32(GELU_NEG_CLIP / 128)) if twin else None
    kw = dict(a_qmax=128, postgelu=twin, in_q=mode if q8 else None)
    xt, wt, at = tensor(x), tensor(w), tensor(a)
    parts = [q8_linear(xt[:, s], wt[s], tensor(ws), None, at, a_neg,
                       out_q="acc", **kw)
             for s in (slice(0, K // 2), slice(K // 2, K))]
    assert parts[0].dtype == torch.int32
    assert parts[0].shape == (2 if twin else 1, M, N)
    acc = parts[0] + parts[1]
    assert torch.equal(acc, _q8_acc_ref(xt, wt, at, a_neg, **kw))
    r = tensor(res) if residual else None
    want = q8_linear_ref(xt, wt, tensor(ws), tensor(b), at, a_neg,
                         residual=r,
                         float_dtype=torch.float32 if q8 else None, **kw)
    got = q8_epilogue(acc, tensor(ws), tensor(b), at, a_neg, residual=r)
    assert got.dtype == torch.float32
    assert torch.equal(got, want)
    assert torch.equal(q8_epilogue_ref(acc, tensor(ws), tensor(b), at, a_neg,
                                       residual=r), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_k_shards_summed_before_the_epilogue_give_b11(dtype):
    """B11's split: each shard's int32 sums in the window layout, summed,
    then the epilogue with the row map to the image layout and the
    residual, equal ``q8_win_proj_ref`` bitwise."""
    rng = np.random.default_rng(12)
    B, res, ws, C = 2, 8, 4, 32
    y_q = tensor(rng.integers(-128, 128, (B * (res // ws) ** 2, ws * ws, C))
                 .astype(np.int8))
    w = tensor(rng.integers(-128, 128, (C, C)).astype(np.int8))
    wsc = tensor(((rng.random(C) + 0.5) / 2000).astype(np.float32))
    b = tensor((rng.standard_normal(C) * 0.1).astype(np.float32))
    r4 = torch.from_numpy(rng.standard_normal((B, res, res, C))
                          .astype(np.float32)).to(dtype)
    a = torch.tensor(0.03)
    parts = [q8_win_proj(y_q[..., s].contiguous(), w[s], wsc, None, a, ws,
                         res, None, a_qmax=128, out_q="acc")
             for s in (slice(0, C // 2), slice(C // 2, C))]
    assert parts[0].shape == (1,) + tuple(y_q.shape)
    got = q8_epilogue(parts[0] + parts[1], wsc, b, a, residual=r4,
                      window=(ws, res))
    want = q8_win_proj_ref(y_q, w, wsc, b, a, ws, res, r4, a_qmax=128)
    assert got.dtype == dtype and torch.equal(got, want)
