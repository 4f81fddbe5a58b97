"""The relaxed serving mode (``int8="fused_relaxed"``,
``ServingEngine(relaxed=True)``: the bf16 epilogues of B6, B7-B9 and B10)
of the port against the JAX package.

Bodies, eagerly: JAX's relaxed kernel bodies (``_linear_kernel``,
``_attn_math``, ``_win_qkv_kernel``) called on numpy refs under
``jax.disable_jit()``, where each operation rounds on its own, against
the port's relaxed plain versions on the same seeded inputs: bitwise,
except the one named class -- a bf16 exp or tanh that the two libraries
round to different sides (``exp_class`` / ``tanh_class``: the bf16
arguments where they part, found over every bf16 value).  An output may
differ only where such an argument was met (the element's GELU; the
softmax row of the logit), and those are counted.

Bodies, under ``jit``: JAX's public kernels in interpret mode, where
XLA's CPU backend keeps excess precision in its bf16 chains (a product
is not rounded to bf16 before its level is taken): every int8 level
within one step of the port's, float outputs within one probability
level's contribution (attention) or a few bf16 steps (GELU); the
elements off are counted.

The tiny ViT and Swin end to end: tests/test_torch_relaxed_forward.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptq4vit_tpu.ops import int8_serve as J
from ptq4vit_tpu.quant.qparams import MatMulQP as JMatMulQP
from ptq4vit_tpu_torch.models.swin import window_partition
from ptq4vit_tpu_torch.ops import int8_serve as P
from ptq4vit_tpu_torch.utils.convert import qstate_from_numpy

Q = 128


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def all_bf16():
    """Every finite bf16 value, as float32."""
    v = torch.arange(2 ** 16, dtype=torch.int32).to(torch.int16) \
        .view(torch.bfloat16).float()
    return v[torch.isfinite(v)]


@pytest.fixture(scope="module")
def classes():
    """{"exp", "tanh"}: the bf16 arguments where JAX's bf16 function
    (eager) and the port's (float32, then rounded) part."""
    v = all_bf16()
    out = {}
    for name, jf, tf in (("exp", jnp.exp, torch.exp),
                         ("tanh", jnp.tanh, torch.tanh)):
        with jax.disable_jit():
            j = np.asarray(jf(jnp.asarray(v.numpy()).astype(jnp.bfloat16))
                           .astype(jnp.float32))
        t = P.bf(tf(v)).numpy()
        part = ~((j == t) | (np.isnan(j) & np.isnan(t)))
        out[name] = torch.from_numpy(v.numpy()[part])
    return out


def test_bf16_class_is_small_and_constants_agree(classes):
    """The class is a few bf16 values, not a formula's difference; the
    tanh-GELU's bf16 constants are JAX's."""
    print(f"exp class {classes['exp'].numel()} values, tanh class "
          f"{classes['tanh'].numel()} of {all_bf16().numel()}")
    assert classes["exp"].numel() <= 64 and classes["tanh"].numel() <= 64
    assert float(P.bf(P.GELU_C)) == float(jnp.bfloat16(P.GELU_C))
    assert float(P.bf(P.GELU_K)) == float(jnp.bfloat16(P.GELU_K))


class Recorder:
    """Records the arguments of ``torch.<name>`` while installed."""

    def __init__(self, monkeypatch, name):
        self.args, fn = [], getattr(torch, name)

        def rec(x, *a, **kw):
            self.args.append(x.detach().clone())
            return fn(x, *a, **kw)
        monkeypatch.setattr(torch, name, rec)


# ---------------------------------------------------------------------------
# B6: _linear_kernel
# ---------------------------------------------------------------------------

def linear_inputs(mode, ln, qmax, M=64, K=128, N=96, seed=0):
    rng = np.random.default_rng(seed + qmax)
    if mode == "q8":
        x = rng.integers(-qmax, qmax, (M, K)).astype(np.int8)
        a = np.float32(0.03)
    else:
        x = (rng.standard_normal((M, K)) * 2 + 0.3).astype(np.float32)
        a = np.float32((3.0 if ln else np.abs(x).max()) / (qmax - 0.5))
    w = rng.integers(-qmax, qmax, (K, N)).astype(np.int8)
    ws = ((rng.random(N) + 0.5) / (a * qmax * qmax * np.sqrt(K) / 3)) \
        .astype(np.float32)
    b = (rng.standard_normal(N) * 0.1).astype(np.float32)
    lnw = (1 + 0.1 * rng.standard_normal(K)).astype(np.float32)
    lnb = (0.1 * rng.standard_normal(K)).astype(np.float32)
    osc = ((rng.random(N) + 1.5) / (qmax - 0.5)).astype(np.float32)
    res = rng.standard_normal((M, N)).astype(np.float32)
    twin = (np.float32(3.0 / (qmax - 0.5)), np.float32(0.17 / qmax))
    return x, a, w, ws, b, (lnw, lnb, 1e-6), osc, res, twin


def port_linear(inp, mode, ln, gelu, out, qmax, residual, relaxed=True):
    x, a, w, ws, b, lnp, osc, res, twin = inp
    return P.q8_linear_ref(
        T(x), T(w), T(ws), T(b), torch.tensor(a), None, a_qmax=qmax,
        postgelu=False, epilogue="gelu" if gelu else None,
        ln=(T(lnp[0]), T(lnp[1]), lnp[2]) if ln else None,
        in_q="q8" if mode == "q8" else None, out_q=out,
        out_scale=(T(osc) if out == "vec" else
                   tuple(torch.tensor(v) for v in twin) if out == "twin"
                   else None),
        out_qmax=qmax, residual=T(res) if residual else None,
        float_dtype=torch.float32, relaxed=relaxed)


LINEAR_CASES = [("f", True, False, "vec", False),
                ("q8", False, False, "vec", False),
                ("f", True, True, "twin", False),
                ("f", False, True, None, False),
                ("f", True, True, None, True)]


@pytest.mark.parametrize("qmax", [128, 32])
@pytest.mark.parametrize("mode,ln,gelu,out,residual", LINEAR_CASES)
def test_relaxed_linear_body_matches_jax_eagerly(classes, monkeypatch, mode,
                                                 ln, gelu, out, residual,
                                                 qmax):
    """B6's relaxed epilogue (per-column requant, twin pack after the
    tanh-GELU, float out after it, with a residual) bitwise JAX's eager
    body, except elements whose tanh argument is in the tanh class."""
    inp = linear_inputs(mode, ln, qmax)
    x, a, w, ws, b, lnp, osc, res, twin = inp
    M, N = x.shape[0], w.shape[1]
    scal = np.array([[a, 1.0, lnp[2], *twin]], np.float32)
    ref = np.zeros((M, N), np.int8 if out else np.float32)
    with jax.disable_jit():
        J._linear_kernel(scal, lnp[0][None], lnp[1][None], x, w, ws[None],
                         b[None], osc[None], res if residual else
                         np.zeros((1, 1), np.float32), ref, a_qmax=qmax,
                         out_qmax=qmax, in_mode=mode, ln=ln, gelu=gelu,
                         out_q=out, residual=residual, relaxed=True)
    tanh = Recorder(monkeypatch, "tanh")
    got = port_linear(inp, mode, ln, gelu, out, qmax, residual).numpy()
    monkeypatch.undo()
    hit = (torch.isin(tanh.args[0], classes["tanh"]).numpy() if gelu
           else np.zeros((M, N), bool))
    off = got != ref
    print(f"{off.sum()} of {off.size} off, {hit.sum()} tanh-class elements")
    assert not (off & ~hit).any()
    # the relaxed chain is another function than the exact one
    exact = port_linear(inp, mode, ln, gelu, out, qmax, residual, False)
    assert not np.array_equal(exact.numpy(), got)


@pytest.mark.parametrize("mode,ln,gelu,out,residual", LINEAR_CASES)
def test_relaxed_linear_under_jit_within_a_step(mode, ln, gelu, out,
                                                residual):
    """JAX's q8_linear(relaxed=True) in interpret mode (jitted): int8
    levels within one step, float GELU outputs within 2^-6 of their size
    (the kept excess precision moves h's bf16 roundings); counted."""
    qmax = 128
    inp = linear_inputs(mode, ln, qmax, seed=5)
    x, a, w, ws, b, lnp, osc, res, twin = inp
    ref = np.asarray(J.q8_linear(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(ws), jnp.asarray(b),
        jnp.asarray(a), None, a_qmax=qmax, postgelu=False,
        epilogue="gelu" if gelu else None,
        ln=tuple(jnp.asarray(v) for v in lnp[:2]) + (lnp[2],) if ln
        else None, in_q="q8" if mode == "q8" else None, out_q=out,
        out_scale=(jnp.asarray(osc) if out == "vec" else
                   tuple(jnp.asarray(v) for v in twin) if out == "twin"
                   else None), out_qmax=qmax,
        residual=jnp.asarray(res) if residual else None,
        float_dtype=jnp.float32, relaxed=True))
    got = port_linear(inp, mode, ln, gelu, out, qmax, residual).numpy()
    if out:
        d = np.abs(got.astype(np.int32) - ref.astype(np.int32))
        print(f"{(d > 0).sum()} of {d.size} levels one step off")
        assert d.max() <= 1
    else:
        err = np.abs(got - ref)
        print(f"{(err > 0).sum()} of {err.size} outputs off")
        # relative to the GELU's output (the residual added after it)
        gelu_out = np.abs(ref - res) if residual else np.abs(ref)
        assert (err <= 2.0 ** -6 * gelu_out + 1e-6).all()


def test_float_linear_without_gelu_is_the_exact_path():
    """A float output without GELU (proj, fc2, the head, B11's epilogue)
    is the same function in both modes: bitwise the exact output, and on
    the card the exact kernel (``relaxed_variant`` False)."""
    for mode in ("f", "q8"):
        for residual in (False, True):
            inp = linear_inputs(mode, mode == "f", Q, seed=9)
            got = port_linear(inp, mode, mode == "f", False, None, Q,
                              residual)
            assert torch.equal(got, port_linear(inp, mode, mode == "f",
                                                False, None, Q, residual,
                                                False))
    assert not P.relaxed_variant(True, None, None)
    assert not P.relaxed_variant(True, None, "acc")
    assert P.relaxed_variant(True, "gelu", None)
    assert P.relaxed_variant(True, None, "vec")
    assert not P.relaxed_variant(False, "gelu", "twin")


# ---------------------------------------------------------------------------
# B7 / B8 / B9: _attn_math
# ---------------------------------------------------------------------------

def attn_inputs(N, hd, sos, in_q8, window, seed):
    rng = np.random.default_rng(seed)
    qf, kf = (rng.standard_normal((2, N, hd)) * 2).astype(np.float32)
    vf = rng.standard_normal((N, hd)).astype(np.float32)
    a1, b1, b2 = (np.float32(np.abs(t).max() / (Q - 0.5))
                  for t in (qf, kf, vf))
    split = np.float32(2.0 ** -5)
    a2 = np.float32(split / (Q - 1)) if sos else np.float32(1 / (Q - 0.5))
    if in_q8:
        qf, kf, vf = (np.clip(np.round(t / s), -Q, Q - 1).astype(np.int8)
                      for t, s in ((qf, a1), (kf, b1), (vf, b2)))
    extra = ((rng.standard_normal((N, N)) * 0.5).astype(np.float32)
             + np.where(rng.random((N, N)) > 0.8, -100.0, 0.0)
             .astype(np.float32)) if window else None
    return qf, kf, vf, (a1, b1, a2, b2), split, extra


@pytest.mark.parametrize("window", [False, True], ids=["vit", "window"])
@pytest.mark.parametrize("in_q8,out_q8", [(False, False), (True, True),
                                          (False, True), (True, False)],
                         ids=["f-f", "q8-q8", "f-q8", "q8-f"])
@pytest.mark.parametrize("sos", [True, False], ids=["sos", "per-head"])
def test_relaxed_attention_body_matches_jax_eagerly(classes, monkeypatch,
                                                    sos, in_q8, out_q8,
                                                    window):
    """The relaxed softmax, SoS / per-head levels and output requant
    bitwise JAX's eager ``_attn_math``, except in softmax rows that met
    the exp class (ViT's head of 64 over 37 keys, a window's 32 over 144
    with the additive term)."""
    N, hd = (144, 32) if window else (37, 64)
    q, k, v, ph, split, extra = attn_inputs(N, hd, sos, in_q8, window,
                                            seed=11 + 2 * sos + in_q8)
    a_out, scale = np.float32(0.02), np.float32(hd ** -0.5)
    with jax.disable_jit():
        ref = np.asarray(J._attn_math(
            q, k.T.copy(), v, *ph, split, scale, a_out, sos=sos,
            in_q8=in_q8, out_q8=out_q8, A1_qmax=Q, B1_qmax=Q, A2_qmax=Q,
            B2_qmax=Q, O_qmax=Q, extra=extra, relaxed=True))
    rec = Recorder(monkeypatch, "exp")
    got = P.fused_attention_ref(
        T(q)[None, None], T(k)[None, None], T(v)[None, None],
        torch.tensor(np.array(ph)).reshape(4, 1),
        torch.tensor(split) if sos else None, float(scale),
        torch.tensor(a_out) if out_q8 else None, sos=sos, in_q8=in_q8,
        qmaxes=(Q,) * 5, out_dtype=torch.float32,
        extra=None if extra is None else T(extra)[None, None],
        relaxed=True)[0, 0].numpy()
    monkeypatch.undo()
    rows = torch.isin(rec.args[0], classes["exp"])[0, 0].any(-1).numpy()
    off = (got != ref).any(-1)
    print(f"{off.sum()} of {N} rows off, {rows.sum()} met the exp class")
    assert got.dtype == ref.dtype and not (off & ~rows).any()


def jax_qps(q, k, v, H, sos):
    shape = (1, H, 1, 1, 1, 1, 1)

    def hmax(t):
        return jnp.asarray((np.abs(t).max((0, 2, 3)) / (Q - 0.5))
                           .reshape(shape).astype(np.float32))
    split = jnp.float32(2.0 ** -5)
    qp1 = JMatMulQP(A_interval=hmax(q), B_interval=hmax(k))
    qp2 = JMatMulQP(A_interval=(split / (Q - 1) if sos else
                                jnp.full(shape, 1 / (Q - 0.5), jnp.float32)),
                    B_interval=hmax(v), split=split if sos else None)
    port = qstate_from_numpy({"1": qp1, "2": qp2})
    return (qp1, qp2), (port["1"], port["2"])


def assert_attention_within_a_step(got, ref, ph, sos, v_lv, a_out):
    """Every probability level within one step of JAX's: an output (B_, N,
    H hd) is then off by at most the sum over the keys of one step's
    contribution, |v level| b2 (1 / (q - 1) + a_int with SoS, a2 per
    head), and an int8 output by one level more than that over a_out.
    ``v_lv`` (B_, N, H, hd): the v levels.  Returns the count of elements
    off."""
    got = got.numpy()
    a_int = float(ph[2][0]) if sos else 0.0
    unit = (ph[3] * (1.0 / (Q - 1) + a_int) if sos else ph[3] * ph[2])
    bound = (np.abs(v_lv.astype(np.float64)).sum(1)
             * unit.numpy()[None, :, None]).reshape(len(got), 1, -1)
    if ref.dtype == np.int8:
        d = np.abs(got.astype(np.int32) - ref.astype(np.int32))
        assert (d <= 1 + np.ceil(bound / a_out)).all()
        return int((d > 0).sum())
    err = np.abs(got.astype(np.float64) - ref)
    assert (err <= 1e-5 * np.abs(ref) + bound).all()
    return int((err > 1e-5 * np.abs(ref)).sum())


@pytest.mark.parametrize("in_q8,out_q8", [(False, False), (True, True)],
                         ids=["f-f", "q8-q8"])
@pytest.mark.parametrize("sos", [True, False], ids=["sos", "per-head"])
def test_relaxed_attention_under_jit_within_a_step(sos, in_q8, out_q8):
    """JAX's fused_attention_qkv(relaxed=True) (B7) and
    fused_window_attention_qkv(relaxed=True) (B9, bias and shifted mask)
    in interpret mode against the port's wrappers on the CPU: under jit a
    whole row's probabilities may move (bf16(1 / sum) is not rounded), so
    the check is every probability level within one step
    (``assert_attention_within_a_step``)."""
    from ptq4vit_tpu_torch.models.swin import shifted_window_mask
    rng = np.random.default_rng(31 + sos)
    off = []
    for kind, (B_, N, H, hd) in (("vit", (2, 37, 2, 64)),
                                 ("window", (8, 16, 4, 32))):
        qkv = rng.standard_normal((B_, N, 3 * H * hd)).astype(np.float32)
        t = qkv.reshape(B_, N, 3, H, hd).transpose(2, 0, 3, 1, 4)
        s = hd ** -0.5
        (jq1, jq2), (pq1, pq2) = jax_qps(t[0] * (s if kind == "window"
                                                 else 1), t[1], t[2], H, sos)
        a_out = np.float32(0.02) if out_q8 else None
        if kind == "vit":
            ph, _ = P.attn_scope(pq1, pq2, H)
        else:
            ph, _ = P.window_attn_scope(pq1, pq2, H, s)
        x = qkv
        if in_q8:
            cols = torch.cat([ph[i].repeat_interleave(hd)
                              for i in (0, 1, 3)]).numpy()
            x = np.clip(np.round(qkv / cols), -Q, Q - 1).astype(np.int8)
        kw = dict(in_q8=in_q8, relaxed=True)
        if kind == "vit":
            ref = np.asarray(J.fused_attention_qkv(
                jnp.asarray(x), H, jq1, jq2, s, out_scale=a_out, **kw))
            got = P.fused_attention_qkv(
                T(x), H, pq1, pq2, s,
                out_scale=None if a_out is None else torch.tensor(a_out),
                **kw)
        else:
            nW, ws = 4, 4
            bias = (rng.standard_normal((H, N, N)) * 0.5).astype(np.float32)
            mask = shifted_window_mask(2 * ws, ws, ws // 2)
            ref = np.asarray(J.fused_window_attention_qkv(
                jnp.asarray(x), H, nW, jq1, jq2, s, jnp.asarray(bias),
                jnp.asarray(mask), out_scale=a_out, **kw))
            got = P.fused_window_attention_qkv(
                T(x), H, nW, pq1, pq2, s, T(bias), T(mask),
                out_scale=None if a_out is None else torch.tensor(a_out),
                **kw)
        v = x.reshape(B_, N, 3, H, hd)[:, :, 2]
        if not in_q8:
            v = np.clip(np.round(v / ph[3].numpy()[:, None]), -Q, Q - 1)
        off.append(assert_attention_within_a_step(got, ref, ph, sos, v,
                                                  a_out))
    print(f"elements off (vit, window): {off}")


# ---------------------------------------------------------------------------
# B10: _win_qkv_kernel
# ---------------------------------------------------------------------------

def win_qkv_inputs(B=1, res=8, ws=4, C=128, seed=41):
    rng = np.random.default_rng(seed)
    x4 = (rng.standard_normal((B, res, res, C)) * 2 + 0.3).astype(np.float32)
    a = np.float32(3.0 / (Q - 0.5))
    w = rng.integers(-Q, Q, (C, 3 * C)).astype(np.int8)
    wsc = ((rng.random(3 * C) + 0.5) / (a * Q * Q * np.sqrt(C) / 3)) \
        .astype(np.float32)
    b = (rng.standard_normal(3 * C) * 0.1).astype(np.float32)
    lnw = (1 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    lnb = (0.1 * rng.standard_normal(C)).astype(np.float32)
    osc = ((rng.random(3 * C) + 1.5) / (Q - 0.5)).astype(np.float32)
    return x4, a, w, wsc, b, (lnw, lnb, 1e-5), ws, osc


def port_win_qkv(inp):
    x4, a, w, wsc, b, lnp, ws, osc = inp
    return P.q8_win_qkv(T(x4), T(w), T(wsc), T(b), torch.tensor(a),
                        (T(lnp[0]), T(lnp[1]), lnp[2]), ws, T(osc),
                        a_qmax=Q, relaxed=True)


def test_relaxed_win_qkv_body_matches_jax_eagerly():
    """B10's relaxed requant bitwise JAX's eager ``_win_qkv_kernel``, one
    band of windows at a time (the image's rows of windows, in
    window_partition's order), and within a step of JAX's jitted
    ``_q8_win_qkv``."""
    inp = win_qkv_inputs()
    x4, a, w, wsc, b, lnp, ws, osc = inp
    B, res, _, C = x4.shape
    nwi, N = res // ws, ws * ws
    scal = np.array([[a, lnp[2]]], np.float32)
    bands = []
    with jax.disable_jit():
        for bb in range(B):
            for wi in range(nwi):
                out = np.zeros((nwi, N, 3 * C), np.int8)
                J._win_qkv_kernel(scal, lnp[0][None], lnp[1][None],
                                  x4[bb:bb + 1, wi * ws:(wi + 1) * ws], w,
                                  wsc[None], b[None], osc[None], out,
                                  a_qmax=Q, ws=ws, nwi=nwi, out_qmax=Q,
                                  relaxed=True)
                bands.append(out)
    got = port_win_qkv(inp).numpy()
    assert np.array_equal(got, np.concatenate(bands))
    jit = np.asarray(J._q8_win_qkv(
        jnp.asarray(x4), jnp.asarray(w), jnp.asarray(wsc), jnp.asarray(b),
        jnp.asarray(a), tuple(jnp.asarray(v) for v in lnp[:2]) + (lnp[2],),
        ws, jnp.asarray(osc), Q, Q, True, relaxed=True))
    d = np.abs(got.astype(np.int32) - jit.astype(np.int32))
    print(f"under jit: {(d > 0).sum()} of {d.size} levels one step off")
    assert d.max() <= 1
    # the same windows as B6's relaxed requant on the partitioned rows
    x, lnt = T(x4), (T(lnp[0]), T(lnp[1]), lnp[2])
    assert torch.equal(T(got), P.q8_linear_ref(
        window_partition(x, ws), T(w), T(wsc), T(b), torch.tensor(a), None,
        a_qmax=Q, postgelu=False, ln=lnt, out_q="vec", out_scale=T(osc),
        relaxed=True))
