"""B10's and B11's plain versions (``q8_win_qkv_ref``, ``q8_win_proj_ref``,
what ``q8_win_qkv`` / ``q8_win_proj`` run on the CPU) against the JAX
package's ``_q8_win_qkv`` / ``_q8_win_proj`` in Pallas interpret mode, fed
the same levels, scales and (a1/s, b1, b2) column scales, with float32 and
bfloat16 inputs, over a grid of 2 x 2 windows (res 8, window 4) and of one
window (res 4, window 4).

Tolerance: B11 bitwise, except where JAX's own rescale rounds otherwise:
XLA on the CPU contracts its ``acc * a * w_scale + b`` into one FMA (the
class of ROADMAP C5), while the port, as the kernel on the card, rounds
the product and the sum apart; there the two may differ by one ulp of the
output.  B10 within one level in at most 0.1% of the elements (the
LayerNorm statistics are summed in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptq4vit_tpu.ops import int8_serve as jserve
from ptq4vit_tpu_torch.models.swin import window_reverse
from ptq4vit_tpu_torch.ops import int8_serve as pserve

B, C, WS, Q = 2, 128, 4, 128
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def linear(rng, K, N, a):
    """int8 weight levels (K, N), a per-column scale that keeps the output
    about unit size, and a bias."""
    w = rng.integers(-Q, Q, (K, N)).astype(np.int8)
    ws = ((rng.random(N) + 0.5) / (a * Q * Q * np.sqrt(K) / 3)) \
        .astype(np.float32)
    return w, ws, (rng.standard_normal(N) * 0.1).astype(np.float32)


def both(a, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``
    (bf16: rounded once, by torch; exact in JAX's bf16)."""
    t = torch.from_numpy(a).to(DTYPES[dtype][0])
    return jnp.asarray(t.float().numpy()).astype(DTYPES[dtype][1]), t


@pytest.mark.parametrize("res", [8, 4])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_b10_matches_jax(dtype, res):
    rng = np.random.default_rng(80 + res)
    x4 = (rng.standard_normal((B, res, res, C)) * 2 + 0.3).astype(np.float32)
    a = np.float32(3.0 / (Q - 0.5))
    w, ws, b = linear(rng, C, 3 * C, a)
    lnw = (1 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    lnb = (0.1 * rng.standard_normal(C)).astype(np.float32)
    cols = ((rng.random(3 * C) + 1.5) / (Q - 0.5)).astype(np.float32)
    jx, tx = both(x4, dtype)
    ref = jserve._q8_win_qkv(
        jx, jnp.asarray(w), jnp.asarray(ws), jnp.asarray(b), jnp.float32(a),
        (jnp.asarray(lnw), jnp.asarray(lnb), 1e-5), WS, jnp.asarray(cols),
        Q, Q, True)
    got = pserve.q8_win_qkv(
        tx, torch.from_numpy(w), torch.from_numpy(ws), torch.from_numpy(b),
        torch.tensor(a), (torch.from_numpy(lnw), torch.from_numpy(lnb),
                          1e-5), WS, torch.from_numpy(cols), a_qmax=Q,
        out_qmax=Q)
    ref = np.asarray(ref)
    assert got.dtype == torch.int8 and got.shape == ref.shape \
        == (B * (res // WS) ** 2, WS * WS, 3 * C)
    d = np.abs(got.numpy().astype(np.int32) - ref.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3


@pytest.mark.parametrize("res", [8, 4])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_b11_matches_jax(dtype, res):
    rng = np.random.default_rng(90 + res)
    y_q = rng.integers(-Q, Q, (B * (res // WS) ** 2, WS * WS, C)) \
        .astype(np.int8)
    a = np.float32(0.03)
    w, ws, b = linear(rng, C, C, a)
    r4 = rng.standard_normal((B, res, res, C)).astype(np.float32)
    jr, tr = both(r4, dtype)
    ref = jserve._q8_win_proj(jnp.asarray(y_q), jnp.asarray(w),
                              jnp.asarray(ws), jnp.asarray(b),
                              jnp.float32(a), WS, res, jr, True)
    got = pserve.q8_win_proj(torch.from_numpy(y_q), torch.from_numpy(w),
                             torch.from_numpy(ws), torch.from_numpy(b),
                             torch.tensor(a), WS, res, tr, a_qmax=Q)
    assert got.dtype == tr.dtype and got.shape == (B, res, res, C)
    got = got.float().numpy()
    ref = np.asarray(ref.astype(jnp.float32))
    # where one FMA rounds acc*a*ws + b otherwise than a product and a sum
    t = (y_q.reshape(-1, C).astype(np.int64) @ w.astype(np.int64)) \
        .astype(np.float32) * a
    fused = (t.astype(np.float64) * ws + b).astype(np.float32)
    def image(v):
        return window_reverse(torch.from_numpy(v.reshape(-1, WS * WS, C)),
                              WS, res, res).numpy()
    contracted = image(fused != t * ws + b)
    assert not ((got != ref) & ~contracted).any()
    # and there by no more than one rounding of each step: the product
    # acc*a*ws (which the FMA skips), its sum with b, the residual add
    eps = 2.0 ** (-23 if dtype == "f32" else -8)
    assert (np.abs(got - ref) <= eps * (np.abs(image(t * ws))
                                        + np.abs(image(fused))
                                        + np.abs(ref))).all()


def test_window_linears_check_their_geometry():
    """A grid that is not whole windows raises, on the CPU as on the
    card."""
    x4 = torch.zeros(1, 6, 6, 8)
    w = torch.zeros(8, 24, dtype=torch.int8)
    with pytest.raises(ValueError):
        pserve.q8_win_qkv(x4, w, torch.ones(24), None, 1.0,
                          (torch.ones(8), torch.zeros(8), 1e-5), 4,
                          torch.ones(24), a_qmax=Q)
    with pytest.raises(ValueError):
        pserve.q8_win_proj(torch.zeros(3, 16, 8, dtype=torch.int8),
                           w[:, :8], torch.ones(8), None, 1.0, 4, 4,
                           torch.zeros(1, 4, 4, 8), a_qmax=Q)
