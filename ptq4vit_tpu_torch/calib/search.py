"""Scale-factor candidate search — the calibration hot path.

The counterpart of ``ptq4vit_tpu/calib/search.py``: the linear search (any
n_V x n_H x n_a grid, every metric, the pearson linear with chunk-local
means), the head-wise matmul search and the general blocked matmul search
(both with the split-of-softmax split search; Swin's window matmuls hold
images x windows samples), and the conv searches (channelwise, layerwise,
the n_V x n_H ``conv_ptqsl`` grid and ``conv_quantile``).

Dispatch follows the JAX package, with the device in place of its backend:

  * A case that JAX scores in a Pallas kernel scores through the port's
    kernel (``ops/search_kernels.py``) when ``use_kernels`` is set.  On
    CUDA that is required (``use_kernels=False`` raises); on CPU tensors
    the kernels' plain versions run.  Those cases:
      - linear, weight side, hessian metric, n_H == 1: B1 with int8
        scoring and n_a == 1, else B4w (search.py:250, 263, 285-289);
      - linear, input side, hessian metric, n_a == 1: B2 with int8 scoring
        and n_H == 1, else B4a (search.py:252, 347, 357-362);
      - unblocked matmul, hessian metric, int8 scoring: B3 or B3f
        (search.py:528-532, 1008-1011).
    JAX's extra test ``pallas_tile_ok`` (128-lane output tiles) is a TPU
    layout limit the port's kernels do not have, so the port drops it.
  * Every other case is plain tensor code on any device, the counterpart
    of the JAX XLA code, not a fallback: non-hessian metrics, n_H > 1 and
    n_a > 1 grids, matmuls under exact scoring or with no kernel (the int8
    XLA branch: levels multiplied exactly, one fp32 rescale in JAX's
    order), blocked matmuls, the SoS split search, the conv searches and
    the interval inits.

``int8_score`` picks int8 scoring (one fp32 rescale of an exact integer
product) or exact scoring (fp32 products of the fake-quant values, the
reference's own numerics); it defaults to on for CUDA and off for CPU, as
JAX's follows the backend (search.py:71-76).  ``use_kernels`` defaults to
on for CUDA and off for CPU.

Parity notes (as in the JAX package): only the first eq_n of the eq_n+1
grid candidates are scored; per-batch similarities are summed, then
argmaxed with the first maximum winning (``torch.argmax``); the pearson
linear's means are chunk-local, with the batch chunk pinned to the
calibrator's batch size (``calib_bs``) when it divides the calib size.

Over a mesh the caches hold this rank's samples (``OpCapture.shard``,
calib/capture.py), and every reduction over samples becomes a collective
over "data" where JAX's psums are (search.py:79-102, 293-294): each
scorer, kernel or plain, sums its rank's samples, then the sums are
``all_reduce``-d before the division and the argmax; the interval inits'
amax becomes a max over the ranks; the pearson means of a batch chunk
that spans the ranks are summed over them; the quantile conv gathers
every sample.  Every rank then picks the same candidates.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.policy import OpPolicy
from ..ops import search_kernels as K
from ..quant import fakequant as fq
from ..quant.metrics import cosine_similarity
from ..quant.qparams import ConvQP, LinearQP, MatMulQP
from ..utils.tracing import span, spanned

DEFAULT_BUDGET = 2 << 30  # bytes of out_sim scratch per candidate chunk


def plan_chunks(eq_n: int, samples: int, out_elems_per_sample_candidate: int,
                budget: int = DEFAULT_BUDGET,
                batch_chunk: Optional[int] = None):
    """Pick (candidate_chunk P, batch_chunk bs) with bs * P * out_elems * 4
    <= budget, preferring P big.  A given ``batch_chunk`` (a divisor of
    ``samples``) is kept as bs and only P is planned."""
    def cands(bs):
        per_cand = bs * out_elems_per_sample_candidate * 4
        return int(max(1, min(eq_n, budget // max(per_cand, 1))))

    if batch_chunk:
        return cands(batch_chunk), batch_chunk
    bs = samples
    P = cands(bs)
    while P < 2 and bs > 1:
        bs = (bs + 1) // 2
        P = cands(bs)
    while samples % bs != 0:   # keep exact chunking
        bs -= 1
    return P, bs


def _candidate_chunks(cands, P: int):
    """(eq_n, ...) -> list of (P, ...) chunks, the last one padded with the
    last candidate (padding is scored, then sliced off before argmax)."""
    eq_n = cands.shape[0]
    nc = -(-eq_n // P)
    pad = nc * P - eq_n
    if pad:
        cands = torch.cat([cands, cands[-1:].expand((pad,) + cands.shape[1:])])
    return list(cands.reshape((nc, P) + cands.shape[1:]))


def _batch_chunks(x, bs: int):
    """(S, ...) -> list of (bs, ...) chunks."""
    return list(x.reshape((x.shape[0] // bs, bs) + x.shape[1:]))


def _feature_similarity(raw, sim, metric: str, raw_grad, axis):
    """Metric along ``axis`` reduced along it (reference _get_similarity,
    linear.py:399-424); ``axis=None`` returns the elementwise map of the
    norm-style metrics."""
    if metric == "cosine":
        return cosine_similarity(raw, sim, axis=axis)
    if metric == "pearson":
        return cosine_similarity(raw - torch.mean(raw, dim=axis, keepdim=True),
                                 sim - torch.mean(sim, dim=axis, keepdim=True),
                                 axis=axis)
    if metric == "L1_norm":
        s = -torch.abs(raw - sim)
    elif metric == "L2_norm":
        s = -((raw - sim) ** 2)
    elif metric == "linear_weighted_L2_norm":
        s = -torch.abs(raw) * (raw - sim) ** 2
    elif metric == "square_weighted_L2_norm":
        s = -((raw * (raw - sim)) ** 2)
    elif metric == "hessian":
        s = -((raw_grad * (raw - sim)) ** 2)
    else:
        raise NotImplementedError(f"metric {metric} not implemented!")
    return s if axis is None else torch.mean(s, dim=axis)


def _quant_act_linear(x, a_interval, a_neg_interval, policy: OpPolicy):
    """Grouped (or twin post-GELU) input fake-quant with current intervals."""
    qmax = fq.qmax_for_bit(policy.a_bit)
    if policy.quantizer == "postgelu_linear":
        return fq.twin_quant_post_gelu(x, a_interval, a_neg_interval, qmax)
    return fq.fake_quant_act_grouped(x, a_interval, qmax)


def _scorer(device: torch.device, use_kernels: bool, pallas_case: bool,
            what: str) -> bool:
    """Whether a search side scores through a kernel: a case the JAX
    package scores in a Pallas kernel does so on CUDA (or raises) and on
    the CPU when ``use_kernels`` (through the kernel's plain version);
    every other case is plain tensor code on any device."""
    if not pallas_case:
        return False
    if device.type == "cuda" and not use_kernels:
        raise NotImplementedError(
            f"this {what} search case is scored by a kernel on CUDA "
            "(use_kernels=True); the card has no plain-torch scorer for it")
    return bool(use_kernels)


def _defaults(device, int8_score, use_kernels):
    on_cuda = device.type == "cuda"
    return (on_cuda if int8_score is None else int8_score,
            on_cuda if use_kernels is None else use_kernels)


def _sum(shard, t):
    """``t`` summed over the ranks holding the other samples."""
    return t if shard is None else shard.sum(t)


def _max(shard, t):
    """``t``'s maximum over the ranks holding the other samples."""
    return t if shard is None else shard.max(t)


def _max_fn(shard):
    """The interval inits' reduce: the amax over the ranks."""
    return None if shard is None else shard.max


_TRACE: Optional[dict] = None  # {op: [(sims, pick), ...]} while tracing
_TRACE_OP: Optional[str] = None


@contextlib.contextmanager
def argmax_trace():
    """Record every candidate pick of the searches run inside, by op
    (``traced_op``): the sims and the index picked, in order.  Two runs'
    traces tell a tie (top sims within rounding, which a reordered sum may
    flip) from a disagreement.  The records stay on the sims' device (the
    sims copied), so tracing adds no host synchronization."""
    global _TRACE
    prev, _TRACE = _TRACE, {}
    try:
        yield _TRACE
    finally:
        _TRACE = prev


@contextlib.contextmanager
def traced_op(name: str):
    """The op the picks inside belong to in an ``argmax_trace``."""
    global _TRACE_OP
    prev, _TRACE_OP = _TRACE_OP, name
    try:
        yield
    finally:
        _TRACE_OP = prev


def _argmax(sims, dim=None):
    """torch.argmax (the first maximum wins), recorded while tracing."""
    best = torch.argmax(sims) if dim is None else torch.argmax(sims, dim=dim)
    if _TRACE is not None:
        _TRACE.setdefault(_TRACE_OP, []).append(
            (sims.detach().to(torch.float32, copy=True), best))
    return best


def _argmax_take(cands2d, sims2d):
    """Per-column argmax of (eq_n, n) sims -> the chosen (n,) candidates."""
    best = _argmax(sims2d, dim=0)
    return torch.gather(cands2d, 0, best[None])[0]


def _levels(x, d, qmax: int):
    """clip(round(x / d)) as float64 levels: their products are exact, as
    the int32 dots of the JAX int8 branch are."""
    return torch.clamp(torch.round(x / d), -qmax, qmax - 1).double()


# ---------------------------------------------------------------------------
# linear search
# ---------------------------------------------------------------------------

def _chunk_mean(shard):
    """The pearson chunk mean over axes (0, 1): local, or over a chunk
    whose samples every rank holds a block of (summed over the ranks)."""
    if shard is None:
        return lambda t: torch.mean(t, dim=(0, 1), keepdim=True)
    return lambda t: shard.sum(torch.sum(t, dim=(0, 1), keepdim=True)) \
        / (t.shape[0] * shard.size * t.shape[1])


def _pearson_w(raw, sim, mean):
    """Reference _get_pearson_w (linear.py:426-439) with chunk-global
    means.  raw: (bs,T,1,n_V,crb); sim: (bs,T,P,n_V,crb) -> (bs,P,n_V)."""
    bs, T, P, n_V, crb = sim.shape
    s = sim.permute(0, 1, 4, 3, 2).reshape(bs, T * crb, n_V, P)
    r = raw.permute(0, 1, 4, 3, 2).reshape(bs, T * crb, n_V, 1)
    s = s - mean(s)
    r = r - mean(r)
    return cosine_similarity(r, s, axis=1).permute(0, 2, 1)


def _pearson_a(raw, sim, mean):
    """Reference _get_pearson_a (linear.py:441-453).  raw: (bs,T,1,oc);
    sim: (bs,T,P,oc) -> (bs,P)."""
    bs, T, P, oc = sim.shape
    s = sim.permute(0, 1, 3, 2).reshape(bs, T * oc, P)
    r = raw.permute(0, 1, 3, 2).reshape(bs, T * oc, 1)
    s = s - mean(s)
    r = r - mean(r)
    return cosine_similarity(r, s, axis=1)


def _linear_search(w, b, x, raw_out, raw_grad, policy: OpPolicy, P: int,
                   bs: int, kern_w: bool, kern_a: bool, int8_score: bool,
                   shard=None, mean=None, scratch_bound=None):
    """calibration_step2 of a linear layer (reference linear.py:536-555).
    x: (S, T, ic); raw_out / raw_grad: (S, T, oc) or None.  ``kern_w`` /
    ``kern_a``: the weight / input side scores through a kernel.
    ``shard``: x holds this rank's samples; ``mean``: the pearson chunk
    mean (``_chunk_mean``); ``scratch_bound``: the kernels' candidate-chunk
    bound (``ops/search_kernels.py``)."""
    x = x.float()
    if raw_out is None:
        raw_out = torch.matmul(x, w.t())
        if b is not None:
            raw_out = raw_out + b
    raw_out = raw_out.float()
    if raw_grad is not None:
        raw_grad = raw_grad.float()
    S, T, ic = x.shape
    oc = raw_out.shape[-1]
    dev = x.device
    metric = policy.metric
    n_V, n_H, n_a = policy.n_V, policy.n_H, policy.n_a
    crb_r = oc // n_V
    w_qmax = fq.qmax_for_bit(policy.w_bit)
    a_qmax = fq.qmax_for_bit(policy.a_bit)
    postgelu = policy.quantizer == "postgelu_linear"
    a_neg = (torch.tensor(fq.GELU_NEG_CLIP / a_qmax, dtype=torch.float32,
                          device=dev) if postgelu else None)
    a_neg_f = fq.GELU_NEG_CLIP / a_qmax if postgelu else 0.0

    with span("ptq.search.init"):
        if policy.init_layerwise:
            w_int0 = fq.minmax_interval(w, w_qmax).reshape(1, 1, 1, 1) \
                .expand(n_V, 1, n_H, 1).contiguous()
            xg = fq.grouped_act_view(x, n_a)
            v = xg if postgelu else torch.abs(xg)
            a_int0 = fq.exact_div(_max(shard, torch.amax(v)), a_qmax - 0.5) \
                .reshape(1, 1).expand(n_a, 1).contiguous()
        else:
            w_int0 = fq.blocked_weight_interval_init(w, n_V, n_H, w_qmax)
            a_int0 = fq.grouped_act_interval_init(x, n_a, a_qmax,
                                                  signed=not postgelu,
                                                  reduce=_max_fn(shard))

        grid = fq.candidate_grid(policy.eq_alpha, policy.eq_beta, policy.eq_n,
                                 device=dev)
        eq_n = policy.eq_n
        w_cands = grid[:eq_n, None, None, None, None] * w_int0[None]
        a_cands = grid[:eq_n, None, None] * a_int0[None]      # eq_n, n_a, 1
        w4 = fq.blocked_weight_view(w, n_V, n_H)

        if kern_w or kern_a:
            rawb = (raw_out if b is None else raw_out - b).reshape(S * T, oc) \
                .contiguous()
            grad_f = raw_grad.reshape(S * T, oc).contiguous()
            x2 = x.reshape(S * T, ic).contiguous()
        if not (kern_w and kern_a):
            xb, rb = _batch_chunks(x, bs), _batch_chunks(raw_out, bs)
            gb = (_batch_chunks(raw_grad, bs) if metric == "hessian"
                  else [None] * len(xb))

    def score_w_kernel(a_int):
        """B1 (int8 scoring, n_a == 1) or B4w: (eq_n, n_V) sims."""
        cands = w_cands.reshape(eq_n, n_V).contiguous()
        if int8_score and n_a == 1:
            a_sc = a_int.reshape(())
            with span("ptq.search.init"):
                if postgelu:
                    x_lv = torch.clamp(torch.round(x2 / a_sc), 0,
                                       a_qmax - 1).to(torch.int8)
                    x_neg = torch.clamp(torch.round(x2 / a_neg), -a_qmax,
                                        0).to(torch.int8)
                else:
                    x_lv = torch.clamp(torch.round(x2 / a_sc), -a_qmax,
                                       a_qmax - 1).to(torch.int8)
                    x_neg = None
            sims = K.linear_w_hessian_sims_i8(
                x_lv, x_neg, a_sc, a_neg, w, cands, rawb, grad_f, w_qmax,
                scratch_bound=scratch_bound)
        else:
            with span("ptq.search.init"):
                x_sim = _quant_act_linear(x2, a_int, a_neg, policy) \
                    .contiguous()
            sims = K.linear_w_hessian_sims(x_sim, w, cands, rawb, grad_f,
                                           w_qmax, scratch_bound=scratch_bound)
        return fq.exact_div(_sum(shard, sims), float(T * crb_r))

    @spanned("ptq.search.score")
    def score_w(w_int, a_int, h):
        """Summed similarities (eq_n, n_V) of the candidates for weight
        column block h (linear.py:455-495)."""
        if kern_w:
            return score_w_kernel(a_int)
        with span("ptq.search.init"):
            x_sim_all = _batch_chunks(
                _quant_act_linear(x, a_int, a_neg, policy), bs)
        mask_h = torch.arange(n_H, device=dev).reshape(1, 1, 1, n_H, 1) == h
        out_sims = []
        for wc in _candidate_chunks(w_cands, P):               # P,n_V,1,n_H,1
            cur = torch.where(mask_h, wc, w_int[None])
            w_sim = (fq.int_quant(w4[None], cur, w_qmax) * cur) \
                .reshape(P, oc, ic)
            acc = torch.zeros(P, n_V, device=dev)
            for x_s, r_s, g_s in zip(x_sim_all, rb, gb):
                out = torch.einsum("bti,poi->btpo", x_s, w_sim)
                if b is not None:
                    out = out + b
                outc = out.reshape(bs, T, P, n_V, crb_r)
                rawc = r_s.reshape(bs, T, 1, n_V, crb_r)
                if metric == "pearson":
                    sim = _pearson_w(rawc, outc, mean)
                else:
                    gc = (g_s.reshape(bs, T, 1, n_V, crb_r)
                          if metric == "hessian" else None)
                    sim = torch.mean(_feature_similarity(
                        rawc, outc, metric, gc, -1), dim=1)
                acc = acc + torch.sum(sim, dim=0)
            out_sims.append(acc)
        return _sum(shard, torch.cat(out_sims)[:eq_n])

    def score_a_kernel(w_int):
        """B2 (int8 scoring, n_H == 1) or B4a: (eq_n,) sims."""
        cands = a_cands.reshape(eq_n).contiguous()
        if int8_score and n_H == 1:
            with span("ptq.search.init"):
                w_lv = fq.int_quant(w4, w_int, w_qmax).to(torch.int8) \
                    .reshape(oc, ic)
                w_sc = w_int[:, 0, 0, 0][:, None].expand(n_V, crb_r) \
                    .reshape(oc).contiguous()
            sims = K.linear_a_hessian_sims_i8(
                x2, w_lv, w_sc, cands, rawb, grad_f, a_qmax,
                postgelu=postgelu, a_neg=a_neg_f, scratch_bound=scratch_bound)
        else:
            with span("ptq.search.init"):
                w_sim = fq.fake_quant_weight_blocked(w, w_int, w_qmax) \
                    .contiguous()
            sims = K.linear_a_hessian_sims(x2, w_sim, cands, rawb, grad_f,
                                           a_qmax, postgelu=postgelu,
                                           a_neg=a_neg_f,
                                           scratch_bound=scratch_bound)
        return fq.exact_div(_sum(shard, sims), float(T * oc))

    @spanned("ptq.search.score")
    def score_a(w_int, a_int, a):
        """Summed similarities (eq_n,) of the candidates for input group a
        (linear.py:497-533, :609-642)."""
        if kern_a:
            return score_a_kernel(w_int)
        with span("ptq.search.init"):
            w_sim = fq.fake_quant_weight_blocked(w, w_int, w_qmax)
        mask_a = torch.arange(n_a, device=dev).reshape(1, n_a, 1) == a
        out_sims = []
        for ac in _candidate_chunks(a_cands, P):               # P, n_a, 1
            cur = torch.where(mask_a, ac, a_int[None])
            acc = torch.zeros(P, device=dev)
            for x_s, r_s, g_s in zip(xb, rb, gb):
                xg = fq.grouped_act_view(x_s, n_a)             # bs,T,n_a,crb
                xq = xg[:, :, None] / cur[None, None]          # bs,T,P,n_a,crb
                if postgelu:
                    xp = torch.clamp(torch.round(xq), 0, a_qmax - 1) \
                        * cur[None, None]
                    xn = torch.clamp(torch.round(fq.exact_div(xg, a_neg)),
                                     -a_qmax, 0) * a_neg
                    x_sim = xp + xn[:, :, None]
                else:
                    x_sim = torch.clamp(torch.round(xq), -a_qmax,
                                        a_qmax - 1) * cur[None, None]
                x_sim = x_sim.reshape(bs, T, P, ic)
                out = torch.einsum("btpi,oi->btpo", x_sim, w_sim)
                if b is not None:
                    out = out + b
                raw = r_s[:, :, None]
                if metric == "pearson":
                    sim = _pearson_a(raw, out, mean)
                else:
                    gc = g_s[:, :, None] if metric == "hessian" else None
                    sim = torch.mean(_feature_similarity(raw, out, metric,
                                                         gc, -1), dim=1)
                acc = acc + torch.sum(sim, dim=0)
            out_sims.append(acc)
        return _sum(shard, torch.cat(out_sims)[:eq_n])

    w_int, a_int = w_int0, a_int0
    for _ in range(policy.search_round):
        for h in range(n_H):
            sims = score_w(w_int, a_int, h)                    # eq_n, n_V
            best = _argmax(sims, dim=0)                   # n_V
            chosen = torch.gather(w_cands[:, :, 0, :, 0], 0,
                                  best[None, :, None].expand(1, n_V, n_H))[0]
            mask_h = torch.arange(n_H, device=dev).reshape(1, 1, n_H, 1) == h
            w_int = torch.where(mask_h, chosen[:, None, :, None], w_int)
        for a in range(n_a):
            chosen = a_cands[_argmax(score_a(w_int, a_int, a))]
            mask_a = torch.arange(n_a, device=dev).reshape(n_a, 1) == a
            a_int = torch.where(mask_a, chosen, a_int)
    return w_int, a_int


def _pearson_chunks(eq_n: int, S: int, width: int, budget: int,
                    calib_bs: Optional[int], shard):
    """(P, local batch chunk, chunk mean) of the pearson linear.  The
    reference's pearson means are chunk-local (linear.py:426-453, chunks
    of calib_batch_size): the chunk is pinned to ``calib_bs`` when it
    divides the calib size, to reproduce them.  Over a mesh the chunk is
    the single device's, in global sample order: whole micro-batches
    (every rank holds a block of each; the means are summed over the
    ranks) or a part of one rank's block (the means stay local)."""
    S_all = S * (1 if shard is None else shard.size)
    pin = calib_bs if calib_bs and S_all % calib_bs == 0 else None
    P, c = plan_chunks(eq_n, S_all, width, budget, batch_chunk=pin)
    if shard is None:
        return P, c, _chunk_mean(None)
    if c % shard.micro == 0:
        bs = c // shard.size
        return plan_chunks(eq_n, S, width, budget, batch_chunk=bs)[0], bs, \
            _chunk_mean(shard)
    if (shard.micro // shard.size) % c == 0:
        return P, c, _chunk_mean(None)
    raise ValueError(f"a pearson chunk of {c} samples straddles the data "
                     f"shards (micro-batches of {shard.micro} over "
                     f"data={shard.size})")


def search_linear(w, b, cap, policy: OpPolicy, budget: int = DEFAULT_BUDGET,
                  calib_bs: Optional[int] = None,
                  int8_score: Optional[bool] = None,
                  use_kernels: Optional[bool] = None,
                  scratch_bound: Optional[int] = None) -> LinearQP:
    """Calibrate a linear op from its captured data.  ``calib_bs`` pins the
    batch chunk of the pearson metric (see the module docstring);
    ``scratch_bound`` bounds each kernel call's scratch (None: one call of
    every candidate)."""
    x = cap.inputs["x"]
    dev = x.device
    int8_score, use_kernels = _defaults(dev, int8_score, use_kernels)
    w = w.to(dev).float().contiguous()
    b = None if b is None else b.to(dev).float()
    S, ic = x.shape[0], x.shape[-1]
    oc = w.shape[0]
    T = 1
    for d in x.shape[1:-1]:
        T *= d
    x = x.reshape(S, T, ic)
    raw_out = None if cap.out is None else cap.out.reshape(S, T, oc)
    hessian = policy.metric == "hessian"
    grad = cap.grad.reshape(S, T, oc) if hessian else None
    kern_w = _scorer(dev, use_kernels, hessian and policy.n_H == 1,
                     "linear weight")
    kern_a = _scorer(dev, use_kernels, hessian and policy.n_a == 1,
                     "linear input")
    # per candidate the plain branches hold the output and, on the input
    # side, the quantized input: plan on the larger
    width = T * max(oc, ic)
    shard = cap.shard
    mean = _chunk_mean(None)
    if policy.metric == "pearson":
        P, bs, mean = _pearson_chunks(policy.eq_n, S, width, budget,
                                      calib_bs, shard)
    else:
        P, bs = plan_chunks(policy.eq_n, S, width, budget)
    w_int, a_int = _linear_search(w, b, x, raw_out, grad, policy, P, bs,
                                  kern_w, kern_a, int8_score, shard, mean,
                                  scratch_bound)
    postgelu = policy.quantizer == "postgelu_linear"
    a_qmax = fq.qmax_for_bit(policy.a_bit)
    return LinearQP(
        w_interval=w_int, a_interval=a_int,
        a_neg_interval=(torch.tensor(fq.GELU_NEG_CLIP / a_qmax,
                                     dtype=torch.float32, device=dev)
                        if postgelu else None),
        w_bit=policy.w_bit, a_bit=policy.a_bit, postgelu=postgelu)


# ---------------------------------------------------------------------------
# matmul search
# ---------------------------------------------------------------------------

def _sos_levels(a, split, qmax: int):
    """SoS hi / lo level sets of the softmax side (matmul.py:595-598) as
    float64 levels, and their scales (s_hi, s_lo)."""
    one = torch.ones((), device=a.device)
    zero = torch.zeros((), device=a.device)
    a_int = fq.exact_div(split, qmax - 1)
    hi = torch.clamp(torch.round(
        torch.minimum(torch.maximum(a, split), one) * (qmax - 1)),
        0, qmax - 1).double()
    lo = torch.clamp(torch.round(fq.exact_div(
        torch.minimum(torch.maximum(a, zero), split), a_int)),
        0, qmax - 1).double()
    return hi, lo, fq.exact_div(one, qmax - 1), a_int


def _raw_out(a_s, b_s, r_s):
    """The stored raw output of a batch chunk, or A @ B when not stored."""
    return torch.matmul(a_s, b_s) if r_s is None else r_s


def _head_sims(out, raw, g_s, metric: str):
    """(P,bs,G,R,Co) -> (P,G): the metric over Co, the mean over rows,
    summed over the batch (matmul.py:510-518)."""
    gc = None if g_s is None else g_s[None]
    sim = _feature_similarity(raw[None], out, metric, gc, -1)
    return torch.sum(torch.mean(sim, dim=3), dim=1)


@spanned("ptq.search.split")
def _split_sims(splits, Ab, Bb, rb, gb, A_qmax: int, metric: str,
                shard=None):
    """Summed similarities of the SoS split grid, B raw
    (matmul.py:600-631), over every rank's samples."""
    sims = []
    for sp in splits:
        acc = torch.zeros((), device=sp.device)
        for a_s, b_s, r_s, g_s in zip(Ab, Bb, rb, gb):
            out = torch.matmul(fq.sos_quant_softmax(a_s, sp, A_qmax), b_s)
            sim = _feature_similarity(_raw_out(a_s, b_s, r_s), out, metric,
                                      g_s, -1)
            acc = acc + torch.sum(torch.mean(sim, dim=(1, 2)))
        sims.append(acc)
    return _sum(shard, torch.stack(sims))


def _matmul_search(A, B, raw_out, raw_grad, policy: OpPolicy, P: int,
                   bs: int, kernels: bool, shard=None, scratch_bound=None):
    """calibration_step2 of an A@B op with head-wise groups and
    n_V = n_H = 1 (reference matmul.py:565-576) under int8 scoring: B3 /
    B3f, or the int8 XLA branch's levels with one rescale (exact scoring
    runs ``_matmul_blocked_search``).  A: (S,G,R,Ci); B: (S,G,Ci,Co);
    raw_out / raw_grad: (S,G,R,Co) or None; ``scratch_bound``: the
    kernel's candidate-chunk bound."""
    S, G, R, Ci = A.shape
    Co = B.shape[-1]
    dev = A.device
    sos = policy.quantizer == "sos_matmul"
    A_qmax = fq.qmax_for_bit(policy.a_bit)
    B_qmax = fq.qmax_for_bit(policy.b_bit)
    hessian = policy.metric == "hessian"
    # the kernel reads the caches in their stored dtype
    A_raw, B_raw = A.contiguous(), B.contiguous()
    grad_raw = raw_grad.contiguous() if raw_grad is not None else None
    A = A.float()
    B = B.float()

    def init_interval(x, qmax):
        if policy.init_layerwise:
            return fq.exact_div(_max(shard, torch.amax(torch.abs(x))),
                                qmax - 0.5) \
                .reshape(1, 1, 1, 1, 1, 1, 1).expand(1, G, 1, 1, 1, 1, 1) \
                .contiguous()
        return fq.matmul_operand_interval_init(x, G, 1, 1, qmax,
                                               reduce=_max_fn(shard))

    with span("ptq.search.init"):
        B_int0 = init_interval(B, B_qmax)
        if sos:
            a_state0 = torch.tensor(0.01, dtype=torch.float32, device=dev)
        else:
            a_state0 = init_interval(A, A_qmax)

        grid = fq.candidate_grid(policy.eq_alpha, policy.eq_beta, policy.eq_n,
                                 device=dev)
        eq_n = policy.eq_n
        B_cands = grid[:eq_n].reshape(-1, 1, 1, 1, 1, 1, 1, 1) * B_int0[None]
        A_cands = (None if sos else
                   grid[:eq_n].reshape(-1, 1, 1, 1, 1, 1, 1, 1)
                   * a_state0[None])
        splits = fq.sos_split_grid(20, device=dev)

        if not kernels or sos:
            Ab, Bb = _batch_chunks(A, bs), _batch_chunks(B, bs)
            rb = ([None] * len(Ab) if raw_out is None
                  else _batch_chunks(raw_out.float(), bs))
            gb = (_batch_chunks(raw_grad.float(), bs) if hessian
                  else [None] * len(Ab))

    @spanned("ptq.search.score")
    def score_A(B_int):
        """(eq_n, G) summed sims of the A-interval candidates
        (matmul.py:483-522)."""
        if kernels:
            sims = K.matmul_hessian_sims(
                A_raw, B_raw, grad_raw, A_cands.reshape(eq_n, G).contiguous(),
                B_int.reshape(G), "a", A_qmax, B_qmax,
                scratch_bound=scratch_bound)
            return fq.exact_div(_sum(shard, sims), float(R * Co))
        # the fixed side as levels; ONE rescale after the exact dot
        # (search.py:649-677)
        with span("ptq.search.init"):
            B_fix = [_levels(b_s, B_int.reshape(1, G, 1, 1), B_qmax)
                     for b_s in Bb]
        b_sc = B_int.reshape(1, 1, G, 1, 1)
        out_sims = []
        for ac in _candidate_chunks(A_cands, P):
            cur = ac.reshape(P, 1, G, 1, 1, 1)
            acc = torch.zeros(P, G, device=dev)
            for a_s, b_raw, b_s, r_s, g_s in zip(Ab, Bb, B_fix, rb, gb):
                blocked = a_s.reshape(1, bs, G, 1, R, Ci)
                a_lv = _levels(blocked, cur, A_qmax).reshape(P, bs, G, R, Ci)
                out = torch.einsum("pbgrc,bgco->pbgro", a_lv, b_s) \
                    .float() * cur.reshape(P, 1, G, 1, 1) * b_sc
                acc = acc + _head_sims(out, _raw_out(a_s, b_raw, r_s), g_s,
                                       policy.metric)
            out_sims.append(acc)
        return _sum(shard, torch.cat(out_sims)[:eq_n])

    @spanned("ptq.search.score")
    def score_B(a_state, B_int):
        """(eq_n, G) summed sims of the B-interval candidates
        (matmul.py:524-563)."""
        if kernels:
            if sos:
                a_int = fq.exact_div(a_state, A_qmax - 1)
                s_hi = fq.exact_div(torch.ones((), device=dev), A_qmax - 1)
                sims = K.matmul_hessian_sims(
                    A_raw, B_raw, grad_raw,
                    B_cands.reshape(eq_n, G).contiguous(),
                    torch.ones(G, device=dev), "b_sos", B_qmax, A_qmax,
                    sos=(a_state, a_int, s_hi, a_int),
                    scratch_bound=scratch_bound)
            else:
                sims = K.matmul_hessian_sims(
                    A_raw, B_raw, grad_raw,
                    B_cands.reshape(eq_n, G).contiguous(),
                    a_state.reshape(G), "b", B_qmax, A_qmax,
                    scratch_bound=scratch_bound)
            return fq.exact_div(_sum(shard, sims), float(R * Co))
        with span("ptq.search.init"):
            if sos:                          # two level sets (:717-751)
                A_fix = [_sos_levels(a_s, a_state, A_qmax)[:2] for a_s in Ab]
                s_hi = fq.exact_div(torch.ones((), device=dev), A_qmax - 1)
                s_lo = fq.exact_div(a_state, A_qmax - 1)
            else:
                A_fix = [(_levels(a_s, a_state.reshape(1, G, 1, 1),
                                  A_qmax),) for a_s in Ab]
                a_sc = a_state.reshape(1, 1, G, 1, 1)
        out_sims = []
        for bc in _candidate_chunks(B_cands, P):
            cur = bc.reshape(P, 1, G, 1, 1, 1)
            cur5 = cur.reshape(P, 1, G, 1, 1)
            acc = torch.zeros(P, G, device=dev)
            for a_raw, a_s, b_s, r_s, g_s in zip(Ab, A_fix, Bb, rb, gb):
                blocked = b_s.reshape(1, bs, G, 1, Ci, Co)
                b_lv = _levels(blocked, cur, B_qmax).reshape(P, bs, G, Ci, Co)
                acc32 = [torch.einsum("bgrc,pbgco->pbgro", lv, b_lv).float()
                         for lv in a_s]
                if sos:
                    out = (acc32[0] * s_hi + acc32[1] * s_lo) * cur5
                else:
                    out = acc32[0] * cur5 * a_sc
                acc = acc + _head_sims(out, _raw_out(a_raw, b_s, r_s), g_s,
                                       policy.metric)
            out_sims.append(acc)
        return _sum(shard, torch.cat(out_sims)[:eq_n])

    a_state, B_int = a_state0, B_int0
    for _ in range(policy.search_round):
        if sos:
            a_state = splits[_argmax(_split_sims(
                splits, Ab, Bb, rb, gb, A_qmax, policy.metric, shard))]
        else:
            a_state = _argmax_take(A_cands.reshape(eq_n, G), score_A(B_int)) \
                .reshape(1, G, 1, 1, 1, 1, 1)
        B_int = _argmax_take(B_cands.reshape(eq_n, G),
                             score_B(a_state, B_int)) \
            .reshape(1, G, 1, 1, 1, 1, 1)
    return a_state, B_int


def _matmul_blocked_search(A, B, raw_out, raw_grad, policy: OpPolicy,
                           P: int, bs: int, n_G_A: int, n_G_B: int,
                           shard=None):
    """General blocked-operand matmul search (JAX
    ``_matmul_blocked_search_jit``; reference PTQSLQuantMatMul
    matmul.py:109-138, search matmul.py:177-241 in its batching form
    :483-563): each operand split n_G x n_V x n_H with ceil-div padding;
    per (v, h) block position the candidates are spliced into the current
    interval grid, the similarities reduced per head, the group axis
    ZERO-padded to n_G*crb_g before the per-group mean (matmul.py:519) and
    argmaxed per group.  SoS: the split-grid A search (n_*_A forced to 1),
    B blocked."""
    S, G, R, Ci = A.shape
    Co = B.shape[-1]
    dev = A.device
    sos = policy.quantizer == "sos_matmul"
    hessian = policy.metric == "hessian"
    A_qmax = fq.qmax_for_bit(policy.a_bit)
    B_qmax = fq.qmax_for_bit(policy.b_bit)
    A = A.float()
    B = B.float()
    nVA, nHA = (1, 1) if sos else (policy.n_V_A, policy.n_H_A)
    nVB, nHB = policy.n_V_B, policy.n_H_B

    def init_interval(x, qmax, nG, nV, nH):
        if policy.init_layerwise:
            return fq.exact_div(_max(shard, torch.amax(torch.abs(x))),
                                qmax - 0.5) \
                .reshape(1, 1, 1, 1, 1, 1, 1) \
                .expand(1, nG, 1, nV, 1, nH, 1).contiguous()
        return fq.matmul_operand_interval_init(x, nG, nV, nH, qmax,
                                               reduce=_max_fn(shard))

    with span("ptq.search.init"):
        B_int0 = init_interval(B, B_qmax, n_G_B, nVB, nHB)
        a_state0 = (torch.tensor(0.01, dtype=torch.float32, device=dev) if sos
                    else init_interval(A, A_qmax, n_G_A, nVA, nHA))
        grid = fq.candidate_grid(policy.eq_alpha, policy.eq_beta, policy.eq_n,
                                 device=dev)
        eq_n = policy.eq_n
        B_cands = grid[:eq_n].reshape(-1, 1, 1, 1, 1, 1, 1, 1) * B_int0[None]
        A_cands = (None if sos else
                   grid[:eq_n].reshape(-1, 1, 1, 1, 1, 1, 1, 1)
                   * a_state0[None])
        splits = fq.sos_split_grid(20, device=dev)

        Ab, Bb = _batch_chunks(A, bs), _batch_chunks(B, bs)
        rb = ([None] * len(Ab) if raw_out is None
              else _batch_chunks(raw_out.float(), bs))
        gb = (_batch_chunks(raw_grad.float(), bs) if hessian
              else [None] * len(Ab))

    def quant_A_state(a, st):
        if sos:
            return fq.sos_quant_softmax(a, st, A_qmax)
        return fq.fake_quant_matmul_operand(a, st, A_qmax)

    def quant_P(x_s, cur, qmax, nG, nV, nH, R_, C_):
        """Blocked quant of (bs,G,R_,C_) under P interval grids
        (P,1,nG,1,nV,1,nH,1) -> (P,bs,G,R_,C_) (matmul.py:124-138)."""
        crb_g, crb_r, crb_c, pg, pr, pc = fq.matmul_block_shape(
            x_s.shape, nG, nV, nH)
        xp = F.pad(x_s, (0, pc, 0, pr, 0, pg))
        xbk = xp.reshape(1, bs, nG, crb_g, nV, crb_r, nH, crb_c)
        cur8 = cur.reshape(P, 1, nG, 1, nV, 1, nH, 1)
        q = torch.clamp(torch.round(xbk / cur8), -qmax, qmax - 1) * cur8
        q = q.reshape(P, bs, nG * crb_g, nV * crb_r, nH * crb_c)
        return q[:, :, :G, :R_, :C_]

    def group_reduce(sims, nG):
        """(eq_n, G) head sims -> (eq_n, nG): ZERO-pad the group axis to
        nG*crb_g, then the per-group mean (matmul.py:519)."""
        crb_g = -(-G // nG)
        sims = F.pad(sims, (0, nG * crb_g - G))
        return torch.mean(sims.reshape(eq_n, nG, crb_g), dim=-1)

    def search_blocks(opA: bool, a_state, B_int):
        nG = n_G_A if opA else n_G_B
        nV = nVA if opA else nVB
        nH = nHA if opA else nHB
        cands = A_cands if opA else B_cands
        qmax = A_qmax if opA else B_qmax
        interval = a_state if opA else B_int
        with span("ptq.search.init"):
            if opA:
                otherq = [fq.fake_quant_matmul_operand(b_s, B_int, B_qmax)
                          for b_s in Bb]
            else:
                otherq = [quant_A_state(a_s, a_state) for a_s in Ab]
        for idx in range(nV * nH):
            v, h = divmod(idx, nH)
            m = ((torch.arange(nV, device=dev).reshape(1, 1, 1, nV, 1, 1, 1)
                  == v)
                 & (torch.arange(nH, device=dev).reshape(1, 1, 1, 1, 1, nH, 1)
                    == h))
            with span("ptq.search.score"):
                out_sims = []
                for cc in _candidate_chunks(cands, P):   # P,1,nG,1,nV,1,nH,1
                    cur = torch.where(m, cc, interval[None])
                    acc = torch.zeros(P, G, device=dev)
                    for a_s, b_s, oq, r_s, g_s in zip(Ab, Bb, otherq, rb, gb):
                        if opA:
                            out = torch.einsum(
                                "pbgrc,bgco->pbgro",
                                quant_P(a_s, cur, qmax, nG, nV, nH, R, Ci), oq)
                        else:
                            out = torch.einsum(
                                "bgrc,pbgco->pbgro", oq,
                                quant_P(b_s, cur, qmax, nG, nV, nH, Ci, Co))
                        acc = acc + _head_sims(
                            out, _raw_out(a_s, b_s, r_s), g_s, policy.metric)
                    out_sims.append(acc)
                sims = group_reduce(
                    _sum(shard, torch.cat(out_sims)[:eq_n]), nG)
            best = _argmax(sims, dim=0)                   # (nG,)
            chosen = torch.gather(
                cands.reshape(eq_n, nG, nV, nH), 0,
                best[None, :, None, None].expand(1, nG, nV, nH))[0]
            interval = torch.where(m, chosen.reshape(1, nG, 1, nV, 1, nH, 1),
                                   interval)
        return interval

    a_state, B_int = a_state0, B_int0
    for _ in range(policy.search_round):
        if sos:
            a_state = splits[_argmax(_split_sims(
                splits, Ab, Bb, rb, gb, A_qmax, policy.metric, shard))]
        else:
            a_state = search_blocks(True, a_state, B_int)
        B_int = search_blocks(False, a_state, B_int)
    return a_state, B_int


def search_matmul(cap, policy: OpPolicy, budget: int = DEFAULT_BUDGET,
                  int8_score: Optional[bool] = None,
                  use_kernels: Optional[bool] = None,
                  scratch_bound: Optional[int] = None) -> MatMulQP:
    """Calibrate an A@B op (head-wise groups) from its captured data;
    ``cap.out=None`` recomputes raw_out as A@B; ``scratch_bound`` bounds
    each kernel call's scratch (None: one call of every candidate)."""
    A, B = cap.inputs["a"], cap.inputs["b"]
    dev = A.device
    int8_score, use_kernels = _defaults(dev, int8_score, use_kernels)
    grad = cap.grad if policy.metric == "hessian" else None
    S, G, R, Ci = A.shape
    Co = B.shape[-1]
    # the plain branches hold the quantized candidate operand as well as
    # the output per candidate: plan on the larger (matmul2's A, R x R per
    # head, is 9x its output at ViT-B/384)
    P, bs = plan_chunks(policy.eq_n, S, G * max(R * Co, R * Ci, Ci * Co),
                        budget)
    blocked = (policy.n_V_A != 1 or policy.n_H_A != 1 or policy.n_V_B != 1
               or policy.n_H_B != 1 or policy.n_G_A > 1 or policy.n_G_B > 1)
    if blocked or not int8_score:
        # n_G defaults to head-wise (matmul.py:411-417); an explicit
        # n_G > 1 overrides it (search.py:994-999).  Exact scoring of the
        # unblocked matmul is the same engine at n_G = G, n_V = n_H = 1.
        n_G_A = policy.n_G_A if policy.n_G_A > 1 else G
        n_G_B = policy.n_G_B if policy.n_G_B > 1 else G
        a_state, B_int = _matmul_blocked_search(A, B, cap.out, grad, policy,
                                                P, bs, n_G_A, n_G_B,
                                                cap.shard)
    else:
        kernels = _scorer(dev, use_kernels, policy.metric == "hessian",
                          "matmul")
        a_state, B_int = _matmul_search(A, B, cap.out, grad, policy, P, bs,
                                        kernels, cap.shard, scratch_bound)
    A_qmax = fq.qmax_for_bit(policy.a_bit)
    if policy.quantizer == "sos_matmul":
        return MatMulQP(A_interval=fq.exact_div(a_state, A_qmax - 1),
                        B_interval=B_int, split=a_state,
                        A_bit=policy.a_bit, B_bit=policy.b_bit)
    return MatMulQP(A_interval=a_state, B_interval=B_int, split=None,
                    A_bit=policy.a_bit, B_bit=policy.b_bit)


# ---------------------------------------------------------------------------
# conv search (patch-embedding conv as matmul)
# ---------------------------------------------------------------------------

def _conv_inputs(w, b, x, raw_out, raw_grad):
    """fp32 x and raw_out (recomputed as x @ wᵀ + b when not stored)."""
    x = x.float()
    if raw_out is None:
        raw_out = torch.matmul(x, w.t())
        if b is not None:
            raw_out = raw_out + b
    return x, raw_out.float(), (None if raw_grad is None
                                else raw_grad.float())


@spanned("ptq.search.score")
def _conv_input_sims(w_sim, b, xb, rb, gb, a_cands, P: int, a_qmax: int,
                     reduce, shard=None):
    """Summed similarities (eq_n,) of the layerwise input-interval
    candidates of the patch-embed conv under its fake-quant weight
    ``w_sim`` (oc, icp) (conv.py:222-243, :429-441); ``reduce(out, raw,
    grad)`` maps a batch chunk's (bs,N,P,oc) outputs to (bs, P) sims."""
    out_sims = []
    for ac in _candidate_chunks(a_cands, P):                   # (P,)
        cur = ac[None, None, :, None]
        acc = torch.zeros(P, device=ac.device)
        for x_s, r_s, g_s in zip(xb, rb, gb):
            x_sim = torch.clamp(torch.round(x_s[:, :, None] / cur),
                                -a_qmax, a_qmax - 1) * cur
            out = torch.einsum("btpi,oi->btpo", x_sim, w_sim)
            if b is not None:
                out = out + b
            acc = acc + torch.sum(reduce(out, r_s, g_s), dim=0)
        out_sims.append(acc)
    return _sum(shard, torch.cat(out_sims)[:a_cands.shape[0]])


def _conv_search(w, b, x, raw_out, raw_grad, policy: OpPolicy, P: int,
                 bs: int, channelwise: bool, shard=None):
    """calibration_step2 of the patch-embed conv (reference
    ChannelwiseBatchingQuantConv2d, conv.py:591-603, and
    BatchingEasyQuantConv2d, conv.py:429-441).  x: (S, N, icp) patchified
    input; w: (oc, icp) flattened kernel."""
    x, raw_out, raw_grad = _conv_inputs(w, b, x, raw_out, raw_grad)
    S, N, icp = x.shape
    oc = w.shape[0]
    dev = x.device
    w_qmax = fq.qmax_for_bit(policy.w_bit)
    a_qmax = fq.qmax_for_bit(policy.a_bit)
    quant_act = policy.a_bit < 32
    metric = policy.metric

    with span("ptq.search.init"):
        if channelwise:
            if policy.init_layerwise:
                w_int0 = fq.minmax_interval(w, w_qmax).reshape(1, 1) \
                    .expand(oc, 1).contiguous()
            else:
                w_int0 = fq.exact_div(torch.amax(torch.abs(w), dim=1,
                                                 keepdim=True), w_qmax - 0.5)
        else:
            w_int0 = fq.minmax_interval(w, w_qmax).reshape(1, 1)
        a_int0 = fq.exact_div(_max(shard, torch.amax(torch.abs(x))),
                              a_qmax - 0.5)

        grid = fq.candidate_grid(policy.eq_alpha, policy.eq_beta, policy.eq_n,
                                 device=dev)
        eq_n = policy.eq_n
        w_cands = grid[:eq_n, None, None] * w_int0[None]        # eq_n,oc|1,1
        a_cands = grid[:eq_n] * a_int0
        xb, rb = _batch_chunks(x, bs), _batch_chunks(raw_out, bs)
        gb = (_batch_chunks(raw_grad, bs) if metric == "hessian"
              else [None] * len(xb))

    def reduce(out, r_s, g_s, for_w):
        raw = r_s[:, :, None]                                  # bs,N,1,oc
        gc = g_s[:, :, None] if metric == "hessian" else None
        if channelwise:
            if metric == "cosine":
                sim = cosine_similarity(raw.permute(0, 2, 3, 1),
                                        out.permute(0, 2, 3, 1), axis=-1)
                return sim if for_w else torch.mean(sim, dim=2)
            sim = _feature_similarity(raw, out, metric, gc, None)
            return (torch.mean(sim, dim=1) if for_w
                    else torch.mean(sim, dim=(1, 3)))
        if metric == "cosine" and for_w:
            return torch.mean(cosine_similarity(raw, out, axis=-1), dim=1)
        if metric == "pearson" and for_w:
            return cosine_similarity(
                raw.reshape(bs, 1, -1),
                out.transpose(1, 2).reshape(bs, out.shape[2], -1), axis=-1)
        sim = _feature_similarity(raw, out, metric, gc, -1)
        return torch.mean(sim, dim=1)

    @spanned("ptq.search.score")
    def score_w(a_int):
        out_sims = []
        for wc in _candidate_chunks(w_cands, P):               # P, oc|1, 1
            w_sim = fq.int_quant(w[None], wc, w_qmax) * wc
            acc = torch.zeros((P, oc) if channelwise else (P,), device=dev)
            for x_s, r_s, g_s in zip(xb, rb, gb):
                if quant_act:
                    x_s = fq.fake_quant(x_s, a_int, a_qmax)
                out = torch.einsum("bti,poi->btpo", x_s, w_sim)
                if b is not None:
                    out = out + b
                acc = acc + torch.sum(reduce(out, r_s, g_s, True), dim=0)
            out_sims.append(acc)
        return _sum(shard, torch.cat(out_sims)[:eq_n])

    w_int, a_int = w_int0, a_int0
    for _ in range(policy.search_round):
        sims = score_w(a_int)
        if channelwise:
            w_int = _argmax_take(w_cands[:, :, 0], sims)[:, None]
        else:
            w_int = w_cands[_argmax(sims)]
        if quant_act:
            a_int = a_cands[_argmax(_conv_input_sims(
                fq.fake_quant(w, w_int, w_qmax), b, xb, rb, gb, a_cands, P,
                a_qmax, lambda o, r, g: reduce(o, r, g, False), shard))]
    return w_int, a_int


def _conv_ptqsl_search(w, b, x, raw_out, raw_grad, policy: OpPolicy, P: int,
                       bs: int, shard=None):
    """Sub-layerwise n_V x n_H conv weight grid (JAX
    ``_conv_ptqsl_search_jit``; reference PTQSLQuantConv2d,
    conv.py:126-277): per (v, h) the candidates are spliced into the
    current interval, the metric runs over the channel axis, and ONE scalar
    argmax picks per block position (conv.py:214-219), alternating with the
    layerwise input search (conv.py:222-243, skipped at a_bit >= 32).
    x: (S, N, icp) patchified input; w: (oc, icp) flattened kernel."""
    x, raw_out, raw_grad = _conv_inputs(w, b, x, raw_out, raw_grad)
    S, N, icp = x.shape
    oc = w.shape[0]
    dev = x.device
    n_V, n_H = policy.n_V, policy.n_H
    w_qmax = fq.qmax_for_bit(policy.w_bit)
    a_qmax = fq.qmax_for_bit(policy.a_bit)
    quant_act = policy.a_bit < 32
    metric = policy.metric

    with span("ptq.search.init"):
        if policy.init_layerwise:                              # conv.py:246
            w_int0 = fq.minmax_interval(w, w_qmax).reshape(1, 1, 1, 1) \
                .expand(n_V, 1, n_H, 1).contiguous()
        else:
            w_int0 = fq.blocked_weight_interval_init(w, n_V, n_H, w_qmax)
        a_int0 = fq.exact_div(_max(shard, torch.amax(torch.abs(x))),
                              a_qmax - 0.5)

        grid = fq.candidate_grid(policy.eq_alpha, policy.eq_beta, policy.eq_n,
                                 device=dev)
        eq_n = policy.eq_n
        w_cands = grid[:eq_n, None, None, None, None] * w_int0[None]
        a_cands = grid[:eq_n] * a_int0
        xb, rb = _batch_chunks(x, bs), _batch_chunks(raw_out, bs)
        gb = (_batch_chunks(raw_grad, bs) if metric == "hessian"
              else [None] * len(xb))
        w4 = fq.blocked_weight_view(w, n_V, n_H)

    def mask_vh(v, h):
        return ((torch.arange(n_V, device=dev).reshape(n_V, 1, 1, 1) == v)
                & (torch.arange(n_H, device=dev).reshape(1, 1, n_H, 1) == h))

    def chan_sims(out, r_s, g_s):
        """(bs,N,P,oc) -> (bs,P): channel-axis metric, mean over
        tokens."""
        gc = g_s[:, :, None] if metric == "hessian" else None
        sim = _feature_similarity(r_s[:, :, None], out, metric, gc, -1)
        return torch.mean(sim, dim=1)

    @spanned("ptq.search.score")
    def score_w(w_int, a_int, m):
        out_sims = []
        for wc in _candidate_chunks(w_cands, P):               # P,n_V,1,n_H,1
            cur = torch.where(m, wc, w_int[None])
            w_sim = (fq.int_quant(w4[None], cur, w_qmax) * cur) \
                .reshape(P, oc, icp)
            acc = torch.zeros(P, device=dev)
            for x_s, r_s, g_s in zip(xb, rb, gb):
                if quant_act:
                    x_s = fq.fake_quant(x_s, a_int, a_qmax)
                out = torch.einsum("bti,poi->btpo", x_s, w_sim)
                if b is not None:
                    out = out + b
                acc = acc + torch.sum(chan_sims(out, r_s, g_s), dim=0)
            out_sims.append(acc)
        return _sum(shard, torch.cat(out_sims)[:eq_n])

    w_int, a_int = w_int0, a_int0
    for _ in range(policy.search_round):
        for idx in range(n_V * n_H):
            m = mask_vh(*divmod(idx, n_H))
            best = _argmax(score_w(w_int, a_int, m))
            w_int = torch.where(m, w_cands[best], w_int)
        if quant_act:
            a_int = a_cands[_argmax(_conv_input_sims(
                fq.fake_quant_weight_blocked(w, w_int, w_qmax), b, xb, rb,
                gb, a_cands, P, a_qmax, chan_sims, shard))]
    return w_int, a_int


def chunked_quantile(x: np.ndarray, q: float) -> float:
    """Quantile with the reference's >=2^24-element chunking: the mean of
    per-chunk quantiles (QuantileQuantConv2d._quantile, conv.py:111-116)."""
    flat = np.abs(np.asarray(x)).reshape(-1)
    if flat.size >= 16777216:
        n = flat.size // 16777216
        chunks = flat[:16777216 * n].reshape(n, 16777216)
        return float(np.mean(np.quantile(chunks, q, axis=1)))
    return float(np.quantile(flat, q))


def quantile_conv(w, cap, policy: OpPolicy) -> ConvQP:
    """Quantile-based conv scale init, no search (reference
    QuantileQuantConv2d, conv.py:91-124).  The quantiles are host numpy,
    as in the JAX package; over a mesh they take every rank's samples, in
    their global order (the >= 2^24-element chunks depend on it)."""
    dev = cap.inputs["x"].device
    w_qmax = fq.qmax_for_bit(policy.w_bit)
    a_qmax = fq.qmax_for_bit(policy.a_bit)

    def host(t):
        return t.detach().float().cpu().numpy()

    def interval(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    w_int = interval(chunked_quantile(host(w), policy.w_quantile)
                     / (w_qmax - 0.5))
    a_int = None
    if policy.a_bit < 32:
        x = cap.inputs["x"]
        if cap.shard is not None:
            x = cap.shard.gather(x)
        a_int = interval(chunked_quantile(host(x), policy.a_quantile)
                         / (a_qmax - 0.5))
    return ConvQP(w_interval=w_int, a_interval=a_int,
                  w_bit=policy.w_bit, a_bit=policy.a_bit)


def search_conv(w, b, cap, policy: OpPolicy,
                budget: int = DEFAULT_BUDGET) -> ConvQP:
    """Calibrate the patch-embedding conv.  w: (oc, ic, kh, kw)."""
    if policy.quantizer == "conv_quantile":
        return quantile_conv(w, cap, policy)
    x = cap.inputs["x"]                                         # S,N,icp
    dev = x.device
    oc = w.shape[0]
    wm = w.to(dev).float().reshape(oc, -1)
    b = None if b is None else b.to(dev).float()
    grad = cap.grad if policy.metric == "hessian" else None
    S, N, _ = x.shape
    P, bs = plan_chunks(policy.eq_n, S, N * oc, budget)
    a_qp = policy.a_bit < 32
    if policy.quantizer == "conv_ptqsl":
        w_int, a_int = _conv_ptqsl_search(wm, b, x, cap.out, grad, policy,
                                          P, bs, cap.shard)
        return ConvQP(w_interval=w_int, a_interval=a_int if a_qp else None,
                      w_bit=policy.w_bit, a_bit=policy.a_bit, blocked=True)
    if policy.quantizer not in ("conv_channelwise", "conv_layerwise"):
        raise NotImplementedError(f"unknown conv quantizer {policy.quantizer}")
    channelwise = policy.quantizer == "conv_channelwise"
    w_int, a_int = _conv_search(wm, b, x, cap.out, grad, policy, P, bs,
                                channelwise, cap.shard)
    w_int = w_int.reshape(oc, 1, 1, 1) if channelwise else w_int.reshape(())
    return ConvQP(w_interval=w_int, a_interval=a_int if a_qp else None,
                  w_bit=policy.w_bit, a_bit=policy.a_bit)
