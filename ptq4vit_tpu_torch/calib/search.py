"""Scale-factor candidate search — the calibration hot path.

The counterpart of ``ptq4vit_tpu/calib/search.py`` for the cases of the
main path of ViT and Swin: the linear search (qkv with n_V = 3, proj, fc1,
the post-GELU fc2, Swin's bias-free patch-merging reduction and the head),
the head-wise attention-matmul search (with the split-of-softmax split
search for matmul2; Swin's window matmuls hold images x windows samples)
and the channelwise patch-embedding conv search.

Scoring mode follows the device, as the JAX package's follows the backend
(search.py:51-76), but as explicit parameters:

  * CPU, default (``int8_score=False``): fp32-scored branches in plain
    torch — the counterparts of the JAX XLA branches;
  * CUDA (``int8_score=True, use_kernels=True``, the default there): int8
    scoring through the hand-written kernels of ``ops/search_kernels.py``;
  * CUDA otherwise: ``NotImplementedError`` for the linear and matmul
    searches (the fp32-scored kernels are not ported yet).  There is no
    fall-through to plain torch on the card.

With ``int8_score=True, use_kernels=True`` on CPU tensors the same code
runs the kernels' plain versions, which is how the tests hold this path
against the JAX Pallas path.  The conv search, the SoS split search and the
interval inits are plain tensor code on every device, as in JAX.

Parity notes (as in the JAX package): only the first eq_n of the eq_n+1
grid candidates are scored; per-batch similarities are summed, then
argmaxed with the first maximum winning (``torch.argmax``).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.policy import OpPolicy
from ..ops import search_kernels as K
from ..quant import fakequant as fq
from ..quant.metrics import cosine_similarity
from ..quant.qparams import ConvQP, LinearQP, MatMulQP

DEFAULT_BUDGET = 2 << 30  # bytes of out_sim scratch per candidate chunk


def plan_chunks(eq_n: int, samples: int, out_elems_per_sample_candidate: int,
                budget: int = DEFAULT_BUDGET):
    """Pick (candidate_chunk P, batch_chunk bs) with bs * P * out_elems * 4
    <= budget, preferring P big."""
    per_cand = samples * out_elems_per_sample_candidate * 4
    P = int(max(1, min(eq_n, budget // max(per_cand, 1))))
    bs = samples
    while P < 2 and bs > 1:
        bs = (bs + 1) // 2
        per_cand = bs * out_elems_per_sample_candidate * 4
        P = int(max(1, min(eq_n, budget // max(per_cand, 1))))
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


def _kernel_path(device: torch.device, int8_score: bool, use_kernels: bool,
                 eligible: bool, what: str) -> bool:
    """Whether the search scores through the int8 kernels.  On CUDA it
    must (or raise); on CPU it does when asked and the case is eligible."""
    if device.type == "cuda":
        if not (int8_score and use_kernels):
            raise NotImplementedError(
                f"the {what} search runs on CUDA only through its int8 "
                "kernels (int8_score=True, use_kernels=True); the "
                "fp32-scored kernels are not ported yet")
        if not eligible:
            raise NotImplementedError(
                f"this {what} search case (blocked layout or non-hessian "
                "metric) has no CUDA kernel yet")
        return True
    return bool(int8_score and use_kernels and eligible)


def _defaults(device, int8_score, use_kernels):
    on_cuda = device.type == "cuda"
    return (on_cuda if int8_score is None else int8_score,
            on_cuda if use_kernels is None else use_kernels)


def _argmax_take(cands2d, sims2d):
    """Per-column argmax of (eq_n, n) sims -> the chosen (n,) candidates."""
    best = torch.argmax(sims2d, dim=0)
    return torch.gather(cands2d, 0, best[None])[0]


# ---------------------------------------------------------------------------
# linear search
# ---------------------------------------------------------------------------

def _linear_search(w, b, x, raw_out, raw_grad, policy: OpPolicy, P: int,
                   bs: int, kernels: bool):
    """calibration_step2 of a linear layer (reference linear.py:536-555).
    x: (S, T, ic); raw_out / raw_grad: (S, T, oc) or None."""
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
    n_V, n_H, n_a = policy.n_V, policy.n_H, policy.n_a
    crb_r = oc // n_V
    w_qmax = fq.qmax_for_bit(policy.w_bit)
    a_qmax = fq.qmax_for_bit(policy.a_bit)
    postgelu = policy.quantizer == "postgelu_linear"
    a_neg = (torch.tensor(fq.GELU_NEG_CLIP / a_qmax, dtype=torch.float32,
                          device=dev) if postgelu else None)

    if policy.init_layerwise:
        w_int0 = fq.minmax_interval(w, w_qmax).reshape(1, 1, 1, 1) \
            .expand(n_V, 1, n_H, 1).contiguous()
        xg = fq.grouped_act_view(x, n_a)
        v = xg if postgelu else torch.abs(xg)
        a_int0 = fq.exact_div(torch.amax(v), a_qmax - 0.5).reshape(1, 1) \
            .expand(n_a, 1).contiguous()
    else:
        w_int0 = fq.blocked_weight_interval_init(w, n_V, n_H, w_qmax)
        a_int0 = fq.grouped_act_interval_init(x, n_a, a_qmax,
                                              signed=not postgelu)

    grid = fq.candidate_grid(policy.eq_alpha, policy.eq_beta, policy.eq_n,
                             device=dev)
    eq_n = policy.eq_n
    w_cands = grid[:eq_n, None, None, None, None] * w_int0[None]
    a_cands = grid[:eq_n, None, None] * a_int0[None]          # eq_n, n_a, 1
    w4 = fq.blocked_weight_view(w, n_V, n_H)

    if kernels:
        rawb = (raw_out if b is None else raw_out - b).reshape(S * T, oc) \
            .contiguous()
        grad_f = raw_grad.reshape(S * T, oc).contiguous()
        x2 = x.reshape(S * T, ic).contiguous()
    else:
        xb, rb = _batch_chunks(x, bs), _batch_chunks(raw_out, bs)
        gb = (_batch_chunks(raw_grad, bs) if policy.metric == "hessian"
              else [None] * len(xb))

    def score_w_kernel(a_int):
        a_sc = a_int.reshape(())
        if postgelu:
            x_lv = torch.clamp(torch.round(x2 / a_sc), 0, a_qmax - 1) \
                .to(torch.int8)
            x_neg = torch.clamp(torch.round(x2 / a_neg), -a_qmax, 0) \
                .to(torch.int8)
        else:
            x_lv = torch.clamp(torch.round(x2 / a_sc), -a_qmax, a_qmax - 1) \
                .to(torch.int8)
            x_neg = None
        sims = K.linear_w_hessian_sims_i8(
            x_lv, x_neg, a_sc, a_neg, w, w_cands.reshape(eq_n, n_V)
            .contiguous(), rawb, grad_f, w_qmax)
        return fq.exact_div(sims, float(T * crb_r))            # eq_n, n_V

    def score_w(w_int, a_int, h):
        """Summed similarities (eq_n, n_V) of the candidates for weight
        column block h (linear.py:455-495)."""
        if kernels:
            return score_w_kernel(a_int)
        x_sim = _quant_act_linear(x, a_int, a_neg, policy)
        x_sim_all = _batch_chunks(x_sim, bs)
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
                gc = (g_s.reshape(bs, T, 1, n_V, crb_r)
                      if policy.metric == "hessian" else None)
                sim = _feature_similarity(rawc, outc, policy.metric, gc, -1)
                acc = acc + torch.sum(torch.mean(sim, dim=1), dim=0)
            out_sims.append(acc)
        return torch.cat(out_sims)[:eq_n]

    def score_a(w_int, a_int, a):
        """Summed similarities (eq_n,) of the candidates for input group a
        (linear.py:497-533, :609-642)."""
        if kernels:
            w_lv = fq.int_quant(w4, w_int, w_qmax).to(torch.int8) \
                .reshape(oc, ic)
            w_sc = w_int[:, 0, 0, 0][:, None].expand(n_V, crb_r) \
                .reshape(oc).contiguous()
            sims = K.linear_a_hessian_sims_i8(
                x2, w_lv, w_sc, a_cands.reshape(eq_n).contiguous(), rawb,
                grad_f, a_qmax, postgelu=postgelu,
                a_neg=fq.GELU_NEG_CLIP / a_qmax if postgelu else 0.0)
            return fq.exact_div(sims, float(T * oc))
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
                gc = g_s[:, :, None] if policy.metric == "hessian" else None
                sim = _feature_similarity(r_s[:, :, None], out,
                                          policy.metric, gc, -1)
                acc = acc + torch.sum(torch.mean(sim, dim=1), dim=0)
            out_sims.append(acc)
        return torch.cat(out_sims)[:eq_n]

    w_int, a_int = w_int0, a_int0
    for _ in range(policy.search_round):
        for h in range(n_H):
            sims = score_w(w_int, a_int, h)                    # eq_n, n_V
            best = torch.argmax(sims, dim=0)                   # n_V
            chosen = torch.gather(w_cands[:, :, 0, :, 0], 0,
                                  best[None, :, None].expand(1, n_V, n_H))[0]
            mask_h = torch.arange(n_H, device=dev).reshape(1, 1, n_H, 1) == h
            w_int = torch.where(mask_h, chosen[:, None, :, None], w_int)
        for a in range(n_a):
            chosen = a_cands[torch.argmax(score_a(w_int, a_int, a))]
            mask_a = torch.arange(n_a, device=dev).reshape(n_a, 1) == a
            a_int = torch.where(mask_a, chosen, a_int)
    return w_int, a_int


def search_linear(w, b, cap, policy: OpPolicy, budget: int = DEFAULT_BUDGET,
                  int8_score: Optional[bool] = None,
                  use_kernels: Optional[bool] = None) -> LinearQP:
    """Calibrate a linear op from its captured data."""
    if policy.metric == "pearson":
        raise NotImplementedError("the pearson linear search is not ported")
    x = cap.inputs["x"]
    dev = x.device
    int8_score, use_kernels = _defaults(dev, int8_score, use_kernels)
    w = w.to(dev).float()
    b = None if b is None else b.to(dev).float()
    S, ic = x.shape[0], x.shape[-1]
    oc = w.shape[0]
    T = 1
    for d in x.shape[1:-1]:
        T *= d
    x = x.reshape(S, T, ic)
    raw_out = None if cap.out is None else cap.out.reshape(S, T, oc)
    grad = (cap.grad.reshape(S, T, oc) if policy.metric == "hessian"
            else None)
    kernels = _kernel_path(
        dev, int8_score, use_kernels,
        policy.n_H == 1 and policy.n_a == 1 and policy.metric == "hessian",
        "linear")
    P, bs = plan_chunks(policy.eq_n, S, T * oc, budget)
    w_int, a_int = _linear_search(w, b, x, raw_out, grad, policy, P, bs,
                                  kernels)
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

def _matmul_search(A, B, raw_out, raw_grad, policy: OpPolicy, P: int,
                   bs: int, kernels: bool):
    """calibration_step2 of an A@B op with head-wise groups and
    n_V = n_H = 1 (reference matmul.py:565-576).  A: (S,G,R,Ci);
    B: (S,G,Ci,Co); raw_out / raw_grad: (S,G,R,Co) or None."""
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
            return fq.exact_div(torch.amax(torch.abs(x)), qmax - 0.5) \
                .reshape(1, 1, 1, 1, 1, 1, 1).expand(1, G, 1, 1, 1, 1, 1) \
                .contiguous()
        return fq.matmul_operand_interval_init(x, G, 1, 1, qmax)

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
               grid[:eq_n].reshape(-1, 1, 1, 1, 1, 1, 1, 1) * a_state0[None])
    splits = fq.sos_split_grid(20, device=dev)

    if not kernels or sos:
        Ab, Bb = _batch_chunks(A, bs), _batch_chunks(B, bs)
        rb = ([None] * len(Ab) if raw_out is None
              else _batch_chunks(raw_out.float(), bs))
        gb = (_batch_chunks(raw_grad.float(), bs) if hessian
              else [None] * len(Ab))

    def get_raw(a_s, b_s, r_s):
        return torch.matmul(a_s, b_s) if r_s is None else r_s

    def sim_reduce(out, raw, g_s):
        """(P,bs,G,R,Co) -> (P, G) per-head summed similarity
        (matmul.py:510-518)."""
        gc = g_s[None] if hessian else None
        sim = _feature_similarity(raw[None], out, policy.metric, gc, -1)
        return torch.sum(torch.mean(sim, dim=3), dim=1)

    def score_splits():
        """SoS split grid, B raw (matmul.py:600-631)."""
        sims = []
        for sp in splits:
            acc = torch.zeros((), device=dev)
            for a_s, b_s, r_s, g_s in zip(Ab, Bb, rb, gb):
                A_sim = fq.sos_quant_softmax(a_s, sp, A_qmax)
                out = torch.matmul(A_sim, b_s)
                sim = _feature_similarity(get_raw(a_s, b_s, r_s), out,
                                          policy.metric, g_s, -1)
                acc = acc + torch.sum(torch.mean(sim, dim=(1, 2)))
            sims.append(acc)
        return torch.stack(sims)

    def score_A(B_int):
        """(eq_n, G) summed sims of the A-interval candidates
        (matmul.py:483-522)."""
        if kernels:
            sims = K.matmul_hessian_sims(
                A_raw, B_raw, grad_raw, A_cands.reshape(eq_n, G).contiguous(),
                B_int.reshape(G), "a", A_qmax, B_qmax)
            return fq.exact_div(sims, float(R * Co))
        B_sim = [fq.fake_quant_matmul_operand(b_s, B_int, B_qmax) for b_s in Bb]
        out_sims = []
        for ac in _candidate_chunks(A_cands, P):
            cur = ac.reshape(P, 1, G, 1, 1, 1)
            acc = torch.zeros(P, G, device=dev)
            for a_s, b_raw, b_s, r_s, g_s in zip(Ab, Bb, B_sim, rb, gb):
                blocked = a_s.reshape(1, bs, G, 1, R, Ci)
                q = torch.clamp(torch.round(blocked / cur), -A_qmax,
                                A_qmax - 1) * cur
                out = torch.einsum("pbgrc,bgco->pbgro",
                                   q.reshape(P, bs, G, R, Ci), b_s)
                acc = acc + sim_reduce(out, get_raw(a_s, b_raw, r_s), g_s)
            out_sims.append(acc)
        return torch.cat(out_sims)[:eq_n]

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
                    sos=(a_state, a_int, s_hi, a_int))
            else:
                sims = K.matmul_hessian_sims(
                    A_raw, B_raw, grad_raw,
                    B_cands.reshape(eq_n, G).contiguous(),
                    a_state.reshape(G), "b", B_qmax, A_qmax)
            return fq.exact_div(sims, float(R * Co))
        if sos:
            A_sim = [fq.sos_quant_softmax(a_s, a_state, A_qmax) for a_s in Ab]
        else:
            A_sim = [fq.fake_quant_matmul_operand(a_s, a_state, A_qmax)
                     for a_s in Ab]
        out_sims = []
        for bc in _candidate_chunks(B_cands, P):
            cur = bc.reshape(P, 1, G, 1, 1, 1)
            acc = torch.zeros(P, G, device=dev)
            for a_raw, a_s, b_s, r_s, g_s in zip(Ab, A_sim, Bb, rb, gb):
                blocked = b_s.reshape(1, bs, G, 1, Ci, Co)
                q = torch.clamp(torch.round(blocked / cur), -B_qmax,
                                B_qmax - 1) * cur
                out = torch.einsum("bgrc,pbgco->pbgro", a_s,
                                   q.reshape(P, bs, G, Ci, Co))
                acc = acc + sim_reduce(out, get_raw(a_raw, b_s, r_s), g_s)
            out_sims.append(acc)
        return torch.cat(out_sims)[:eq_n]

    a_state, B_int = a_state0, B_int0
    for _ in range(policy.search_round):
        if sos:
            a_state = splits[torch.argmax(score_splits())]
        else:
            a_state = _argmax_take(A_cands.reshape(eq_n, G), score_A(B_int)) \
                .reshape(1, G, 1, 1, 1, 1, 1)
        B_int = _argmax_take(B_cands.reshape(eq_n, G),
                             score_B(a_state, B_int)) \
            .reshape(1, G, 1, 1, 1, 1, 1)
    return a_state, B_int


def search_matmul(cap, policy: OpPolicy, budget: int = DEFAULT_BUDGET,
                  int8_score: Optional[bool] = None,
                  use_kernels: Optional[bool] = None) -> MatMulQP:
    """Calibrate an A@B op (head-wise groups) from its captured data;
    ``cap.out=None`` recomputes raw_out as A@B."""
    blocked = (policy.n_V_A != 1 or policy.n_H_A != 1 or policy.n_V_B != 1
               or policy.n_H_B != 1 or policy.n_G_A > 1 or policy.n_G_B > 1)
    if blocked:
        raise NotImplementedError("blocked matmul operand grids are not "
                                  "ported yet")
    A, B = cap.inputs["a"], cap.inputs["b"]
    dev = A.device
    int8_score, use_kernels = _defaults(dev, int8_score, use_kernels)
    grad = cap.grad if policy.metric == "hessian" else None
    S, G, R, _ = A.shape
    Co = B.shape[-1]
    kernels = _kernel_path(dev, int8_score, use_kernels,
                           policy.metric == "hessian", "matmul")
    P, bs = plan_chunks(policy.eq_n, S, G * R * Co, budget)
    a_state, B_int = _matmul_search(A, B, cap.out, grad, policy, P, bs,
                                    kernels)
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

def _conv_search(w, b, x, raw_out, raw_grad, policy: OpPolicy, P: int,
                 bs: int, channelwise: bool):
    """calibration_step2 of the patch-embed conv (reference
    ChannelwiseBatchingQuantConv2d, conv.py:591-603, and
    BatchingEasyQuantConv2d, conv.py:429-441).  x: (S, N, icp) patchified
    input; w: (oc, icp) flattened kernel."""
    x = x.float()
    if raw_out is None:
        raw_out = torch.matmul(x, w.t())
        if b is not None:
            raw_out = raw_out + b
    raw_out = raw_out.float()
    if raw_grad is not None:
        raw_grad = raw_grad.float()
    S, N, icp = x.shape
    oc = w.shape[0]
    dev = x.device
    w_qmax = fq.qmax_for_bit(policy.w_bit)
    a_qmax = fq.qmax_for_bit(policy.a_bit)
    quant_act = policy.a_bit < 32
    metric = policy.metric

    if channelwise:
        if policy.init_layerwise:
            w_int0 = fq.minmax_interval(w, w_qmax).reshape(1, 1) \
                .expand(oc, 1).contiguous()
        else:
            w_int0 = fq.exact_div(torch.amax(torch.abs(w), dim=1,
                                             keepdim=True), w_qmax - 0.5)
    else:
        w_int0 = fq.minmax_interval(w, w_qmax).reshape(1, 1)
    a_int0 = fq.exact_div(torch.amax(torch.abs(x)), a_qmax - 0.5)

    grid = fq.candidate_grid(policy.eq_alpha, policy.eq_beta, policy.eq_n,
                             device=dev)
    eq_n = policy.eq_n
    w_cands = grid[:eq_n, None, None] * w_int0[None]            # eq_n,oc|1,1
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
        return torch.cat(out_sims)[:eq_n]

    def score_a(w_int):
        w_sim = fq.fake_quant(w, w_int, w_qmax)
        out_sims = []
        for ac in _candidate_chunks(a_cands, P):               # (P,)
            acc = torch.zeros(P, device=dev)
            for x_s, r_s, g_s in zip(xb, rb, gb):
                cur = ac[None, None, :, None]
                x_sim = torch.clamp(torch.round(x_s[:, :, None] / cur),
                                    -a_qmax, a_qmax - 1) * cur
                out = torch.einsum("btpi,oi->btpo", x_sim, w_sim)
                if b is not None:
                    out = out + b
                acc = acc + torch.sum(reduce(out, r_s, g_s, False), dim=0)
            out_sims.append(acc)
        return torch.cat(out_sims)[:eq_n]

    w_int, a_int = w_int0, a_int0
    for _ in range(policy.search_round):
        sims = score_w(a_int)
        if channelwise:
            w_int = _argmax_take(w_cands[:, :, 0], sims)[:, None]
        else:
            w_int = w_cands[torch.argmax(sims)]
        if quant_act:
            a_int = a_cands[torch.argmax(score_a(w_int))]
    return w_int, a_int


def search_conv(w, b, cap, policy: OpPolicy,
                budget: int = DEFAULT_BUDGET) -> ConvQP:
    """Calibrate the patch-embedding conv.  w: (oc, ic, kh, kw)."""
    if policy.quantizer not in ("conv_channelwise", "conv_layerwise"):
        raise NotImplementedError(f"{policy.quantizer} is not ported yet")
    x = cap.inputs["x"]                                         # S,N,icp
    dev = x.device
    oc = w.shape[0]
    wm = w.to(dev).float().reshape(oc, -1)
    b = None if b is None else b.to(dev).float()
    grad = cap.grad if policy.metric == "hessian" else None
    S, N, _ = x.shape
    P, bs = plan_chunks(policy.eq_n, S, N * oc, budget)
    channelwise = policy.quantizer == "conv_channelwise"
    w_int, a_int = _conv_search(wm, b, x, cap.out, grad, policy, P, bs,
                                channelwise)
    w_int = w_int.reshape(oc, 1, 1, 1) if channelwise else w_int.reshape(())
    return ConvQP(w_interval=w_int,
                  a_interval=(a_int if policy.a_bit < 32 else None),
                  w_bit=policy.w_bit, a_bit=policy.a_bit)
