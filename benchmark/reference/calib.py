"""Plain PTQ4ViT calibration of chosen ops, and the comparison that judges
a calibrated qstate (Yuan et al., arXiv:2111.12293).

Parallel paradigm: every op is calibrated on the inputs of the
unquantized net.  The capture runs the float net over the calibration
images in micro-batches and keeps each chosen op's inputs and the
gradient of ``KL(log_softmax(logits) || softmax(logits + sigma u))`` with
respect to its output; the caches are kept in the configuration's cache
dtype (bfloat16).  The search then alternates, for ``rounds`` rounds,
between the weight (or first operand) interval and the input (or second
operand) interval, each picked among ``eq_n`` multiples ``alpha + i (beta
- alpha) / eq_n`` of its absmax / (qmax - 0.5) start by the hessian
metric ``-sum (g (raw - quantized))^2``, the first maximum winning.  The
post-softmax operand is searched as a split point over ``2^-i``, i < 20,
with the other operand raw; the post-GELU input has a fixed negative
interval; the patch embedding searches one weight interval per channel
and leaves its input unquantized.  A round that leaves both intervals as
they were ends the search: every later round would repeat it.

The products and the metric are computed in ``dtype``: float32 (TF32
off) for the reference, a lower precision for the control.
"""
from __future__ import annotations

from typing import Dict

import torch

from . import fq
from .models import Hooks, forward, op_weight


def capture(params, cfg, images, probe_u, ops, *, micro=4, sigma=1e-3,
            dtype=torch.float32, cache_dtype=torch.bfloat16):
    """{op: {"x" | "a", "b", "g": cache}} over every image, samples
    leading (Swin's window matmuls: images x windows)."""
    cast = cast_tree(params, dtype)
    kept: Dict[str, Dict[str, list]] = {op: {} for op in ops}
    for s0 in range(0, images.shape[0], micro):
        x = images[s0:s0 + micro].to(dtype)
        u = probe_u[s0:s0 + micro].float()
        shapes = {}

        def record(name, out, shapes=shapes):
            shapes[name] = out.shape
            return out
        with torch.no_grad():
            hk = Hooks(taps=ops)
            hk._out = record
            logits = forward(cast, x, cfg, hk)
            target = torch.softmax(logits.float() + sigma * u, dim=-1)
        eps = {op: torch.zeros(shapes[op], dtype=dtype, device=x.device,
                               requires_grad=True) for op in ops}
        with torch.enable_grad():
            hk = Hooks(taps=ops, eps=eps)
            logits = forward(cast, x, cfg, hk).float()
            logt = torch.log(torch.clamp(target, min=1e-30))
            loss = torch.sum(target * (logt - torch.log_softmax(logits, -1))) \
                / x.shape[0]
            grads = torch.autograd.grad(loss, [eps[op] for op in ops])
        for op, g in zip(ops, grads):
            for k, t in list(hk.kept[op].items()) + [("g", g)]:
                kept[op].setdefault(k, []).append(t.detach().to(cache_dtype))
        del hk, eps, grads, logits
    return {op: {k: torch.cat(v) for k, v in d.items()}
            for op, d in kept.items()}


def cast_tree(tree, dtype):
    if torch.is_tensor(tree):
        return tree.to(dtype)
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    return [cast_tree(v, dtype) for v in tree]


def _chunk(n_bytes_per_cand, budget=1 << 31):
    return max(1, int(budget // max(n_bytes_per_cand, 1)))


class Policy:
    def __init__(self, mix):
        self.alpha = mix.get("eq_alpha", 0.01)
        self.beta = mix.get("eq_beta", 1.2)
        self.eq_n = mix.get("eq_n", 100)
        self.rounds = mix.get("search_round", 3)
        self.bits = tuple(mix.get("bits", (8, 8)))
        self.w_qmax = 2 ** (self.bits[0] - 1)
        self.a_qmax = 2 ** (self.bits[1] - 1)


# -- the errors of given intervals (the metric, as a positive error) ------

def linear_err(x, g, raw, w, b, wq_int, a_int, a_neg, pol, n_v):
    """Hessian error of each row block (n_V,) under the given intervals."""
    xq = (fq.quant_twin_gelu(x, a_int, a_neg, pol.a_qmax) if a_neg is not None
          else fq.quant(x, a_int, pol.a_qmax))
    out = xq @ fq.quant_rows(w, wq_int, pol.w_qmax).t()
    if b is not None:
        out = out + b
    e = (g * (raw - out)) ** 2
    return e.reshape(e.shape[0], n_v, -1).sum((0, 2))


def matmul_err(g, raw, qa, qb):
    """Hessian error of each head (G,) for quantized operands."""
    return ((g * (raw - qa @ qb)) ** 2).float().sum((0, 2, 3))


# -- the searches ---------------------------------------------------------

def search_linear(x, g, w, b, pol, n_v, postgelu, dtype):
    """x (M, ic), g (M, oc) -> {"w": (n_V,), "a": (), "a_neg"}."""
    x, g = x.to(dtype), g.to(dtype)
    w = w.to(dtype)
    b = None if b is None else b.to(dtype)
    raw = x @ w.t() + (0 if b is None else b)
    oc, ic = w.shape
    M = x.shape[0]
    cands = fq.grid(pol.alpha, pol.beta, pol.eq_n, x.device).to(dtype)
    w0 = fq.div(w.abs().reshape(n_v, -1).amax(1).float(),
                pol.w_qmax - 0.5).to(dtype)
    a0 = fq.div((x if postgelu else x.abs()).amax().float(),
                pol.a_qmax - 0.5).to(dtype)
    a_neg = (fq.div(torch.tensor(fq.GELU_NEG_CLIP, device=x.device),
                    pol.a_qmax).to(dtype) if postgelu else None)
    esz = torch.tensor([], dtype=dtype).element_size()
    P = _chunk(M * oc * esz * 3)

    def quant_x(a):
        return (fq.quant_twin_gelu(x, a, a_neg, pol.a_qmax) if postgelu
                else fq.quant(x, a, pol.a_qmax))

    def step_w(a):
        xq = quant_x(a)
        errs = []
        for c in cands.split(P):
            wq = torch.cat([fq.quant_rows(w, ci * w0, pol.w_qmax)
                            for ci in c])                      # (p oc, ic)
            out = (xq @ wq.t()).reshape(M, len(c), oc)
            if b is not None:
                out = out + b
            e = (g[:, None] * (raw[:, None] - out)) ** 2
            errs.append(e.reshape(M, len(c), n_v, -1).float().sum((0, 3)))
        best = torch.argmin(torch.cat(errs), dim=0)            # (n_V,)
        return cands[best] * w0

    def step_a(wi):
        wq = fq.quant_rows(w, wi, pol.w_qmax)
        errs = []
        for c in cands.split(P):
            xq = torch.stack([quant_x(ci * a0) for ci in c])   # (p, M, ic)
            out = xq @ wq.t()
            if b is not None:
                out = out + b
            errs.append((((g * (raw - out)) ** 2).float()).sum((1, 2)))
        return cands[torch.argmin(torch.cat(errs))] * a0

    wi, ai = w0, a0
    for _ in range(pol.rounds):
        wn = step_w(ai)
        an = step_a(wn)
        if torch.equal(wn, wi) and torch.equal(an, ai):
            break
        wi, ai = wn, an
    return {"w": wi.float(), "a": ai.float(),
            "a_neg": None if a_neg is None else a_neg.float()}


def search_matmul(a, bm, g, pol, sos, dtype):
    """a (S, G, R, Ci), b (S, G, Ci, Co), g (S, G, R, Co) -> {"a": (G,)}
    or {"split": ()}, with {"b": (G,)}."""
    a, bm, g = a.to(dtype), bm.to(dtype), g.to(dtype)
    raw = a @ bm
    G = a.shape[1]
    cands = fq.grid(pol.alpha, pol.beta, pol.eq_n, a.device).to(dtype)

    def start(t):
        return fq.div(t.abs().transpose(0, 1).reshape(G, -1).amax(1)
                      .float(), pol.a_qmax - 0.5).to(dtype)

    a0, b0 = start(a), start(bm)

    def err(qa, qb):
        return matmul_err(g, raw, qa, qb)

    def pick(errs, base):
        e = torch.stack(errs)                                   # (n, G)
        return cands[torch.argmin(e, dim=0)] * base

    if sos:
        splits = fq.split_grid(20, a.device).to(dtype)
        es = [err(fq.quant_sos(a, s, pol.a_qmax), bm).sum() for s in splits]
        split = splits[torch.argmin(torch.stack(es))]
        qa = fq.quant_sos(a, split, pol.a_qmax)
        bi = pick([err(qa, fq.quant_heads(bm, c * b0, pol.a_qmax))
                   for c in cands], b0)
        # the split step ignores the second operand: every round repeats
        return {"split": split.float(), "b": bi.float()}
    ai, bi = a0, b0
    for _ in range(pol.rounds):
        qb = fq.quant_heads(bm, bi, pol.a_qmax)
        an = pick([err(fq.quant_heads(a, c * a0, pol.a_qmax), qb)
                   for c in cands], a0)
        qa = fq.quant_heads(a, an, pol.a_qmax)
        bn = pick([err(qa, fq.quant_heads(bm, c * b0, pol.a_qmax))
                   for c in cands], b0)
        if torch.equal(an, ai) and torch.equal(bn, bi):
            break
        ai, bi = an, bn
    return {"a": ai.float(), "b": bi.float()}


def search_conv(x, g, w, b, pol, dtype):
    """Patch embedding: x (M, icp), g (M, oc) -> {"w": (oc,)}; its input
    is not quantized, so one step is the whole search."""
    x, g, w = x.to(dtype), g.to(dtype), w.to(dtype)
    b = None if b is None else b.to(dtype)
    raw = x @ w.t() + (0 if b is None else b)
    M, oc = g.shape
    cands = fq.grid(pol.alpha, pol.beta, pol.eq_n, x.device).to(dtype)
    w0 = fq.div(w.abs().amax(1).float(), pol.w_qmax - 0.5).to(dtype)
    esz = torch.tensor([], dtype=dtype).element_size()
    errs = []
    for c in cands.split(_chunk(M * oc * esz * 3)):
        wq = torch.cat([fq.quant(w, (ci * w0)[:, None], pol.w_qmax)
                        for ci in c])
        out = (x @ wq.t()).reshape(M, len(c), oc)
        if b is not None:
            out = out + b
        errs.append(((g[:, None] * (raw[:, None] - out)) ** 2).float()
                    .sum(0))
    return {"w": (cands[torch.argmin(torch.cat(errs), 0)] * w0).float()}


def flat(t):
    """(S, ..., C) -> (S * ..., C)."""
    return t.reshape(-1, t.shape[-1])


def search_op(kind, cache, params, name, pol, dtype):
    if kind in ("matmul", "sos"):
        return search_matmul(cache["a"], cache["b"], cache["g"], pol,
                             kind == "sos", dtype)
    w, b = op_weight(params, name)
    if kind == "conv":
        return search_conv(flat(cache["x"]), flat(cache["g"]), w, b, pol,
                           dtype)
    return search_linear(flat(cache["x"]), flat(cache["g"]), w, b, pol,
                         3 if kind == "qkv" else 1, kind == "postgelu", dtype)


def op_errors(kind, cache, params, name, pol, iv):
    """Each group's error (row block, head or channel) of intervals ``iv``
    on the float32 caches."""
    if kind in ("matmul", "sos"):
        a, bm, g = (cache[k].float() for k in ("a", "b", "g"))
        qa = (fq.quant_sos(a, iv["split"], pol.a_qmax) if kind == "sos"
              else fq.quant_heads(a, iv["a"], pol.a_qmax))
        return matmul_err(g, a @ bm, qa,
                          fq.quant_heads(bm, iv["b"], pol.a_qmax))
    w, b = op_weight(params, name)
    x, g = flat(cache["x"]).float(), flat(cache["g"]).float()
    raw = x @ w.t() + (0 if b is None else b)
    if kind == "conv":
        out = x @ fq.quant(w, iv["w"][:, None], pol.w_qmax).t()
        if b is not None:
            out = out + b
        return ((g * (raw - out)) ** 2).sum(0)
    n_v = 3 if kind == "qkv" else 1
    return linear_err(x, g, raw, w, b, iv["w"], iv["a"], iv.get("a_neg"),
                      pol, n_v)


def judge(kinds, caches, params, pol, program, reference):
    """The numbers that decide ``correct`` for a calibration: ``gap``, the
    widest share by which a group's error under the program's intervals
    exceeds its error under the reference's, and ``moved``, the largest
    share over the ops of an op's interval entries that differ from the
    reference's by more than one part in 10^5 (each op weighs alike, so
    one op's intervals moved show whatever the other ops hold).  Returns
    (numbers, the worst op by gap and by moved)."""
    gap, moved, worst = 0.0, 0.0, [None, None]
    for name, kind in kinds.items():
        e_ref = op_errors(kind, caches[name], params, name, pol,
                          reference[name])
        e_prog = op_errors(kind, caches[name], params, name, pol,
                           program[name])
        g = float(((e_prog - e_ref) / torch.clamp(e_ref, min=1e-30)).max())
        if g > gap or worst[0] is None:
            gap, worst[0] = max(gap, g), name
        n_moved, total = 0, 0
        for k, r in reference[name].items():
            if r is None:
                continue
            p = program[name][k].reshape(r.shape).float()
            n_moved += int(((p - r).abs() > 1e-5 * r.abs()).sum())
            total += r.numel()
        m = n_moved / max(total, 1)
        if m > moved or worst[1] is None:
            moved, worst[1] = max(moved, m), name
    return {"gap": gap, "moved": moved}, tuple(worst)
