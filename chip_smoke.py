"""Card check of the PyTorch / CUDA port (ptq4vit_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):
  1. the card's name and power limit; CUDA is required, TF32 is off;
  2. build the search kernels from ptq4vit_tpu_torch/csrc/;
  3. each kernel against its plain PyTorch version, with both times and
     the least time the card could take for the same work: B1 plain/twin,
     B2 signed/post-GELU, B3 a/b/b_sos, B4w fc1 / post-GELU fc2 / qkv
     n_V=3 and B4a signed / post-GELU at ViT-B/384 shapes (4 images); B3f
     a/b/b_sos at Swin-B/384 window shapes (4 images, stages 1 and 3), with
     B3 timed on the same inputs;
  4. the ViT path: quantize("vit_base_patch16_384", 8 images, PTQ4ViT W8A8)
     with random weights from a seeded generator; B1, B2 and B3 must be
     launched and every interval finite and positive; serve 4 images with
     the fake-quant forward and check the card's forwards against the same
     forwards on the CPU for one image;
  5. the Swin path: the same for "swin_base_patch4_window12_384" at full
     width and depth (149 ops), with B1, B2 and B3f launched;
  6. the exact-scoring path: phase 4 with int8_score=False; B4w and B4a
     are launched 147 times each (49 linears x 3 rounds) and B1-B3f never;
     then the flip count: per op type, the interval slots where this qstate
     and phase 4's int8-scored one differ (same net, images and probe);
  7. the policy path, at full ViT-B/384 width and depth 2 built with
     net_from_config: BasePTQ W6A6 (cosine metric: plain torch, no kernel)
     and PTQ4ViT W8A8 sequential (B1, B2 and B3 launched); finite positive
     intervals and finite logits;
  8. print the kernels' JSON line, the card line, then the result line.
Each path is driven with the launch counts set to 0 just before it and
read just after.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

SIMS_RTOL = 1e-4       # reordered fp32 sums of up to ~7M terms
ARGMAX_TIE = 1e-4      # top-two sims closer than this may swap
NUM_CALIB = 8
SOURCE = "ptq4vit_tpu_torch/csrc/search_kernels.cu"
REPLACES = {
    "linear_w_hessian_sims_i8": "ptq4vit_tpu/ops/pallas_search.py:285",
    "linear_a_hessian_sims_i8": "ptq4vit_tpu/ops/pallas_search.py:453",
    "matmul_hessian_sims_b3": "ptq4vit_tpu/ops/pallas_search.py:548",
    "matmul_hessian_sims_b3f": "ptq4vit_tpu/ops/pallas_search.py:634",
    "linear_w_hessian_sims": "ptq4vit_tpu/ops/pallas_search.py:117",
    "linear_a_hessian_sims": "ptq4vit_tpu/ops/pallas_search.py:975",
}
# the kernels each path must launch (None: at least once) and must not
INT8 = ("linear_w_hessian_sims_i8", "linear_a_hessian_sims_i8",
        "matmul_hessian_sims_b3", "matmul_hessian_sims_b3f")
PATHS = {
    "vit_base_patch16_384": (
        {"linear_w_hessian_sims_i8": None, "linear_a_hessian_sims_i8": None,
         "matmul_hessian_sims_b3": None}, ()),
    "swin_base_patch4_window12_384": (
        {"linear_w_hessian_sims_i8": None, "linear_a_hessian_sims_i8": None,
         "matmul_hessian_sims_b3f": None}, ()),
    "vit_base_patch16_384 exact": (
        {"linear_w_hessian_sims": 147, "linear_a_hessian_sims": 147}, INT8),
    "vit_base_patch16_384 depth 2 BasePTQ W6A6": ({}, tuple(REPLACES)),
    "vit_base_patch16_384 depth 2 PTQ4ViT sequential": (
        {"linear_w_hessian_sims_i8": None, "linear_a_hessian_sims_i8": None,
         "matmul_hessian_sims_b3": None}, ()),
}
# published H100 SXM peaks at 700 W (NVIDIA's data sheet, dense)
PEAK_OPS = {"int8": 1979e12, "fp32": 67e12}
PEAK_BYTES = 3.35e12


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def check_sims(name, got, ref):
    """Sims within SIMS_RTOL; argmax equal unless a near-tie."""
    got, ref = got.double().cpu(), ref.double().cpu()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite sims")
    err = (got - ref).abs()
    if not (err <= SIMS_RTOL * ref.abs()).all():
        raise AssertionError(f"{name}: sims off by {float((err / ref.abs()).max()):.3e} relative")
    g2 = got.reshape(got.shape[0], -1)
    r2 = ref.reshape(ref.shape[0], -1)
    for col in range(r2.shape[1]):
        i, j = int(g2[:, col].argmax()), int(r2[:, col].argmax())
        if i != j and abs(float(r2[i, col] - r2[j, col])) > \
                ARGMAX_TIE * abs(float(r2[j, col])):
            raise AssertionError(f"{name}: argmax {i} != {j} (column {col})")
    return float(err.max())


def work(kname, args, out):
    """(operations by type, bytes) a call needs: each input read once and
    the output written once; int8 multiply-adds of the levels (2 ops) for
    B1-B3f, fp32 ones for B4w / B4a and for B3's in-kernel raw = A @ B."""
    nbytes = sum(a.numel() * a.element_size() for a in args
                 if torch.is_tensor(a)) + out.numel() * out.element_size()
    P = args[3].shape[0] if kname.startswith("matmul") else None
    if kname == "linear_w_hessian_sims_i8":
        (M, K), N, P = args[0].shape, args[4].shape[0], args[5].shape[0]
        return {"int8": 2 * P * M * K * N * (2 if args[1] is not None
                                              else 1)}, nbytes
    if kname == "linear_a_hessian_sims_i8":
        (M, K), N, P = args[0].shape, args[1].shape[0], args[3].shape[0]
        return {"int8": 2 * M * K * N * (P + (1 if args[7] else 0))}, nbytes
    if kname.startswith("matmul"):
        S, G, R, Ci = args[0].shape
        mm = 2 * S * G * R * Ci * args[1].shape[-1]
        return {"int8": P * mm * (2 if args[5] == "b_sos" else 1),
                "fp32": mm}, nbytes
    (M, K), N, P = args[0].shape, args[1].shape[0], args[2].shape[0]
    return {"fp32": 2 * P * M * K * N}, nbytes                 # B4w, B4a


def bound(ops, nbytes):
    """The least time (ms) the card could take, and what bounds it."""
    t_ops = sum(n / PEAK_OPS[k] for k, n in ops.items())
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def kernel_phase(sk, dev):
    """Each kernel against its plain version at ViT-B/384 shapes."""
    from ptq4vit_tpu_torch.quant.fakequant import GELU_NEG_CLIP
    rng = np.random.default_rng(0)
    S, N, d, hid, G, hd, P, q = 4, 577, 768, 3072, 12, 64, 100, 128
    M = S * N
    grid = np.linspace(0.01, 1.2, P + 1)[:P].astype(np.float32)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    def linear_case(ic, oc, n_V, postgelu):
        x = rng.standard_normal((M, ic)).astype(np.float32)
        if postgelu:
            x = x * 0.5 * (1 + np.tanh(0.7978845608 * (x + 0.044715 * x ** 3)))
        w = (rng.standard_normal((oc, ic)) * (2 / (ic + oc)) ** 0.5) \
            .astype(np.float32)
        raw = (x @ w.T).astype(np.float32)
        g = (rng.standard_normal((M, oc)) * 1e-4).astype(np.float32)
        return x, w, raw, g

    def case(kname, label, args, ref_name=None, other=None):
        fn = getattr(sk, kname)
        ref = getattr(sk, ref_name or kname + "_ref")
        cases.append((kname, label, args, lambda: fn(*args),
                      lambda: ref(*args), other))

    cases = []   # (kernel, label, args, fn, ref_fn, other)
    for label, ic, oc, n_V, pg in (("fc1", d, hid, 1, False),
                                   ("fc2 twin", hid, d, 1, True),
                                   ("qkv n_V=3", d, 3 * d, 3, False)):
        x, w, raw, g = linear_case(ic, oc, n_V, pg)
        a = np.float32((x.max() if pg else np.abs(x).max()) / (q - 0.5))
        a_neg = np.float32(GELU_NEG_CLIP / q)
        lo = 0 if pg else -q
        x_lv = np.clip(np.round(x / a), lo, q - 1)
        x_neg = np.clip(np.round(x / a_neg), -q, 0)
        base = np.abs(w.reshape(n_V, -1)).max(1) / (q - 0.5)
        cw = t(grid[:, None] * base[None].astype(np.float32))
        case("linear_w_hessian_sims_i8", label,
             (t(x_lv, torch.int8), t(x_neg, torch.int8) if pg else None,
              float(a), float(a_neg) if pg else None, t(w), cw, t(raw), t(g),
              q))
        # B4w takes the fake-quant input (twin on fc2) as fp32
        x_sim = x_lv * a + (x_neg * a_neg if pg else 0)
        case("linear_w_hessian_sims", label,
             (t(x_sim), t(w), cw if n_V > 1 else cw[:, 0].contiguous(),
              t(raw), t(g), q))
        w_int = (np.abs(w).max() / (q - 0.5)).astype(np.float32)
        w_lv = np.clip(np.round(w / w_int), -q, q - 1)
        ca = t(grid * a)
        case("linear_a_hessian_sims_i8", label,
             (t(x), t(w_lv, torch.int8), t(np.full(oc, w_int, np.float32)),
              ca, t(raw), t(g), q, pg, GELU_NEG_CLIP / q if pg else 0.0))
        if n_V == 1:      # B4a: signed (fc1) and post-GELU (fc2)
            case("linear_a_hessian_sims", label,
                 (t(x), t(w_lv * w_int), ca, t(raw), t(g), q, pg,
                  GELU_NEG_CLIP / q if pg else 0.0))

    for label, args in matmul_cases(rng, grid, S, G, N, hd, q, t):
        case("matmul_hessian_sims_b3", label, args, "matmul_hessian_sims_ref")
    # Swin-B/384 window matmuls (window 12: N = 144, head dim 32) at 4
    # images: stage 1 (64 windows, 4 heads), stage 3 (4 windows, 16 heads);
    # B3 runs on the same inputs for comparison
    for stage, nwin, G_s in ((1, 64, 4), (3, 4, 16)):
        for label, args in matmul_cases(rng, grid, S * nwin, G_s, 144, 32,
                                        q, t):
            if sk.mm_fold_factor(G_s, args[0].shape[-1],
                                 args[1].shape[-1]) <= 1:
                raise AssertionError("Swin window shapes must fold")
            case("matmul_hessian_sims_b3f", f"stage {stage} {label}", args,
                 "matmul_hessian_sims_ref",
                 lambda args=args: sk.matmul_hessian_sims_b3(*args))

    stats = {}
    for kname, label, args, fn, ref_fn, other in cases:
        got = fn()
        ref = ref_fn()
        torch.cuda.synchronize()
        err = check_sims(f"{kname} {label}", got, ref)
        ms = time_ms(fn, 5)
        plain_ms = time_ms(ref_fn, 1)
        bound_ms, bound_by = bound(*work(kname, args, got))
        entry = {"case": label, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": bound_ms, "bound_by": bound_by}
        line = (f"[kernel] {kname} {label}: max_abs_err {err:.3e} "
                f"(max |sim| {float(ref.abs().max()):.3e}), kernel "
                f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
                f"{bound_ms:.3f} ms ({bound_by})")
        if other is not None:             # B3 on the same inputs
            entry["b3_max_abs_err"] = check_sims(f"B3 {label}", other(), ref)
            entry["b3_ms"] = time_ms(other, 5)
            line += (f", B3 {entry['b3_ms']:.3f} ms (max_abs_err "
                     f"{entry['b3_max_abs_err']:.3e})")
        log(line)
        s = stats.setdefault(kname, {"max_abs_err": 0.0, "cases": []})
        s["max_abs_err"] = max(s["max_abs_err"], err)
        if "ms" not in s:   # the first case is the entry's headline
            s.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                     bound_by=bound_by)
        s["cases"].append(entry)
    return stats


def matmul_cases(rng, grid, S, G, N, hd, q, t):
    """matmul1 a / b and matmul2 b_sos inputs at S samples, G heads, N
    tokens, head dim hd (bf16, as the calibration caches on the card)."""
    qk = rng.standard_normal((S, G, N, hd)).astype(np.float32)
    kT = rng.standard_normal((S, G, hd, N)).astype(np.float32)
    att = qk @ kT / np.float32(hd ** 0.5)
    att = np.exp(att - att.max(-1, keepdims=True))
    att = (att / att.sum(-1, keepdims=True)).astype(np.float32)
    v = rng.standard_normal((S, G, N, hd)).astype(np.float32)
    g1 = (rng.standard_normal((S, G, N, N)) * 1e-4).astype(np.float32)
    g2 = (rng.standard_normal((S, G, N, hd)) * 1e-4).astype(np.float32)
    bf = torch.bfloat16

    def heads_absmax(a):
        return (np.abs(a).max((0, 2, 3)) / (q - 0.5)).astype(np.float32)

    split = np.float32(2.0 ** -6)
    a_int = np.float32(split / np.float32(q - 1))
    s_hi = np.float32(np.float32(1.0) / np.float32(q - 1))
    out = []
    for label, A, B, gr, mode, cand_src, fix in (
            ("matmul1 a", qk, kT, g1, "a", qk, heads_absmax(kT)),
            ("matmul1 b", qk, kT, g1, "b", kT, heads_absmax(qk)),
            ("matmul2 b_sos", att, v, g2, "b_sos", v,
             np.ones(G, np.float32))):
        cm = t(grid[:, None] * heads_absmax(cand_src)[None])
        sos = (float(split), float(a_int), float(s_hi), float(a_int)) \
            if mode == "b_sos" else None
        out.append((label, (t(A, bf), t(B, bf), t(gr, bf), cm, t(fix),
                            mode, q, q, sos)))
    return out


def check_qstate(net, qstate, what):
    if set(qstate) != {n for n, _ in net.op_inventory}:
        raise AssertionError(f"{what}: the qstate does not cover every op")
    for op, qp in qstate.items():
        for f, v in vars(qp).items():
            if torch.is_tensor(v) and not (torch.isfinite(v).all()
                                           and (v > 0).all()):
                raise AssertionError(f"{what}: {op}.{f} is not finite and "
                                     "positive")


def check_launches(path, launches):
    expect, absent = PATHS[path]
    for k, n in expect.items():
        if (launches[k] <= 0) if n is None else (launches[k] != n):
            raise AssertionError(f"{k} was launched {launches[k]} times by "
                                 f"the {path} path, expected "
                                 f"{'some' if n is None else n}")
    for k in absent:
        if launches[k]:
            raise AssertionError(f"{k} was launched by the {path} path")


def run_path(path, sk, net, calib, **qkw):
    """Quantize ``net`` with the launch counts set to 0 just before and
    read just after; returns (qstate, launches, summary)."""
    from ptq4vit_tpu_torch import quantize
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sk.reset_launch_counts()
    t0 = time.time()
    net, qstate, report = quantize(net, calib, batch_size=4,
                                   device=torch.device("cuda"),
                                   return_report=True, **qkw)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = sk.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    by_kind = {}
    for op, mtype in net.op_inventory:
        by_kind[mtype] = by_kind.get(mtype, 0.0) + report.search_seconds[op]
    summary = {"path": path, "images": len(calib), "wall_s": wall,
               "capture_s": report.capture_seconds,
               "search_s": sum(report.search_seconds.values()),
               "search_s_by_kind": by_kind,
               "groups": report.num_groups, "peak_gib": peak / 2 ** 30,
               "capture_peak_gib": report.capture_peak_bytes / 2 ** 30,
               "ops": len(qstate), "launches": launches}
    log(f"[calib] {path} x {len(calib)} images: {wall:.1f} s wall, capture "
        f"{summary['capture_s']:.1f} s, search {summary['search_s']:.1f} s, "
        f"groups {report.num_groups}, peak memory {peak / 2**30:.2f} GiB "
        f"({summary['capture_peak_gib']:.2f} GiB by the end of capture), "
        f"{len(qstate)} ops, launches {launches}")
    log(f"[calib] {path} search seconds by op type: "
        + ", ".join(f"{k} {v:.2f}" for k, v in by_kind.items()))
    check_launches(path, launches)
    check_qstate(net, qstate, path)
    return qstate, launches, summary


def serve(path, net, qstate, summary):
    """Serve 4 images with the fake-quant forward; hold the card's forwards
    to the CPU's for one image."""
    from ptq4vit_tpu_torch.utils.convert import params_from_numpy, qstate_to
    size, classes = net.cfg.img_size, net.cfg.num_classes
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4, 3, size, size)).astype(np.float32)).cuda()
    with torch.no_grad():
        fp = net.apply(x)
        qlog = net.apply(x, qstate=qstate)
    torch.cuda.synchronize()
    if qlog.shape != (4, classes) or not torch.isfinite(qlog).all():
        raise AssertionError("quantized logits are not finite (4, classes)")
    cos = torch.nn.functional.cosine_similarity(qlog, fp, dim=-1)
    summary["serve_cosine"] = [float(c) for c in cos]
    log(f"[serve] {path}, 4 images: cosine(quant, fp32) per image "
        f"{[round(float(c), 5) for c in cos]}")
    if (cos < 0.9).any():
        raise AssertionError("W8A8 logits drifted from the fp32 logits")
    # the card's forwards against the same forwards on the CPU, one image.
    # FP32 logits agree to rounding.  The fake-quant forward of a deep net
    # with random weights is ill-conditioned: a 1e-7 relative input change
    # flips quantization levels that compound to ~3% of the largest logit
    # (measured on the CPU for ViT-B/384), so it is held by cosine instead.
    cpu_params = params_from_numpy(net.params, "cpu")
    with torch.no_grad():
        fp_cpu = net.forward(cpu_params, x[:1].cpu(), net.cfg)
        q_cpu = net.forward(cpu_params, x[:1].cpu(), net.cfg,
                            qstate=qstate_to(qstate, "cpu"))
    fp_diff = float((fp[:1].cpu() - fp_cpu).abs().max())
    q_cos = float(torch.nn.functional.cosine_similarity(
        qlog[:1].cpu(), q_cpu, dim=-1)[0])
    summary.update(cpu_fp32_max_abs_diff=fp_diff, cpu_quant_cosine=q_cos)
    log(f"[serve] {path}, card vs CPU, 1 image: fp32 logits max abs diff "
        f"{fp_diff:.3e} (max |logit| {float(fp_cpu.abs().max()):.3e}); "
        f"fake-quant logits cosine {q_cos:.6f}")
    if fp_diff > 1e-4 * float(fp_cpu.abs().max()):
        raise AssertionError("the card's fp32 forward disagrees with the "
                             "CPU's")
    if q_cos < 0.99:
        raise AssertionError("the card's fake-quant forward disagrees with "
                             "the CPU's")


def calibrate_and_serve(path, name, sk, **qkw):
    """One full-width, full-depth path: quantize ``name`` (random weights
    from a seeded generator, 8 images), check the qstate and serve.
    Returns (qstate on the CPU, launches, summary)."""
    from ptq4vit_tpu_torch.configs import ptq4vit
    from ptq4vit_tpu_torch.models import get_net
    from ptq4vit_tpu_torch.utils.convert import qstate_to
    net = get_net(name, seed=0)
    size = net.cfg.img_size
    calib = np.random.default_rng(1).standard_normal(
        (NUM_CALIB, 3, size, size)).astype(np.float32)
    qkw.setdefault("config", ptq4vit())
    qstate, launches, summary = run_path(path, sk, net, calib, **qkw)
    serve(path, net, qstate, summary)
    qcpu = qstate_to(qstate, "cpu")
    del net, qstate
    torch.cuda.empty_cache()
    return qcpu, launches, summary


def flip_count(inventory, q_int8, q_exact):
    """Per op type [slots where the two qstates' intervals differ, all
    slots]."""
    out = {}
    for op, mtype in inventory:
        a, b = vars(q_int8[op]), vars(q_exact[op])
        for f, v in a.items():
            if torch.is_tensor(v):
                same = torch.isclose(v.reshape(-1), b[f].reshape(-1),
                                     rtol=1e-6, atol=0)
                n = out.setdefault(mtype, [0, 0])
                n[0] += int((~same).sum())
                n[1] += same.numel()
    return out


def policy_phase(sk):
    """BasePTQ W6A6 and PTQ4ViT W8A8 sequential at full ViT-B/384 width,
    depth 2, each with finite positive intervals and finite logits."""
    from ptq4vit_tpu_torch.configs import base_ptq, ptq4vit
    from ptq4vit_tpu_torch.models import model_config, net_from_config, vit
    cfg = dataclasses.replace(model_config("vit_base_patch16_384"), depth=2)
    net = net_from_config(cfg, vit.init_params(
        cfg, np.random.default_rng(0), device="cuda"))
    calib = np.random.default_rng(1).standard_normal(
        (NUM_CALIB, 3, cfg.img_size, cfg.img_size)).astype(np.float32)
    x = torch.from_numpy(calib[:4]).cuda()
    out = {}
    for path, qkw in (
            ("vit_base_patch16_384 depth 2 BasePTQ W6A6",
             dict(config=base_ptq(), bits=(6, 6))),
            ("vit_base_patch16_384 depth 2 PTQ4ViT sequential",
             dict(config=ptq4vit(), sequential=True))):
        qstate, launches, summary = run_path(path, sk, net, calib, **qkw)
        with torch.no_grad():
            logits = net.apply(x, qstate=qstate)
        if not torch.isfinite(logits).all():
            raise AssertionError(f"{path}: logits are not finite")
        cos = torch.nn.functional.cosine_similarity(
            logits, net.apply(x), dim=-1)
        summary["serve_cosine"] = [float(c) for c in cos]
        log(f"[serve] {path}, 4 images: cosine(quant, fp32) per image "
            f"{[round(float(c), 5) for c in cos]}")
        out[path] = (launches, summary)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from ptq4vit_tpu_torch.ops import build
    from ptq4vit_tpu_torch.ops import search_kernels as sk

    card = card_line()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.time()
    _, nvcc_s = build.build()
    build.load()
    log(f"[build] kernels built in {nvcc_s:.1f} s (nvcc), "
        f"{time.time() - t0:.1f} s with loading")

    stats = kernel_phase(sk, torch.device("cuda"))

    by_path, summaries, qstates = {}, [], {}
    for path, name, qkw in (
            ("vit_base_patch16_384", "vit_base_patch16_384", {}),
            ("swin_base_patch4_window12_384",
             "swin_base_patch4_window12_384", {}),
            ("vit_base_patch16_384 exact", "vit_base_patch16_384",
             {"int8_score": False})):
        qstates[path], by_path[path], summary = calibrate_and_serve(
            path, name, sk, **qkw)
        summaries.append(summary)
    from ptq4vit_tpu_torch.models import model_config, vit
    flips = flip_count(vit.op_inventory(model_config("vit_base_patch16_384")),
                       qstates["vit_base_patch16_384"],
                       qstates["vit_base_patch16_384 exact"])
    total = [sum(v[0] for v in flips.values()),
             sum(v[1] for v in flips.values())]
    log("[flips] int8 vs exact scoring, vit_base_patch16_384, 8 images: "
        + json.dumps({"by_op_type": flips, "total": total}))
    for path, (launches, summary) in policy_phase(sk).items():
        by_path[path] = launches
        summaries.append(summary)
    log("[paths] " + json.dumps({"card": card, "paths": summaries}))

    entries = [{"name": k, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[k],
                "launches": sum(c[k] for c in by_path.values()),
                "launches_by_path": {n: c[k] for n, c in by_path.items()},
                "max_abs_err": stats[k]["max_abs_err"],
                "ms": stats[k]["ms"], "plain_ms": stats[k]["plain_ms"],
                "bound_ms": stats[k]["bound_ms"],
                "bound_by": stats[k]["bound_by"],
                # no single PyTorch call computes these sims
                "library_ms": None, "cases": stats[k]["cases"]}
               for k in REPLACES]
    print(json.dumps({"kernels": entries}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
