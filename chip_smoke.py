"""Card check of the PyTorch / CUDA port (ptq4vit_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):
  1. the card's name and power limit; CUDA is required, TF32 is off;
  2. build the search and serving kernels from ptq4vit_tpu_torch/csrc/
     (one nvcc per source, started together);
  3. each kernel against its plain PyTorch version, with both times (a
     kernel's over at least TIMED_MS of launches), the least time the card
     could take for the same work (for B3 / B3f also the bound of the
     products alone, without the fp32 epilogue) and the share of the int8
     (fp32) peak its operations reach: B1 plain/twin, B2
     signed/post-GELU, B3 a/b/b_sos, B4w fc1 / post-GELU fc2 / qkv n_V=3
     and B4a signed / post-GELU at ViT-B/384 shapes (4 images), B1, B2,
     B4w and B4a also at fc1 with 32 images (the headline job's M =
     18,464) and B3 a / b_sos with 32 images, each B4 case beside
     torch.mm of the same fp32 fake-quant operands P times (cuBLAS SGEMM,
     TF32 off; context only); B3f a/b/b_sos at Swin-B/384 window shapes
     (4 images, stages 1 and 3); B6 in the block's four modes, the head,
     the fp32 engine's qkv and the per-op post-GELU fc2, B7 int8 -> int8 and
     float -> float (SoS and per-head) and B8 at ViT-B/384 shapes with 32
     images (float outputs of B6 bitwise; float attention outputs rtol
     1e-5, atol 2e-5 max|ref|, except in at most 0.05% of the elements,
     each off by at most one probability level's contribution; int8
     outputs one level off in at most 0.1%), beside torch._int_mm (on the
     (K, N) row-major weight and on its K-major layout, cuBLAS's int8
     preference) and SDPA as context; B10 and B11 at Swin-B/384 stages 1
     and 3 and B9 int8
     -> int8 on stage 1's shifted block (64 masks) and stage 4's one
     window, float -> float (SoS and per-head) on stage 1, with 32 images
     (B11 bitwise, B9 and B10 under the same rules), beside torch._int_mm
     (both layouts) and SDPA with the same additive mask; each attention
     case's [kernel] line also gives its CUDA-core floor (a model, not a
     measurement: the softmax's instructions a logit at the card's issue
     rate, ``cuda_core_floor``; it stays out of the JSON kernels line);
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
  7. the serving paths: phase 4's and phase 5's seeded nets and qstates
     (no second calibration), pack_weights, then ServingEngine (bf16,
     fused kernels) on 4 requests of 32 images each: ViT-B/384 launches B6
     exactly 4 x 49 times and B7 4 x 12, Swin-B/384 B6 4 x 52 and B9, B10
     and B11 4 x 24 each (SERVE_LAUNCHES), and no other kernel; finite
     logits; cosine >= 0.99 between the engine's logits and the fused
     fp32 forward's, between the fused fp32 and exact int8=True forwards
     and between int8=True and the fake-quant forward; img/s of the engine
     and of those three forwards; one request's device time by kernel
     under torch.profiler, with the device's busy time, the span of its
     kernels and the wall time;
     after ViT's, B8's path: each block's attention on its captured (B, H,
     N, hd) q, k, v through fused_attention (12 launches), by cosine to
     the exact int8 attention;
     then the per-op window path: Swin-B/384 at full width, depths (2, 2,
     2, 2), PTQ4ViT W8A8 with no_postgelu calibrated on 8 images (B1, B2,
     B3f), whose fused forward (8 images) launches B6 36 and B9 8 times on
     the float qkv and B10 / B11 never, with finite logits at cosine >=
     0.99 to int8=True;
  8. the policy path, at full ViT-B/384 width and depth 2 built with
     net_from_config: BasePTQ W6A6 (cosine metric: plain torch, no kernel)
     and PTQ4ViT W8A8 sequential (B1, B2 and B3 launched); finite positive
     intervals and finite logits;
  9. print the kernels' JSON line (all twelve kernels), the card line,
     then the result line.
Each path is driven with the launch counts set to 0 just before it and
read just after.
"""
from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

SIMS_RTOL = 1e-4       # reordered fp32 sums of up to ~7M terms
ARGMAX_TIE = 1e-4      # top-two sims closer than this may swap
LEVEL_SHARE = 1e-3     # int8 outputs: at most this share one level off
ATTN_RTOL = 1e-5       # float attention outputs: rtol, atol 2e-5 max|ref|,
FLIP_SHARE = 5e-4      # except in at most this share of the elements, off
                       # by at most one probability level's contribution
NUM_CALIB = 8
TIMED_MS = 100.0       # a kernel's timing spans at least this many ms of
MAX_REPS = 2000        # launches (at most this many)
SERVE_BATCH, SERVE_REQUESTS = 32, 4
SEARCH_SOURCE = "ptq4vit_tpu_torch/csrc/search_kernels.cu"
SERVE_SOURCE = "ptq4vit_tpu_torch/csrc/serve_kernels.cu"
# each kernel: (its source, the TPU kernel it replaces)
KERNELS = {
    "linear_w_hessian_sims_i8": (SEARCH_SOURCE,
                                 "ptq4vit_tpu/ops/pallas_search.py:285"),
    "linear_a_hessian_sims_i8": (SEARCH_SOURCE,
                                 "ptq4vit_tpu/ops/pallas_search.py:453"),
    "matmul_hessian_sims_b3": (SEARCH_SOURCE,
                               "ptq4vit_tpu/ops/pallas_search.py:548"),
    "matmul_hessian_sims_b3f": (SEARCH_SOURCE,
                                "ptq4vit_tpu/ops/pallas_search.py:634"),
    "linear_w_hessian_sims": (SEARCH_SOURCE,
                              "ptq4vit_tpu/ops/pallas_search.py:117"),
    "linear_a_hessian_sims": (SEARCH_SOURCE,
                              "ptq4vit_tpu/ops/pallas_search.py:975"),
    "q8_linear": (SERVE_SOURCE, "ptq4vit_tpu/ops/int8_serve.py:205"),
    "fused_attention_qkv": (SERVE_SOURCE,
                            "ptq4vit_tpu/ops/int8_serve.py:547"),
    "fused_attention": (SERVE_SOURCE, "ptq4vit_tpu/ops/int8_serve.py:486"),
    "fused_window_attention_qkv": (SERVE_SOURCE,
                                   "ptq4vit_tpu/ops/int8_serve.py:638"),
    "q8_win_qkv": (SERVE_SOURCE, "ptq4vit_tpu/ops/int8_serve.py:917"),
    "q8_win_proj": (SERVE_SOURCE, "ptq4vit_tpu/ops/int8_serve.py:974"),
}
SEARCH = tuple(k for k, (src, _) in KERNELS.items() if src == SEARCH_SOURCE)
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
    "vit_base_patch16_384 depth 2 BasePTQ W6A6": ({}, SEARCH),
    "vit_base_patch16_384 depth 2 PTQ4ViT sequential": (
        {"linear_w_hessian_sims_i8": None, "linear_a_hessian_sims_i8": None,
         "matmul_hessian_sims_b3": None}, ()),
    "swin_base_patch4_window12_384 depths (2, 2, 2, 2) no_postgelu": (
        {"linear_w_hessian_sims_i8": None, "linear_a_hessian_sims_i8": None,
         "matmul_hessian_sims_b3f": None}, ()),
}
# launches of the serving kernels a request makes (every other kernel: 0).
# ViT-B/384: B6 for qkv, proj, fc1 and fc2 of 12 blocks and the head, B7
# in each block.  Swin-B/384: each of its 24 blocks runs B10 (qkv), B9
# and B11 (proj), and B6 for fc1 and fc2; B6 also for the 3 patch-merging
# reductions and the head: 2 x 24 + 3 + 1 = 52
SERVE_LAUNCHES = {
    "vit_base_patch16_384": {"q8_linear": 49, "fused_attention_qkv": 12},
    "swin_base_patch4_window12_384": {
        "q8_linear": 52, "fused_window_attention_qkv": 24, "q8_win_qkv": 24,
        "q8_win_proj": 24},
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


def time_ms(fn, reps: int = 5, min_ms: float = TIMED_MS) -> float:
    """Mean ms of a call over at least ``reps`` calls and, for a short
    call, enough calls to fill ``min_ms`` (one warm-up call first, a
    second call sizes the count)."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    if min_ms > 0:
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        reps = max(reps, min(MAX_REPS, int(min_ms / max(
            e0.elapsed_time(e1), 1e-3)) + 1))
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


# fp32 operations of B3's / B3f's epilogue per (output, candidate): the
# rescale, the difference and the weighted square, summed (csrc
# mm_epilogue; "b_sos" rescales two sums)
MM_EPILOGUE_OPS = {"a": 5, "b": 5, "b_sos": 8}


def work(kname, args, out, epilogue=True):
    """(operations by type, bytes) a call needs: each input read once and
    the output written once; int8 multiply-adds of the levels (2 ops) for
    B1-B3f, fp32 ones for B4w / B4a and for B3's in-kernel raw = A @ B,
    and (``epilogue``) B3's / B3f's fp32 epilogue."""
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
        Co = args[1].shape[-1]
        mm = 2 * S * G * R * Ci * Co
        epi = P * S * G * R * Co * MM_EPILOGUE_OPS[args[5]] if epilogue \
            else 0
        return {"int8": P * mm * (2 if args[5] == "b_sos" else 1),
                "fp32": mm + epi}, nbytes
    (M, K), N, P = args[0].shape, args[1].shape[0], args[2].shape[0]
    return {"fp32": 2 * P * M * K * N}, nbytes                 # B4w, B4a


def bound(ops, nbytes):
    """The least time (ms) the card could take, and what bounds it."""
    t_ops = sum(n / PEAK_OPS[k] for k, n in ops.items())
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def peak_share(ops, ms):
    """{type: the share of the card's peak rate of that type} the call's
    operations reach in ``ms``."""
    return {k: n / (ms * 1e-3) / PEAK_OPS[k] for k, n in ops.items()}


def share_text(share):
    return ", ".join(f"{v:.1%} of the {k} peak" for k, v in share.items())


def kernel_phase(sk, dev):
    """Each kernel against its plain version at ViT-B/384 shapes (B3f at
    Swin-B/384's), beside its bound with and without B3's epilogue."""
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

    def case(kname, label, args, ref_name=None, sgemm=None):
        fn = getattr(sk, kname)
        ref = getattr(sk, ref_name or kname + "_ref")
        cases.append((kname, label, args, lambda: fn(*args),
                      lambda: ref(*args), sgemm))

    def sgemm(xq, wq):
        """The P fp32 products of a B4 call alone, as cuBLAS SGEMM runs
        them (TF32 off): context for B4w / B4a, never called by the port."""
        buf = torch.empty(xq.shape[0], wq.shape[0], device=dev)
        return lambda: [torch.mm(xq, wq.t(), out=buf) for _ in range(P)]

    cases = []   # (kernel, label, args, fn, ref_fn, sgemm)
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
        w_int = (np.abs(w).max() / (q - 0.5)).astype(np.float32)
        w_lv = np.clip(np.round(w / w_int), -q, q - 1)
        products = sgemm(t(x_sim), t(w_lv * w_int))
        case("linear_w_hessian_sims", label,
             (t(x_sim), t(w), cw if n_V > 1 else cw[:, 0].contiguous(),
              t(raw), t(g), q), sgemm=products)
        ca = t(grid * a)
        case("linear_a_hessian_sims_i8", label,
             (t(x), t(w_lv, torch.int8), t(np.full(oc, w_int, np.float32)),
              ca, t(raw), t(g), q, pg, GELU_NEG_CLIP / q if pg else 0.0))
        if n_V == 1:      # B4a: signed (fc1) and post-GELU (fc2)
            case("linear_a_hessian_sims", label,
                 (t(x), t(w_lv * w_int), ca, t(raw), t(g), q, pg,
                  GELU_NEG_CLIP / q if pg else 0.0), sgemm=products)

    # B1, B2, B4w and B4a at fc1 with 32 images, the headline job's shape
    # (a generator of their own keeps the other cases' inputs as they were)
    r32 = np.random.default_rng(7)
    M32 = 32 * N
    x = r32.standard_normal((M32, d)).astype(np.float32)
    w = (r32.standard_normal((hid, d)) * (2 / (d + hid)) ** 0.5) \
        .astype(np.float32)
    raw = (x @ w.T).astype(np.float32)
    g = (r32.standard_normal((M32, hid)) * 1e-4).astype(np.float32)
    a = np.float32(np.abs(x).max() / (q - 0.5))
    base = np.abs(w).max() / (q - 0.5)
    case("linear_w_hessian_sims_i8", "fc1 32 images",
         (t(np.clip(np.round(x / a), -q, q - 1), torch.int8), None,
          float(a), None, t(w), t(grid[:, None] * np.float32(base)),
          t(raw), t(g), q))
    w_int = (np.abs(w).max() / (q - 0.5)).astype(np.float32)
    w_lv = np.clip(np.round(w / w_int), -q, q - 1)
    case("linear_a_hessian_sims_i8", "fc1 32 images",
         (t(x), t(w_lv, torch.int8), t(np.full(hid, w_int, np.float32)),
          t(grid * a), t(raw), t(g), q, False, 0.0))
    x_sim = t(np.clip(np.round(x / a), -q, q - 1) * a)
    products = sgemm(x_sim, t(w_lv * w_int))
    case("linear_w_hessian_sims", "fc1 32 images",
         (x_sim, t(w), t(grid * np.float32(base)), t(raw), t(g), q),
         sgemm=products)
    case("linear_a_hessian_sims", "fc1 32 images",
         (t(x), t(w_lv * w_int), t(grid * a), t(raw), t(g), q, False, 0.0),
         sgemm=products)
    del x, w, raw, g, w_lv, x_sim

    for label, args in matmul_cases(rng, grid, S, G, N, hd, q, t):
        case("matmul_hessian_sims_b3", label, args, "matmul_hessian_sims_ref")
    # Swin-B/384 window matmuls (window 12: N = 144, head dim 32) at 4
    # images: stage 1 (64 windows, 4 heads), stage 3 (4 windows, 16 heads)
    for stage, nwin, G_s in ((1, 64, 4), (3, 4, 16)):
        for label, args in matmul_cases(rng, grid, S * nwin, G_s, 144, 32,
                                        q, t):
            if sk.mm_fold_factor(G_s, args[0].shape[-1],
                                 args[1].shape[-1]) <= 1:
                raise AssertionError("Swin window shapes must fold")
            case("matmul_hessian_sims_b3f", f"stage {stage} {label}", args,
                 "matmul_hessian_sims_ref")
    # B3 at ViT-B/384 with 32 images, the headline job's shape: matmul1 a
    # and matmul2 b_sos (a generator of their own keeps the other cases'
    # inputs as they were)
    for label, args in matmul_cases(np.random.default_rng(8), grid, 32, G,
                                    N, hd, q, t, ("a", "b_sos")):
        case("matmul_hessian_sims_b3", f"{label} 32 images", args,
             "matmul_hessian_sims_ref")

    stats = {}
    for kname, label, args, fn, ref_fn, products in cases:
        got = fn()
        ref = ref_fn()
        torch.cuda.synchronize()
        err = check_sims(f"{kname} {label}", got, ref)
        del ref
        ms = time_ms(fn, 5)
        plain_ms = time_ms(ref_fn, 1, 0)
        ops, in_bytes = work(kname, args, got)
        bound_ms, bound_by = bound(ops, in_bytes)
        share = peak_share(ops, ms)
        entry = {"case": label, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": bound_ms, "bound_by": bound_by,
                 "peak_share": share}
        line = (f"[kernel] {kname} {label}: max_abs_err {err:.3e} "
                f"(max |sim| {float(got.abs().max()):.3e}), kernel "
                f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
                f"{bound_ms:.3f} ms ({bound_by}), {share_text(share)}")
        if kname.startswith("matmul"):    # the products alone
            pops, _ = work(kname, args, got, epilogue=False)
            entry["products_bound_ms"], _ = bound(pops, in_bytes)
            line += (f", products-only bound "
                     f"{entry['products_bound_ms']:.3f} ms")
        if products is not None:          # B4w / B4a: cuBLAS SGEMM x P
            entry["sgemm_ms"] = time_ms(products, 1, 0)
            line += (f", torch.mm x {P} {entry['sgemm_ms']:.3f} ms (context "
                     "only)")
        log(line)
        s = stats.setdefault(kname, {"max_abs_err": 0.0, "cases": []})
        s["max_abs_err"] = max(s["max_abs_err"], err)
        if "ms" not in s:   # the first case is the entry's headline
            s.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                     bound_by=bound_by)
        s["cases"].append(entry)
    return stats


def matmul_cases(rng, grid, S, G, N, hd, q, t, modes=("a", "b", "b_sos")):
    """matmul1 a / b and matmul2 b_sos inputs (those of ``modes``) at S
    samples, G heads, N tokens, head dim hd (bf16, as the calibration
    caches on the card)."""
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
        if mode not in modes:
            continue
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


def nbytes(*ts):
    """Bytes of the tensors among ``ts`` (each read or written once)."""
    out = 0
    for t in ts:
        if isinstance(t, (tuple, list)):
            out += nbytes(*t)
        elif torch.is_tensor(t):
            out += t.numel() * t.element_size()
    return out


# B6's cases at ViT-B/384 with SERVE_BATCH images (M = 18,464 token
# rows): (label, M, K, N, input mode, LayerNorm, GELU, output, dtype); the
# first is its headline
_M, _D, _HID = SERVE_BATCH * 577, 768, 3072
B6_CASES = (
    ("qkv: LN, quantize -> int8 per column", _M, _D, 3 * _D, "f", True,
     False, "vec", torch.bfloat16),
    ("proj: int8 in -> + residual", _M, _D, _D, "q8", False, False,
     "residual", torch.bfloat16),
    ("fc1: LN, quantize -> GELU -> twin int8", _M, _D, _HID, "f", True, True,
     "twin", torch.bfloat16),
    ("fc2: twin int8 in -> + residual", _M, _HID, _D, "q8twin", False, False,
     "residual", torch.bfloat16),
    ("head: quantize -> float", SERVE_BATCH, _D, 1000, "f", False, False,
     "float", torch.bfloat16),
    ("qkv fp32 engine: LN, quantize -> int8 per column", _M, _D, 3 * _D,
     "f", True, False, "vec", torch.float32),
    ("fc2 per op: post-GELU twin quantize -> float", _M, _HID, _D, "f_twin",
     False, False, "float", torch.float32))
# B10 / B11's Swin-B/384 stages: (stage, resolution, channels)
WINDOW_STAGES = ((1, 96, 128), (3, 24, 512))


def q8_inputs(rng, M, K, N, mode, ln, gelu, out, dtype, q=128):
    """(args, kwargs) of q8_linear at one of the block's modes, with
    scales that keep the output about unit size."""
    dev = "cuda"

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)
    if mode in ("q8", "q8twin"):
        x = t(rng.integers(-q, q, (M, K)), torch.int8)
        a = 0.03
    else:
        xn = (rng.standard_normal((M, K)) * 2 + 0.3).astype(np.float32)
        if mode == "f_twin":
            xn = np.where(xn > 0, xn, xn * 0.05).astype(np.float32)
        x = t(xn, dtype)
        a = float(np.float32((3.0 if ln else np.abs(xn).max()) / (q - 0.5)))
    twin = mode in ("f_twin", "q8twin")
    kw = dict(a_qmax=q, postgelu=twin, epilogue="gelu" if gelu else None,
              in_q=mode if mode in ("q8", "q8twin") else None,
              out_q={"vec": "vec", "twin": "twin"}.get(out), out_qmax=q,
              float_dtype=dtype if mode in ("q8", "q8twin") else None)
    if ln:
        kw["ln"] = (t(1 + 0.1 * rng.standard_normal(K)),
                    t(0.1 * rng.standard_normal(K)), 1e-6)
    if out == "residual":
        kw["residual"] = t(rng.standard_normal((M, N)), dtype)
    if out == "vec":
        kw["out_scale"] = t((rng.random(N) + 1.5) / (q - 0.5))
    if out == "twin":
        kw["out_scale"] = (torch.tensor(3.0 / (q - 0.5), device=dev),
                           torch.tensor(0.16997124254703522 / q, device=dev))
    args = (x, t(rng.integers(-q, q, (K, N)), torch.int8),
            t((rng.random(N) + 0.5) / (a * q * q * np.sqrt(K) / 3)),
            t(rng.standard_normal(N) * 0.1), torch.tensor(a, device=dev),
            torch.tensor(0.16997124254703522 / q, device=dev) if twin
            else None)
    return args, kw


def kmajor_levels(levels):
    from ptq4vit_tpu_torch.ops.pack import kmajor_levels as kmajor
    return kmajor(levels)


def int_mm_calls(lv, w):
    """torch._int_mm of the (M, K) levels with the (K, N) weight levels,
    row-major and K-major (the (N, K) contiguous copy seen as (K, N),
    cuBLAS's int8 preference): context calls, never the port's."""
    wk = w.t().contiguous().t()
    return {"int_mm_ms": lambda: torch._int_mm(lv, w),
            "int_mm_kmajor_ms": lambda: torch._int_mm(lv, wk)}


def call_bytes(args, kw):
    """Bytes of a call's inputs, the weight levels once (``w_kmaj`` is the
    kernel's copy of ``args[1]``)."""
    return nbytes(args, [v for k, v in kw.items() if k != "w_kmaj"])


def attn_level_step(ph, sos, qmax=128):
    """(H,) the most that one probability level moves an attention output
    of each head: a v level (at most qmax) times b2, times 1 / (qmax - 1)
    (SoS: a level of the upper range; one of the lower range weighs split
    times less) or times a2 (per head)."""
    return qmax * ph[3] * (1.0 / (qmax - 1) if sos else ph[2])


def compare_outputs(name, got, ref, atol=0.0, rtol=0.0, step=None):
    """int8 outputs: at most one level off in at most LEVEL_SHARE of the
    elements.  Float outputs: |got - ref| <= atol + rtol |ref| (0: bitwise)
    everywhere; with ``step`` (broadcast to the output: what one attention
    probability level moves an element by), at most FLIP_SHARE of the
    elements may be off by up to ``step`` more, where a probability
    rounded to the neighbouring level.  Returns (max abs error, share of
    the elements off by a level or beyond the tolerance)."""
    if got.dtype != ref.dtype or got.shape != ref.shape:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} vs "
                             f"{ref.dtype} {tuple(ref.shape)}")
    if got.dtype == torch.int8:
        d = (got.int() - ref.int()).abs()
        share = float((d > 0).double().mean())
        if int(d.max()) > 1 or share > LEVEL_SHARE:
            raise AssertionError(f"{name}: levels off by up to {int(d.max())}"
                                 f" in {share:.3%} of the outputs")
        return float(d.max()), share
    g, r = got.double(), ref.double()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: non-finite output")
    err = (g - r).abs()
    tol = atol + rtol * r.abs()
    share = float((err > tol).double().mean())
    if step is None:
        bad = share > 0.0
    else:
        bad = share > FLIP_SHARE or bool((err > tol + step.double()).any())
    if bad:
        raise AssertionError(f"{name}: {share:.4%} of the outputs off, by "
                             f"up to {float(err.max()):.3e}")
    return float(err.max()), share


def serve_kernel_phase(sv, dev):
    """B6, B7 and B8 against their plain versions at ViT-B/384 shapes with
    32 images (M = 18,464 token rows), beside torch._int_mm on both weight
    layouts (B6) and
    scaled_dot_product_attention (B7, B8) on the same shapes, for context
    only: neither computes the quantized function, and the port never
    calls them."""
    rng = np.random.default_rng(5)
    cases = []
    for label, m, K, Nn, mode, ln, gelu, out, dt in B6_CASES:
        args, kw = q8_inputs(rng, m, K, Nn, mode, ln, gelu, out, dt)
        kw["w_kmaj"] = kmajor_levels(args[1].t())    # as pack_weights keeps it
        twin = mode in ("f_twin", "q8twin")
        # the int8 levels _int_mm would multiply: (M, K) x (K, N)
        lv = args[0] if args[0].dtype == torch.int8 else torch.clamp(
            torch.round(args[0].float() / args[4]), -128, 127) \
            .to(torch.int8)
        ops = {"int8": 2 * m * K * Nn * (2 if twin else 1)}
        cases.append((
            "q8_linear", label,
            lambda args=args, kw=kw: sv.q8_linear(*args, **kw),
            lambda args=args, kw=kw: sv.q8_linear_ref(*args, **kw),
            call_bytes(args, kw), ops, int_mm_calls(lv, args[1]), None,
            None))
    return measure_serving(cases + vit_attention_cases(sv, dev, rng))


# CUDA-core instructions a logit of the quantized softmax needs, whatever
# the kernel's design: the function's own steps, one SASS instruction each
# (expf and the IEEE division's fast path 8 each): convert, scale, max,
# subtract, expf, sum, divide (21); then SoS's hi level (2 clamps,
# multiply, rint, 2 clamps, convert: 7) and lo level (2 clamps, divide,
# rint, 2 clamps, convert: 14), or the per-head level (divide, rint, 2
# clamps, convert: 12); a byte packed per level; B9's bias and mask adds 2
SOFTMAX_INSTR = {True: 44, False: 34}
WINDOW_INSTR = 2
# one such instruction a lane a clock: the fp32 peak counts an FMA as two
LANE_RATE = PEAK_OPS["fp32"] / 2


def cuda_core_floor(logits, sos, window=False):
    """The least ms the CUDA cores take for the softmax and the levels of
    ``logits`` logits (SOFTMAX_INSTR at LANE_RATE); the products run
    beside them on the tensor cores."""
    return logits * (SOFTMAX_INSTR[sos] + (WINDOW_INSTR if window else 0)) \
        / LANE_RATE * 1e3


def attention_plain(sv, kname, args, kw):
    """The plain version of a B7 / B8 call."""
    if kname == "fused_attention":
        q_, k_, v_, p1, p2, sc = args
        ph, sos = sv.attn_scope(p1, p2, q_.shape[1])
        return sv.fused_attention_ref(
            q_, k_, v_, ph, p2.split if sos else None, sc, None, sos=sos,
            in_q8=False, qmaxes=sv.attn_qmaxes(p1, p2, 128),
            out_dtype=q_.dtype)
    x, heads, p1, p2, sc = args
    Bx, Nx, d3 = x.shape
    ph, sos = sv.attn_scope(p1, p2, heads)
    c = x.reshape(Bx, Nx, 3, heads, d3 // 3 // heads) \
        .permute(2, 0, 3, 1, 4)
    out = sv.fused_attention_ref(
        c[0], c[1], c[2], ph, p2.split if sos else None, sc,
        kw.get("out_scale"), sos=sos, in_q8=kw.get("in_q8", False),
        qmaxes=sv.attn_qmaxes(p1, p2, 128),
        out_dtype=x.dtype if x.is_floating_point() else torch.float32)
    return out.transpose(1, 2).reshape(Bx, Nx, d3 // 3)


def vit_attention_cases(sv, dev, rng):
    """B7 (int8 -> int8 and float -> float, SoS and per-head) and B8
    (float, SoS) at ViT-B/384 shapes with SERVE_BATCH images, as
    measure_serving takes them, with SDPA on the same q, k, v as
    context."""
    from ptq4vit_tpu_torch.quant.qparams import MatMulQP
    B, N, d, H, hd = SERVE_BATCH, 577, 768, 12, 64
    qkv = torch.from_numpy(rng.standard_normal((B, N, 3 * d))
                           .astype(np.float32)).to(dev)
    t = qkv.reshape(B, N, 3, H, hd).permute(2, 0, 3, 1, 4)
    shape = (1, H, 1, 1, 1, 1, 1)

    def hmax(v):
        return (v.abs().amax((0, 2, 3)) / 127.5).reshape(shape)
    qp1 = MatMulQP(A_interval=hmax(t[0]), B_interval=hmax(t[1]))
    split = torch.tensor(2.0 ** -6, device=dev)
    a_out = torch.tensor(0.02, device=dev)
    q4, k4, v4 = (c.contiguous() for c in t)
    cases = []
    for sos in (True, False):
        qp2 = MatMulQP(A_interval=(split / 127 if sos else
                                   torch.full(shape, 1 / 127.5, device=dev)),
                       B_interval=hmax(t[2]), split=split if sos else None)
        ph, _ = sv.attn_scope(qp1, qp2, H)
        cols = torch.cat([ph[i].repeat_interleave(hd) for i in (0, 1, 3)])
        lv = torch.clamp(torch.round(qkv / cols), -128, 127).to(torch.int8)
        ops = {"int8": 2 * B * H * N * N * hd * (3 if sos else 2),
               # max, subtract, exp, sum, divide per logit
               "fp32": 5 * B * H * N * N}
        floor = cuda_core_floor(B * H * N * N, sos)
        tag = "SoS" if sos else "per-head"
        sdpa = {"sdpa_ms": lambda: torch.nn.functional
                .scaled_dot_product_attention(q4, k4, v4)}
        step = attn_level_step(ph, sos)
        calls = [("fused_attention_qkv", f"int8 in -> int8 out, {tag}",
                  (lv, H, qp1, qp2, hd ** -0.5),
                  dict(in_q8=True, out_scale=a_out), None),
                 ("fused_attention_qkv", f"float in -> float out, {tag}",
                  (qkv, H, qp1, qp2, hd ** -0.5), {},
                  step.repeat_interleave(hd))]
        if sos:
            calls.append(("fused_attention", "(B, H, N, hd) float, SoS",
                          (q4, k4, v4, qp1, qp2, hd ** -0.5), {},
                          step.reshape(1, H, 1, 1)))
        for kname, label, args, kw, st in calls:
            cases.append((
                kname, label,
                lambda kname=kname, args=args, kw=kw: getattr(sv, kname)(
                    *args, **kw),
                lambda kname=kname, args=args, kw=kw: attention_plain(
                    sv, kname, args, kw),
                call_bytes(args, kw), ops, sdpa, st, floor))
    return cases


def measure_serving(cases):
    """Each serving kernel case (kernel, label, call, plain call, bytes of
    the inputs, operations, context calls by key, step, CUDA-core floor
    ms or None) against its plain version (``compare_outputs``; attention
    float outputs under the FLIP_SHARE rule, other float outputs bitwise),
    then timed beside the plain version, the bound, the attentions'
    CUDA-core floor (``cuda_core_floor``) and the context calls
    (torch._int_mm on both weight layouts for the linears, SDPA for the
    attentions).  Returns the stats by kernel; a kernel's first case is
    its headline."""
    stats = {}
    for kname, label, fn, plain, in_bytes, ops, lib_fn, step, floor \
            in cases:
        got = fn()
        ref = plain()
        torch.cuda.synchronize()
        attention = "attention" in kname
        # attention sums its softmax in another order
        tol = (2e-5 * float(ref.float().abs().max()), ATTN_RTOL) \
            if attention else (0.0, 0.0)
        err, share = compare_outputs(f"{kname} {label}", got, ref, *tol,
                                     step=step)
        ms = time_ms(fn, 5)
        plain_ms = time_ms(plain, 1, 0)
        lib = {k: time_ms(f, 5) for k, f in lib_fn.items()}
        bound_ms, bound_by = bound(ops, in_bytes + nbytes(got))
        peak = peak_share(ops, ms)
        entry = {"case": label, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": bound_ms, "bound_by": bound_by,
                 "peak_share": peak,
                 "out": str(got.dtype).replace("torch.", ""),
                 "max_abs_err": err, "level_flip_share": share, **lib}
        log(f"[kernel] {kname} {label}: {entry['out']} out, max_abs_err "
            f"{err:.3e}" + (" levels" if got.dtype == torch.int8 else "")
            + f" ({share:.4%} of the outputs off by a level or beyond "
            "tolerance)"
            + f", kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by})"
            + (f", CUDA-core floor {floor:.4f} ms" if floor is not None
               else "") + f", {share_text(peak)}, "
            + ", ".join(f"{k} {v:.3f}" for k, v in lib.items())
            + " (context only)")
        st = stats.setdefault(kname, {"max_abs_err": 0.0, "cases": []})
        st["max_abs_err"] = max(st["max_abs_err"], err
                                if got.dtype != torch.int8 else 0.0)
        st["max_share_off"] = max(st.get("max_share_off", 0.0), share)
        if "ms" not in st:
            st.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                      bound_by=bound_by)
        st["cases"].append(entry)
        del got, ref
    torch.cuda.empty_cache()
    return stats


def window_linear_inputs(rng, res, C, B=SERVE_BATCH, ws=12, q=128):
    """The positional arguments of B10 (q8_win_qkv: LayerNorm, quantize,
    int8 per column) and of B11 (q8_win_proj: int8 in, residual) at one
    Swin stage (``res`` x ``res`` tokens of C channels an image, windows of
    ``ws``), bf16 activations, with scales that keep the outputs about
    unit size."""
    dev = "cuda"

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)
    bf = torch.bfloat16
    x4 = t(rng.standard_normal((B, res, res, C)) * 2 + 0.3, bf)
    a = torch.tensor(3.0 / (q - 0.5), device=dev)
    w = t(rng.integers(-q, q, (C, 3 * C)), torch.int8)
    wsc = t((rng.random(3 * C) + 0.5) / (float(a) * q * q * np.sqrt(C) / 3))
    qkv = (x4, w, wsc, t(rng.standard_normal(3 * C) * 0.1), a,
           (t(1 + 0.1 * rng.standard_normal(C)),
            t(0.1 * rng.standard_normal(C)), 1e-5), ws,
           t((rng.random(3 * C) + 1.5) / (q - 0.5)))
    N = ws * ws
    y_q = t(rng.integers(-q, q, (B * res * res // N, N, C)), torch.int8)
    wp = t(rng.integers(-q, q, (C, C)), torch.int8)
    proj = (y_q, wp, t((rng.random(C) + 0.5) / (0.03 * q * q * np.sqrt(C)
                                                / 3)),
            t(rng.standard_normal(C) * 0.1), torch.tensor(0.03, device=dev),
            ws, res, t(rng.standard_normal((B, res, res, C)), bf))
    return qkv, proj


def window_attention_cases(sv, dev, rng):
    """B9 int8 -> int8 on Swin-B/384 stage 1's shifted block (64 masks) and
    stage 4's one unshifted window (32 heads), and float -> float (SoS and
    per-head) on stage 1's shifted block, with SERVE_BATCH images (window
    12: N = 144 tokens, head dim 32), as measure_serving takes them, with
    SDPA on the float q, k, v and the same additive bias and mask as
    context."""
    from ptq4vit_tpu_torch.models.swin import shifted_window_mask
    from ptq4vit_tpu_torch.quant.qparams import MatMulQP
    B, ws, hd, q = SERVE_BATCH, 12, 32, 128
    N = ws * ws

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)

    def levels(x, a):
        return torch.clamp(torch.round(x.float() / a), -q, q - 1) \
            .to(torch.int8)

    cases = []
    for stage, res, H, shift, modes in (
            (1, 96, 4, ws // 2, ("int8 SoS", "float SoS", "float per-head")),
            (4, 12, 32, 0, ("int8 SoS",))):
        C = H * hd
        nW = (res // ws) ** 2
        B_ = B * nW
        qkv = t(rng.standard_normal((B_, N, 3 * C)))
        bias = t(rng.standard_normal((H, N, N)) * 0.5)
        mask = shifted_window_mask(res, ws, shift)
        mask = t(mask) if mask is not None else None
        tq = qkv.reshape(B_, N, 3, H, hd).permute(2, 0, 3, 1, 4)
        q4, k4, v4 = (c.contiguous() for c in tq)
        extra = bias[None] + (mask[:, None] if mask is not None else 0)
        sdpa_mask = extra.repeat(B, 1, 1, 1)
        shape = (1, H, 1, 1, 1, 1, 1)

        def hmax(v):
            return (v.abs().amax((0, 2, 3)) / 127.5).reshape(shape)
        s = hd ** -0.5
        qp1 = MatMulQP(A_interval=hmax(tq[0] * s), B_interval=hmax(tq[1]))
        split = torch.tensor(2.0 ** -6, device=dev)
        for mode in modes:
            sos = mode.endswith("SoS")
            qp2 = MatMulQP(A_interval=(split / 127 if sos else
                                       torch.full(shape, 1 / 127.5,
                                                  device=dev)),
                           B_interval=hmax(tq[2]),
                           split=split if sos else None)
            ph, _ = sv.window_attn_scope(qp1, qp2, H, s)
            if mode.startswith("int8"):
                cols = torch.cat([ph[i].repeat_interleave(hd)
                                  for i in (0, 1, 3)])
                x, kw = levels(qkv / cols, 1.0), dict(
                    in_q8=True, out_scale=torch.tensor(0.02, device=dev))
                label, step = f"{mode}, int8 -> int8", None
            else:
                x, kw, label = qkv, {}, f"{mode}, float -> float"
                step = attn_level_step(ph, sos).repeat_interleave(hd)
            where = "shifted, 64 masks" if shift else "one window"
            label = f"stage {stage}, {where}: {label}"
            args = (x, H, nW, qp1, qp2, s, bias, mask)
            ref_args = (x, H, nW, ph, split if sos else None, s, bias, mask,
                        kw.get("out_scale"))
            ref_kw = dict(sos=sos, in_q8=mode.startswith("int8"),
                          qmaxes=(q,) * 5, out_dtype=torch.float32)
            cases.append((
                "fused_window_attention_qkv", label,
                lambda args=args, kw=kw: sv.fused_window_attention_qkv(
                    *args, **kw),
                lambda a=ref_args, kw=ref_kw: sv.fused_window_attention_ref(
                    *a, **kw), nbytes(args),
                {"int8": 2 * B_ * H * N * N * hd * (3 if sos else 2),
                 # the bias and mask adds, max, subtract, exp, sum, divide
                 "fp32": 7 * B_ * H * N * N},
                {"sdpa_ms": lambda qkv4=(q4, k4, v4), m=sdpa_mask: torch.nn
                 .functional.scaled_dot_product_attention(
                     *qkv4, attn_mask=m)}, step,
                cuda_core_floor(B_ * H * N * N, sos, window=True)))

    return cases


def window_kernel_phase(sv, dev):
    """B10, B9 and B11 against their plain versions at Swin-B/384 shapes
    with 32 images (window 12: N = 144 tokens, head dim 32), beside
    torch._int_mm on the same levels, both weight layouts (B10, B11), and
    SDPA with the same additive bias and mask on the float q, k, v (B9),
    for context only.
    B10 and B11 at stage 1 (res 96, C 128, 64 windows an image) and stage
    3 (res 24, C 512); B9 int8 -> int8 on stage 1's shifted block (64
    masks) and stage 4's one unshifted window (32 heads), and float ->
    float (SoS and per-head) on stage 1's shifted block."""
    rng = np.random.default_rng(6)
    B, q = SERVE_BATCH, 128

    def levels(x, a):
        return torch.clamp(torch.round(x.float() / a), -q, q - 1) \
            .to(torch.int8)

    cases = []        # as measure_serving takes them
    for stage, res, C in WINDOW_STAGES:
        M = B * res * res
        args, proj_args = window_linear_inputs(rng, res, C)
        x4, w, a = args[0], args[1], args[4]
        lv = levels(x4.reshape(M, C), a)
        kw = dict(a_qmax=q, out_qmax=q, w_kmaj=kmajor_levels(w.t()))
        cases.append(("q8_win_qkv", f"stage {stage}: LN, quantize -> int8 "
                      "per column", lambda args=args, kw=kw: sv.q8_win_qkv(
                          *args, **kw),
                      lambda args=args, kw=kw: sv.q8_win_qkv_ref(
                          *args, **kw), nbytes(args),
                      {"int8": 2 * M * C * 3 * C}, int_mm_calls(lv, w),
                      None, None))
        args = proj_args
        y_q, wp = args[0], args[1]
        kw = dict(a_qmax=q, w_kmaj=kmajor_levels(wp.t()))
        cases.append(("q8_win_proj", f"stage {stage}: int8 in -> + residual "
                      "(image layout)",
                      lambda args=args, kw=kw: sv.q8_win_proj(*args, **kw),
                      lambda args=args, kw=kw: sv.q8_win_proj_ref(*args,
                                                                  **kw),
                      nbytes(args), {"int8": 2 * M * C * C},
                      int_mm_calls(y_q.reshape(M, C), wp), None, None))

    return measure_serving(cases + window_attention_cases(sv, dev, rng))


def profile_call(fn):
    """One call of ``fn`` under torch.profiler: device time by kernel (ms,
    launches), the busy time of the device, the span from the first
    kernel's start to the last one's end, and the host's wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    by_kernel, t_lo, t_hi = {}, float("inf"), 0.0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = re.sub(r"^void |\(anonymous namespace\)::", "", e.name)
        name = name.split("(")[0].strip()[:60]
        ms, n = by_kernel.get(name, (0.0, 0))
        by_kernel[name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
        t_lo = min(t_lo, e.time_range.start)
        t_hi = max(t_hi, e.time_range.end)
    busy = sum(ms for ms, _ in by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])
    return {"busy_ms": busy, "span_ms": (t_hi - t_lo) / 1e3,
            "wall_ms": wall * 1e3,
            "by_kernel": [[k, ms, n] for k, (ms, n) in top]}


def serving_phase(sk, sv, name, qcpu):
    """The serving path of ``name``: the calibration phase's seeded net and
    its qstate (no second calibration), pack_weights, then ServingEngine
    (bf16) on SERVE_REQUESTS requests of SERVE_BATCH images with the
    launch counts set to 0 just before and read just after, each kernel
    launched exactly as SERVE_LAUNCHES says; then the fused fp32, exact
    int8 and fake-quant forwards on the first request, held to each other
    and the engine's logits to the fused fp32 ones by cosine (>= 0.99),
    and the img/s of each.  Returns (launches, summary, (net, qstate, the
    first request on the card))."""
    from ptq4vit_tpu_torch import ServingEngine
    from ptq4vit_tpu_torch.models import get_net
    from ptq4vit_tpu_torch.ops.pack import pack_weights
    from ptq4vit_tpu_torch.utils.convert import qstate_to
    path = f"{name} serving"
    net = get_net(name, seed=0)
    qstate = qstate_to(qcpu, "cuda")
    size, classes = net.cfg.img_size, net.cfg.num_classes
    reqs = [np.random.default_rng(10 + i).standard_normal(
        (SERVE_BATCH, 3, size, size)).astype(np.float32)
        for i in range(SERVE_REQUESTS)]
    torch.cuda.synchronize()
    t0 = time.time()
    packed = pack_weights(net.params, qstate)
    torch.cuda.synchronize()
    pack_s = time.time() - t0
    engine = ServingEngine(net, qstate)                 # bf16, the card
    engine(reqs[0])                                     # warm-up
    torch.cuda.synchronize()
    sk.reset_launch_counts()
    sv.reset_launch_counts()
    t0 = time.time()
    outs = [engine(x) for x in reqs]
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {**sk.launch_counts(), **sv.launch_counts()}
    expect = {k: SERVE_REQUESTS * n for k, n in SERVE_LAUNCHES[name].items()}
    for k, v in launches.items():
        if v != expect.get(k, 0):
            raise AssertionError(f"{k} was launched {v} times by the {path} "
                                 f"path, expected {expect.get(k, 0)}")
    for o in outs:
        if o.shape != (SERVE_BATCH, classes) or not torch.isfinite(
                o.float()).all():
            raise AssertionError("served logits are not finite "
                                 f"({SERVE_BATCH}, {classes})")
    n_img = SERVE_BATCH * SERVE_REQUESTS
    x0 = torch.from_numpy(reqs[0]).cuda()
    ips = {"fused bf16 engine": n_img / wall}
    logits = {}
    with torch.no_grad():
        for name, fwd in (
                ("fused fp32", lambda: net.apply(x0, qstate=qstate,
                                                 int8="fused",
                                                 packed=packed)),
                ("exact int8", lambda: net.apply(x0, qstate=qstate,
                                                 int8=True, packed=packed)),
                ("fake-quant", lambda: net.apply(x0, qstate=qstate))):
            logits[name] = fwd()                        # warm-up
            torch.cuda.synchronize()
            t0 = time.time()
            logits[name] = fwd()
            torch.cuda.synchronize()
            ips[name] = SERVE_BATCH / (time.time() - t0)
    cos = {}
    for a, b in (("fused fp32", "exact int8"), ("exact int8", "fake-quant"),
                 ("fused fp32", "fused bf16 engine")):
        la = logits[a] if a in logits else outs[0]
        lb = logits[b] if b in logits else outs[0]
        c = torch.nn.functional.cosine_similarity(la.float(), lb.float(),
                                                  dim=-1)
        cos[f"{a} vs {b}"] = float(c.min())
    summary = {"path": path, "requests": SERVE_REQUESTS,
               "batch": SERVE_BATCH, "wall_s": wall, "pack_s": pack_s,
               "img_per_s": ips, "min_cosine": cos, "launches": launches,
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    log(f"[serve] {path}: {SERVE_REQUESTS} requests x {SERVE_BATCH} images "
        f"in {wall:.3f} s, pack_weights {pack_s:.3f} s, launches {launches}")
    log(f"[serve] img/s at {SERVE_BATCH} images: " + ", ".join(
        f"{k} {v:.1f}" for k, v in ips.items()))
    log("[serve] min cosine over the request's images: " + ", ".join(
        f"{k} {v:.6f}" for k, v in cos.items()))
    for k, c in cos.items():
        if c < 0.99:
            raise AssertionError(f"{k}: cosine {c:.4f} < 0.99")
    # where one request's time goes on the device
    prof = profile_call(lambda: engine(reqs[0]))
    summary["profile"] = prof
    log(f"[profile] {path}, one request of {SERVE_BATCH} images under "
        f"torch.profiler: device busy {prof['busy_ms']:.2f} ms of a "
        f"{prof['span_ms']:.2f} ms span and {prof['wall_ms']:.2f} ms wall; "
        "by kernel (ms, launches): " + ", ".join(
            f"{k} {ms:.2f} x{n}" for k, ms, n in prof["by_kernel"][:10]))
    del engine, packed, outs, logits
    torch.cuda.empty_cache()
    return launches, summary, (net, qstate, x0)


def layout_path(sk, sv, net, qstate, x):
    """B8's path: every block's attention of the calibrated ViT-B/384 on
    its (B, H, N, hd) q, k, v (from a capture of 4 images) through
    ``fused_attention``, with the launch counts set to 0 just before and
    read just after; each context held by cosine to the exact int8 path
    (matmul_int8 -> softmax -> matmul_int8)."""
    from ptq4vit_tpu_torch.models.common import softmax_f32
    from ptq4vit_tpu_torch.ops.int8 import matmul_int8
    path = "vit_base_patch16_384 attention, (B, H, N, hd) layout"
    scale = net.cfg.head_dim ** -0.5
    with torch.no_grad():
        _, taps = net.apply(x, capture=True)
    qkv = []
    for i in range(net.cfg.depth):
        m1 = taps[f"blocks.{i}.attn.matmul1"]
        m2 = taps[f"blocks.{i}.attn.matmul2"]
        qkv.append((m1["a"].contiguous(),
                    m1["b"].transpose(-2, -1).contiguous(),
                    m2["b"].contiguous(), qstate[f"blocks.{i}.attn.matmul1"],
                    qstate[f"blocks.{i}.attn.matmul2"]))
    del taps
    torch.cuda.synchronize()
    sk.reset_launch_counts()
    sv.reset_launch_counts()
    t0 = time.time()
    outs = [sv.fused_attention(q, k, v, qp1, qp2, scale)
            for q, k, v, qp1, qp2 in qkv]
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {**sk.launch_counts(), **sv.launch_counts()}
    depth = net.cfg.depth
    for k_, v_ in launches.items():
        if v_ != (depth if k_ == "fused_attention" else 0):
            raise AssertionError(f"{k_} was launched {v_} times by the "
                                 f"{path} path")
    cos = 1.0
    with torch.no_grad():
        for (q, k, v, qp1, qp2), o in zip(qkv, outs):
            p = softmax_f32(matmul_int8(q, k.transpose(-2, -1), qp1) * scale)
            ref = matmul_int8(p, v, qp2)
            cos = min(cos, float(torch.nn.functional.cosine_similarity(
                o.reshape(-1).double(), ref.reshape(-1).double(), dim=0)))
    log(f"[serve] {path}: {depth} blocks x {len(x)} images in {wall:.4f} s, "
        f"min cosine to the exact int8 attention {cos:.6f}, launches "
        f"{launches}")
    if cos < 0.99:
        raise AssertionError(f"{path}: cosine {cos:.4f} < 0.99")
    return launches, {"path": path, "images": len(x), "wall_s": wall,
                      "min_cosine": cos, "launches": launches}


def window_per_op_path(sk, sv):
    """The per-op window path: Swin-B/384 at full width, depths cut to (2,
    2, 2, 2), calibrated with PTQ4ViT W8A8 and no_postgelu (8 images), so
    fc2 is a plain linear and no block is in scope of the fused block
    path.  Its fused forward on 8 images, with the launch counts set to 0
    just before and read just after, runs each block's four linears, the
    3 reductions and the head through B6 (4 x 8 + 4 = 36) and each
    block's attention through B9 on the float qkv (8), with no B10 or
    B11; finite logits, cosine >= 0.99 to the exact int8=True forward."""
    from ptq4vit_tpu_torch.configs import ptq4vit
    from ptq4vit_tpu_torch.models import model_config, net_from_config, swin
    from ptq4vit_tpu_torch.ops.pack import pack_weights
    cfg = dataclasses.replace(model_config("swin_base_patch4_window12_384"),
                              depths=(2, 2, 2, 2))
    net = net_from_config(cfg, swin.init_params(
        cfg, np.random.default_rng(0), device="cuda"))
    calib = np.random.default_rng(1).standard_normal(
        (NUM_CALIB, 3, cfg.img_size, cfg.img_size)).astype(np.float32)
    path = "swin_base_patch4_window12_384 depths (2, 2, 2, 2) no_postgelu"
    qstate, calib_launches, summary = run_path(
        path, sk, net, calib, config=ptq4vit(no_postgelu=True))
    x = torch.from_numpy(calib).cuda()
    packed = pack_weights(net.params, qstate)
    with torch.no_grad():
        torch.cuda.synchronize()
        sk.reset_launch_counts()
        sv.reset_launch_counts()
        t0 = time.time()
        fused = net.apply(x, qstate=qstate, int8="fused", packed=packed)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = {**sk.launch_counts(), **sv.launch_counts()}
        exact = net.apply(x, qstate=qstate, int8=True, packed=packed)
    blocks = sum(cfg.depths)
    expect = {"q8_linear": 4 * blocks + cfg.num_layers,
              "fused_window_attention_qkv": blocks}
    for k, v in launches.items():
        if v != expect.get(k, 0):
            raise AssertionError(f"{k} was launched {v} times by the {path} "
                                 f"forward, expected {expect.get(k, 0)}")
    if not torch.isfinite(fused).all():
        raise AssertionError(f"{path}: logits are not finite")
    cos = float(torch.nn.functional.cosine_similarity(
        fused.double(), exact.double(), dim=-1).min())
    summary.update(forward_s=wall, forward_launches=launches,
                   min_cosine_to_exact=cos)
    log(f"[serve] {path}: fused per-op forward of {len(x)} images in "
        f"{wall:.3f} s, launches {launches}, min cosine to int8=True "
        f"{cos:.6f}")
    if cos < 0.99:
        raise AssertionError(f"{path}: cosine {cos:.4f} < 0.99")
    del net, qstate, packed
    torch.cuda.empty_cache()
    # the calibration's launches and the forward's, apart
    return {path: calib_launches, f"{path} serving": launches}, summary


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from ptq4vit_tpu_torch.ops import build
    from ptq4vit_tpu_torch.ops import int8_serve as sv
    from ptq4vit_tpu_torch.ops import search_kernels as sk

    card = card_line()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.time()
    _, nvcc_s = build.build_all()          # one nvcc per source, together
    for name in build.LIBRARIES:
        build.load(name)
    log(f"[build] {len(build.LIBRARIES)} kernel libraries built in "
        f"{nvcc_s:.1f} s (nvcc, in parallel), {time.time() - t0:.1f} s "
        "with loading")

    stats = kernel_phase(sk, torch.device("cuda"))
    serve_stats = serve_kernel_phase(sv, torch.device("cuda"))
    serve_stats.update(window_kernel_phase(sv, torch.device("cuda")))

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
    for name in SERVE_LAUNCHES:
        launches, summary, (net, qstate, x0) = serving_phase(
            sk, sv, name, qstates[name])
        by_path[summary["path"]] = launches
        summaries.append(summary)
        if name == "vit_base_patch16_384":
            launches, summary = layout_path(sk, sv, net, qstate, x0[:4])
            by_path[summary["path"]] = launches
            summaries.append(summary)
        del net, qstate, x0
        torch.cuda.empty_cache()
    launches, summary = window_per_op_path(sk, sv)
    by_path.update(launches)
    summaries.append(summary)
    for path, (launches, summary) in policy_phase(sk).items():
        by_path[path] = launches
        summaries.append(summary)
    log("[paths] " + json.dumps({"card": card, "paths": summaries}))

    stats.update(serve_stats)
    entries = [{"name": k, "route": "cuda", "source": src, "replaces": rep,
                "launches": sum(c.get(k, 0) for c in by_path.values()),
                "launches_by_path": {n: c.get(k, 0)
                                     for n, c in by_path.items()},
                "max_abs_err": stats[k]["max_abs_err"],
                "ms": stats[k]["ms"], "plain_ms": stats[k]["plain_ms"],
                "bound_ms": stats[k]["bound_ms"],
                "bound_by": stats[k]["bound_by"],
                # no PyTorch call computes the sims or the quantized
                # function: the B4 cases carry torch.mm, the serving cases
                # torch._int_mm / SDPA times as context
                "library_ms": None, "cases": stats[k]["cases"]}
               for k, (src, rep) in KERNELS.items()]
    print(json.dumps({"kernels": entries}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
