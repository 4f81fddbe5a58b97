"""Card check of the PyTorch / CUDA port (ptq4vit_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):
  1. the card's name and power limit; CUDA is required, TF32 is off;
  2. build the search kernels from ptq4vit_tpu_torch/csrc/;
  3. each kernel against its plain PyTorch version, with both times: B1
     plain/twin, B2 signed/post-GELU, B3 a/b/b_sos at ViT-B/384 shapes (4
     images); B3f a/b/b_sos at Swin-B/384 window shapes (4 images, stages 1
     and 3), with B3 timed on the same inputs;
  4. the ViT path: quantize("vit_base_patch16_384", 8 images, PTQ4ViT W8A8)
     with random weights from a seeded generator; B1, B2 and B3 must be
     launched and every interval finite and positive; serve 4 images with
     the fake-quant forward and check the card's forwards against the same
     forwards on the CPU for one image;
  5. the Swin path: the same for "swin_base_patch4_window12_384" at full
     width and depth (149 ops), with B1, B2 and B3f launched;
  6. print the kernels' JSON line, then the result line.
"""
from __future__ import annotations

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
}
# the kernels each main path must launch
PATHS = {
    "vit_base_patch16_384": ("linear_w_hessian_sims_i8",
                             "linear_a_hessian_sims_i8",
                             "matmul_hessian_sims_b3"),
    "swin_base_patch4_window12_384": ("linear_w_hessian_sims_i8",
                                      "linear_a_hessian_sims_i8",
                                      "matmul_hessian_sims_b3f"),
}


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

    cases = []   # (kernel, label, fn, ref_fn)
    for label, ic, oc, n_V, pg in (("fc1", d, hid, 1, False),
                                   ("fc2 twin", hid, d, 1, True),
                                   ("qkv n_V=3", d, 3 * d, 3, False)):
        x, w, raw, g = linear_case(ic, oc, n_V, pg)
        a = np.float32((x.max() if pg else np.abs(x).max()) / (q - 0.5))
        a_neg = np.float32(GELU_NEG_CLIP / q)
        lo = 0 if pg else -q
        x_lv = t(np.clip(np.round(x / a), lo, q - 1), torch.int8)
        x_neg = (t(np.clip(np.round(x / a_neg), -q, 0), torch.int8)
                 if pg else None)
        base = np.abs(w.reshape(n_V, -1)).max(1) / (q - 0.5)
        cw = t(grid[:, None] * base[None].astype(np.float32))
        args = (x_lv, x_neg, float(a), float(a_neg) if pg else None, t(w), cw,
                t(raw), t(g), q)
        cases.append(("linear_w_hessian_sims_i8", label,
                      lambda args=args: sk.linear_w_hessian_sims_i8(*args),
                      lambda args=args: sk.linear_w_hessian_sims_i8_ref(*args)))
        w_int = (np.abs(w).max() / (q - 0.5)).astype(np.float32)
        w_lv = t(np.clip(np.round(w / w_int), -q, q - 1), torch.int8)
        ca = t(grid * a)
        args = (t(x), w_lv, t(np.full(oc, w_int, np.float32)), ca, t(raw),
                t(g), q, pg, GELU_NEG_CLIP / q if pg else 0.0)
        cases.append(("linear_a_hessian_sims_i8", label,
                      lambda args=args: sk.linear_a_hessian_sims_i8(*args),
                      lambda args=args: sk.linear_a_hessian_sims_i8_ref(*args)))

    for label, args in matmul_cases(rng, grid, S, G, N, hd, q, t):
        cases.append(("matmul_hessian_sims_b3", label,
                      lambda args=args: sk.matmul_hessian_sims_b3(*args),
                      lambda args=args: sk.matmul_hessian_sims_ref(*args)))
    # Swin-B/384 window matmuls (window 12: N = 144, head dim 32) at 4
    # images: stage 1 (64 windows, 4 heads), stage 3 (4 windows, 16 heads);
    # B3 runs on the same inputs for comparison
    for stage, nwin, G_s in ((1, 64, 4), (3, 4, 16)):
        for label, args in matmul_cases(rng, grid, S * nwin, G_s, 144, 32,
                                        q, t):
            if sk.mm_fold_factor(G_s, args[0].shape[-1],
                                 args[1].shape[-1]) <= 1:
                raise AssertionError("Swin window shapes must fold")
            cases.append((
                "matmul_hessian_sims_b3f", f"stage {stage} {label}",
                lambda args=args: sk.matmul_hessian_sims_b3f(*args),
                lambda args=args: sk.matmul_hessian_sims_ref(*args),
                lambda args=args: sk.matmul_hessian_sims_b3(*args)))

    stats = {}
    for kname, label, fn, ref_fn, *other in cases:
        got = fn()
        ref = ref_fn()
        torch.cuda.synchronize()
        err = check_sims(f"{kname} {label}", got, ref)
        ms = time_ms(fn, 5)
        plain_ms = time_ms(ref_fn, 1)
        entry = {"case": label, "ms": ms, "plain_ms": plain_ms}
        line = (f"[kernel] {kname} {label}: max_abs_err {err:.3e} "
                f"(max |sim| {float(ref.abs().max()):.3e}), kernel "
                f"{ms:.3f} ms, plain {plain_ms:.3f} ms")
        if other:             # B3 on the same inputs
            b3 = other[0]
            entry["b3_max_abs_err"] = check_sims(f"B3 {label}", b3(), ref)
            entry["b3_ms"] = time_ms(b3, 5)
            line += (f", B3 {entry['b3_ms']:.3f} ms (max_abs_err "
                     f"{entry['b3_max_abs_err']:.3e})")
        log(line)
        s = stats.setdefault(kname, {"max_abs_err": 0.0, "ms": None,
                                     "plain_ms": None, "cases": []})
        s["max_abs_err"] = max(s["max_abs_err"], err)
        if s["ms"] is None:   # the first case is the entry's headline time
            s["ms"], s["plain_ms"] = ms, plain_ms
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


def calibrate_and_serve(name, dev, sk):
    """One main path: quantize ``name`` at full width and depth on the
    card with the launch counts set to 0 just before and read just after;
    check the qstate, the served logits, and the card's forwards against
    the CPU's.  Returns (launches, summary)."""
    from ptq4vit_tpu_torch import quantize
    from ptq4vit_tpu_torch.configs import ptq4vit
    from ptq4vit_tpu_torch.models import get_net
    from ptq4vit_tpu_torch.utils.convert import params_from_numpy, qstate_to

    net = get_net(name, seed=0, device=dev)
    size, classes = net.cfg.img_size, net.cfg.num_classes
    calib = np.random.default_rng(1).standard_normal(
        (NUM_CALIB, 3, size, size)).astype(np.float32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sk.reset_launch_counts()
    t0 = time.time()
    net, qstate, report = quantize(net, calib, config=ptq4vit(),
                                   batch_size=4, device=dev,
                                   return_report=True)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = sk.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    by_kind = {}
    for op, mtype in net.op_inventory:
        by_kind[mtype] = by_kind.get(mtype, 0.0) + report.search_seconds[op]
    summary = {"model": name, "images": NUM_CALIB, "wall_s": wall,
               "capture_s": report.capture_seconds,
               "search_s": sum(report.search_seconds.values()),
               "search_s_by_kind": by_kind,
               "groups": report.num_groups, "peak_gib": peak / 2 ** 30,
               "capture_peak_gib": report.capture_peak_bytes / 2 ** 30,
               "ops": len(qstate), "launches": launches}
    log(f"[calib] {name} x {NUM_CALIB} images: {wall:.1f} s wall, capture "
        f"{summary['capture_s']:.1f} s, search {summary['search_s']:.1f} s, "
        f"groups {report.num_groups}, peak memory {peak / 2**30:.2f} GiB "
        f"({summary['capture_peak_gib']:.2f} GiB by the end of capture), "
        f"{len(qstate)} ops, launches {launches}")
    log(f"[calib] {name} search seconds by op type: "
        + ", ".join(f"{k} {v:.2f}" for k, v in by_kind.items()))
    for k in PATHS[name]:
        if launches[k] <= 0:
            raise AssertionError(f"{k} was not launched by the {name} path")
    if set(qstate) != {n for n, _ in net.op_inventory}:
        raise AssertionError("qstate does not cover every op")
    for op, qp in qstate.items():
        for f, v in vars(qp).items():
            if torch.is_tensor(v) and not (torch.isfinite(v).all()
                                           and (v > 0).all()):
                raise AssertionError(f"{op}.{f} is not finite and positive")

    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4, 3, size, size)).astype(np.float32)).to(dev)
    with torch.no_grad():
        fp = net.apply(x)
        qlog = net.apply(x, qstate=qstate)
    torch.cuda.synchronize()
    if qlog.shape != (4, classes) or not torch.isfinite(qlog).all():
        raise AssertionError("quantized logits are not finite (4, classes)")
    cos = torch.nn.functional.cosine_similarity(qlog, fp, dim=-1)
    summary["serve_cosine"] = [float(c) for c in cos]
    log(f"[serve] {name}, 4 images: cosine(quant, fp32) per image "
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
    log(f"[serve] {name}, card vs CPU, 1 image: fp32 logits max abs diff "
        f"{fp_diff:.3e} (max |logit| {float(fp_cpu.abs().max()):.3e}); "
        f"fake-quant logits cosine {q_cos:.6f}")
    if fp_diff > 1e-4 * float(fp_cpu.abs().max()):
        raise AssertionError("the card's fp32 forward disagrees with the "
                             "CPU's")
    if q_cos < 0.99:
        raise AssertionError("the card's fake-quant forward disagrees with "
                             "the CPU's")
    del net, qstate
    torch.cuda.empty_cache()
    return launches, summary


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
    dev = torch.device("cuda")

    t0 = time.time()
    _, nvcc_s = build.build()
    build.load()
    log(f"[build] kernels built in {nvcc_s:.1f} s (nvcc), "
        f"{time.time() - t0:.1f} s with loading")

    stats = kernel_phase(sk, dev)

    by_path, summaries = {}, []
    for name in PATHS:
        by_path[name], summary = calibrate_and_serve(name, dev, sk)
        summaries.append(summary)
    log("[paths] " + json.dumps({"card": card, "paths": summaries}))

    entries = [{"name": k, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[k],
                "launches": sum(c[k] for c in by_path.values()),
                "launches_by_path": {n: c[k] for n, c in by_path.items()},
                "max_abs_err": stats[k]["max_abs_err"], "ms": stats[k]["ms"],
                "plain_ms": stats[k]["plain_ms"], "cases": stats[k]["cases"]}
               for k in REPLACES]
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
