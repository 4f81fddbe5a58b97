"""Card probes of the port's search kernels, for comparing two checkouts
(a parent commit unpacked beside this tree, and this tree) on one GPU.

    python scripts/torch_search_probe.py profile ROOT [--streamed]
    python scripts/torch_search_probe.py b3 ROOT
    python scripts/torch_search_probe.py b4 ROOT [--images=4,32]
    python scripts/torch_search_probe.py ptxas ROOT [LIBRARY]
    python scripts/torch_search_probe.py qstates ROOT OUT.pkl [--exact]
    python scripts/torch_search_probe.py compare PARENT.pkl CHANGE.pkl
    python scripts/torch_search_probe.py flips ROOT [--images=32]

ROOT is the checkout whose ``ptq4vit_tpu_torch`` (and ``chip_smoke.py``)
is imported; each command prints JSON lines.

  profile  B1 and B2 at ViT-B/384 fc1 (4 and 32 images) and post-GELU fc2
           (4 images), P = 100: the wrapper's ms (CUDA events, 5 calls)
           and the device ms of each kernel of one call under
           torch.profiler (pre-pass, scored GEMM, reduction).  With
           --streamed, where the checkout has ``linear_plan``, also with
           the fixed tile streamed with every chunk.
  b3       B3 at chip_smoke.py's ViT-B/384 cases and B3f at its Swin
           stage-1 and stage-3 cases (4 images): the wrapper's ms (CUDA
           events, 20 calls) and the device ms of each kernel of one call
           under torch.profiler (level pre-pass, scored kernel,
           reduction), one JSON line a case.
  b4       B4w (fc1, post-GELU twin fc2, qkv n_V=3) and B4a (fc1,
           post-GELU fc2, qkv) at ViT-B/384 shapes with 4 and 32 images
           (or the --images given), P = 100: one JSON line a case with
           the wrapper's ms (CUDA events, 3 calls), the device ms of each
           kernel of one call
           under torch.profiler (level pre-pass, scored kernel,
           reduction), and the SHA-1 of the sims' bytes (equal between
           two checkouts where their sims are bitwise equal).
  ptxas    ptxas's registers and spill bytes of each kernel as the
           checkout's search_kernels.cu (or LIBRARY: serve_kernels)
           builds -- B3 / B3f ``mm_tc_kernel<W, SOS, FAST, KL>``, B4
           ``fp32_scored_kernel<KIND>`` (0 B4w, 1 B4a, 2 B4a post-GELU),
           B6 / B10 / B11 ``q8_tc_kernel<TWIN>``, B7 / B8 / B9
           ``attention_kernel<WINDOW, HDP, SOS, PARK>``, ... --, with the
           count of IGMMA (int8 wgmma), IMMA (int8 mma.sync) and IDP.4A
           (dp4a) instructions in each
           kernel's SASS (cuobjdump) and of its WARPGROUP.DEPBAR waits,
           one JSON line a kernel, and every ptxas warning (C7510-C7520:
           serialized wgmma).
  qstates  PTQ4ViT W8A8 calibration of ViT-B/384 and Swin-B/384 on 8
           images (chip_smoke.py's seeds); pickles each qstate and every
           scorer call's sims, by op, in call order.  With --exact:
           ViT-B/384 only, with int8_score=False (the B4w / B4a calls).
  compare  the interval slots where two such qstates differ, and for
           each op the first scorer call whose argmax differs, with its
           top-two gap (a near-tie when within chip_smoke.ARGMAX_TIE).
  flips    bench_torch.py's ViT-B/384 run (one repeat, 32 images or the
           --images given) under int8 scoring, then under exact scoring
           (PTQ4VIT_TPU_INT8_SCORE=0), each final row printed, then the
           interval slots where the two qstates differ, by op type
           (chip_smoke.flip_count).
"""
from __future__ import annotations

import hashlib
import json
import pickle
import re
import sys

import numpy as np

P, Q, D, HID = 100, 128, 768, 3072
GRID = np.linspace(0.01, 1.2, P + 1)[:P].astype(np.float32)


def _import(root):
    sys.path.insert(0, root)
    import torch
    from ptq4vit_tpu_torch.ops import build, search_kernels
    build.load()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch, search_kernels


def _time_ms(torch, fn, reps=5):
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


def _device_ms(torch, fn):
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = re.sub(r"^void |\(anonymous namespace\)::", "", e.name)
        name = name.split("(")[0][:50]
        out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    return out


def _streamed(sk):
    """A linear_plan that streams the fixed tile, with as many ring slots
    as a block's shared memory holds."""
    orig = sk.linear_plan

    def plan(kind, M, N, K, P_, n_V=1, twin=False):
        p = orig(kind, M, N, K, P_, n_V, twin)
        nl = 2 if kind == "w" and twin else 1
        st = 2
        while st < sk.LQ_MAX_STAGES and sk.linear_smem_bytes(
                nl, K, False, st + 1, p.pc, p.nbl) <= sk.SMEM_LIMIT:
            st += 1
        return p._replace(resident=False, stages=st,
                          smem=sk.linear_smem_bytes(nl, K, False, st, p.pc,
                                                    p.nbl))
    return orig, plan


def profile(root, streamed):
    torch, sk = _import(root)

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to("cuda", dt)
    a_neg = np.float32(0.16997124254703522 / Q)
    for images, ic, oc, twin in ((4, D, HID, False), (32, D, HID, False),
                                 (4, HID, D, True)):
        rng = np.random.default_rng(0)
        M = images * 577
        x = rng.standard_normal((M, ic)).astype(np.float32)
        if twin:
            x = x * 0.5 * (1 + np.tanh(0.7978845608 * (x + 0.044715 * x ** 3)))
        w = (rng.standard_normal((oc, ic)) * (2 / (ic + oc)) ** 0.5) \
            .astype(np.float32)
        raw = (x @ w.T).astype(np.float32)
        g = (rng.standard_normal((M, oc)) * 1e-4).astype(np.float32)
        a = np.float32((x.max() if twin else np.abs(x).max()) / (Q - 0.5))
        x_lv = np.clip(np.round(x / a), 0 if twin else -Q, Q - 1)
        x_neg = np.clip(np.round(x / a_neg), -Q, 0)
        base = np.abs(w).max() / (Q - 0.5)
        b1 = (t(x_lv, torch.int8), t(x_neg, torch.int8) if twin else None,
              float(a), float(a_neg) if twin else None, t(w),
              t(GRID[:, None] * np.float32(base)), t(raw), t(g), Q)
        w_int = np.float32(np.abs(w).max() / (Q - 0.5))
        b2 = (t(x), t(np.clip(np.round(w / w_int), -Q, Q - 1), torch.int8),
              t(np.full(oc, w_int, np.float32)), t(GRID * a), t(raw), t(g),
              Q, twin, float(a_neg) if twin else 0.0)
        for name, fn, args in (("B1", sk.linear_w_hessian_sims_i8, b1),
                               ("B2", sk.linear_a_hessian_sims_i8, b2)):
            variants = [("plan", None)]
            if streamed and hasattr(sk, "linear_plan"):
                variants.append(("streamed", _streamed(sk)))
            for vname, patch in variants:
                if patch is not None:
                    sk.linear_plan = patch[1]
                try:
                    ms = _time_ms(torch, lambda: fn(*args))
                    by_kernel = _device_ms(torch, lambda: fn(*args))
                finally:
                    if patch is not None:
                        sk.linear_plan = patch[0]
                print(json.dumps({
                    "case": f"{name} M={M} K={ic} N={oc} twin={twin}",
                    "variant": vname, "ms": ms, "by_kernel": by_kernel}),
                    flush=True)


def b3(root):
    torch, sk = _import(root)
    import chip_smoke as cs

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to("cuda", dt)
    rng = np.random.default_rng(0)
    cases = [("b3 " + label, sk.matmul_hessian_sims_b3, args)
             for label, args in cs.matmul_cases(rng, GRID, 4, 12, 577, 64,
                                                Q, t)]
    for stage, nwin, G in ((1, 64, 4), (3, 4, 16)):
        cases += [(f"b3f stage {stage} {label}", sk.matmul_hessian_sims_b3f,
                   args)
                  for label, args in cs.matmul_cases(rng, GRID, 4 * nwin, G,
                                                     144, 32, Q, t)]
    for name, fn, args in cases:
        print(json.dumps({
            "case": name, "ms": _time_ms(torch, lambda: fn(*args), 20),
            "by_kernel": _device_ms(torch, lambda: fn(*args))}), flush=True)


def b4(root, images_list=(4, 32)):
    torch, sk = _import(root)

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to("cuda", dt)
    a_neg = np.float32(0.16997124254703522 / Q)
    for images in images_list:
        M = images * 577
        for label, ic, oc, n_V, twin in (("fc1", D, HID, 1, False),
                                         ("fc2 twin", HID, D, 1, True),
                                         ("qkv", D, 3 * D, 3, False)):
            rng = np.random.default_rng(0)
            x = rng.standard_normal((M, ic)).astype(np.float32)
            if twin:
                x = x * 0.5 * (1 + np.tanh(0.7978845608
                                           * (x + 0.044715 * x ** 3)))
            w = (rng.standard_normal((oc, ic)) * (2 / (ic + oc)) ** 0.5) \
                .astype(np.float32)
            raw = (x @ w.T).astype(np.float32)
            g = (rng.standard_normal((M, oc)) * 1e-4).astype(np.float32)
            a = np.float32((x.max() if twin else np.abs(x).max()) / (Q - 0.5))
            x_lv = np.clip(np.round(x / a), 0 if twin else -Q, Q - 1)
            x_sim = x_lv * a
            if twin:
                x_sim = x_sim + np.clip(np.round(x / a_neg), -Q, 0) * a_neg
            base = np.abs(w.reshape(n_V, -1)).max(1) / (Q - 0.5)
            cw = GRID[:, None] * base[None].astype(np.float32)
            w_int = np.float32(np.abs(w).max() / (Q - 0.5))
            w_sim = np.clip(np.round(w / w_int), -Q, Q - 1) * w_int
            del x_lv
            bw = (t(x_sim), t(w), t(cw if n_V > 1 else cw[:, 0]), t(raw),
                  t(g), Q)
            ba = (t(x), t(w_sim), t(GRID * a), t(raw), t(g), Q, twin,
                  float(a_neg) if twin else 0.0)
            del x, w, raw, g, x_sim, w_sim
            for name, fn, args in (("B4w", sk.linear_w_hessian_sims, bw),
                                   ("B4a", sk.linear_a_hessian_sims, ba)):
                sims = fn(*args)
                ms = _time_ms(torch, lambda: fn(*args), 3)
                by_kernel = _device_ms(torch, lambda: fn(*args))
                print(json.dumps({
                    "case": f"{name} {label} M={M} K={ic} N={oc}",
                    "ms": ms, "by_kernel": by_kernel,
                    "sims_sha1": hashlib.sha1(
                        sims.cpu().numpy().tobytes()).hexdigest()}),
                    flush=True)
            del bw, ba
            torch.cuda.empty_cache()


def ptxas(root, library="search_kernels"):
    import os
    import subprocess
    import tempfile
    sys.path.insert(0, root)
    from ptq4vit_tpu_torch.ops import build
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    fd, cubin = tempfile.mkstemp(suffix=".cubin", dir=build.BUILD_DIR)
    os.close(fd)
    flags = [f for f in build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    try:
        out = subprocess.run(
            [build.nvcc_path(), *flags, "-Xptxas", "-v", "-cubin", "-o", cubin,
             build.source_path(library)],
            capture_output=True, text=True, check=True).stderr
        cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()),
                                 "cuobjdump")
        sass = subprocess.run([cuobjdump, "-sass", cubin],
                              capture_output=True, text=True,
                              check=True).stdout
    finally:
        os.remove(cubin)
    # SASS by mangled kernel name
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = {"igmma": 0, "imma": 0, "idp4a": 0,
                            "wg_depbar": 0}
        elif name is not None:
            counts[name]["igmma"] += "IGMMA" in line
            counts[name]["imma"] += "IMMA" in line
            counts[name]["idp4a"] += "IDP.4A" in line
            counts[name]["wg_depbar"] += "WARPGROUP.DEPBAR" in line
    kernel = None
    for line in out.splitlines():
        if "arning" in line or "(C75" in line:   # C751x / C752x: serialized
            # wgmma
            print(json.dumps({"ptxas_warning": line.strip()}), flush=True)
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            k = re.search(r"fp32_scored_kernelILi(\d)E", mangled)
            mm = re.search(r"mm_tc_kernelILi(\d+)ELb(\d)ELb(\d)ELi(\d)E",
                           mangled)
            other = None       # a name its mangled length prefix gives
            for c in re.finditer(r"\d+(?=[a-z])", mangled):
                for i in range(len(c.group(0))):     # the length's digits
                    end = c.end() + int(c.group(0)[i:])
                    if mangled[c.end():end].endswith("_kernel"):
                        tail = re.match(r"I\w*?EE", mangled[end:])
                        other = (mangled[c.end():end], ", ".join(re.findall(
                            r"L[bi](\d+)E", tail.group(0) if tail else "")))
            kernel = (f"fp32_scored_kernel<{k.group(1)}>" if k else
                      "mm_tc_kernel<" + ", ".join(mm.groups()) + ">"
                      if mm else f"{other[0]}<{other[1]}>"
                      if other else mangled)
            spills = None
            continue
        if kernel is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            spills = [int(m.group(2)), int(m.group(3)), int(m.group(1))]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            print(json.dumps({"kernel": kernel,
                              "registers": int(m.group(1)),
                              "spill_stores": spills[0] if spills else 0,
                              "spill_loads": spills[1] if spills else 0,
                              "stack_frame": spills[2] if spills else 0,
                              **counts.get(mangled, {})}),
                  flush=True)
            kernel = None
    print(json.dumps({"library": library, "kernels": len(counts),
                      "igmma": sum(c["igmma"] for c in counts.values()),
                      "imma": sum(c["imma"] for c in counts.values()),
                      "idp4a": sum(c["idp4a"] for c in counts.values())}),
          flush=True)


def qstates(root, path, exact=False):
    torch, sk = _import(root)
    from ptq4vit_tpu_torch import quantize
    from ptq4vit_tpu_torch.calib import calibrator
    from ptq4vit_tpu_torch.configs import ptq4vit
    from ptq4vit_tpu_torch.models import get_net
    current = {"op": None}
    search_one = calibrator.HessianQuantCalibrator._search_one

    def named_search(self, name, *a, **kw):
        current["op"] = name
        return search_one(self, name, *a, **kw)
    calibrator.HessianQuantCalibrator._search_one = named_search
    log = []
    for kname in (("linear_w_hessian_sims", "linear_a_hessian_sims")
                  if exact else ("linear_w_hessian_sims_i8",
                                 "linear_a_hessian_sims_i8",
                                 "matmul_hessian_sims")):
        fn = getattr(sk, kname)

        def logged(*a, _fn=fn, _k=kname, **kw):
            out = _fn(*a, **kw)
            log.append((current["op"], _k, out.float().cpu().numpy()))
            return out
        logged.launches = 0     # the wrappers count on their global name
        setattr(sk, kname, logged)
    res = {}
    for name in (("vit_base_patch16_384",) if exact else
                 ("vit_base_patch16_384", "swin_base_patch4_window12_384")):
        log.clear()
        net = get_net(name, seed=0)
        size = net.cfg.img_size
        calib = np.random.default_rng(1).standard_normal(
            (8, 3, size, size)).astype(np.float32)
        _, q = quantize(net, calib, config=ptq4vit(), batch_size=4,
                        device=torch.device("cuda"),
                        **({"int8_score": False} if exact else {}))
        res[name] = {"qstate": {op: {f: v.cpu().numpy()
                                     for f, v in vars(qp).items()
                                     if torch.is_tensor(v)}
                                for op, qp in q.items()},
                     "log": list(log)}
        print(json.dumps({"model": name, "ops": len(q),
                          "scorer_calls": len(log)}), flush=True)
        del net, q
        torch.cuda.empty_cache()
    with open(path, "wb") as fh:
        pickle.dump(res, fh)


def compare(path_a, path_b, tie=1e-4):
    with open(path_a, "rb") as fh:
        a = pickle.load(fh)
    with open(path_b, "rb") as fh:
        b = pickle.load(fh)
    for name in a:
        qa, qb = a[name]["qstate"], b[name]["qstate"]
        diff = total = 0
        for op in qa:
            for f, v in qa[op].items():
                same = np.isclose(v.reshape(-1), qb[op][f].reshape(-1),
                                  rtol=1e-6, atol=0)
                diff += int((~same).sum())
                total += same.size
        first, worst = {}, {}
        for (op, kname, sa), (op_b, _, sb) in zip(a[name]["log"],
                                                  b[name]["log"]):
            if op != op_b:
                raise ValueError("the two runs called the scorers in "
                                 "another order")
            if op in first:
                continue
            rel = float(np.max(np.abs(sa - sb)
                               / np.maximum(np.abs(sa), 1e-30)))
            worst[kname] = max(worst.get(kname, 0.0), rel)
            s2a = sa.reshape(sa.shape[0], -1)
            s2b = sb.reshape(sb.shape[0], -1)
            for col in range(s2a.shape[1]):
                i, j = int(s2a[:, col].argmax()), int(s2b[:, col].argmax())
                if i != j:
                    gap = abs(float(s2a[i, col] - s2a[j, col])) \
                        / abs(float(s2a[i, col]))
                    first[op] = {"kernel": kname, "column": col,
                                 "argmax": [i, j], "gap": gap,
                                 "near_tie": gap <= tie}
                    break
        print(json.dumps({"model": name, "slots_differ": diff,
                          "slots": total, "max_rel_sim_diff": worst,
                          "first_divergences": first}), flush=True)


def flips(root, images=32):
    _import(root)
    import bench_torch
    import chip_smoke
    from ptq4vit_tpu_torch.models import model_config, vit
    qstates = {}
    for label, env in (("int8", {}), ("exact",
                                      {"PTQ4VIT_TPU_INT8_SCORE": "0"})):
        rc, row, q = bench_torch.run(dict(env, BENCH_CALIB=str(images),
                                          BENCH_REPEATS="1"))
        if rc != 0:
            raise SystemExit(f"the {label} run failed: {row.get('error')}")
        qstates[label] = q
    counts = chip_smoke.flip_count(
        vit.op_inventory(model_config("vit_base_patch16_384")),
        qstates["int8"], qstates["exact"])
    print(json.dumps({"flips": "int8 vs exact scoring",
                      "model": "vit_base_patch16_384", "images": images,
                      "by_op_type": counts,
                      "total": [sum(v[0] for v in counts.values()),
                                sum(v[1] for v in counts.values())]}),
          flush=True)


def main(argv):
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    cmd, args = argv[1], argv[2:]
    if cmd == "profile":
        profile(args[0], "--streamed" in args)
    elif cmd == "b3":
        b3(args[0])
    elif cmd == "b4":
        b4(args[0], *[tuple(int(n) for n in a.split("=", 1)[1].split(","))
                      for a in args[1:] if a.startswith("--images=")])
    elif cmd == "ptxas":
        ptxas(*args[:2])
    elif cmd == "qstates":
        qstates(args[0], args[1], "--exact" in args)
    elif cmd == "compare":
        compare(args[0], args[1])
    elif cmd == "flips":
        flips(args[0], *[int(a.split("=", 1)[1]) for a in args[1:]
                         if a.startswith("--images=")])
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
