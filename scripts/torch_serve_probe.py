"""Card A/B probe of the port's serving kernels and serving engine: a
parent commit unpacked beside this tree, and this tree, on one GPU, on the
same seeded inputs.

    python scripts/torch_serve_probe.py ab PARENT_ROOT [OUT_DIR]
    python scripts/torch_serve_probe.py prepare OUT_DIR
    python scripts/torch_serve_probe.py run ROOT OUT_DIR TAG [--keep]
    python scripts/torch_serve_probe.py compare OUT_DIR TAG [TAG ...]
    python scripts/torch_serve_probe.py relaxed ROOT

ROOT is the checkout whose ``ptq4vit_tpu_torch`` is imported; the inputs,
the cases and the timing come from this tree's ``chip_smoke.py``.  Each
command prints JSON lines.

  ab       prepare, then ``run`` in four processes in the order parent /
           change / change / parent (the first of each kept), then
           ``compare`` of the four.  OUT_DIR (about 1 GB of kept outputs)
           defaults to _scratch/serve_probe.
  prepare  PTQ4ViT W8A8 calibration of ViT-B/384, Swin-B/384 and
           SwinV2-B/384 on 8 images with this tree (chip_smoke.py's seeds:
           weights seed 0, images seed 1), each qstate saved as a
           directory under OUT_DIR (calib/calibrator.save_qstate).
  run      with ROOT's package: B6 at chip_smoke.py's seven ViT-B/384 cases
           (B6_CASES), B10 / B11 at its Swin-B/384 stages (WINDOW_STAGES),
           and its attention cases (vit_attention_cases: B7 int8 and
           float, SoS and per-head, B8; window_attention_cases: B9 at
           stages 1 and 4; swinv2_kernel_cases: V2's B10, B9 and
           q8_postnorm at its four stages), 32 images, the relaxed
           variants of these cases (RELAXED_B6, B10 at stage 1, B7 / B8 /
           B9) and the adversarial relaxed cases (adversarial_cases) where
           ROOT's wrappers take ``relaxed``, inputs from fixed seeds: each
           kernel's ms (CUDA events over at least 100 ms of launches) and
           the SHA-1 of its output's bytes; then the bf16 ServingEngine on
           ViT-B/384, Swin-B/384 and SwinV2-B/384 (weights seed 0, the
           prepared qstates): the SHA-1 of one request's logits (32
           images, seed 10), img/s over 4 requests (host numpy in, logits
           out), and one request's device busy time, kernel span and wall
           time under torch.profiler.  The summary also goes to
           OUT_DIR/TAG.json; with --keep the outputs and logits go to
           OUT_DIR/TAG.pt.
  compare  per case: each run's ms, the mean of each ROOT's runs and
           their ratio; whether every run's output hashes agree; for two
           kept runs of different ROOTs, the count of elements that differ.
  relaxed  chip_smoke.py phase 3's relaxed cases alone (B6 / B10 relaxed,
           B7 / B8 / B9 relaxed, the adversarial relaxed cases): each
           against its relaxed plain version and timed beside its exact
           kernel on the same inputs in this process, with ROOT's
           package; one JSON line.
"""
from __future__ import annotations

import hashlib
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = ("vit_base_patch16_384", "swin_base_patch4_window12_384",
          "swinv2_base_window12to24_192to384")
REQUESTS = 4


def _smoke():
    """This tree's chip_smoke.py as a module (its cases and timing)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_cases", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sha1(t) -> str:
    """SHA-1 of a tensor's bytes (equal where two tensors are bitwise)."""
    import torch
    return hashlib.sha1(t.detach().contiguous().cpu().view(-1)
                        .view(torch.uint8).numpy().tobytes()).hexdigest()


def _kmajor(torch, w):
    """(N, Kp) K-major copy of (K, N) levels, K padded to 16 with zeros."""
    K, N = w.shape
    out = torch.zeros((N, -(-K // 16) * 16), dtype=torch.int8,
                      device=w.device)
    out[:, :K] = w.t()
    return out


def prepare(out_dir):
    sys.path.insert(0, HERE)
    import torch
    from ptq4vit_tpu_torch import quantize
    from ptq4vit_tpu_torch.calib.calibrator import save_qstate
    from ptq4vit_tpu_torch.configs import ptq4vit
    from ptq4vit_tpu_torch.models import get_net
    from ptq4vit_tpu_torch.utils.convert import qstate_to
    for name in MODELS:
        net = get_net(name, seed=0)
        size = net.cfg.img_size
        calib = np.random.default_rng(1).standard_normal(
            (8, 3, size, size)).astype(np.float32)
        _, qstate = quantize(net, calib, config=ptq4vit(), batch_size=4,
                             device=torch.device("cuda"))
        save_qstate(os.path.join(out_dir, name), qstate_to(qstate, "cpu"))
        print(json.dumps({"prepared": name, "ops": len(qstate)}), flush=True)
        del net, qstate
        torch.cuda.empty_cache()


def _kernel_cases(torch, sv, cs):
    """(kernel, label, call) of B6's seven cases, B10 / B11's stages and
    the attention cases (B7, B8, B9), on this tree's inputs, with the
    K-major weight where ROOT takes it."""
    takes = {fn: "w_kmaj" in inspect.signature(getattr(sv, fn)).parameters
             for fn in ("q8_linear", "q8_win_qkv", "q8_win_proj")}
    has_relaxed = "relaxed" in inspect.signature(sv.q8_linear).parameters
    rng = np.random.default_rng(5)
    inputs = {}
    for label, m, K, N, mode, ln, gelu, out, dt in cs.B6_CASES:
        args, kw = cs.q8_inputs(rng, m, K, N, mode, ln, gelu, out, dt)
        if takes["q8_linear"]:
            kw["w_kmaj"] = _kmajor(torch, args[1])
        inputs[label] = (args, kw)
        yield ("q8_linear", label,
               lambda args=args, kw=kw: sv.q8_linear(*args, **kw))
    # B6's relaxed variant (chip_smoke.py RELAXED_B6): a B6 case's inputs
    # or a case of its own
    for label, spec in cs.RELAXED_B6 if has_relaxed else ():
        if spec is None:
            args, kw = inputs[label]
        else:
            args, kw = cs.q8_inputs(rng, *spec)
            if takes["q8_linear"]:
                kw["w_kmaj"] = _kmajor(torch, args[1])
        yield ("q8_linear_relaxed", f"{label} (relaxed)",
               lambda args=args, kw=kw: sv.q8_linear(*args, relaxed=True,
                                                     **kw))
    rng = np.random.default_rng(6)
    for stage, res, C in cs.WINDOW_STAGES:
        qkv, proj = cs.window_linear_inputs(rng, res, C)
        kq = dict(a_qmax=128, out_qmax=128)
        kp = dict(a_qmax=128)
        if takes["q8_win_qkv"]:
            kq["w_kmaj"] = _kmajor(torch, qkv[1])
        if takes["q8_win_proj"]:
            kp["w_kmaj"] = _kmajor(torch, proj[1])
        yield ("q8_win_qkv", f"stage {stage}",
               lambda a=qkv, kw=kq: sv.q8_win_qkv(*a, **kw))
        if has_relaxed and stage == 1:
            yield ("q8_win_qkv_relaxed", f"stage {stage} (relaxed)",
                   lambda a=qkv, kw=kq: sv.q8_win_qkv(*a, relaxed=True,
                                                      **kw))
        yield ("q8_win_proj", f"stage {stage}",
               lambda a=proj, kw=kp: sv.q8_win_proj(*a, **kw))
    # B7 / B8 at ViT-B/384 and B9 at Swin-B/384's stages 1 and 4, 32
    # images: chip_smoke.py's attention cases, their relaxed variants
    # among them; then its adversarial relaxed cases
    rng = np.random.default_rng(7)
    for build_cases in (cs.vit_attention_cases, cs.window_attention_cases):
        for case in build_cases(sv, "cuda", rng):
            yield case[0], case[1], case[2]
    # Swin V2's cases at SwinV2-B/384's four stages (chip_smoke.py phase
    # 14: B10 normalizing q and k, B9 at 576 keys with tau, q8_postnorm)
    for case in cs.swinv2_kernel_cases(sv, "cuda"):
        yield case[0], case[1], case[2]
    for case in cs.adversarial_cases(sv, "cuda") if has_relaxed else ():
        yield case[0], case[1], case[2]


def relaxed(root):
    """chip_smoke.py phase 3's relaxed cases alone, with ROOT's package:
    each relaxed kernel against its relaxed plain version and timed beside
    its exact kernel on the same inputs (chip_smoke.measure_serving), then
    one JSON line of the stats by kernel."""
    sys.path.insert(0, root)
    import torch
    from ptq4vit_tpu_torch.ops import build
    from ptq4vit_tpu_torch.ops import int8_serve as sv
    cs = _smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    build.load("serve_kernels")
    cases = [c for c in cs.serve_kernel_cases(sv, "cuda")
             + cs.window_kernel_cases(sv, "cuda")
             + cs.adversarial_cases(sv, "cuda")
             if c[0].endswith("_relaxed")]
    stats = cs.measure_serving(cases)
    print(json.dumps({"root": root, "card": cs.card_line(),
                      "relaxed": stats}), flush=True)


def run(root, out_dir, tag, keep):
    sys.path.insert(0, root)
    import torch
    from ptq4vit_tpu_torch import ServingEngine
    from ptq4vit_tpu_torch.calib.calibrator import load_qstate
    from ptq4vit_tpu_torch.models import get_net
    from ptq4vit_tpu_torch.ops import build
    from ptq4vit_tpu_torch.ops import int8_serve as sv
    cs = _smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.load("serve_kernels")
    summary = {"tag": tag, "root": root, "card": cs.card_line(),
               "kernels": [], "serving": []}
    kept = {}
    for kname, label, fn in _kernel_cases(torch, sv, cs):
        got = fn()
        torch.cuda.synchronize()
        entry = {"kernel": kname, "case": label, "ms": cs.time_ms(fn, 5),
                 "sha1": _sha1(got)}
        summary["kernels"].append(entry)
        print(json.dumps({"tag": tag, **entry}), flush=True)
        if keep:
            kept[f"{kname} {label}"] = got.cpu()
        del got
    torch.cuda.empty_cache()
    for name in MODELS:
        net = get_net(name, seed=0)
        engine = ServingEngine(net, load_qstate(os.path.join(out_dir, name),
                                                device="cuda"))
        size = net.cfg.img_size
        reqs = [np.random.default_rng(10 + i).standard_normal(
            (cs.SERVE_BATCH, 3, size, size)).astype(np.float32)
            for i in range(REQUESTS)]
        logits = engine(reqs[0])                        # warm-up
        torch.cuda.synchronize()
        t0 = time.time()
        outs = [engine(x) for x in reqs]
        torch.cuda.synchronize()
        wall = time.time() - t0
        prof = cs.profile_call(lambda: engine(reqs[0]))
        entry = {"model": name, "img_per_s": REQUESTS * cs.SERVE_BATCH / wall,
                 "busy_ms": prof["busy_ms"], "span_ms": prof["span_ms"],
                 "wall_ms": prof["wall_ms"],
                 "busy_share_of_span": prof["busy_ms"] / prof["span_ms"],
                 "logits_sha1": _sha1(outs[0]),
                 "same_as_warmup": bool(torch.equal(outs[0], logits)),
                 "by_kernel": prof["by_kernel"][:6]}
        summary["serving"].append(entry)
        print(json.dumps({"tag": tag, **entry}), flush=True)
        if keep:
            kept[f"logits {name}"] = outs[0].cpu()
        del net, engine, outs, logits
        torch.cuda.empty_cache()
    with open(os.path.join(out_dir, f"{tag}.json"), "w") as f:
        json.dump(summary, f)
    if keep:
        torch.save(kept, os.path.join(out_dir, f"{tag}.pt"))


def compare(out_dir, tags):
    runs = {}
    for t in tags:
        with open(os.path.join(out_dir, f"{t}.json")) as f:
            runs[t] = json.load(f)
    roots = sorted({r["root"] for r in runs.values()})
    kept = {t: os.path.join(out_dir, f"{t}.pt") for t in tags
            if os.path.exists(os.path.join(out_dir, f"{t}.pt"))}
    pair = None
    for a in kept:
        for b in kept:
            if runs[a]["root"] < runs[b]["root"] and pair is None:
                pair = (a, b)
    loaded = {}
    if pair is not None:
        import torch
        loaded = {t: torch.load(kept[t]) for t in pair}
    first = runs[tags[0]]
    for i, e in enumerate(first["kernels"]):
        key = f"{e['kernel']} {e['case']}"
        ms = {t: r["kernels"][i]["ms"] for t, r in runs.items()}
        mean = {root: float(np.mean([ms[t] for t, r in runs.items()
                                     if r["root"] == root]))
                for root in roots}
        line = {"case": key, "ms": ms, "mean_ms_by_root": mean,
                "bitwise_all_runs": len({r["kernels"][i]["sha1"]
                                         for r in runs.values()}) == 1}
        if loaded:
            a, b = (loaded[t][key] for t in pair)
            line["elements_differing"] = int((a != b).sum())
            line["elements"] = a.numel()
        print(json.dumps(line), flush=True)
    for i, e in enumerate(first["serving"]):
        line = {"model": e["model"],
                "img_per_s": {t: r["serving"][i]["img_per_s"]
                              for t, r in runs.items()},
                "busy_share_of_span": {
                    t: r["serving"][i]["busy_share_of_span"]
                    for t, r in runs.items()},
                "busy_ms": {t: r["serving"][i]["busy_ms"]
                            for t, r in runs.items()},
                "bitwise_all_runs": len({r["serving"][i]["logits_sha1"]
                                         for r in runs.values()}) == 1}
        if loaded:
            key = f"logits {e['model']}"
            a, b = (loaded[t][key] for t in pair)
            line["logits_differing"] = int((a != b).sum())
        print(json.dumps(line), flush=True)
    print(json.dumps({"card": first["card"], "roots": roots}), flush=True)


def ab(parent, out_dir):
    os.makedirs(out_dir, exist_ok=True)
    me = os.path.abspath(__file__)
    subprocess.run([sys.executable, me, "prepare", out_dir], check=True)
    tags = []
    for tag, root in (("parent1", parent), ("change1", HERE),
                      ("change2", HERE), ("parent2", parent)):
        subprocess.run([sys.executable, me, "run", os.path.abspath(root),
                        out_dir, tag] + (["--keep"] if tag.endswith("1")
                                         else []), check=True)
        tags.append(tag)
    compare(out_dir, tags)


def main(argv):
    if len(argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    cmd, args = argv[1], argv[2:]
    if cmd == "ab":
        ab(args[0], args[1] if len(args) > 1 else
           os.path.join(HERE, "_scratch", "serve_probe"))
    elif cmd == "relaxed":
        relaxed(args[0])
    elif cmd == "prepare":
        prepare(args[0])
    elif cmd == "run":
        run(args[0], args[1], args[2], "--keep" in args)
    elif cmd == "compare":
        compare(args[0], args[1:])
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
