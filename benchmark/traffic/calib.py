"""Calibration traffic: back-to-back PTQ4ViT calibration jobs on one set
of images.

Mix parameters (``benchmark/mixes/<traffic>.json``): ``host_threads``
(read by the harness), ``images`` (the calibration set),
``micro_batch`` (the capture's), ``config`` and ``bits`` (the policy),
``cache_dtype``, ``warmup_jobs``, ``check_ops`` ({op kind: how many ops
of that kind the check samples in each stage}), ``check_reductions``
(Swin's downsample reductions it samples) and, for small tests,
``eq_n`` / ``search_round`` overrides.

Set-up draws the weights, the images and the probe noise from the seed,
builds the kernel libraries (cached in the checkout) and runs the warm-up
jobs.  In the window a new job starts while the elapsed time is under
``--seconds``; every started job completes and counts.  A job is
``ptq4vit_tpu_torch.api.quantize`` on the net, ending with its qstate on
the host.  The check samples ops from the seed, calibrates them with the
plain reference on the reference's own capture, and judges every window
job's intervals of those ops (``reference/calib.judge``).
"""
from __future__ import annotations

import contextlib
import random
import re
import time

import torch

from .. import model
from ..reference import calib as ref
from ..reference.models import op_kinds
from ..trace import profiled, span


def policy(mix):
    from ptq4vit_tpu_torch.configs import get_config
    cfg = get_config(mix.get("config", "PTQ4ViT"))
    for kw in (cfg.ptqsl_conv2d_kwargs, cfg.ptqsl_linear_kwargs,
               cfg.ptqsl_matmul_kwargs):
        for k in ("eq_n", "search_round"):
            if k in mix:
                kw[k] = mix[k]
    return cfg


def setup(run):
    from ptq4vit_tpu_torch.models.registry import net_from_config
    mix, cfg, dev = run.mix, run.cfg, run.device
    if dev.type == "cuda":
        from ptq4vit_tpu_torch.ops import build
        build.build_all()
    params = model.make_params(cfg, run.seed, dev)
    n = mix["images"]
    images = model.make_images(n, cfg, run.seed, dev)
    probe = model.make_probe_u(n, cfg, run.seed, dev)
    run.state.update(
        params=params, images=images, probe=probe,
        net=net_from_config(model.port_config(cfg, run.cell.config["name"]),
                            params),
        images_host=images.cpu().numpy(), probe_host=probe.cpu().numpy())
    for _ in range(mix.get("warmup_jobs", 1)):
        job(run)


def job(run, spans=False):
    """One calibration job: (start, end, qstate on the host, report)."""
    from ptq4vit_tpu_torch.api import quantize
    st, mix = run.state, run.mix
    bits = tuple(mix.get("bits", (8, 8)))
    with patched_spans(run.device) if spans else contextlib.nullcontext():
        t0 = time.time()
        _, qstate, report = quantize(
            st["net"], st["images_host"], config=policy(mix), bits=bits,
            batch_size=mix.get("micro_batch", 4), device=run.device,
            probe_u=st["probe_host"], int8_score=True,
            cache_dtype=mix.get("cache_dtype", "bfloat16"),
            return_report=True)
        host = model.qstate_to_host(qstate)
        t1 = time.time()
    return t0, t1, host, report


@contextlib.contextmanager
def patched_spans(device):
    """``bench.capture`` and ``bench.search`` spans around the
    calibrator's calls into the capture and the searches (traced runs
    only); a call that a later program no longer makes leaves its span
    empty."""
    from ptq4vit_tpu_torch.calib import calibrator, search
    saved = []

    def wrap(mod, attr, name):
        fn = getattr(mod, attr, None)
        if fn is None:
            return

        def inner(*a, **k):
            with span(name, device):
                return fn(*a, **k)
        saved.append((mod, attr, fn))
        setattr(mod, attr, inner)

    wrap(calibrator, "capture", "capture")
    for attr in ("search_linear", "search_matmul", "search_conv"):
        wrap(search, attr, "search")
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def window(run):
    dev = run.device
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    jobs, traced = [], None
    start = time.time()
    while time.time() - start < run.seconds:
        run.attempted += 1
        try:
            if run.traced and traced is None:
                out = {}
                with profiled(dev, out):
                    traced = job(run, spans=True)
                run.trace = out["trace"]
                continue
            jobs.append(job(run))
        except Exception as e:                       # counted, not hidden
            run.failed += 1
            run.log(f"job failed: {type(e).__name__}: {e}")
    done = jobs + ([traced] if traced else [])
    run.records["jobs"] = jobs
    run.records["traced_job"] = traced
    if done:
        first = min(j[0] for j in done)
        last = max(j[1] for j in done)
        run.e2e["calib_s"] = (last - first) / len(done)
    if cuda:
        run.e2e["calib_peak_gib"] = \
            torch.cuda.max_memory_allocated(dev) / 2 ** 30
    run.log(f"{len(done)} jobs: " + ", ".join(
        phases(j) for j in sorted(done, key=lambda j: j[0])))
    if traced and jobs:
        run.log(f"traced job {traced[1] - traced[0]:.3f}s, untraced mean "
                f"{sum(j[1] - j[0] for j in jobs) / len(jobs):.3f}s")


def phases(job):
    """A job's seconds, with the report's capture and search seconds and
    its slowest op's search, so that a slow job shows where it lost
    time."""
    t0, t1, _, report = job
    if report is None or not report.search_seconds:
        return f"{t1 - t0:.3f}s"
    op, slow = max(report.search_seconds.items(), key=lambda kv: kv[1])
    return (f"{t1 - t0:.3f}s (capture {report.capture_seconds:.2f}, "
            f"search {sum(report.search_seconds.values()):.2f}, "
            f"slowest {op} {slow:.2f})")


def release(run):
    for k in ("net", "images_host", "probe_host"):
        run.state.pop(k, None)


def stage(name):
    """The stage of a block's op: Swin's ``layers.<i>.blocks`` (one head
    count, width and fold factor), ViT's ``blocks``; None outside the
    blocks."""
    m = re.match(r"((?:layers\.\d+\.)?blocks)\.\d+\.", name)
    return m.group(1) if m else None


def sample_ops(run):
    """The ops the check calibrates, drawn from the seed: in every stage
    the mix's ``check_ops`` count of each op kind, ``check_reductions`` of
    Swin's downsample reductions, and the patch embedding and the head
    always."""
    kinds = op_kinds(run.cfg)
    rng = random.Random(run.seed)
    reductions = [n for n in kinds if n.endswith("downsample.reduction")]
    pick = ["patch_embed.proj", "head"] + rng.sample(
        reductions, min(run.mix.get("check_reductions", 0), len(reductions)))
    for st in sorted({stage(n) for n in kinds} - {None}):
        for kind, k in sorted(run.mix.get("check_ops", {}).items()):
            names = [n for n in kinds if kinds[n] == kind and stage(n) == st]
            pick += rng.sample(names, min(k, len(names)))
    return {n: kinds[n] for n in kinds if n in pick}


def check(run):
    """The widest gap and the moved share over the sampled ops and every
    window job; with ``run.control`` the control (the reference in
    bfloat16) is judged too, into ``run.records["control"]``."""
    st, mix = run.state, run.mix
    kinds = sample_ops(run)
    pol = ref.Policy(mix)
    t0 = time.time()
    cache = getattr(torch, mix.get("cache_dtype", "bfloat16"))
    caches = ref.capture(st["params"], run.cfg, st["images"], st["probe"],
                         list(kinds), micro=mix.get("micro_batch", 4),
                         cache_dtype=cache)
    reference = {n: ref.search_op(k, caches[n], st["params"], n, pol,
                                  torch.float32) for n, k in kinds.items()}
    run.records["reference_s"] = time.time() - t0
    jobs = run.records["jobs"] + ([run.records["traced_job"]]
                                  if run.records["traced_job"] else [])
    numbers = {"gap": 0.0, "moved": 0.0}
    for _, _, host, _ in jobs:
        prog = {n: {k: None if v is None else v.to(run.device)
                    for k, v in model.plain_intervals(host[n]).items()}
                for n in kinds}
        got, worst = ref.judge(kinds, caches, st["params"], pol, prog,
                               reference)
        for k in numbers:
            numbers[k] = max(numbers[k], got[k])
        run.log(f"check: {got} (worst ops {worst})")
    if not jobs:
        numbers = {"gap": float("inf"), "moved": 1.0}
    if run.control:
        low = torch.bfloat16
        c_caches = ref.capture(st["params"], run.cfg, st["images"],
                               st["probe"], list(kinds),
                               micro=mix.get("micro_batch", 4), dtype=low,
                               cache_dtype=cache)
        control = {n: ref.search_op(k, c_caches[n], st["params"], n, pol,
                                    low) for n, k in kinds.items()}
        run.records["control"], worst = ref.judge(
            kinds, caches, st["params"], pol, control, reference)
        run.log(f"control: {run.records['control']} (worst ops {worst})")
    run.log(f"reference {run.records['reference_s']:.1f}s over "
            f"{len(kinds)} ops: {sorted(kinds)}")
    return numbers
