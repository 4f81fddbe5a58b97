"""Serving traffic: a closed loop with one client sending batches of
host images through ``ServingEngine`` and fetching the logits to the
host before its next request.

Mix parameters: ``batch`` (images a request), ``pool`` (distinct host
arrays the requests cycle through), ``warmup`` (requests in set-up),
``traced_requests`` and ``traced_after`` (the traced sub-window),
``check_requests`` (window requests the check samples) and
``host_threads`` (read by the harness).

Set-up draws the weights and the pool from the seed on the device,
copies the pool to host memory (pageable numpy arrays, as a caller hands
them), calibrates the serving qstate by min-max on the first request's
images with the float net (``model.serving_qstate``), builds the engine
and sends the warm-up requests.  A request runs from the call into the engine to its logits on
the host.  The check samples window requests from the seed and compares
their logits with the plain reference's on the same images.
"""
from __future__ import annotations

import random
import time

import numpy as np
import torch

from .. import model
from ..reference import serve as ref
from ..trace import profiled


def setup(run):
    from ptq4vit_tpu_torch import ServingEngine
    from ptq4vit_tpu_torch.models.registry import net_from_config
    mix, cfg, dev = run.mix, run.cfg, run.device
    if dev.type == "cuda":
        from ptq4vit_tpu_torch.ops import build
        build.build_all()
    params = model.make_params(cfg, run.seed, dev)
    b, n = mix["batch"], mix["pool"]
    imgs = model.make_images(b * n, cfg, run.seed, dev)
    plain = model.serving_qstate(params, cfg, imgs[:b],
                                 tuple(mix.get("bits", (8, 8))))
    net = net_from_config(model.port_config(cfg, run.cell.config["name"]),
                          params)
    engine = ServingEngine(net, model.port_qstate(plain, cfg), device=dev)
    imgs = imgs.cpu().numpy()
    pool = [np.ascontiguousarray(imgs[i * b:(i + 1) * b]) for i in range(n)]
    del imgs
    run.state.update(params=params, plain=plain, engine=engine, pool=pool)
    for i in range(mix.get("warmup", 3)):
        engine(pool[i % n]).cpu()


def window(run):
    st, mix, dev = run.state, run.mix, run.device
    engine, pool = st["engine"], st["pool"]
    lat, outs, spans = [], [], []
    k0 = mix.get("traced_after", 5)
    k1 = k0 + mix.get("traced_requests", 20)
    prof, out = None, {}
    start = time.time()
    i = 0
    while time.time() - start < run.seconds or (
            run.traced and prof is not None):
        if run.traced and i == k0:
            prof = profiled(dev, out)
            prof.__enter__()
            t_tr = time.perf_counter()
        run.attempted += 1
        t0 = time.perf_counter()
        try:
            logits = engine(pool[i % len(pool)]).cpu()
        except Exception as e:                       # counted, not hidden
            run.failed += 1
            run.log(f"request failed: {type(e).__name__}: {e}")
            logits = None
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        spans.append((t0, t1))
        outs.append(logits)
        i += 1
        if prof is not None and i == k1:
            run.records["traced_s"] = time.perf_counter() - t_tr
            prof.__exit__(None, None, None)
            run.trace = out["trace"]
            run.records["traced_n"] = k1 - k0
            prof = None
    end = spans[-1][1]
    run.records.update(latency=lat, outs=outs, spans=spans,
                       traced=range(k0, k1) if run.traced else range(0))
    images = sum(o.shape[0] for o in outs if o is not None)
    wall = end - spans[0][0]
    run.records["wall_s"] = wall
    run.records["images"] = images
    run.e2e["serve_img_s"] = images / wall
    run.e2e["serve_p95_ms"] = float(np.percentile(np.array(lat) * 1e3, 95))
    run.log(f"{len(lat)} requests, {images} images in {wall:.3f}s; "
            f"latency ms median {np.median(lat) * 1e3:.3f}")
    if run.records.get("traced_n"):
        rest = [t for i, t in enumerate(lat) if i not in range(k0, k1)]
        run.log(f"traced: {run.records['traced_s'] / (k1 - k0) * 1e3:.3f}"
                f" ms a request, untraced median "
                f"{np.median(rest) * 1e3:.3f} ms")


def release(run):
    run.state.pop("engine", None)


def check(run):
    """The widest logit error and top-1 gap over the sampled requests;
    with ``run.control`` also the control's (float8 activations) on the
    same images, into ``run.records["control"]``."""
    st, mix = run.state, run.mix
    outs = run.records["outs"]
    done = [i for i, o in enumerate(outs) if o is not None]
    if not done:
        return {k: float("inf") for k in run.cell.limits}
    rng = random.Random(run.seed)
    k = min(mix.get("check_requests", 4), len(done))
    by_pool = {}
    for i in rng.sample(done, len(done)):
        by_pool.setdefault(i % len(st["pool"]), i)
    picks = sorted(by_pool.values())[:k]
    if len(picks) < k:
        picks += rng.sample([i for i in done if i not in picks],
                            k - len(picks))
    t0 = time.time()
    numbers, control = {}, {}
    for i in picks:
        x = st["pool"][i % len(st["pool"])]
        r = ref.logits(st["params"], run.cfg, st["plain"], x)
        for name, v in ref.judge(outs[i], r).items():
            numbers[name] = max(numbers.get(name, 0.0), v)
        if run.control:
            c = ref.logits(st["params"], run.cfg, st["plain"], x,
                           control=True)
            for name, v in ref.judge(c, r).items():
                control[name] = max(control.get(name, 0.0), v)
    run.records["reference_s"] = time.time() - t0
    if run.control:
        run.records["control"] = control
        run.log(f"control: {control}")
    run.log(f"check of requests {picks}: {numbers} "
            f"(reference {run.records['reference_s']:.1f}s)")
    return numbers
