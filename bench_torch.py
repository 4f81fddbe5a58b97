#!/usr/bin/env python
"""Headline benchmark of the PyTorch / CUDA port: full PTQ4ViT
calibration (hessian metric, twin quantizers, eq_n=100, 3 search rounds)
of ViT-B/384 with 32 calibration images, wall-clock minutes on one card.
The counterpart of ``bench.py`` on ``ptq4vit_tpu_torch``.

    python bench_torch.py                                   # the card
    BENCH_MODEL=swin_base_patch4_window12_384 python bench_torch.py
    PTQ4VIT_TPU_INT8_SCORE=0 python bench_torch.py          # exact scoring
    BENCH_DEVICE=cpu BENCH_CALIB=2 BENCH_MODEL=vit_tiny_patch16_224 \
        python bench_torch.py

It times ``HessianQuantCalibrator(net, cfg, calib, sequential=...,
batch_size=4, cache_dtype=...).batching_quant_calib()`` on
``synthetic_images(CALIB, img_size, seed=3)`` with random weights from a
seeded generator, on the host clock, the qstate brought to the host
before the clock stops.  Calibration time does not depend on the weights'
values, so random weights time what a checkpoint would.  The kernel
libraries are built before the first repeat (``build_s``); run 1 still
pays first-call allocations and is left out of ``median``.

Knobs, from the environment as bench.py takes them: ``BENCH_MODEL``,
``BENCH_CALIB`` (32), ``BENCH_CONFIG`` (PTQ4ViT), ``BENCH_BITS`` ("8,8"),
``BENCH_METRIC`` (hessian, or "config" for the config's own metric),
``BENCH_SEQUENTIAL`` ("1"), ``BENCH_CACHE_DTYPE`` ("bfloat16"),
``BENCH_REPEATS`` (2); the port's own: ``PTQ4VIT_TPU_INT8_SCORE=0``
(exact scoring, ``int8_score=False``; the JAX package's switch) and
``BENCH_DEVICE`` (the card by default; "cpu" runs on the CPU).  Settings
other than the default suffix the metric name, so rows never mix cells.
Without a card, and without ``BENCH_DEVICE=cpu``, the run fails.

stdout contract (every line is JSON; consumers take the LAST one):
  1. an interim startup line ({"interim": true, "startup": true, ...})
     printed before torch is imported;
  2. the final row: "value" (best-of minutes), "median" and
     "warm_minutes" over the repeats after the first, "all_minutes",
     "capture_s", "search_s", "target_s", "sync_s", "other_s",
     "overlap_s" (of the best run), "peak_gib" (the highest
     ``torch.cuda.max_memory_allocated`` of a repeat, null on the CPU),
     "card" (nvidia-smi's name and power limit), "device" and
     "vs_baseline" (the reference README's own minutes, taken on the
     reference's GPU, over this run's).
Per-repeat rows go to stderr, each with its minutes, "peak_gib", capture
and search seconds, "num_groups" (capture passes), "chunked_ops" (ops
whose search kernels the calibrator ran in candidate chunks) and
"chunked_calls" (kernel calls so cut).  A run that fails anywhere, one
repeat included, ends in a final row with "value": null and "error", and
exits non-zero.
"""
import dataclasses
import json
import os
import sys
import time

# the reference's published calibration minutes (README.md:28-40) per
# (model, calib size), taken on the reference's own GPU; bench.py:48-60
_BASELINES = {
    "vit_small_patch32_224": {32: 2, 128: 5},
    "vit_small_patch16_224": {32: 3, 128: 7},
    "vit_base_patch16_224": {32: 4, 128: 13},
    "vit_base_patch16_384": {32: 12, 128: 43},
    "deit_small_patch16_224": {32: 3, 128: 7},
    "deit_base_patch16_224": {32: 4, 128: 16},
    "deit_base_patch16_384": {32: 14, 128: 52},
    "swin_tiny_patch4_window7_224": {32: 3, 128: 9},
    "swin_small_patch4_window7_224": {32: 8, 128: 17},
    "swin_base_patch4_window7_224": {32: 10, 128: 23},
    "swin_base_patch4_window12_384": {32: 25, 128: 69},
}


@dataclasses.dataclass(frozen=True)
class Knobs:
    model: str = "vit_base_patch16_384"
    calib: int = 32
    config: str = "PTQ4ViT"
    bits: tuple = (8, 8)
    metric: str = "hessian"
    sequential: bool = False
    cache_dtype: str = ""
    repeats: int = 2
    exact: bool = False
    device: str = "cuda"


def knobs(env) -> Knobs:
    """The run's settings from an environment mapping."""
    bits = tuple(int(b) for b in env.get("BENCH_BITS", "8,8").split(","))
    if len(bits) != 2:
        raise ValueError(f"BENCH_BITS must be 'w,a' (two ints), got "
                         f"{env['BENCH_BITS']!r}")
    return Knobs(model=env.get("BENCH_MODEL", Knobs.model),
                 calib=int(env.get("BENCH_CALIB", Knobs.calib)),
                 config=env.get("BENCH_CONFIG", Knobs.config),
                 bits=bits,
                 metric=env.get("BENCH_METRIC", Knobs.metric),
                 sequential=env.get("BENCH_SEQUENTIAL") == "1",
                 cache_dtype=env.get("BENCH_CACHE_DTYPE", ""),
                 repeats=max(1, int(env.get("BENCH_REPEATS",
                                            Knobs.repeats))),
                 exact=env.get("PTQ4VIT_TPU_INT8_SCORE") == "0",
                 device=env.get("BENCH_DEVICE", Knobs.device))


def metric_name(k: Knobs) -> str:
    """bench.py's metric name for the same knobs (bench.py:240-252), then
    the port's suffixes."""
    metric = f"ptq4vit_calib_minutes_{k.model}_{k.calib}imgs"
    if k.config != "PTQ4ViT":
        metric += f"_{k.config.lower()}"
    if k.bits != (8, 8):
        metric += f"_w{k.bits[0]}a{k.bits[1]}"
    if k.metric != "hessian":
        metric += f"_{k.metric}"
    if k.sequential:
        metric += "_sequential"
    if k.exact:
        metric += "_exact"
    return metric


def baseline_minutes(k: Knobs):
    """The reference's published minutes for this cell, or None: they are
    PTQ4ViT W8A8 parallel calibrations."""
    if k.config != "PTQ4ViT" or k.bits != (8, 8) or k.sequential:
        return None
    b = _BASELINES.get(k.model, {}).get(k.calib)
    return float(b) if b is not None else None


def card_line():
    """nvidia-smi's name and power limit of the first card, or None."""
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def make_config(k: Knobs):
    """The cell's QuantConfig, through the reference grid's cfg_modifier
    as bench.py applies it (bench.py:302-312)."""
    from ptq4vit_tpu_torch.configs import apply_modifier, get_config
    cfg = get_config(k.config)
    return apply_modifier(cfg, bit_setting=k.bits,
                          metric=None if k.metric == "config" else k.metric)


def one_run(k: Knobs, net, calib, device):
    """One timed calibration: (minutes, report, qstate on the host,
    peak GiB or None, {the ops whose search kernels ran in candidate
    chunks, the kernel calls cut into chunks})."""
    import torch
    from ptq4vit_tpu_torch.calib.calibrator import HessianQuantCalibrator
    from ptq4vit_tpu_torch.ops import search_kernels
    from ptq4vit_tpu_torch.utils.convert import qstate_to
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    chunked = search_kernels.chunked_calls()
    t0 = time.time()
    calibrator = HessianQuantCalibrator(
        net, make_config(k), calib, sequential=k.sequential, batch_size=4,
        cache_dtype="bfloat16" if k.cache_dtype == "bfloat16" else None,
        device=device,
        int8_score=False if k.exact else None)
    qstate = qstate_to(calibrator.batching_quant_calib(verbose=False), "cpu")
    minutes = (time.time() - t0) / 60.0
    if len(qstate) != len(net.op_inventory):
        raise RuntimeError(f"the qstate has {len(qstate)} ops of "
                           f"{len(net.op_inventory)}")
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30 if cuda \
        else None
    return minutes, calibrator.report, qstate, peak, {
        "chunked_ops": len(calibrator.scratch_bounds),
        "chunked_calls": search_kernels.chunked_calls() - chunked}


def run(env=None, out=None, err=None):
    """The whole benchmark; returns (exit code, final row, the best run's
    qstate on the host or None).  Prints the stdout contract to ``out``
    and the per-repeat rows to ``err``."""
    env = os.environ if env is None else env
    out = sys.stdout if out is None else out
    err = sys.stderr if err is None else err

    def emit(stream, row):
        print(json.dumps(row), file=stream, flush=True)

    try:
        k = knobs(env)
    except ValueError as e:
        row = {"metric": None, "value": None, "unit": "min",
               "vs_baseline": None, "error": f"{type(e).__name__}: {e}"}
        emit(out, row)
        return 2, row, None
    metric = metric_name(k)
    baseline = baseline_minutes(k)
    # FIRST line out: parseable before torch is imported
    emit(out, {"metric": metric, "interim": True, "startup": True,
               "value": None, "unit": "min", "vs_baseline": None})
    runs, card, dev_name = [], None, None

    def failed(msg):
        row = {"metric": metric, "value": None, "unit": "min",
               "vs_baseline": None, "error": msg[:2000],
               "all_minutes": [m for m, *_ in runs], "card": card,
               "device": dev_name}
        emit(out, row)
        return 1, row, None

    try:
        import torch
        from ptq4vit_tpu_torch.models import get_net
        from ptq4vit_tpu_torch.models.registry import resolve_device
        device = resolve_device(k.device)     # no card: raises
        from ptq4vit_tpu_torch.utils.synthetic import synthetic_images
        build_s = 0.0
        if device.type == "cuda":
            from ptq4vit_tpu_torch.ops import build
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            card = card_line()
            dev_name = torch.cuda.get_device_name(device)
            _, build_s = build.build_all()
        else:
            dev_name = "cpu"
        net = get_net(k.model, seed=0, device=device)
        calib = synthetic_images(k.calib, net.cfg.img_size, seed=3)
    except Exception as e:      # the boundary: report, never a traceback
        return failed(f"setup: {type(e).__name__}: {e}")
    for i in range(k.repeats):
        try:
            runs.append(one_run(k, net, calib, device))
        except Exception as e:
            emit(err, {"metric": metric, "interim": True, "run": i + 1,
                       "error": f"{type(e).__name__}: {e}"[:2000]})
            return failed(f"run {i + 1}: {type(e).__name__}: {e}")
        minutes, report, _, peak, chunks = runs[-1]
        emit(err, {"metric": metric, "interim": True, "run": i + 1,
                   "value": minutes, "unit": "min", "peak_gib": peak,
                   "capture_s": report.capture_seconds,
                   "search_s": sum(report.search_seconds.values()),
                   "num_groups": report.num_groups, **chunks})
    best = min(range(len(runs)), key=lambda i: runs[i][0])
    minutes, r, qstate = runs[best][:3]
    warm = sorted(m for m, *_ in runs[1:]) or [runs[0][0]]
    median = warm[len(warm) // 2] if len(warm) % 2 else (
        warm[len(warm) // 2 - 1] + warm[len(warm) // 2]) / 2
    capture_s = r.capture_seconds
    search_s = sum(r.search_seconds.values())
    phases = capture_s + search_s + r.target_seconds + r.sync_seconds
    peaks = [run[3] for run in runs if run[3] is not None]
    row = {
        "metric": metric,
        "value": minutes,
        "unit": "min",
        "vs_baseline": baseline / minutes if baseline is not None else None,
        "median": median,
        "median_vs_baseline": (baseline / median if baseline is not None
                               else None),
        "warm_minutes": warm,
        "capture_s": capture_s,
        "search_s": search_s,
        "target_s": r.target_seconds,
        "sync_s": r.sync_seconds,
        "setup_s": r.setup_seconds,
        # the port's phases do not overlap; overlap_s stays as bench.py
        # reports it
        "other_s": max(0.0, minutes * 60 - phases),
        "overlap_s": max(0.0, phases - minutes * 60),
        "num_groups": r.num_groups,
        "all_minutes": [m for m, *_ in runs],
        "peak_gib": max(peaks) if peaks else None,
        "build_s": build_s,
        "card": card,
        "device": dev_name,
    }
    emit(out, row)
    return 0, row, qstate


def main():
    rc, _, _ = run()
    sys.exit(rc)


if __name__ == "__main__":
    main()
