#!/usr/bin/env python
"""End-to-end serving throughput of the PyTorch / CUDA port: host images
in, logits on the host, the host-to-device copy inside the timed window.
The counterpart of ``scripts/serve_e2e_bench.py`` on
``ptq4vit_tpu_torch`` (``bench_infer_torch.py`` leaves the copy out).

    python scripts/torch_serve_e2e_bench.py                  # the card
    BENCH_MODEL=swin_base_patch4_window12_384 \\
        python scripts/torch_serve_e2e_bench.py
    BENCH_DEVICE=cpu BENCH_MODEL=vit_tiny_patch16_224 BENCH_BS=4 \
        BENCH_NBATCH=2 python scripts/torch_serve_e2e_bench.py

Four modes cross {f32, uint8 normalized on the device} x {sync, pipe}:
  f32_sync  -- float32 NCHW batches through ServingEngine, each batch's
               logits fetched before the next is sent;
  f32_pipe  -- every batch sent before any result is read;
  u8_sync   -- uint8 NCHW through ServingEngine(raw_uint8=True), which
               normalizes (x / 255 - mean) / std on the device (a quarter
               of the bytes to copy);
  u8_pipe   -- uint8, pipelined.
The engine copies each batch from pageable host memory
(``torch.as_tensor(x).to(device)``), which waits for the card's earlier
work, so "pipelined" modes may run no faster than the sync ones; the
numbers say how far.

Each batch is a distinct host numpy array: seeded uint8 images, and for
the f32 modes their host normalization with the net's data config (a
true division, as ``EvalTransform`` computes it).  So the two routes see
the same images, and ``u8_equals_f32`` reports whether their logits are
bitwise equal.  One untimed warm-up batch precedes each mode; the clock
stops when the last batch's logits are on the host.  The engines run on
``synthetic_qstate`` and random weights from a seeded generator: the
rates do not depend on either's values.  Knobs: ``BENCH_MODEL``,
``BENCH_BS`` (32), ``BENCH_NBATCH`` (8), ``BENCH_DEVICE`` (the card by
default; "cpu" runs the kernels' plain versions on the CPU; without a
card and without it the run fails).

Prints ONE JSON line: img/s per mode, the card's name and power limit.
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from bench_torch import card_line  # noqa: E402

MODES = ("f32_sync", "f32_pipe", "u8_sync", "u8_pipe")


def batches(data_config, bs, nb, img, seed=0):
    """(uint8 batches, their float32 host normalization), ``nb`` distinct
    arrays each."""
    rng = np.random.default_rng(seed)
    mean = np.asarray(data_config.mean, np.float32).reshape(1, 3, 1, 1)
    std = np.asarray(data_config.std, np.float32).reshape(1, 3, 1, 1)
    u8 = [rng.integers(0, 256, (bs, 3, img, img), dtype=np.uint8)
          for _ in range(nb)]
    f32 = [((b.astype(np.float32) / np.float32(255.0)) - mean) / std
           for b in u8]
    return u8, f32


def serve(engine, batches, pipelined, device):
    """img/s of ``batches`` through ``engine`` after one warm-up batch,
    and every batch's logits on the host."""
    import torch
    engine(batches[0]).cpu()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.time()
    if pipelined:
        outs = [engine(b) for b in batches]
        outs = [o.cpu() for o in outs]
    else:
        outs = [engine(b).cpu() for b in batches]
    wall = time.time() - t0
    return sum(len(b) for b in batches) / wall, outs


def run(env=None):
    """Returns (exit code, the JSON row, {mode: logits of every batch})."""
    env = os.environ if env is None else env
    model = env.get("BENCH_MODEL", "vit_base_patch16_384")
    bs = int(env.get("BENCH_BS", "32"))
    nb = int(env.get("BENCH_NBATCH", "8"))
    row = {"metric": f"serve_e2e_images_per_s_{model}_bs{bs}",
           "unit": "img/s"}
    logits = {}
    try:
        import torch
        from ptq4vit_tpu_torch import ServingEngine
        from ptq4vit_tpu_torch.configs import ptq4vit
        from ptq4vit_tpu_torch.models import get_net
        from ptq4vit_tpu_torch.models.registry import resolve_device
        from ptq4vit_tpu_torch.utils.synthetic import synthetic_qstate
        device = resolve_device(env.get("BENCH_DEVICE", "cuda"))
        if device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        row.update(card=card_line() if device.type == "cuda" else None,
                   device=(torch.cuda.get_device_name(device)
                           if device.type == "cuda" else "cpu"))
        net = get_net(model, seed=0, device=device)
        qstate = synthetic_qstate(net, ptq4vit())
        u8, f32 = batches(net.data_config, bs, nb, net.cfg.img_size)
        engines = {"f32": ServingEngine(net, qstate, device=device),
                   "u8": ServingEngine(net, qstate, raw_uint8=True,
                                       device=device)}
        for mode in MODES:
            route, how = mode.split("_")
            row[mode], logits[mode] = serve(
                engines[route], u8 if route == "u8" else f32, how == "pipe",
                device)
            if not all(torch.isfinite(o.float()).all()
                       for o in logits[mode]):
                raise RuntimeError(f"{mode}: logits are not finite")
    except Exception as e:      # the boundary: report, never a traceback
        row.update(value=None, error=f"{type(e).__name__}: {e}"[:2000])
        print(json.dumps(row), flush=True)
        return 1, row, logits
    row["u8_pipe_vs_f32_sync"] = row["u8_pipe"] / row["f32_sync"]
    row["u8_equals_f32"] = all(
        torch.equal(a, b) for a, b in zip(logits["u8_sync"],
                                          logits["f32_sync"]))
    print(json.dumps(row), flush=True)
    return 0, row, logits


def main():
    rc, _, _ = run()
    sys.exit(rc)


if __name__ == "__main__":
    main()
