#!/usr/bin/env python
"""Serving-throughput benchmark of the PyTorch / CUDA port: images/s of
the quantized ViT-B/384 forward in each execution mode, the input
resident on the card (the host-to-device copy is left out; see
``scripts/torch_serve_e2e_bench.py`` for the copy included).  The
counterpart of ``bench_infer.py`` on ``ptq4vit_tpu_torch``.

    python bench_infer_torch.py                              # the card
    BENCH_MODEL=swin_base_patch4_window12_384 python bench_infer_torch.py
    BENCH_DEVICE=cpu BENCH_MODEL=vit_tiny_patch16_224 BENCH_BS=4 \
        BENCH_ITERS=1 python bench_infer_torch.py

Modes (bench_infer.py:54-77): ``fp32`` and ``bf16`` (the raw net),
``fake_quant``, ``int8`` (exact int8 ops) and ``int8_bf16``,
``int8_packed_bf16`` (the same from packed weights) and
``int8_fused_bf16`` (the fused kernels, as ``ServingEngine`` runs them),
``int8_fused_relaxed_bf16`` (the same with the kernels' relaxed bf16
epilogues, ``ServingEngine(relaxed=True)``: not bitwise the exact path,
levels within a step) and ``int8_fused_vs_bf16``.

The qstate is ``synthetic_qstate`` (weight statistics, placeholder
activation intervals) and the weights are random from a seeded generator:
the rates do not depend on either's values.  The input is a seeded
gaussian batch on the device.  Each mode makes one untimed warm-up call,
then ``BENCH_ITERS`` timed calls; the clock stops on
``torch.cuda.synchronize()``.  Knobs: ``BENCH_MODEL``, ``BENCH_BS`` (32),
``BENCH_ITERS`` (10), ``BENCH_BITS`` (8, or 6 for the W6A6 grid half),
``BENCH_DEVICE`` (the card by default; "cpu" runs the kernels' plain
versions on the CPU; without a card and without it the run fails).

Prints ONE JSON line: img/s per mode, the card's name and power limit.
A failed run prints the line with "value": null and "error", and exits
non-zero.
"""
import json
import os
import sys
import time

from bench_torch import card_line

MODES = ("fp32", "bf16", "fake_quant", "int8", "int8_bf16",
         "int8_packed_bf16", "int8_fused_bf16", "int8_fused_relaxed_bf16")


def forwards(net, qstate, packed):
    """{mode: forward(x) -> logits} of every mode."""
    import torch
    bf16 = torch.bfloat16
    return {
        "fp32": lambda x: net.apply(x),
        "bf16": lambda x: net.apply(x, compute_dtype=bf16),
        "fake_quant": lambda x: net.apply(x, qstate=qstate),
        "int8": lambda x: net.apply(x, qstate=qstate, int8=True),
        "int8_bf16": lambda x: net.apply(x, qstate=qstate, int8=True,
                                         compute_dtype=bf16),
        "int8_packed_bf16": lambda x: net.apply(
            x, qstate=qstate, int8=True, packed=packed, compute_dtype=bf16),
        "int8_fused_bf16": lambda x: net.apply(
            x, qstate=qstate, int8="fused", packed=packed,
            compute_dtype=bf16),
        "int8_fused_relaxed_bf16": lambda x: net.apply(
            x, qstate=qstate, int8="fused_relaxed", packed=packed,
            compute_dtype=bf16),
    }


def setup(model, bs, bits, device):
    """(net, qstate, packed, x): the seeded net, its synthetic qstate and
    packed weights, and a seeded batch, all on ``device``."""
    import torch
    from ptq4vit_tpu_torch.configs import ptq4vit
    from ptq4vit_tpu_torch.models import get_net
    from ptq4vit_tpu_torch.ops.pack import pack_weights
    from ptq4vit_tpu_torch.utils.synthetic import (synthetic_images,
                                                   synthetic_qstate)
    net = get_net(model, seed=0, device=device)
    qstate = synthetic_qstate(net, ptq4vit().set_bits(bits, bits))
    packed = pack_weights(net.params, qstate)
    x = torch.from_numpy(synthetic_images(bs, net.cfg.img_size,
                                          seed=0)).to(device)
    return net, qstate, packed, x


def timed(fn, x, iters, device):
    """img/s of ``iters`` calls after one untimed warm-up, and the last
    call's logits."""
    import torch

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    with torch.no_grad():
        fn(x)
        sync()
        t0 = time.time()
        for _ in range(iters):
            out = fn(x)
        sync()
    return len(x) * iters / (time.time() - t0), out


def run(env=None):
    """Returns (exit code, the JSON row, {mode: last logits})."""
    env = os.environ if env is None else env
    model = env.get("BENCH_MODEL", "vit_base_patch16_384")
    bs = int(env.get("BENCH_BS", "32"))
    iters = int(env.get("BENCH_ITERS", "10"))
    bits = int(env.get("BENCH_BITS", "8"))
    row = {"metric": f"infer_images_per_s_{model}_bs{bs}"
                     + (f"_w{bits}a{bits}" if bits != 8 else ""),
           "unit": "img/s"}
    logits = {}
    try:
        import torch
        from ptq4vit_tpu_torch.models.registry import resolve_device
        device = resolve_device(env.get("BENCH_DEVICE", "cuda"))
        if device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        row.update(card=card_line() if device.type == "cuda" else None,
                   device=(torch.cuda.get_device_name(device)
                           if device.type == "cuda" else "cpu"))
        net, qstate, packed, x = setup(model, bs, bits, device)
        for mode, fn in forwards(net, qstate, packed).items():
            row[mode], logits[mode] = timed(fn, x, iters, device)
            if not torch.isfinite(logits[mode].float()).all():
                raise RuntimeError(f"{mode}: logits are not finite")
    except Exception as e:      # the boundary: report, never a traceback
        row.update(value=None, error=f"{type(e).__name__}: {e}"[:2000])
        print(json.dumps(row), flush=True)
        return 1, row, logits
    row["int8_fused_vs_bf16"] = row["int8_fused_bf16"] / row["bf16"]
    print(json.dumps(row), flush=True)
    return 0, row, logits


def main():
    rc, _, _ = run()
    sys.exit(rc)


if __name__ == "__main__":
    main()
