#!/usr/bin/env python
"""How far ``int8="fused_relaxed"`` moves the logits of the PyTorch / CUDA
port from its exact fused path.  The counterpart of
``scripts/relaxed_divergence.py`` on ``ptq4vit_tpu_torch``.

    python scripts/torch_relaxed_divergence.py [n_instances] [out.json]
    python scripts/torch_relaxed_divergence.py 4 --device cpu

The same instances: alternately a tiny ViT (32 px, patch 8, embed 128,
depth 2, heads 2) and a tiny windowed Swin (32 px, patch 2, embed 128,
depths (2, 2), heads (2, 4), window 4: heads of 64 in both stages), each
with random weights from a numpy generator seeded with its index,
calibrated by PTQ4ViT W8A8 with the search shrunk (eq_n 8, one round) on
4 seeded images, then 32 seeded images through the fused forward, exact
and relaxed.  Prints, for each instance and over all of them, the max and
mean logit shift as a share of the instance's max |exact logit|, and the
top-1 flips; every block must take the fused path in both modes.  The
port's weights are not the JAX package's (its generator is numpy's), so
the instances are alike in shape, not in value.  Runs on the card by
default (``--device cpu``: the kernels' plain versions); without a card
and without it the run fails.  Prints ONE JSON line last.
"""
import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def make_net(i, device):
    """Instance i: the tiny ViT (even i) or the tiny Swin (odd i)."""
    from ptq4vit_tpu_torch.models import net_from_config, swin, vit
    from ptq4vit_tpu_torch.models.registry import DataConfig
    if i % 2 == 0:
        cfg, mod = vit.ViTConfig(name=f"rlx{i}", img_size=32, patch_size=8,
                                 embed_dim=128, depth=2, num_heads=2,
                                 num_classes=10), vit
    else:
        cfg, mod = swin.SwinConfig(name=f"rlx{i}", img_size=32,
                                   patch_size=2, embed_dim=128,
                                   depths=(2, 2), num_heads=(2, 4),
                                   window_size=4, num_classes=10), swin
    params = mod.init_params(cfg, np.random.default_rng(i), device=device)
    return net_from_config(cfg, params, DataConfig(32, 1.0, (0.5,) * 3,
                                                   (0.5,) * 3))


def small_ptq4vit():
    """PTQ4ViT with the search shrunk as the JAX script's ``small_cfg``
    (eq_n 8, one round)."""
    from ptq4vit_tpu_torch.configs import ptq4vit
    cfg = ptq4vit()
    for kw in (cfg.ptqsl_conv2d_kwargs, cfg.ptqsl_linear_kwargs,
               cfg.ptqsl_matmul_kwargs):
        kw["eq_n"], kw["search_round"] = 8, 1
    return cfg


def run(n_inst, device):
    import torch
    from ptq4vit_tpu_torch.calib.calibrator import HessianQuantCalibrator
    from ptq4vit_tpu_torch.models.registry import resolve_device
    from ptq4vit_tpu_torch.ops import int8_serve as ser
    from ptq4vit_tpu_torch.ops.pack import pack_weights
    device = resolve_device(device)
    rng = np.random.default_rng(7)
    flips = total = 0
    max_shift, mean_shifts, instances = 0.0, [], []
    for i in range(n_inst):
        net = make_net(i, device)
        calib = rng.standard_normal((4, 3, 32, 32)).astype(np.float32)
        qstate = HessianQuantCalibrator(net, small_ptq4vit(), calib,
                                        batch_size=2, device=device) \
            .batching_quant_calib()
        packed = pack_weights(net.params, qstate)
        x = torch.from_numpy(rng.standard_normal((32, 3, 32, 32))
                             .astype(np.float32)).to(device)
        hits = {"n": 0}
        saved = {f: getattr(ser, f)
                 for f in ("fused_swin_block", "fused_vit_block")}
        for fname, orig in saved.items():
            def spy(*a, _o=orig, **kw):
                r = _o(*a, **kw)
                hits["n"] += r is not None
                return r
            setattr(ser, fname, spy)
        try:
            with torch.no_grad():
                exact = net.apply(x, qstate=qstate, int8="fused",
                                  packed=packed).double().cpu().numpy()
                relaxed = net.apply(x, qstate=qstate, int8="fused_relaxed",
                                    packed=packed).double().cpu().numpy()
        finally:
            for fname, orig in saved.items():
                setattr(ser, fname, orig)
        blocks = (sum(net.cfg.depths) if hasattr(net.cfg, "depths")
                  else net.cfg.depth)
        if hits["n"] != 2 * blocks:
            raise RuntimeError(f"{net.name}: {hits['n']} of {2 * blocks} "
                               "blocks took the fused path")
        shift = np.abs(relaxed - exact) / max(np.abs(exact).max(), 1e-9)
        f = int((relaxed.argmax(-1) != exact.argmax(-1)).sum())
        max_shift = max(max_shift, float(shift.max()))
        mean_shifts.append(float(shift.mean()))
        flips += f
        total += exact.shape[0]
        instances.append({"net": "vit" if i % 2 == 0 else "swin",
                          "max_shift": float(shift.max()),
                          "mean_shift": float(shift.mean()), "flips": f})
        print(f"instance {i}: max_shift={shift.max():.4f} "
              f"flips={f}/{exact.shape[0]}", flush=True)
    return {"n_instances": n_inst, "images_per_instance": 32,
            "families": "alternating tiny-ViT / tiny windowed-Swin",
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
            "top1_flips": flips, "top1_total": total,
            "max_logit_shift_rel": max_shift,
            "mean_logit_shift_rel": float(np.mean(mean_shifts)),
            "instances": instances}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_instances", nargs="?", type=int, default=5)
    ap.add_argument("out", nargs="?", default=None)
    ap.add_argument("--device", default=None,
                    help="the card by default; cpu for the plain versions")
    args = ap.parse_args()
    result = run(args.n_instances, args.device)
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
