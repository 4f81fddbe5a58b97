#!/usr/bin/env python
"""Calibration-seed stability study -- the counterpart of
``examples/stability.py`` (the reference's 20-seed robustness experiment,
README.md:74-75 in hahnyuan/PTQ4ViT) on ``ptq4vit_tpu_torch``:
recalibrate on K calibration subsets drawn with seeds 0..K-1 and report
the top-1 mean and std.

    python examples/torch_stability.py --dataset_root DIR --seeds 5
    python examples/torch_stability.py --synthetic --quick --device cpu

The subsets are stability.py's: ``synthetic_images(calib_size, img,
seed=seed)`` with ``--synthetic``, else the ImageFolder's
``calib_batch(num=calib_size, seed=seed)``.  With random weights
(``--synthetic``, or no checkpoint in ``$PTQ4VIT_TPU_CKPT_DIR``) top-1
means nothing: the run then exercises the path and says nothing of
accuracy or its spread.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

from torch_test_vit import (apply_quick, build_net_and_data,  # noqa: E402
                            init_config, parse_args, test_classification)


def calib_subset(net, args, seed):
    """The calibration images of ``seed``."""
    from ptq4vit_tpu_torch.utils.datasets import ViTImageNetLoaderGenerator
    from ptq4vit_tpu_torch.utils.synthetic import synthetic_images
    if args.synthetic:
        return synthetic_images(args.calib_size, net.cfg.img_size, seed=seed)
    g = ViTImageNetLoaderGenerator(args.dataset_root, "imagenet", 32, 32, 16,
                                   kwargs={"model": net})
    return g.calib_batch(num=args.calib_size, seed=seed)


def stability(name="vit_small_patch16_224", config="PTQ4ViT", seeds=5,
              args=None):
    """Top-1 of each seed's calibration; returns the list."""
    from ptq4vit_tpu_torch.calib.calibrator import HessianQuantCalibrator
    quant_cfg = apply_quick(init_config(config), args)
    accs = []
    for seed in range(seeds):
        net, test_loader, _ = build_net_and_data(name, args, args.calib_size)
        calib = calib_subset(net, args, seed)
        qstate = HessianQuantCalibrator(net, quant_cfg, calib,
                                        batch_size=4) \
            .batching_quant_calib(verbose=False)
        acc = test_classification(net, test_loader, qstate=qstate,
                                  max_iteration=args.max_iteration)
        accs.append(acc)
        print(f"seed {seed}: {acc:.4f}")
    print(f"mean {np.mean(accs):.4f} std {np.std(accs):.4f}")
    return accs


if __name__ == "__main__":
    args = parse_args(lambda p: (
        p.add_argument("--model", default="vit_small_patch16_224"),
        p.add_argument("--config", default="PTQ4ViT"),
        p.add_argument("--seeds", type=int, default=5)))
    stability(args.model, args.config, seeds=args.seeds, args=args)
