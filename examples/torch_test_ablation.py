#!/usr/bin/env python
"""Ablation grid of the PyTorch / CUDA port -- the counterpart of
``examples/test_ablation.py`` (the reference's example/test_ablation.py
in hahnyuan/PTQ4ViT) on ``ptq4vit_tpu_torch``: metric {hessian, cosine}
x no_softmax x no_postgelu x bits, search_round 3.

    python examples/torch_test_ablation.py --dataset_root DIR   # the card
    python examples/torch_test_ablation.py --synthetic --quick --device cpu

Prints one JSON line a cell with test_ablation.py's keys.  With
``--multiprocess`` the cells go to one spawned worker per card.  With
random weights (``--synthetic``, or no checkpoint in
``$PTQ4VIT_TPU_CKPT_DIR``) top-1 means nothing.
"""
import json
import os
import sys
from itertools import product

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from torch_test_vit import (apply_quick, build_net_and_data,  # noqa: E402
                            init_config, multiprocess, parse_args,
                            test_classification)

from ptq4vit_tpu_torch.configs import apply_modifier  # noqa: E402


def test_all_ablation(name, cfg_modifier=None, calib_size=32, args=None):
    """One ablation cell: build, calibrate, evaluate, report.  Returns the
    stdout row with the net and the qstate."""
    from ptq4vit_tpu_torch.calib.calibrator import HessianQuantCalibrator
    quant_cfg = init_config("PTQ4ViT")
    if cfg_modifier is not None:
        quant_cfg = cfg_modifier(quant_cfg)
    apply_quick(quant_cfg, args)
    net, test_loader, calib = build_net_and_data(name, args, calib_size)
    calibrator = HessianQuantCalibrator(net, quant_cfg, calib,
                                        sequential=False, batch_size=4)
    qstate = calibrator.batching_quant_calib()
    acc = test_classification(net, test_loader, qstate=qstate,
                              max_iteration=args.max_iteration)
    # one JSON line per ablation cell, test_ablation.py's keys
    row = {
        "model": name,
        "calib_size": calib_size,
        "w_bit": quant_cfg.bit,
        "metric": quant_cfg.ptqsl_linear_kwargs["metric"],
        "no_softmax": quant_cfg.no_softmax,
        "no_postgelu": quant_cfg.no_postgelu,
        "top1": acc,
    }
    print(json.dumps(row), flush=True)
    return {**row, "net": net, "qstate": qstate}


test_all_ablation.__test__ = False      # not a pytest test


class CfgModifier:
    def __init__(self, **kwargs):
        for name, value in kwargs.items():
            setattr(self, name, value)

    def __call__(self, cfg):
        return apply_modifier(cfg, bit_setting=self.bit_setting,
                              linear_ptq_setting=self.linear_ptq_setting,
                              metric=self.metric,
                              search_round=self.search_round,
                              no_softmax=self.no_softmax,
                              no_postgelu=self.no_postgelu)


cfg_modifier = CfgModifier  # reference-spelled alias


def grid(args):
    """The cells of test_ablation.py's grid, in its order, as keyword
    dicts of ``test_all_ablation``."""
    names = [
        "vit_small_patch16_224",
        "vit_base_patch16_224",
        "vit_base_patch16_384",
    ]
    metrics = ["hessian", "cosine"]
    linear_ptq_settings = [(1, 1, 1)]
    search_rounds = [3]
    calib_sizes = [32]
    bit_settings = [(8, 8), (6, 6)]
    no_softmaxs = [True, False]
    no_postgelus = [True, False]

    cfg_list = []
    for (name, metric, lp, sr, calib_size, bits, nsm,
         npg) in product(names, metrics, linear_ptq_settings, search_rounds,
                         calib_sizes, bit_settings, no_softmaxs, no_postgelus):
        cfg_list.append({
            "name": name,
            "cfg_modifier": CfgModifier(
                linear_ptq_setting=lp, metric=metric, search_round=sr,
                bit_setting=bits, no_softmax=nsm, no_postgelu=npg),
            "calib_size": calib_size,
            "args": args,
        })
    return cfg_list


if __name__ == "__main__":
    args = parse_args()
    cfg_list = grid(args)
    if args.multiprocess:
        multiprocess(test_all_ablation, cfg_list, n_workers=args.n_workers)
    else:
        for cfg in cfg_list:
            test_all_ablation(**cfg)
