#!/usr/bin/env python
"""Full benchmark grid of the PyTorch / CUDA port -- the counterpart of
``examples/test_all.py`` (the reference's example/test_all.py in
hahnyuan/PTQ4ViT) on ``ptq4vit_tpu_torch``: 13 models x calib {32, 128}
x bits {(8,8), (6,6)} x configs {PTQ4ViT, BasePTQ}, hessian metric on
every cell, with per-cell calibration timing.

    # the whole grid on the card, on an ImageFolder under DIR:
    python examples/torch_test_all.py --dataset_root DIR
    # part of it, random weights and gaussian images:
    python examples/torch_test_all.py --synthetic \\
        --names vit_base_patch16_384 --calib_sizes 128
    # on the CPU (tiny search):
    python examples/torch_test_all.py --synthetic --quick --device cpu ...

Prints one JSON line a cell on stdout with test_all.py's keys, and one
on stderr with the cell's peak device memory (``peak_gib``, null on the
CPU), capture passes (``num_groups``) and the ops and kernel calls run in
candidate chunks (``chunked_ops``, ``chunked_calls``).  ``--names`` /
``--calib_sizes`` keep a part of the grid, in the grid's order.  With
``--multiprocess`` the cells go to one spawned worker per card (one card:
one worker, the cells in order).  With random weights (``--synthetic``,
or no checkpoint in ``$PTQ4VIT_TPU_CKPT_DIR``) top-1 means nothing.
"""
import json
import os
import sys
import time
from itertools import product

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from torch_test_vit import (apply_quick, build_net_and_data,  # noqa: E402
                            init_config, multiprocess, parse_args,
                            test_classification)

from ptq4vit_tpu_torch.configs import apply_modifier  # noqa: E402


def peak_gib(net):
    """The peak device memory since the last reset, or None on the CPU."""
    import torch
    dev = net.params["head"]["weight"].device
    if dev.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(dev) / 2 ** 30


def reset_peak(net):
    import torch
    dev = net.params["head"]["weight"].device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def test_all(name, cfg_modifier=None, calib_size=32, config_name="PTQ4ViT",
             args=None):
    """One grid cell: build, calibrate (timed), evaluate, report.  Returns
    the stdout row with the net and the qstate."""
    from ptq4vit_tpu_torch.calib.calibrator import HessianQuantCalibrator
    from ptq4vit_tpu_torch.ops import search_kernels
    quant_cfg = init_config(config_name)
    if cfg_modifier is not None:
        quant_cfg = cfg_modifier(quant_cfg)
    apply_quick(quant_cfg, args)
    net, test_loader, calib = build_net_and_data(name, args, calib_size)

    reset_peak(net)
    chunked = search_kernels.chunked_calls()
    calib_start_time = time.time()
    calibrator = HessianQuantCalibrator(net, quant_cfg, calib,
                                        sequential=False, batch_size=4)
    qstate = calibrator.batching_quant_calib()
    calib_end_time = time.time()
    peak = peak_gib(net)

    acc = test_classification(net, test_loader, qstate=qstate,
                              max_iteration=args.max_iteration)

    # one JSON line per grid cell, test_all.py's keys
    row = {
        "model": name,
        "config": config_name,
        "calib_size": calib_size,
        "w_bit": quant_cfg.bit,
        "linear_kwargs": quant_cfg.ptqsl_linear_kwargs,
        "calib_minutes": (calib_end_time - calib_start_time) / 60,
        "capture_seconds": calibrator.report.capture_seconds,
        "search_seconds": sum(calibrator.report.search_seconds.values()),
        "top1": acc,
    }
    print(json.dumps(row), flush=True)
    print(json.dumps({"model": name, "config": config_name,
                      "calib_size": calib_size, "w_bit": quant_cfg.bit,
                      "peak_gib": peak,
                      "num_groups": calibrator.report.num_groups,
                      "chunked_ops": len(calibrator.scratch_bounds),
                      "chunked_calls": search_kernels.chunked_calls()
                      - chunked}),
          file=sys.stderr, flush=True)
    return {**row, "peak_gib": peak, "net": net, "qstate": qstate}


test_all.__test__ = False      # not a pytest test


class CfgModifier:
    """In-place config mutation (reference test_all.py:48-78)."""

    def __init__(self, **kwargs):
        for name, value in kwargs.items():
            setattr(self, name, value)

    def __call__(self, cfg):
        return apply_modifier(cfg, bit_setting=self.bit_setting,
                              linear_ptq_setting=self.linear_ptq_setting,
                              metric=self.metric)


cfg_modifier = CfgModifier  # reference-spelled alias


NAMES = [
    "vit_tiny_patch16_224",
    "vit_small_patch32_224",
    "vit_small_patch16_224",
    "vit_base_patch16_224",
    "vit_base_patch16_384",

    "deit_tiny_patch16_224",
    "deit_small_patch16_224",
    "deit_base_patch16_224",
    "deit_base_patch16_384",

    "swin_tiny_patch4_window7_224",
    "swin_small_patch4_window7_224",
    "swin_base_patch4_window7_224",
    "swin_base_patch4_window12_384",
]


def grid(args):
    """The cells of test_all.py's grid, in its order, as keyword dicts of
    ``test_all``; the ``--names`` / ``--calib_sizes`` filters keep a part
    of it."""
    metrics = ["hessian"]
    linear_ptq_settings = [(1, 1, 1)]  # n_V, n_H, n_a
    calib_sizes = [32, 128]
    bit_settings = [(8, 8), (6, 6)]   # weight, activation
    config_names = ["PTQ4ViT", "BasePTQ"]

    def keep(values, wanted):
        return [v for v in values if wanted is None or v in wanted]
    cfg_list = []
    for name, metric, lp, calib_size, bits, config_name in product(
            keep(NAMES, getattr(args, "names", None)), metrics,
            linear_ptq_settings,
            keep(calib_sizes, getattr(args, "calib_sizes", None)),
            bit_settings, config_names):
        cfg_list.append({
            "name": name,
            "cfg_modifier": CfgModifier(linear_ptq_setting=lp, metric=metric,
                                        bit_setting=bits),
            "calib_size": calib_size,
            "config_name": config_name,
            "args": args,
        })
    return cfg_list


def grid_filters(parser):
    parser.add_argument("--names", nargs="+", default=None,
                        help="keep these models of the grid")
    parser.add_argument("--calib_sizes", nargs="+", type=int, default=None)


if __name__ == "__main__":
    args = parse_args(grid_filters)
    cfg_list = grid(args)
    if args.multiprocess:
        multiprocess(test_all, cfg_list, n_workers=args.n_workers)
    else:
        for cfg in cfg_list:
            test_all(**cfg)
