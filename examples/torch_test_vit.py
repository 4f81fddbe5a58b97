#!/usr/bin/env python
"""Basic experiment script of the PyTorch / CUDA port, and the helpers
its other example scripts share: the counterpart of
``examples/test_vit.py`` (the reference's example/test_vit.py in
hahnyuan/PTQ4ViT) on ``ptq4vit_tpu_torch`` -- parse_args, init_config,
apply_quick, test_classification, experiment-level multiprocessing,
build_net_and_data, experiment_basic.  The other drivers beside it:
``torch_test_all.py``, ``torch_test_ablation.py``, ``torch_get_int.py``
and ``torch_stability.py``.

    # on the card, an ImageFolder with train/ and val/ under the root:
    python examples/torch_test_vit.py --dataset_root /datasets/imagenet
    # random weights and gaussian images, a shrunken search, on the CPU:
    python examples/torch_test_vit.py --synthetic --quick --device cpu

Weights come from ``$PTQ4VIT_TPU_CKPT_DIR`` (a converted timm checkpoint,
see ``ptq4vit_tpu_torch/utils/timm_port.py``) when one is there, else from
a seeded random init.  ``--checkpoint_dir`` makes each calibration
resumable.  With ``--multiprocess`` one spawned worker per card pulls
whole experiments from a queue, each seeing one card through
``CUDA_VISIBLE_DEVICES``.
"""
import argparse
import multiprocessing
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402


def parse_args(extra=None, argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--n_workers", "--n_gpu", type=int, default=1,
                        help="worker processes for experiment parallelism")
    parser.add_argument("--multiprocess", action="store_true")
    parser.add_argument("--dataset_root", default="/datasets/imagenet")
    parser.add_argument("--synthetic", action="store_true",
                        help="random weights + synthetic data (no ImageNet)")
    parser.add_argument("--calib_size", type=int, default=32)
    parser.add_argument("--max_iteration", type=int, default=None)
    parser.add_argument("--quick", action="store_true",
                        help="shrink the search (eq_n=8, 1 round) for smoke "
                             "tests")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card; 'cpu' runs "
                             "on the CPU)")
    parser.add_argument("--checkpoint_dir", default=None,
                        help="per-op calibration checkpoints: resume from "
                             "the ops found there")
    if extra:
        extra(parser)
    return parser.parse_args(argv)


def init_config(config_name, **overrides):
    """Config loader (reference test_vit.py:82-90)."""
    from ptq4vit_tpu_torch.configs import get_config
    return get_config(config_name, **overrides)


def apply_quick(quant_cfg, args):
    """``--quick``: shrink the search to eq_n=8 and one round (smoke
    runs, not the job)."""
    if getattr(args, "quick", False):
        for kw in (quant_cfg.ptqsl_conv2d_kwargs, quant_cfg.ptqsl_linear_kwargs,
                   quant_cfg.ptqsl_matmul_kwargs):
            kw.update(eq_n=8, search_round=1)
    return quant_cfg


def test_classification(net, test_loader, qstate=None, max_iteration=None,
                        description=None, device=None):
    """Top-1 eval loop (reference test_vit.py:26-45) through the port's
    ``Evaluator``."""
    from ptq4vit_tpu_torch.parallel import Evaluator
    ev = Evaluator(net, qstate=qstate, device=device)
    acc = ev.evaluate(test_loader, max_iteration=max_iteration, verbose=True)
    print(acc)
    return acc


test_classification.__test__ = False      # not a pytest test


def process(pid, experiment_process, args_queue, n_workers):
    """Worker process (reference test_vit.py:47-62): sees one card, picked
    by ``pid`` from the parent's visible cards, before CUDA initializes."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    cards = visible.split(",") if visible else [str(i) for i in
                                                range(n_workers)]
    os.environ["CUDA_VISIBLE_DEVICES"] = cards[pid % len(cards)]
    tot_run = 0
    while args_queue.qsize():
        try:
            test_args = args_queue.get(timeout=1)
        except Exception:
            break
        print(f"Run {test_args} on pid={pid}")
        experiment_process(**test_args)
        time.sleep(0.5)
        tot_run += 1
    print(f"{pid} tot_run {tot_run}")


def multiprocess(experiment_process, cfg_list=None, n_workers=1,
                 start_method="spawn"):
    """Queue-based experiment parallelism (reference test_vit.py:65-80).
    Workers are spawned, not forked: each initializes CUDA on its own
    card, and a process that has initialized CUDA cannot fork."""
    ctx = multiprocessing.get_context(start_method)
    args_queue = ctx.Queue()
    for cfg in cfg_list:
        args_queue.put(cfg)
    ps = []
    for pid in range(n_workers):
        p = ctx.Process(
            target=process,
            args=(pid, experiment_process, args_queue, n_workers))
        p.start()
        ps.append(p)
    for p in ps:
        p.join()


def build_net_and_data(name, args, calib_size):
    """Model + (test_loader, calib_batch) on ``args.device``; synthetic
    mode uses random weights and gaussian inputs.  The card's cached
    blocks go back to the driver first: an experiment that follows
    another in the same process would otherwise place its params inside
    the earlier one's cached blocks, which then can be neither freed nor
    used for a large allocation (ROADMAP C7)."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    from ptq4vit_tpu_torch.models import get_net
    from ptq4vit_tpu_torch.utils.datasets import ViTImageNetLoaderGenerator
    from ptq4vit_tpu_torch.utils.synthetic import synthetic_images
    from ptq4vit_tpu_torch.utils.timm_port import load_timm_checkpoint_if_any
    params = None if args.synthetic else load_timm_checkpoint_if_any(name)
    net = get_net(name, params=params, device=getattr(args, "device", None))
    if args.synthetic:
        calib = synthetic_images(calib_size, net.cfg.img_size, seed=3)
        n_eval = 64
        x = synthetic_images(n_eval, net.cfg.img_size, seed=7)
        y = np.zeros((n_eval,), np.int64)
        test_loader = [(x[i:i + 32], y[i:i + 32])
                       for i in range(0, n_eval, 32)]
        return net, test_loader, calib
    g = ViTImageNetLoaderGenerator(args.dataset_root, "imagenet", 32, 32, 16,
                                   kwargs={"model": net})
    return net, g.test_loader(), g.calib_batch(num=calib_size)


def experiment_basic(net="vit_base_patch16_384", config="PTQ4ViT",
                     args=None):
    """Minimal end-to-end experiment (reference test_vit.py:93-108):
    build, calibrate (resumably with ``args.checkpoint_dir``), evaluate.
    Returns {"net", "qstate", "calib", "accuracy", "report"}."""
    from ptq4vit_tpu_torch.calib.calibrator import HessianQuantCalibrator
    args = args or parse_args()
    quant_cfg = apply_quick(init_config(config), args)
    model, test_loader, calib = build_net_and_data(net, args, args.calib_size)
    calibrator = HessianQuantCalibrator(
        model, quant_cfg, calib, sequential=False, batch_size=4,
        checkpoint_dir=getattr(args, "checkpoint_dir", None))
    qstate = calibrator.batching_quant_calib()
    acc = test_classification(model, test_loader, qstate=qstate,
                              max_iteration=args.max_iteration)
    return {"net": model, "qstate": qstate, "calib": calib,
            "accuracy": acc, "report": calibrator.report}


if __name__ == "__main__":
    args = parse_args()
    nets = ["vit_tiny_patch16_224", "deit_base_patch16_384"]
    configs = ["PTQ4ViT"]
    cfg_list = [{"net": n, "config": c, "args": args}
                for n in nets for c in configs]
    if args.multiprocess:
        multiprocess(experiment_basic, cfg_list, n_workers=args.n_workers)
    else:
        for cfg in cfg_list:
            experiment_basic(**cfg)
