#!/usr/bin/env python
"""Calibrate, then export int8 weights -- the counterpart of
``examples/get_int.py`` (the reference's example/get_int.py in
hahnyuan/PTQ4ViT) on ``ptq4vit_tpu_torch``: ``int_weights/{name}.npz``
with the int8 weight levels and every op's intervals, and with
``--activations`` the int activation payloads (uint8 for the twin
post-GELU and SoS operands) of four calibration images.

    python examples/torch_get_int.py --dataset_root DIR          # the card
    python examples/torch_get_int.py --synthetic --quick --device cpu \\
        --model vit_base_patch16_384 --activations

The file's keys and array dtypes are get_int.py's ("weight:{op}",
"interval:{op}:{field}", "act:{op}:{operand}"), so one reader takes
either package's file.
"""
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

from torch_test_vit import (apply_quick, build_net_and_data,  # noqa: E402
                            init_config, parse_args)


def int_payload(net, qstate, calib, activations=False):
    """{npz key: numpy array}: int weights, intervals and, with
    ``activations``, the int activations of ``calib[:4]``."""
    import torch
    from ptq4vit_tpu_torch.utils import integer as I
    payload = {f"weight:{k}": v
               for k, v in I.get_model_int_weight(net, qstate).items()}
    for opname, qp in qstate.items():
        for f in dataclasses.fields(qp):
            v = getattr(qp, f.name)
            if torch.is_tensor(v):
                payload[f"interval:{opname}:{f.name}"] = \
                    v.detach().cpu().numpy()
    if activations:
        acts = I.get_model_int_activations(net, qstate,
                                           np.asarray(calib[:4]))
        for opname, d in acts.items():
            for k, v in d.items():
                payload[f"act:{opname}:{k}"] = v
    return payload


def get_int_weights(name="vit_base_patch16_384", config="PTQ4ViT",
                    args=None, out_dir="./int_weights", activations=False):
    """Calibrate ``name`` and write its npz; returns the file's path."""
    from ptq4vit_tpu_torch.calib.calibrator import HessianQuantCalibrator
    quant_cfg = apply_quick(init_config(config), args)
    net, _, calib = build_net_and_data(name, args, args.calib_size)
    calibrator = HessianQuantCalibrator(net, quant_cfg, calib,
                                        sequential=False, batch_size=4)
    qstate = calibrator.batching_quant_calib()
    payload = int_payload(net, qstate, calib, activations)
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"{name}.npz")
    np.savez(out, **payload)
    print(f"saved {len(payload)} arrays to {out}")
    return out


if __name__ == "__main__":
    args = parse_args(lambda p: (
        p.add_argument("--model", default="vit_base_patch16_384"),
        p.add_argument("--config", default="PTQ4ViT"),
        p.add_argument("--out_dir", default="./int_weights"),
        p.add_argument("--activations", action="store_true")))
    get_int_weights(args.model, args.config, args=args,
                    out_dir=args.out_dir, activations=args.activations)
