"""Op-selection helpers: which ops get a calibrated QP, and in what order.

The counterpart of ``ptq4vit_tpu/models/net_wrap.py`` (framework-neutral
there except for ``_fold_bn``; importing the JAX package would load JAX,
so the port keeps its own copy).  The reference swaps leaves of the torch
module tree for quant modules; here models are written around named tap
points, so "wrapping" reduces to choosing the ops that get a QP:

  * :func:`wrap_modules_in_net`  -> the full ordered op dict;
  * :func:`wrap_certain_modules_in_net` -> the ablation subset: chosen
    module kinds inside chosen transformer-block indices;
  * :func:`fold_bn_into_conv`    -> BN folding (unused by the ViT
    pipeline, kept for CNN-style backbones);
  * :func:`reference_wrap_order` -> the order sequential calibration
    steps through.
"""
from __future__ import annotations

import re
from typing import Dict, Sequence

import torch

# leaf-name -> module-type map (reference net_wrap.py:42; head_dist is the
# JAX package's addition for distilled DeiT)
MODULE_TYPES = {"qkv": "qlinear_qkv", "proj": "qlinear_proj",
                "fc1": "qlinear_MLP_1", "fc2": "qlinear_MLP_2",
                "head": "qlinear_classifier",
                "head_dist": "qlinear_classifier", "matmul1": "qmatmul_qk",
                "matmul2": "qmatmul_scorev", "reduction": "qlinear_reduction"}


def wrap_modules_in_net(net, cfg) -> Dict[str, str]:
    """Ordered {op name: module_type}, each policy resolvable through
    ``cfg.op_policy``: the calibrator's work list."""
    return dict(net.op_inventory)


def wrap_certain_modules_in_net(net, cfg, layers: Sequence[int],
                                modules_to_wrap: Sequence[str],
                                wrap_embedding: bool = False) -> Dict[str, str]:
    """Ablation subset (reference net_wrap.py:83-139): only ops whose leaf
    name is in ``modules_to_wrap`` and whose block index is in ``layers``;
    the patch-embed conv only with ``wrap_embedding``."""
    out = {}
    for name, mtype in net.op_inventory:
        if mtype == "qconv":
            if wrap_embedding:
                out[name] = mtype
            continue
        leaf = name.rsplit(".", 1)[-1]
        if leaf not in modules_to_wrap:
            continue
        # Swin paths read layers.<stage>.blocks.<idx>...: the block index
        # is the one after "blocks", not the stage
        m = re.search(r"blocks\.(\d+)", name) or re.search(r"\d+", name)
        if m is not None and int(m.group(m.lastindex or 0)) not in layers:
            continue
        out[name] = mtype
    return out


def _fold_bn(conv_w, conv_b, bn_mean, bn_var, bn_weight, bn_bias, eps):
    """(weight, bias) of a conv with the BatchNorm after it folded in
    (reference _fold_bn, net_wrap.py:8-31)."""
    t = torch.as_tensor
    conv_w = t(conv_w)
    safe_std = torch.sqrt(t(bn_var) + eps)
    view = (conv_w.shape[0], 1, 1, 1)
    if bn_weight is not None:
        w = conv_w * (t(bn_weight) / safe_std).reshape(view)
        beta = t(bn_bias) - t(bn_weight) * t(bn_mean) / safe_std
        b = (t(bn_weight) * t(conv_b) / safe_std + beta
             if conv_b is not None else beta)
    else:
        w = conv_w / safe_std.reshape(view)
        beta = -t(bn_mean) / safe_std
        b = t(conv_b) / safe_std + beta if conv_b is not None else beta
    return w, b


def fold_bn_into_conv(conv_params: Dict, bn_params: Dict,
                      eps: float = 1e-5) -> Dict:
    """A new conv param dict with the BN statistics folded in (reference
    fold_bn_into_conv, net_wrap.py:33-36)."""
    w, b = _fold_bn(conv_params["weight"], conv_params.get("bias"),
                    bn_params["running_mean"], bn_params["running_var"],
                    bn_params.get("weight"), bn_params.get("bias"), eps)
    return {"weight": w, "bias": b}


def reference_wrap_order(pairs):
    """Reorder (op name, module type) pairs into the reference's module-walk
    order, which is what its SEQUENTIAL calibration steps through.

    The reference wraps modules in ``net.named_modules()`` order
    (net_wrap.py:44) and its calibrators "assume wrapped modules are in
    order" (quant_calib.py:316).  Because the patched ``matmul1``/``matmul2``
    are ``setattr``-ed onto the timm attention AFTER its native children
    (utils/models.py:81-86), that order within every attention is
    ``qkv, proj, matmul1, matmul2`` — i.e. ``proj`` is calibrated BEFORE the
    matmuls even though it consumes their output.  This is load-bearing in
    sequential mode: once ``proj`` is in quant_forward, the eps-probe
    gradient of the matmuls dies at proj's round() (derivative 0), so their
    hessian score curves are constant and the searches degenerate to the
    first candidate — the reference's actual behavior, pinned by the
    sequential differential golden.  Everywhere else the dataflow order the
    op inventory uses coincides with the module walk.
    """
    _RANK = {"qkv": 0, "proj": 1, "matmul1": 2, "matmul2": 3}
    first = {}
    keys = []
    for i, (n, _) in enumerate(pairs):
        scope, _sep, leaf = n.rpartition(".")
        if scope.endswith("attn") and leaf in _RANK:
            keys.append((first.setdefault(scope, i), _RANK[leaf]))
        else:
            keys.append((i, -1))
    return [p for _, p in sorted(zip(keys, pairs), key=lambda t: t[0])]
