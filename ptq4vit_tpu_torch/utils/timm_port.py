"""timm checkpoint ingestion: a timm state_dict (numpy arrays) -> the port's
parameter tree (timm key layout, float32 numpy arrays; ``get_net`` moves
it to the device).

The counterpart of ``ptq4vit_tpu/utils/timm_port.py`` state_dict
conversion, written with numpy only.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np


def _taker(sd: Dict[str, Any]):
    def g(k):
        return np.asarray(sd.pop(k), np.float32)

    def lin(p, bias=True):
        out = {"weight": g(p + ".weight")}
        if bias:
            out["bias"] = g(p + ".bias")
        return out
    return g, lin


def vit_params_from_state_dict(sd: Dict[str, Any], cfg) -> Dict[str, Any]:
    """timm VisionTransformer state_dict -> ViT param tree.  Consumes
    ``sd``; raises on keys left over."""
    g, lin = _taker(sd)
    params = {
        "cls_token": g("cls_token"),
        "pos_embed": g("pos_embed"),
        "patch_embed": {"proj": lin("patch_embed.proj")},
        "blocks": [],
        "norm": lin("norm"),
        "head": lin("head"),
    }
    if getattr(cfg, "distilled", False):
        params["dist_token"] = g("dist_token")
        params["head_dist"] = lin("head_dist")
    for i in range(cfg.depth):
        p = f"blocks.{i}"
        params["blocks"].append({
            "norm1": lin(p + ".norm1"),
            "attn": {"qkv": lin(p + ".attn.qkv"),
                     "proj": lin(p + ".attn.proj")},
            "norm2": lin(p + ".norm2"),
            "mlp": {"fc1": lin(p + ".mlp.fc1"), "fc2": lin(p + ".mlp.fc2")},
        })
    leftovers = [k for k in sd if not k.endswith("num_batches_tracked")
                 and "pre_logits" not in k]
    if leftovers:
        raise ValueError(f"unconsumed checkpoint keys: {leftovers[:8]}")
    return params


def swin_params_from_state_dict(sd: Dict[str, Any], cfg) -> Dict[str, Any]:
    """timm SwinTransformer state_dict -> Swin param tree.  Consumes
    ``sd``; the static ``relative_position_index`` and ``attn_mask``
    buffers are dropped (the forward rebuilds them)."""
    g, lin = _taker(sd)
    params = {
        "patch_embed": {"proj": lin("patch_embed.proj"),
                        "norm": lin("patch_embed.norm")},
        "layers": [],
        "norm": lin("norm"),
        "head": lin("head"),
    }
    for i, depth in enumerate(cfg.depths):
        layer: Dict[str, Any] = {"blocks": []}
        for j in range(depth):
            p = f"layers.{i}.blocks.{j}"
            sd.pop(p + ".attn.relative_position_index", None)
            sd.pop(p + ".attn_mask", None)
            layer["blocks"].append({
                "norm1": lin(p + ".norm1"),
                "attn": {
                    "qkv": lin(p + ".attn.qkv"),
                    "proj": lin(p + ".attn.proj"),
                    "relative_position_bias_table":
                        g(p + ".attn.relative_position_bias_table")},
                "norm2": lin(p + ".norm2"),
                "mlp": {"fc1": lin(p + ".mlp.fc1"),
                        "fc2": lin(p + ".mlp.fc2")},
            })
        if i < cfg.num_layers - 1:
            layer["downsample"] = {
                "norm": lin(f"layers.{i}.downsample.norm"),
                "reduction": lin(f"layers.{i}.downsample.reduction",
                                 bias=False)}
        params["layers"].append(layer)
    leftovers = [k for k in sd if "attn_mask" not in k]
    if leftovers:
        raise ValueError(f"unconsumed checkpoint keys: {leftovers[:8]}")
    return params


def params_from_state_dict(name: str, sd: Dict[str, Any]):
    """A MODEL_ZOO model's timm state_dict -> its param tree."""
    from ..models.registry import MODEL_ZOO, model_config
    cfg = model_config(name)
    sd = {k: np.asarray(v) for k, v in sd.items()}
    if MODEL_ZOO[name]["kind"] == "swin":
        return swin_params_from_state_dict(sd, cfg)
    return vit_params_from_state_dict(sd, cfg)
