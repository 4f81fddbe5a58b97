"""timm checkpoint ingestion: a timm state_dict (numpy arrays) -> the port's
parameter tree (timm key layout, float32 numpy arrays; ``get_net`` moves
it to the device), its npz form, and checkpoint discovery.

The counterpart of ``ptq4vit_tpu/utils/timm_port.py``, written with numpy
(and torch only to read a ``.pth``).  There is no download: drop
``{name}.pth`` (a timm state_dict) or ``{name}.npz`` (a converted tree)
into ``$PTQ4VIT_TPU_CKPT_DIR`` (default ``./checkpoints``).  The variable,
the file names and the npz keys are the JAX package's, so a checkpoint
converted by either package loads in the other.
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

import numpy as np

CKPT_ENV = "PTQ4VIT_TPU_CKPT_DIR"


def _ckpt_dir() -> str:
    return os.environ.get(CKPT_ENV, "./checkpoints")


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


# ---------------------------------------------------------------------------
# param tree <-> npz (flat dotted keys, list indices as numbers)
# ---------------------------------------------------------------------------

def flatten_params(params, prefix="") -> Dict[str, np.ndarray]:
    """{dotted key: numpy array} of a param tree (numpy or torch leaves)."""
    out = {}
    if isinstance(params, dict):
        for k, v in params.items():
            out.update(flatten_params(v, f"{prefix}{k}."))
    elif isinstance(params, list):
        for i, v in enumerate(params):
            out.update(flatten_params(v, f"{prefix}{i}."))
    else:
        if hasattr(params, "detach"):
            params = params.detach().cpu().numpy()
        out[prefix[:-1]] = np.asarray(params)
    return out


def unflatten_params(flat: Dict[str, np.ndarray]):
    """The param tree of ``flatten_params``'s dict (numpy leaves; all-digit
    keys become lists, in numeric order)."""
    root: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split(".")
        node = root
        for a in parts[:-1]:
            node = node.setdefault(a, {})
        node[parts[-1]] = np.asarray(v)

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(re.fullmatch(r"\d+", k) for k in node):
            return [listify(node[str(i)]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}
    return listify(root)


def save_params_npz(path: str, params) -> None:
    np.savez(path, **flatten_params(params))


def load_params_npz(path: str):
    with np.load(path) as z:
        return unflatten_params({k: z[k] for k in z.files})


# ---------------------------------------------------------------------------
# checkpoint discovery
# ---------------------------------------------------------------------------

def convert_torch_checkpoint(name: str, pth_path: str,
                             out_path: Optional[str] = None) -> str:
    """One-time .pth (a timm state_dict, bare or under "state_dict" /
    "model") -> .npz conversion of MODEL_ZOO model ``name``; returns the
    npz path.  The file is read with ``weights_only=True``: tensors and
    plain containers, no arbitrary pickled objects."""
    import torch
    obj = torch.load(pth_path, map_location="cpu", weights_only=True)
    sd = obj.get("state_dict", obj.get("model", obj)) \
        if isinstance(obj, dict) else obj
    sd = {k: v.numpy() for k, v in sd.items() if hasattr(v, "numpy")}
    params = params_from_state_dict(name, sd)
    out_path = out_path or os.path.join(_ckpt_dir(), f"{name}.npz")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    save_params_npz(out_path, params)
    return out_path


def load_timm_checkpoint_if_any(name: str):
    """The converted param tree of ``name`` when a checkpoint is in
    ``$PTQ4VIT_TPU_CKPT_DIR`` (an npz, or a .pth converted to one on the
    way), else None (callers fall back to random init)."""
    d = _ckpt_dir()
    npz = os.path.join(d, f"{name}.npz")
    if os.path.exists(npz):
        return load_params_npz(npz)
    pth = os.path.join(d, f"{name}.pth")
    if os.path.exists(pth):
        convert_torch_checkpoint(name, pth, npz)
        return load_params_npz(npz)
    return None
