"""Functional ViT / DeiT forward with explicit quantization tap points.

The counterpart of ``ptq4vit_tpu/models/vit.py``: pre-norm blocks, cls
token + learned position embeddings, exact-GELU MLP, classification from
the cls token, and attention written around explicit ``matmul1`` (q @ kᵀ)
and ``matmul2`` (softmax @ v) ops.  Parameters are a nested dict whose keys
mirror timm state_dict names.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from .common import QuantCtx, gelu, layer_norm, softmax_f32


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    name: str
    img_size: int = 224
    patch_size: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    num_classes: int = 1000
    ln_eps: float = 1e-6
    in_chans: int = 3
    distilled: bool = False

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def seq_len(self) -> int:
        return self.num_patches + (2 if self.distilled else 1)


def init_params(cfg: ViTConfig, generator: np.random.Generator,
                device="cpu") -> Dict[str, Any]:
    """Random-init parameter tree (timm key layout), drawn from ``generator``.
    Real runs load converted checkpoints; random init is for tests and the
    card check."""
    d = cfg.embed_dim
    hid = int(d * cfg.mlp_ratio)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    def normal(shape, scale):
        return t(generator.standard_normal(shape, dtype=np.float32) * scale)

    def lin(n_in, n_out):
        s = np.float32((2.0 / (n_in + n_out)) ** 0.5)
        return {"weight": normal((n_out, n_in), s),
                "bias": t(np.zeros((n_out,)))}

    def ln():
        return {"weight": t(np.ones((d,))), "bias": t(np.zeros((d,)))}

    params: Dict[str, Any] = {
        "cls_token": normal((1, 1, d), 0.02),
        "pos_embed": normal((1, cfg.seq_len, d), 0.02),
        "patch_embed": {"proj": {
            "weight": normal((d, cfg.in_chans, cfg.patch_size,
                              cfg.patch_size), 0.02),
            "bias": t(np.zeros((d,)))}},
        "blocks": [],
        "norm": ln(),
        "head": lin(d, cfg.num_classes),
    }
    if cfg.distilled:
        params["dist_token"] = normal((1, 1, d), 0.02)
        params["head_dist"] = lin(d, cfg.num_classes)
    for _ in range(cfg.depth):
        params["blocks"].append({
            "norm1": ln(),
            "attn": {"qkv": lin(d, 3 * d), "proj": lin(d, d)},
            "norm2": ln(),
            "mlp": {"fc1": lin(d, hid), "fc2": lin(hid, d)},
        })
    return params


def forward(params: Dict[str, Any], x, cfg: ViTConfig,
            qstate: Optional[Dict[str, Any]] = None,
            eps: Optional[Dict[str, torch.Tensor]] = None,
            capture: bool = False, int8: bool = False):
    """ViT forward.  x: (B, 3, H, W) float32.  Returns logits, or
    (logits, taps) when ``capture``."""
    ctx = QuantCtx(qstate=qstate, eps=eps, capture=capture, int8=int8)
    B = x.shape[0]
    d, H = cfg.embed_dim, cfg.num_heads
    scale = cfg.head_dim ** -0.5

    pe = params["patch_embed"]["proj"]
    x, _ = ctx.conv2d_patch("patch_embed.proj", x, pe["weight"], pe["bias"],
                            cfg.patch_size)
    tokens = [params["cls_token"].expand(B, 1, d)]
    if cfg.distilled:
        tokens.append(params["dist_token"].expand(B, 1, d))
    x = torch.cat(tokens + [x], dim=1) + params["pos_embed"]

    for i, blk in enumerate(params["blocks"]):
        p = f"blocks.{i}"
        y = layer_norm(x, blk["norm1"]["weight"], blk["norm1"]["bias"],
                       cfg.ln_eps)
        qkv = ctx.linear(f"{p}.attn.qkv", y, blk["attn"]["qkv"]["weight"],
                         blk["attn"]["qkv"]["bias"])
        N = qkv.shape[1]
        qkv = qkv.reshape(B, N, 3, H, cfg.head_dim).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = ctx.matmul(f"{p}.attn.matmul1", q, k.transpose(-2, -1)) \
            * scale
        attn = softmax_f32(attn, dim=-1)
        y = ctx.matmul(f"{p}.attn.matmul2", attn, v)
        y = y.transpose(1, 2).reshape(B, N, d)
        y = ctx.linear(f"{p}.attn.proj", y, blk["attn"]["proj"]["weight"],
                       blk["attn"]["proj"]["bias"])
        x = x + y
        y = layer_norm(x, blk["norm2"]["weight"], blk["norm2"]["bias"],
                       cfg.ln_eps)
        y = gelu(ctx.linear(f"{p}.mlp.fc1", y, blk["mlp"]["fc1"]["weight"],
                            blk["mlp"]["fc1"]["bias"]))
        y = ctx.linear(f"{p}.mlp.fc2", y, blk["mlp"]["fc2"]["weight"],
                       blk["mlp"]["fc2"]["bias"])
        x = x + y

    x = layer_norm(x, params["norm"]["weight"], params["norm"]["bias"],
                   cfg.ln_eps)
    logits = ctx.linear("head", x[:, 0], params["head"]["weight"],
                        params["head"]["bias"])
    if cfg.distilled:
        logits_d = ctx.linear("head_dist", x[:, 1],
                              params["head_dist"]["weight"],
                              params["head_dist"]["bias"])
        logits = (logits + logits_d) / 2
    if capture:
        return logits, ctx.taps
    return logits


def op_inventory(cfg: ViTConfig):
    """Ordered (name, module_type) list of quantizable ops."""
    ops = [("patch_embed.proj", "qconv")]
    for i in range(cfg.depth):
        p = f"blocks.{i}"
        ops += [
            (f"{p}.attn.qkv", "qlinear_qkv"),
            (f"{p}.attn.matmul1", "qmatmul_qk"),
            (f"{p}.attn.matmul2", "qmatmul_scorev"),
            (f"{p}.attn.proj", "qlinear_proj"),
            (f"{p}.mlp.fc1", "qlinear_MLP_1"),
            (f"{p}.mlp.fc2", "qlinear_MLP_2"),
        ]
    ops.append(("head", "qlinear_classifier"))
    if cfg.distilled:
        ops.append(("head_dist", "qlinear_classifier"))
    return ops


def op_shapes(cfg: ViTConfig):
    """Static per-op shape info (the calibrator sizes its capture groups
    from it)."""
    info = {}
    d, hid = cfg.embed_dim, int(cfg.embed_dim * cfg.mlp_ratio)
    N, Hh, hd = cfg.seq_len, cfg.num_heads, cfg.head_dim
    info["patch_embed.proj"] = {
        "kind": "conv",
        "in_features": cfg.in_chans * cfg.patch_size ** 2, "out_features": d,
        "tokens": cfg.num_patches}
    for i in range(cfg.depth):
        p = f"blocks.{i}"
        info[f"{p}.attn.qkv"] = {"kind": "linear", "in_features": d,
                                 "out_features": 3 * d, "tokens": N}
        info[f"{p}.attn.matmul1"] = {"kind": "matmul", "heads": Hh,
                                     "rows": N, "inner": hd, "cols": N}
        info[f"{p}.attn.matmul2"] = {"kind": "matmul", "heads": Hh,
                                     "rows": N, "inner": N, "cols": hd}
        info[f"{p}.attn.proj"] = {"kind": "linear", "in_features": d,
                                  "out_features": d, "tokens": N}
        info[f"{p}.mlp.fc1"] = {"kind": "linear", "in_features": d,
                                "out_features": hid, "tokens": N}
        info[f"{p}.mlp.fc2"] = {"kind": "linear", "in_features": hid,
                                "out_features": d, "tokens": N}
    info["head"] = {"kind": "linear", "in_features": d,
                    "out_features": cfg.num_classes, "tokens": 1}
    if cfg.distilled:
        info["head_dist"] = {"kind": "linear", "in_features": d,
                             "out_features": cfg.num_classes, "tokens": 1}
    return info
