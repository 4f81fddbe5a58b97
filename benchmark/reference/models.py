"""Plain forwards of ViT (Dosovitskiy et al., arXiv:2010.11929) and Swin
(Liu et al., arXiv:2103.14030) with the quantized ops of PTQ4ViT.

Parameters follow timm's state-dict names.  Each quantizable op is named
by its timm module path (``blocks.3.mlp.fc1``).  A :class:`Hooks` object
decides, op by op, whether the op runs on fake-quantized operands (the
served model), records its inputs (the calibration's capture) and adds a
zero tensor to its output whose gradient is the gradient of the loss with
respect to that output (the hessian metric's probe).

The attention matmuls are ``matmul1 = q @ k^T`` and ``matmul2 = softmax
@ v``.  ViT scales matmul1's output; Swin scales q before matmul1 and adds
the relative-position bias and the shifted-window mask after it.  The
patch embedding is a linear over flattened patches, with a per-channel
weight quantizer and an unquantized input.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F


class Hooks:
    """qstate: {op: fq.OpQuant}; taps: op names whose inputs are kept;
    eps: {op: zero tensor added to the output}; act: applied to every
    float tensor an op or a residual sum hands on (the control's lower
    precision), identity by default."""

    def __init__(self, qstate=None, taps=(), eps=None, act=None):
        self.qstate = qstate or {}
        self.taps = set(taps)
        self.eps = eps or {}
        self.act = act or (lambda t: t)
        self.kept: Dict[str, Dict[str, torch.Tensor]] = {}

    def _out(self, name, out):
        if name in self.eps:
            out = out + self.eps[name]
        return self.act(out)

    def linear(self, name, x, w, b):
        q = self.qstate.get(name)
        if name in self.taps:
            self.kept[name] = {"x": x.detach()}
        if q is not None:
            x, w = q.input(x), q.weight(w)
        out = torch.matmul(x, w.t())
        if b is not None:
            out = out + b
        return self._out(name, out)

    def matmul(self, name, a, b):
        q = self.qstate.get(name)
        if name in self.taps:
            self.kept[name] = {"a": a.detach(), "b": b.detach()}
        if q is not None:
            a, b = q.operands(a, b)
        return self._out(name, torch.matmul(a, b))


def layer_norm(x, w, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def patchify(x, p):
    B, C, H, W = x.shape
    x = x.reshape(B, C, H // p, p, W // p, p).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(B, (H // p) * (W // p), C * p * p)


def vit_forward(params, x, cfg, hk: Hooks):
    d, H = cfg["embed_dim"], cfg["num_heads"]
    hd = d // H
    B = x.shape[0]
    pe = params["patch_embed"]["proj"]
    x = hk.linear("patch_embed.proj", patchify(x, cfg["patch_size"]),
                  pe["weight"].reshape(d, -1), pe["bias"])
    x = torch.cat([params["cls_token"].expand(B, 1, d), x], 1) \
        + params["pos_embed"]
    x = hk.act(x)
    eps = cfg["ln_eps"]
    for i, blk in enumerate(params["blocks"]):
        p = f"blocks.{i}"
        y = layer_norm(x, blk["norm1"]["weight"], blk["norm1"]["bias"], eps)
        qkv = hk.linear(f"{p}.attn.qkv", hk.act(y),
                        blk["attn"]["qkv"]["weight"],
                        blk["attn"]["qkv"]["bias"])
        N = qkv.shape[1]
        q, k, v = qkv.reshape(B, N, 3, H, hd).permute(2, 0, 3, 1, 4)
        s = hk.matmul(f"{p}.attn.matmul1", q, k.transpose(-2, -1)) \
            * hd ** -0.5
        a = hk.act(torch.softmax(s, dim=-1))
        y = hk.matmul(f"{p}.attn.matmul2", a, v)
        y = y.transpose(1, 2).reshape(B, N, d)
        y = hk.linear(f"{p}.attn.proj", y, blk["attn"]["proj"]["weight"],
                      blk["attn"]["proj"]["bias"])
        x = hk.act(x + y)
        y = layer_norm(x, blk["norm2"]["weight"], blk["norm2"]["bias"], eps)
        y = hk.linear(f"{p}.mlp.fc1", hk.act(y), blk["mlp"]["fc1"]["weight"],
                      blk["mlp"]["fc1"]["bias"])
        y = hk.act(F.gelu(y))
        y = hk.linear(f"{p}.mlp.fc2", y, blk["mlp"]["fc2"]["weight"],
                      blk["mlp"]["fc2"]["bias"])
        x = hk.act(x + y)
    x = layer_norm(x, params["norm"]["weight"], params["norm"]["bias"], eps)
    return hk.linear("head", hk.act(x[:, 0]), params["head"]["weight"],
                     params["head"]["bias"])


@functools.lru_cache(maxsize=None)
def rel_index(ws: int) -> np.ndarray:
    c = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    c = c.reshape(2, -1)
    r = (c[:, :, None] - c[:, None, :]).transpose(1, 2, 0) + (ws - 1)
    return (r[:, :, 0] * (2 * ws - 1) + r[:, :, 1]).reshape(-1)


@functools.lru_cache(maxsize=None)
def shift_mask(res: int, ws: int, shift: int) -> Optional[np.ndarray]:
    if shift == 0:
        return None
    img = np.zeros((res, res), np.float32)
    n = 0
    cuts = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    for hs in cuts:
        for wsl in cuts:
            img[hs, wsl] = n
            n += 1
    win = img.reshape(res // ws, ws, res // ws, ws).transpose(0, 2, 1, 3) \
        .reshape(-1, ws * ws)
    m = win[:, None, :] - win[:, :, None]
    return np.where(m != 0, -100.0, 0.0).astype(np.float32)


def swin_geometry(cfg, i, j):
    res = cfg["img_size"] // cfg["patch_size"] // 2 ** i
    ws = cfg["window_size"]
    shift = 0 if j % 2 == 0 else ws // 2
    if res <= ws:
        ws, shift = res, 0
    return res, ws, shift


def swin_forward(params, x, cfg, hk: Hooks):
    B = x.shape[0]
    eps = cfg["ln_eps"]
    pe = params["patch_embed"]
    C0 = cfg["embed_dim"]
    x = hk.linear("patch_embed.proj", patchify(x, cfg["patch_size"]),
                  pe["proj"]["weight"].reshape(C0, -1), pe["proj"]["bias"])
    x = hk.act(layer_norm(x, pe["norm"]["weight"], pe["norm"]["bias"], eps))
    for i, layer in enumerate(params["layers"]):
        d = C0 * 2 ** i
        H = cfg["num_heads"][i]
        hd = d // H
        for j, blk in enumerate(layer["blocks"]):
            res, ws, shift = swin_geometry(cfg, i, j)
            p = f"layers.{i}.blocks.{j}"
            N = ws * ws
            nw = (res // ws) ** 2
            idx = torch.from_numpy(rel_index(ws)).to(x.device)
            bias = blk["attn"]["relative_position_bias_table"][idx] \
                .reshape(N, N, H).permute(2, 0, 1)
            y = layer_norm(x, blk["norm1"]["weight"], blk["norm1"]["bias"],
                           eps).reshape(B, res, res, d)
            if shift:
                y = torch.roll(y, (-shift, -shift), dims=(1, 2))
            y = y.reshape(B, res // ws, ws, res // ws, ws, d) \
                .permute(0, 1, 3, 2, 4, 5).reshape(B * nw, N, d)
            qkv = hk.linear(f"{p}.attn.qkv", hk.act(y),
                            blk["attn"]["qkv"]["weight"],
                            blk["attn"]["qkv"]["bias"])
            q, k, v = qkv.reshape(B * nw, N, 3, H, hd).permute(2, 0, 3, 1, 4)
            s = hk.matmul(f"{p}.attn.matmul1", q * hd ** -0.5,
                          k.transpose(-2, -1)) + bias[None]
            m = shift_mask(res, ws, shift)
            if m is not None:
                m = torch.from_numpy(m).to(device=x.device, dtype=s.dtype)
                s = (s.reshape(B, nw, H, N, N) + m[None, :, None]) \
                    .reshape(B * nw, H, N, N)
            a = hk.act(torch.softmax(s, dim=-1))
            y = hk.matmul(f"{p}.attn.matmul2", a, v)
            y = hk.linear(f"{p}.attn.proj", y.transpose(1, 2).reshape(
                B * nw, N, d), blk["attn"]["proj"]["weight"],
                blk["attn"]["proj"]["bias"])
            y = y.reshape(B, res // ws, res // ws, ws, ws, d) \
                .permute(0, 1, 3, 2, 4, 5).reshape(B, res, res, d)
            if shift:
                y = torch.roll(y, (shift, shift), dims=(1, 2))
            x = hk.act(x + y.reshape(B, res * res, d))
            y = layer_norm(x, blk["norm2"]["weight"], blk["norm2"]["bias"],
                           eps)
            y = hk.linear(f"{p}.mlp.fc1", hk.act(y),
                          blk["mlp"]["fc1"]["weight"],
                          blk["mlp"]["fc1"]["bias"])
            y = hk.linear(f"{p}.mlp.fc2", hk.act(F.gelu(y)),
                          blk["mlp"]["fc2"]["weight"],
                          blk["mlp"]["fc2"]["bias"])
            x = hk.act(x + y)
        if "downsample" in layer:
            ds = layer["downsample"]
            y = x.reshape(B, res, res, d)
            y = torch.cat([y[:, 0::2, 0::2], y[:, 1::2, 0::2],
                           y[:, 0::2, 1::2], y[:, 1::2, 1::2]], -1)
            y = layer_norm(y.reshape(B, -1, 4 * d), ds["norm"]["weight"],
                           ds["norm"]["bias"], eps)
            x = hk.linear(f"layers.{i}.downsample.reduction", hk.act(y),
                          ds["reduction"]["weight"], None)
    x = layer_norm(x, params["norm"]["weight"], params["norm"]["bias"], eps)
    return hk.linear("head", hk.act(x.mean(1)), params["head"]["weight"],
                     params["head"]["bias"])


def forward(params, x, cfg, hk: Hooks):
    """Logits of the configuration ``cfg`` (the ``model`` group of a
    configuration file, with its ``kind``)."""
    fn = vit_forward if cfg["kind"] == "vit" else swin_forward
    return fn(params, x, cfg, hk)


def op_kinds(cfg) -> Dict[str, str]:
    """{op: "conv" | "linear" | "postgelu" | "matmul" | "sos"} in the
    forward's order; qkv linears carry three row blocks."""
    ops = {"patch_embed.proj": "conv"}
    blocks = ([f"blocks.{i}" for i in range(cfg["depth"])]
              if cfg["kind"] == "vit" else None)
    if blocks is None:
        blocks = []
        for i, n in enumerate(cfg["depths"]):
            blocks += [f"layers.{i}.blocks.{j}" for j in range(n)]
            if i < len(cfg["depths"]) - 1:
                blocks.append(f"layers.{i}.downsample.reduction")
    for p in blocks:
        if p.endswith("reduction"):
            ops[p] = "linear"
            continue
        ops.update({f"{p}.attn.qkv": "qkv", f"{p}.attn.matmul1": "matmul",
                    f"{p}.attn.matmul2": "sos", f"{p}.attn.proj": "linear",
                    f"{p}.mlp.fc1": "linear", f"{p}.mlp.fc2": "postgelu"})
    ops["head"] = "linear"
    return ops


def op_weight(params, name):
    node = params
    for part in name.split("."):
        node = node[int(part)] if isinstance(node, list) else node[part]
    w = node["weight"]
    return w.reshape(w.shape[0], -1), node.get("bias")
