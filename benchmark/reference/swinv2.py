"""Plain Swin Transformer V2 (Liu et al., arXiv:2111.09883) with the
quantized ops of PTQ4ViT, the benchmark's own reference for the
``swinv2`` configurations: the served model's logits, worked out plainly
in float32 from the float weights and the plain qstate.

Per block, with x the block input and H heads:

  qkv = x W_qkvᵀ + [q_bias, 0, v_bias]        (no LayerNorm first)
  logits_h = (q̂ k̂ᵀ) τ_h + B_h (+ shifted mask), q̂ = q / ||q|| per head,
             τ_h = exp(min(θ_h, ln 100)), B = 16 σ(MLP(Δ̂))[index]
  x ← x + LN1(proj(softmax(logits) v)),  x ← x + LN2(fc2(GELU(fc1(x))))
  PatchMerging: 2x2 concat -> reduction -> LN

The CPB network MLP = Linear(2, 512) + ReLU + Linear(512, H, no bias)
runs over the (2W-1)² coordinates Δ̂ = sign(Δ) log2(1 + |8 Δ / (W_pre -
1)|) / log2 8 and is not quantized.  Departures from timm's layout, none
in the arithmetic: the downsample sits at the end of stage i
(``layers.i.downsample``); timm's q_bias and v_bias are held as the qkv
linear's bias, whose k third is read as zero.

The quantized ops and the hooks are the V1 reference's
(``reference/models.py``): matmul1 takes q̂ and k̂ᵀ, and τ scales its
output outside the op.  The control rounds every float tensor that an op
or a residual sum hands on to float8 (e4m3).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from .models import Hooks, layer_norm, patchify, rel_index, shift_mask
from .serve import fp8

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

LN_100 = math.log(100.0)


@functools.lru_cache(maxsize=None)
def coords(ws: int, pws: int) -> np.ndarray:
    """((2ws-1)², 2) log-spaced relative coordinates, in float32."""
    r = torch.arange(-(ws - 1), ws, dtype=torch.float32)
    t = torch.stack(torch.meshgrid(r, r, indexing="ij"), -1)
    t = t / ((pws if pws > 0 else ws) - 1) * 8
    t = torch.sign(t) * torch.log2(torch.abs(t) + 1.0) / math.log2(8)
    return t.reshape(-1, 2).numpy()


def position_bias(attn, ws: int, pws: int):
    """(H, N, N) float32 bias 16 σ(MLP(Δ̂))[index]."""
    m0, m2 = attn["cpb_mlp"]["0"], attn["cpb_mlp"]["2"]
    dev = m2["weight"].device
    h = torch.relu(torch.from_numpy(coords(ws, pws)).to(dev)
                   @ m0["weight"].float().t() + m0["bias"].float())
    table = h @ m2["weight"].float().t()
    idx = torch.from_numpy(rel_index(ws)).to(dev)
    N = ws * ws
    return 16.0 * torch.sigmoid(table[idx].reshape(N, N, -1)
                                .permute(2, 0, 1))


def geometry(cfg, i, j):
    res = cfg["img_size"] // cfg["patch_size"] // 2 ** i
    ws = cfg["window_size"]
    shift = 0 if j % 2 == 0 else ws // 2
    if res <= ws:
        ws, shift = res, 0
    return res, ws, shift


def forward(params, x, cfg, hk: Hooks):
    """Logits of a ``swinv2`` configuration's ``model`` group."""
    B = x.shape[0]
    eps = cfg["ln_eps"]
    pe = params["patch_embed"]
    c0 = cfg["embed_dim"]
    x = hk.linear("patch_embed.proj", patchify(x, cfg["patch_size"]),
                  pe["proj"]["weight"].reshape(c0, -1), pe["proj"]["bias"])
    x = hk.act(layer_norm(x, pe["norm"]["weight"], pe["norm"]["bias"], eps))
    for i, layer in enumerate(params["layers"]):
        d = c0 * 2 ** i
        H = cfg["num_heads"][i]
        hd = d // H
        for j, blk in enumerate(layer["blocks"]):
            res, ws, shift = geometry(cfg, i, j)
            p = f"layers.{i}.blocks.{j}"
            a = blk["attn"]
            N, nw = ws * ws, (res // ws) ** 2
            y = x.reshape(B, res, res, d)
            if shift:
                y = torch.roll(y, (-shift, -shift), dims=(1, 2))
            y = y.reshape(B, res // ws, ws, res // ws, ws, d) \
                .permute(0, 1, 3, 2, 4, 5).reshape(B * nw, N, d)
            b_qkv = a["qkv"]["bias"].clone()
            b_qkv[d:2 * d] = 0.0
            qkv = hk.linear(f"{p}.attn.qkv", y, a["qkv"]["weight"], b_qkv)
            q, k, v = qkv.reshape(B * nw, N, 3, H, hd).permute(2, 0, 3, 1, 4)
            s = hk.matmul(f"{p}.attn.matmul1", hk.act(F.normalize(q, dim=-1)),
                          hk.act(F.normalize(k, dim=-1)).transpose(-2, -1))
            tau = torch.exp(torch.clamp(a["logit_scale"].reshape(H, 1, 1),
                                        max=LN_100))
            s = s * tau + position_bias(a, ws,
                                        cfg["pretrained_window_sizes"][i])
            if shift:
                m = torch.from_numpy(shift_mask(res, ws, shift)).to(
                    device=x.device, dtype=s.dtype)
                s = (s.reshape(B, nw, H, N, N) + m[None, :, None]) \
                    .reshape(B * nw, H, N, N)
            s = hk.act(torch.softmax(s, dim=-1))
            y = hk.matmul(f"{p}.attn.matmul2", s, v)
            y = hk.linear(f"{p}.attn.proj",
                          y.transpose(1, 2).reshape(B * nw, N, d),
                          a["proj"]["weight"], a["proj"]["bias"])
            y = y.reshape(B, res // ws, res // ws, ws, ws, d) \
                .permute(0, 1, 3, 2, 4, 5).reshape(B, res, res, d)
            if shift:
                y = torch.roll(y, (shift, shift), dims=(1, 2))
            x = hk.act(x + layer_norm(y.reshape(B, res * res, d),
                                      blk["norm1"]["weight"],
                                      blk["norm1"]["bias"], eps))
            y = hk.linear(f"{p}.mlp.fc1", x, blk["mlp"]["fc1"]["weight"],
                          blk["mlp"]["fc1"]["bias"])
            y = hk.linear(f"{p}.mlp.fc2", hk.act(F.gelu(y)),
                          blk["mlp"]["fc2"]["weight"],
                          blk["mlp"]["fc2"]["bias"])
            x = hk.act(x + layer_norm(y, blk["norm2"]["weight"],
                                      blk["norm2"]["bias"], eps))
        if "downsample" in layer:
            ds = layer["downsample"]
            res = cfg["img_size"] // cfg["patch_size"] // 2 ** i
            y = x.reshape(B, res, res, d)
            y = torch.cat([y[:, 0::2, 0::2], y[:, 1::2, 0::2],
                           y[:, 0::2, 1::2], y[:, 1::2, 1::2]], -1)
            y = hk.linear(f"layers.{i}.downsample.reduction",
                          y.reshape(B, -1, 4 * d), ds["reduction"]["weight"],
                          None)
            x = hk.act(layer_norm(y, ds["norm"]["weight"], ds["norm"]["bias"],
                                  eps))
    x = layer_norm(x, params["norm"]["weight"], params["norm"]["bias"], eps)
    return hk.linear("head", hk.act(x.mean(1)), params["head"]["weight"],
                     params["head"]["bias"])


def logits(params, cfg, qstate, images, *, block=8, control=False):
    """(N, classes) float32 logits of the served W8A8 net on host or
    device images, ``block`` images at a time on the params' device; the
    control in float8 between the ops."""
    dev = params["head"]["weight"].device
    out = []
    with torch.no_grad():
        for s0 in range(0, images.shape[0], block):
            x = torch.as_tensor(images[s0:s0 + block]).to(dev).float()
            hk = Hooks(qstate=qstate, act=fp8 if control else None)
            out.append(forward(params, x, cfg, hk).float())
    return torch.cat(out)


def capture(params, cfg, images, probe_u, ops, *, micro=4, sigma=1e-3,
            cache_dtype=torch.bfloat16):
    """``reference/calib.capture`` over this forward: {op: {"x" | "a",
    "b", "g": cache}} of the chosen ops over every image, samples leading
    (window matmuls: images x windows), in ``cache_dtype``."""
    kept = {op: {} for op in ops}
    for s0 in range(0, images.shape[0], micro):
        x = images[s0:s0 + micro].float()
        u = probe_u[s0:s0 + micro].float()
        shapes = {}

        def record(name, out, shapes=shapes):
            shapes[name] = out.shape
            return out
        with torch.no_grad():
            hk = Hooks(taps=ops)
            hk._out = record
            target = torch.softmax(forward(params, x, cfg, hk).float()
                                   + sigma * u, dim=-1)
        eps = {op: torch.zeros(shapes[op], device=x.device,
                               requires_grad=True) for op in ops}
        with torch.enable_grad():
            hk = Hooks(taps=ops, eps=eps)
            logp = torch.log_softmax(forward(params, x, cfg, hk).float(), -1)
            logt = torch.log(torch.clamp(target, min=1e-30))
            loss = torch.sum(target * (logt - logp)) / x.shape[0]
            grads = torch.autograd.grad(loss, [eps[op] for op in ops])
        for op, g in zip(ops, grads):
            for k, t in list(hk.kept[op].items()) + [("g", g)]:
                kept[op].setdefault(k, []).append(t.detach().to(cache_dtype))
        del hk, eps, grads
    return {op: {k: torch.cat(v) for k, v in d.items()}
            for op, d in kept.items()}
