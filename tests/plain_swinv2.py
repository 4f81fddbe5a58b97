"""Plain Swin Transformer V2 in float32 PyTorch: the reference that the
port's Swin V2 (``ptq4vit_tpu_torch/models/swinv2.py`` and its serving
path) is held to in ``tests/test_torch_swinv2.py``.  It imports neither
the JAX package nor the port and sets TF32 off, so it runs on the card's
machine too.

Liu et al., "Swin Transformer V2" (arXiv:2111.09883), as timm's
``SwinTransformerV2`` computes it, per block with x the block input and H
heads:

  qkv = x W_qkvᵀ + [q_bias, 0, v_bias]               (no LayerNorm first)
  logits_h = (q̂ k̂ᵀ) τ_h + B_h (+ shifted mask),  q̂ = q / ||q||,
             τ_h = exp(min(θ_h, ln 100)),
             B = 16 σ(MLP(Δ̂))[index],  MLP = Linear(2, 512) + ReLU +
             Linear(512, H, no bias) over the (2W-1)² coordinates
             Δ̂ = sign(Δ) log2(1 + |8 Δ / (W_pre - 1)|) / log2 8
  x ← x + LN1(proj(softmax(logits) v)),  x ← x + LN2(fc2(GELU(fc1(x))))
  PatchMerging: 2x2 concat -> reduction (4C -> 2C, no bias) -> LN(2C)

Departures from timm's module layout, none of them in the arithmetic:

  * the downsample sits at the end of stage i (``layers.i.downsample``),
    as the port's Swin V1 places it; timm runs the same PatchMerging at
    the start of stage i + 1;
  * timm's ``q_bias`` and ``v_bias`` are held as the qkv linear's bias
    [q_bias, k_bias, v_bias]; k's third is read as zero, whatever it
    holds (timm's ``k_bias`` is a zero buffer, not a parameter).

The quantized ops are PTQ4ViT's (Yuan et al., arXiv:2111.12293): the
patch embedding, qkv, matmul1 (on q̂ and k̂, before τ), matmul2 (softmax
by v), proj, fc1, fc2 (post-GELU), the reductions and the head; the CPB
network is float.  An :class:`Ops` object runs each op raw or on
fake-quantized operands (``qstate``: {op: plain intervals}), records its
inputs and output, and adds a probe tensor to its output (``eps``) whose
gradient is the loss's gradient with respect to that output.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

LN_100 = math.log(100.0)


# -- quantizers: levels [-qmax, qmax - 1], half to even ---------------------

def quant(x, d, qmax):
    return torch.clamp(torch.round(x / d), -qmax, qmax - 1) * d


def quant_rows(w, d, qmax):
    """(oc, ic) weight, one interval per block of rows: d (n_V,)."""
    n_v = d.numel()
    return quant(w.reshape(n_v, -1, w.shape[-1]), d.reshape(n_v, 1, 1),
                 qmax).reshape(w.shape)


def quant_twin_gelu(x, d_pos, d_neg, qmax):
    pos = torch.clamp(torch.round(x / d_pos), 0, qmax - 1) * d_pos
    neg = torch.clamp(torch.round(x / d_neg), -qmax, 0) * d_neg
    return pos + neg


def quant_sos(x, split, qmax):
    """The split-of-softmax quantizer: [split, 1] on 1 / (qmax - 1)
    steps, [0, split] on split / (qmax - 1) steps, summed."""
    one = torch.ones((), dtype=x.dtype, device=x.device)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    q1 = torch.tensor(qmax - 1, dtype=torch.float32, device=x.device)
    lo_step = split / q1
    hi = torch.clamp(torch.round(torch.minimum(torch.maximum(x, split), one)
                                 * (qmax - 1)), 0, qmax - 1) / q1
    lo = torch.clamp(torch.round(torch.minimum(torch.maximum(x, zero), split)
                                 / lo_step), 0, qmax - 1) * lo_step
    return hi + lo


def quant_heads(x, d, qmax):
    """(S, G, R, C) operand, one interval per head: d (G,)."""
    return quant(x, d.reshape(1, -1, 1, 1), qmax)


class Ops:
    """The quantized ops of one forward.

    qstate: {op: {"kind", "w_qmax", "a_qmax", fields}}, fields by kind --
    linear: w (n_V,), a (), a_neg () or None; matmul: a (G,) or split
    (), b (G,); conv: w (oc,), a () or None (the input unquantized).
    eps: {op: tensor added to the output}.  ``kept`` holds every op's
    inputs and output."""

    def __init__(self, qstate=None, eps=None):
        self.qstate = qstate or {}
        self.eps = eps or {}
        self.kept: Dict[str, Dict[str, torch.Tensor]] = {}

    def _out(self, name, out, kept):
        if name in self.eps:
            out = out + self.eps[name]
        kept["out"] = out
        self.kept[name] = kept
        return out

    def linear(self, name, x, w, b):
        q = self.qstate.get(name)
        kept = {"x": x}
        if q is not None:
            w = quant_rows(w, q["w"], q["w_qmax"])
            x = (quant_twin_gelu(x, q["a"], q["a_neg"], q["a_qmax"])
                 if q.get("a_neg") is not None else quant(x, q["a"],
                                                          q["a_qmax"]))
        out = torch.matmul(x, w.t())
        if b is not None:
            out = out + b
        return self._out(name, out, kept)

    def conv(self, name, x, w, b):
        """The patch embedding as a linear over flattened patches."""
        q = self.qstate.get(name)
        kept = {"x": x}
        if q is not None:
            w = quant(w, q["w"].reshape(-1, 1), q["w_qmax"])
            if q.get("a") is not None:
                x = quant(x, q["a"], q["a_qmax"])
        return self._out(name, torch.matmul(x, w.t()) + b, kept)

    def matmul(self, name, a, b):
        q = self.qstate.get(name)
        kept = {"a": a, "b": b}
        if q is not None:
            a = (quant_sos(a, q["split"], q["a_qmax"])
                 if q.get("split") is not None
                 else quant_heads(a, q["a"], q["a_qmax"]))
            b = quant_heads(b, q["b"], q["b_qmax"])
        return self._out(name, torch.matmul(a, b), kept)


# -- geometry ---------------------------------------------------------------

def layer_norm(x, w, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def patchify(x, p):
    B, C, H, W = x.shape
    x = x.reshape(B, C, H // p, p, W // p, p).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(B, (H // p) * (W // p), C * p * p)


def rel_index(ws):
    """(ws² · ws²,) index into the (2ws-1)² table."""
    c = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    c = c.reshape(2, -1)
    r = (c[:, :, None] - c[:, None, :]).transpose(1, 2, 0) + (ws - 1)
    return torch.from_numpy((r[:, :, 0] * (2 * ws - 1) + r[:, :, 1])
                            .reshape(-1))


def shift_mask(res, ws, shift):
    """(nW, N, N) additive mask (0 / -100) of the shifted windows."""
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
    return torch.from_numpy(np.where(m != 0, -100.0, 0.0).astype(np.float32))


def coords_table(ws, pws):
    """((2ws-1)², 2) log-spaced relative coordinates."""
    r = torch.arange(-(ws - 1), ws, dtype=torch.float32)
    t = torch.stack(torch.meshgrid(r, r, indexing="ij"), -1)
    t = t / ((pws if pws > 0 else ws) - 1) * 8
    t = torch.sign(t) * torch.log2(torch.abs(t) + 1.0) / math.log2(8)
    return t.reshape(-1, 2)


def cpb_bias(attn, ws, pws):
    """(H, N, N) position bias 16 σ(MLP(Δ̂))[index]."""
    m0, m2 = attn["cpb_mlp"]["0"], attn["cpb_mlp"]["2"]
    dev = m2["weight"].device
    h = torch.relu(coords_table(ws, pws).to(dev) @ m0["weight"].t()
                   + m0["bias"])
    table = h @ m2["weight"].t()
    N = ws * ws
    b = table[rel_index(ws).to(dev)].reshape(N, N, -1).permute(2, 0, 1)
    return 16.0 * torch.sigmoid(b)


def geometry(cfg, i, j):
    """(res, ws, shift) of block j of stage i: odd blocks shift by half a
    window; a stage that fits one window takes it whole, unshifted."""
    res = cfg["img_size"] // cfg["patch_size"] // 2 ** i
    ws = cfg["window_size"]
    shift = 0 if j % 2 == 0 else ws // 2
    if res <= ws:
        ws, shift = res, 0
    return res, ws, shift


# -- the forward --------------------------------------------------------------

def forward(params, x, cfg, ops: Optional[Ops] = None):
    """Logits of images x (B, 3, H, W); ``cfg`` as the benchmark's model
    group (img_size, patch_size, embed_dim, depths, num_heads,
    window_size, pretrained_window_sizes, ln_eps)."""
    ops = ops or Ops()
    B = x.shape[0]
    eps = cfg["ln_eps"]
    c0, p = cfg["embed_dim"], cfg["patch_size"]
    pe = params["patch_embed"]
    x = ops.conv("patch_embed.proj", patchify(x, p),
                 pe["proj"]["weight"].reshape(c0, -1), pe["proj"]["bias"])
    x = layer_norm(x, pe["norm"]["weight"], pe["norm"]["bias"], eps)
    for i, layer in enumerate(params["layers"]):
        d = c0 * 2 ** i
        H = cfg["num_heads"][i]
        hd = d // H
        for j, blk in enumerate(layer["blocks"]):
            res, ws, shift = geometry(cfg, i, j)
            pre = f"layers.{i}.blocks.{j}"
            a = blk["attn"]
            N, nw = ws * ws, (res // ws) ** 2
            y = x.reshape(B, res, res, d)
            if shift:
                y = torch.roll(y, (-shift, -shift), dims=(1, 2))
            y = y.reshape(B, res // ws, ws, res // ws, ws, d) \
                .permute(0, 1, 3, 2, 4, 5).reshape(B * nw, N, d)
            b_qkv = a["qkv"]["bias"].clone()
            b_qkv[d:2 * d] = 0.0
            qkv = ops.linear(f"{pre}.attn.qkv", y, a["qkv"]["weight"], b_qkv)
            q, k, v = qkv.reshape(B * nw, N, 3, H, hd).permute(2, 0, 3, 1, 4)
            s = ops.matmul(f"{pre}.attn.matmul1", F.normalize(q, dim=-1),
                           F.normalize(k, dim=-1).transpose(-2, -1))
            tau = torch.exp(torch.clamp(a["logit_scale"].reshape(H, 1, 1),
                                        max=LN_100))
            s = s * tau + cpb_bias(a, ws, cfg["pretrained_window_sizes"][i])
            if shift:
                m = shift_mask(res, ws, shift).to(s.device)
                s = (s.reshape(B, nw, H, N, N) + m[None, :, None]) \
                    .reshape(B * nw, H, N, N)
            s = torch.softmax(s, dim=-1)
            y = ops.matmul(f"{pre}.attn.matmul2", s, v)
            y = ops.linear(f"{pre}.attn.proj",
                           y.transpose(1, 2).reshape(B * nw, N, d),
                           a["proj"]["weight"], a["proj"]["bias"])
            y = y.reshape(B, res // ws, res // ws, ws, ws, d) \
                .permute(0, 1, 3, 2, 4, 5).reshape(B, res, res, d)
            if shift:
                y = torch.roll(y, (shift, shift), dims=(1, 2))
            x = x + layer_norm(y.reshape(B, res * res, d),
                               blk["norm1"]["weight"], blk["norm1"]["bias"],
                               eps)
            y = ops.linear(f"{pre}.mlp.fc1", x, blk["mlp"]["fc1"]["weight"],
                           blk["mlp"]["fc1"]["bias"])
            y = ops.linear(f"{pre}.mlp.fc2", F.gelu(y),
                           blk["mlp"]["fc2"]["weight"],
                           blk["mlp"]["fc2"]["bias"])
            x = x + layer_norm(y, blk["norm2"]["weight"],
                               blk["norm2"]["bias"], eps)
        if "downsample" in layer:
            ds = layer["downsample"]
            res = cfg["img_size"] // p // 2 ** i
            y = x.reshape(B, res, res, d)
            y = torch.cat([y[:, 0::2, 0::2], y[:, 1::2, 0::2],
                           y[:, 0::2, 1::2], y[:, 1::2, 1::2]], -1)
            y = ops.linear(f"layers.{i}.downsample.reduction",
                           y.reshape(B, -1, 4 * d),
                           ds["reduction"]["weight"], None)
            x = layer_norm(y, ds["norm"]["weight"], ds["norm"]["bias"], eps)
    x = layer_norm(x, params["norm"]["weight"], params["norm"]["bias"], eps)
    return ops.linear("head", x.mean(1), params["head"]["weight"],
                      params["head"]["bias"])


def capture(params, x, cfg, probe_u, sigma=1e-3, qstate=None):
    """Every op's inputs, output and probe gradient on images x: the
    gradient of KL(softmax(logits + σ u) || softmax(logits)) / B with
    respect to each op's output (PTQ4ViT's hessian probe), the target
    from the forward's own logits.  Returns (logits, {op: {"x" | "a",
    "b", "out", "g"}})."""
    with torch.no_grad():
        ops = Ops(qstate)
        logits = forward(params, x, cfg, ops)
        target = torch.softmax(logits + sigma * probe_u, dim=-1)
    eps = {n: torch.zeros_like(k["out"], requires_grad=True)
           for n, k in ops.kept.items()}
    with torch.enable_grad():
        ops = Ops(qstate, eps)
        logp = torch.log_softmax(forward(params, x, cfg, ops), -1)
        loss = torch.sum(target * (torch.log(torch.clamp(target, min=1e-30))
                                   - logp)) / x.shape[0]
        grads = torch.autograd.grad(loss, list(eps.values()))
    out = {}
    for (n, g) in zip(eps, grads):
        out[n] = {k: v.detach() for k, v in ops.kept[n].items()}
        out[n]["out"] = out[n]["out"] - eps[n].detach()
        out[n]["g"] = g
    return logits, out
