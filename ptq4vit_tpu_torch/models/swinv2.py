"""Functional Swin Transformer V2 forward with explicit quantization taps.

Liu et al., "Swin Transformer V2: Scaling Up Capacity and Resolution"
(arXiv:2111.09883), as timm's ``SwinTransformerV2`` computes it, written
around the same named ops as the Swin V1 forward (``models/swin.py``,
whose window geometry it shares).  Per block, with x the block input:

  * qkv = x·W_qkvᵀ + [q_bias, 0, v_bias]: no LayerNorm before attention
    (timm's q_bias and v_bias are held as the qkv linear's bias, its k
    third zero, so that every quantized op's weight and bias sit at its
    path as in V1);
  * cosine attention: matmul1's operands are q̂ = q/‖q‖ and k̂ = k/‖k‖ per
    head (``F.normalize``), its output is scaled per head by
    τ_h = exp(min(θ_h, ln 100)) outside the quantized op, then the
    continuous position bias 16·σ(MLP(Δ̂))[index] (and the shifted mask)
    is added;
  * res-post-norm: x ← x + LN1(proj(·)), x ← x + LN2(fc2(GELU(fc1(x))));
  * PatchMerging: 2x2 concat -> reduction (4C -> 2C) -> LN(2C), at the end
    of stage i as the port's V1 places it.

The CPB network (Linear(2, 512) + ReLU + Linear(512, H)) stays float: it
is not one of PTQ4ViT's quantized ops.  It runs in float32 from the float
params whatever the compute dtype.  A serving engine builds each block's
B9 term (bias and mask) and τ once (``serving_terms``);
``cpb_counts()`` counts the CPB builds, the forward's hits on an
engine's terms and the bytes of the terms built.

The relaxed serving mode and tensor parallelism are not built for V2 and
raise ``ValueError``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import int8_serve as serve
from ..utils.tracing import span
from . import swin
from .common import QuantCtx, cast_params, layer_norm, softmax_f32

CPB_HIDDEN = 512
LOGIT_SCALE_MAX = math.log(1.0 / 0.01)


@dataclasses.dataclass(frozen=True)
class SwinV2Config(swin.SwinConfig):
    """SwinConfig plus each stage's pretrained window size, which
    normalizes the CPB coordinates (0: the block's own window)."""
    pretrained_window_sizes: Tuple[int, ...] = (0, 0, 0, 0)


# ---------------------------------------------------------------------------
# continuous position bias
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def device_coords_table(ws: int, pws: int,
                        device: torch.device) -> torch.Tensor:
    """((2ws-1)², 2) float32 log-spaced relative coordinates on
    ``device``: Δ / (W_pre - 1) · 8, then sign·log2(1 + |·|) / log2 8, as
    timm computes them in float32 (W_pre = ws when ``pws`` is 0)."""
    r = torch.arange(-(ws - 1), ws, dtype=torch.float32)
    t = torch.stack(torch.meshgrid(r, r, indexing="ij"), -1)
    t = t / ((pws if pws > 0 else ws) - 1)
    t = t * 8
    t = torch.sign(t) * torch.log2(torch.abs(t) + 1.0) / math.log2(8)
    return t.reshape(-1, 2).to(device)


def cpb_bias(attn_p, ws: int, pws: int) -> torch.Tensor:
    """A block's (H, N, N) float32 position bias 16·σ(MLP(Δ̂))[index]
    from its float attention params."""
    w0 = attn_p["cpb_mlp"]["0"]
    w2 = attn_p["cpb_mlp"]["2"]["weight"].float()
    dev = w2.device
    h = torch.relu(device_coords_table(ws, pws, dev) @ w0["weight"].float().t()
                   + w0["bias"].float())
    table = h @ w2.t()                                  # ((2ws-1)², H)
    rpi = swin.device_relative_position_index(ws, dev)
    bias = table[rpi].reshape(ws * ws, ws * ws, -1).permute(2, 0, 1)
    _CPB_COUNTS["cpb_builds"] += 1
    return 16.0 * torch.sigmoid(bias)


def logit_tau(attn_p) -> torch.Tensor:
    """(H,) float32 τ_h = exp(min(θ_h, ln 100))."""
    theta = attn_p["logit_scale"].float().reshape(-1)
    return torch.exp(torch.clamp(theta, max=LOGIT_SCALE_MAX))


_CPB_COUNTS = {"cpb_builds": 0, "cpb_hits": 0, "term_bytes": 0}


def cpb_counts() -> dict:
    """CPB network runs (``cpb_builds``), a forward's lookups of an
    engine's terms in place of them (``cpb_hits``) and the bytes of the
    B9 terms ``serving_terms`` built (``term_bytes``), since
    ``reset_cpb_counts``."""
    return dict(_CPB_COUNTS)


def reset_cpb_counts() -> None:
    _CPB_COUNTS.update(cpb_builds=0, cpb_hits=0, term_bytes=0)


def block_terms(blk, cfg: SwinV2Config, i: int, j: int, dtype):
    """A block's float32 bias (H, N, N) and τ (H,) and the shifted mask
    in ``dtype`` (or None)."""
    ws, shift = cfg.block_geometry(i, j)
    res = cfg.layer_resolution(i)
    a = blk["attn"]
    mask = (swin.device_shifted_window_mask(
        res, ws, shift, a["logit_scale"].device, dtype) if shift else None)
    return cpb_bias(a, ws, cfg.pretrained_window_sizes[i]), logit_tau(a), mask


def serving_terms(params: Dict[str, Any], cfg: SwinV2Config,
                  compute_dtype) -> Dict[str, Any]:
    """What a serving engine builds once per block from its float params:
    ``packed`` entries ``{"layers.i.blocks.j.attn": {"window_term",
    "tau"}}`` -- B9's float32 term of the position bias and the mask in
    ``compute_dtype`` (``ops/int8_serve.window_term``), and τ in
    float32."""
    terms = {}
    for i, layer in enumerate(params["layers"]):
        for j, blk in enumerate(layer["blocks"]):
            bias, tau, mask = block_terms(blk, cfg, i, j, compute_dtype)
            term = serve.window_term(bias, mask)
            terms[f"layers.{i}.blocks.{j}.attn"] = {"window_term": term,
                                                    "tau": tau}
            _CPB_COUNTS["term_bytes"] += term.numel() * term.element_size()
    return terms


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def init_params(cfg: SwinV2Config, generator: np.random.Generator,
                device="cpu") -> Dict[str, Any]:
    """Random-init parameter tree under timm's names, drawn from
    ``generator``: linears normal with std sqrt(2 / (in + out)), biases
    (the qkv bias [q_bias, 0, v_bias] too) and LayerNorm shifts zero,
    LayerNorm scales one, ``logit_scale`` at ln 10 (timm's init)."""
    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    def normal(shape, scale):
        return t(generator.standard_normal(shape, dtype=np.float32) * scale)

    def lin(n_in, n_out, bias=True):
        p = {"weight": normal((n_out, n_in),
                              np.float32((2.0 / (n_in + n_out)) ** 0.5))}
        if bias:
            p["bias"] = t(np.zeros((n_out,)))
        return p

    def ln(d):
        return {"weight": t(np.ones((d,))), "bias": t(np.zeros((d,)))}

    dlast = cfg.layer_dim(cfg.num_layers - 1)
    params: Dict[str, Any] = {
        "patch_embed": {
            "proj": {"weight": normal((cfg.embed_dim, cfg.in_chans,
                                       cfg.patch_size, cfg.patch_size), 0.02),
                     "bias": t(np.zeros((cfg.embed_dim,)))},
            "norm": ln(cfg.embed_dim)},
        "layers": [],
        "norm": ln(dlast),
        "head": lin(dlast, cfg.num_classes),
    }
    for i, (depth, heads) in enumerate(zip(cfg.depths, cfg.num_heads)):
        d = cfg.layer_dim(i)
        hid = int(d * cfg.mlp_ratio)
        layer: Dict[str, Any] = {"blocks": []}
        for _ in range(depth):
            layer["blocks"].append({
                "attn": {"qkv": lin(d, 3 * d),
                         "logit_scale": t(np.full((heads, 1, 1),
                                                  math.log(10.0))),
                         "cpb_mlp": {"0": lin(2, CPB_HIDDEN),
                                     "2": lin(CPB_HIDDEN, heads,
                                              bias=False)},
                         "proj": lin(d, d)},
                "norm1": ln(d),
                "mlp": {"fc1": lin(d, hid), "fc2": lin(hid, d)},
                "norm2": ln(d),
            })
        if i < cfg.num_layers - 1:
            layer["downsample"] = {"reduction": lin(4 * d, 2 * d, bias=False),
                                   "norm": ln(2 * d)}
        params["layers"].append(layer)
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _window_attention(ctx: QuantCtx, prefix: str, x, attn_p, heads: int,
                      bias, tau, mask):
    """Cosine window attention over (B·nW, N, C) windows, the generic
    per-op path: q̂ and k̂ into matmul1, its output times τ_h plus the
    bias (H, N, N) and the mask (nW, N, N) or None."""
    B_, N, C = x.shape
    hd = C // heads
    qkv = ctx.linear(f"{prefix}.qkv", x, attn_p["qkv"]["weight"],
                     attn_p["qkv"]["bias"])
    qkv = qkv.reshape(B_, N, 3, heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = F.normalize(qkv[0], dim=-1), F.normalize(qkv[1], dim=-1), qkv[2]
    attn = ctx.matmul(f"{prefix}.matmul1", q, k.transpose(-2, -1))
    attn = attn * tau.to(attn.dtype).reshape(1, heads, 1, 1) \
        + bias.to(attn.dtype)[None]
    if mask is not None:
        nW = mask.shape[0]
        attn = (attn.reshape(B_ // nW, nW, heads, N, N)
                + mask[None, :, None]).reshape(B_, heads, N, N)
    attn = softmax_f32(attn, dim=-1)
    y = ctx.matmul(f"{prefix}.matmul2", attn, v)
    y = y.transpose(1, 2).reshape(B_, N, C)
    return ctx.linear(f"{prefix}.proj", y, attn_p["proj"]["weight"],
                      attn_p["proj"]["bias"])


def forward(params: Dict[str, Any], x, cfg: SwinV2Config,
            qstate: Optional[Dict[str, Any]] = None,
            eps: Optional[Dict[str, torch.Tensor]] = None,
            capture: bool = False, int8=False, compute_dtype=None,
            packed: Optional[Dict[str, Any]] = None, mesh=None):
    """Swin V2 forward; arguments and result as the Swin V1 forward's.
    ``int8="fused"`` runs each block's fused path (``ctx.swinv2_block``:
    B10, its normalizing epilogue, B9, B11 and B6 with post-norm
    epilogues) where the block's QPs are in scope, else the generic ops."""
    if int8 == "fused_relaxed":
        raise ValueError("Swin V2 has no relaxed serving mode: serve it "
                         "with int8='fused' (relaxed=False)")
    with span("ptq.forward.prep"):
        floats = params                 # the CPB runs on the float params
        if compute_dtype is not None:
            params = cast_params(params, compute_dtype)
            x = x.to(compute_dtype)
        ctx = QuantCtx(qstate=qstate, eps=eps, capture=capture, int8=int8,
                       packed=packed, mesh=mesh)
    if ctx.tp > 1:
        raise ValueError("Swin V2 has no tensor-parallel forward: run it "
                         "data-parallel (model=1)")
    B = x.shape[0]
    with span("ptq.forward.embed"):
        pe = params["patch_embed"]
        x, _ = ctx.conv2d_patch("patch_embed.proj", x, pe["proj"]["weight"],
                                pe["proj"]["bias"], cfg.patch_size)
        x = layer_norm(x, pe["norm"]["weight"], pe["norm"]["bias"],
                       cfg.ln_eps)

    for i, layer in enumerate(params["layers"]):
        res = cfg.layer_resolution(i)
        d = cfg.layer_dim(i)
        heads = cfg.num_heads[i]
        for j, blk in enumerate(layer["blocks"]):
            with span("ptq.forward.block"):
                ws, shift = cfg.block_geometry(i, j)
                p = f"layers.{i}.blocks.{j}"
                held = ctx.packed.get(f"{p}.attn") or {}
                if "window_term" in held:
                    _CPB_COUNTS["cpb_hits"] += 1
                    term, tau = held["window_term"], held["tau"]
                    bias = mask = None
                else:
                    with span("ptq.forward.cpb"):
                        bias, tau, mask = block_terms(
                            floats["layers"][i]["blocks"][j], cfg, i, j,
                            x.dtype)
                        term = None
                xb = ctx.swinv2_block(p, x, blk, heads, ws, shift, res, bias,
                                      tau, mask, cfg.ln_eps, term)
                if xb is not None:
                    x = xb
                    continue
                if bias is None:
                    bias, _, mask = block_terms(
                        floats["layers"][i]["blocks"][j], cfg, i, j, x.dtype)
                y = x.reshape(B, res, res, d)
                if shift > 0:
                    y = torch.roll(y, (-shift, -shift), dims=(1, 2))
                yw = _window_attention(ctx, f"{p}.attn",
                                       swin.window_partition(y, ws),
                                       blk["attn"], heads, bias, tau, mask)
                y = swin.window_reverse(yw, ws, res, res)
                if shift > 0:
                    y = torch.roll(y, (shift, shift), dims=(1, 2))
                x = x + layer_norm(y.reshape(B, res * res, d),
                                   blk["norm1"]["weight"],
                                   blk["norm1"]["bias"], cfg.ln_eps)
                y = ctx.linear_gelu(f"{p}.mlp.fc1", x,
                                    blk["mlp"]["fc1"]["weight"],
                                    blk["mlp"]["fc1"]["bias"])
                y = ctx.linear(f"{p}.mlp.fc2", y, blk["mlp"]["fc2"]["weight"],
                               blk["mlp"]["fc2"]["bias"])
                x = x + layer_norm(y, blk["norm2"]["weight"],
                                   blk["norm2"]["bias"], cfg.ln_eps)
        if "downsample" in layer:
            with span("ptq.forward.downsample"):
                # PatchMerging V2: 2x2 concat -> reduction -> LN
                ds = layer["downsample"]
                y = x.reshape(B, res, res, d)
                y = torch.cat([y[:, 0::2, 0::2], y[:, 1::2, 0::2],
                               y[:, 0::2, 1::2], y[:, 1::2, 1::2]], dim=-1)
                y = y.reshape(B, (res // 2) * (res // 2), 4 * d)
                y = ctx.linear(f"layers.{i}.downsample.reduction", y,
                               ds["reduction"]["weight"], None)
                x = layer_norm(y, ds["norm"]["weight"], ds["norm"]["bias"],
                               cfg.ln_eps)

    with span("ptq.forward.head"):
        x = layer_norm(x, params["norm"]["weight"], params["norm"]["bias"],
                       cfg.ln_eps)
        x = torch.mean(x, dim=1)
        logits = ctx.linear("head", x, params["head"]["weight"],
                            params["head"]["bias"])
    if capture:
        return logits, ctx.taps
    return logits


# the quantizable ops and their shapes: Swin V1's, at V2's geometry
op_inventory = swin.op_inventory
op_shapes = swin.op_shapes
