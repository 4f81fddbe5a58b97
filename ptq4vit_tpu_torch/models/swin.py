"""Functional Swin Transformer forward with explicit quantization taps.

The counterpart of ``ptq4vit_tpu/models/swin.py``: timm's SwinTransformer
(window attention with a relative-position bias, shifted windows, patch
merging) written around explicit ``matmul1`` / ``matmul2`` ops.  Unlike
ViT, q is pre-scaled BEFORE matmul1, so the matmul1 tap's A operand is
``q * hd**-0.5``; the rel-pos bias and the shift mask are added after the
matmul1 tap.  The ``reduction`` linear of PatchMerging is a quantizable op
without bias.

Window-attention taps are (B·nW, heads, N, ·) with the window axis
images-major, so a capture's per-micro-batch concatenation is (images ×
windows)-major, as in the JAX capture.

The window geometry (the rel-pos index, the shifted mask) is made on the
device once per shape and then cached, so a forward copies nothing from
the host; a serving engine also makes each block's B9 term of bias and
mask once (``serving_terms``).  ``geometry_counts()`` counts the builds
and the hits.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..ops import int8_serve as serve
from ..utils.tracing import span
from .common import QuantCtx, cast_params, layer_norm, softmax_f32


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    name: str
    img_size: int = 224
    patch_size: int = 4
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window_size: int = 7
    mlp_ratio: float = 4.0
    num_classes: int = 1000
    ln_eps: float = 1e-5
    in_chans: int = 3

    @property
    def num_layers(self) -> int:
        return len(self.depths)

    def layer_dim(self, i: int) -> int:
        return self.embed_dim * (2 ** i)

    def layer_resolution(self, i: int) -> int:
        return self.img_size // self.patch_size // (2 ** i)

    def block_geometry(self, i: int, j: int) -> Tuple[int, int]:
        """(window_size, shift_size) of block j in layer i: shift on odd
        blocks; both collapse when the resolution fits one window."""
        res = self.layer_resolution(i)
        ws = self.window_size
        shift = 0 if j % 2 == 0 else ws // 2
        if res <= ws:
            ws, shift = res, 0
        return ws, shift


# ---------------------------------------------------------------------------
# static geometry (numpy, cached per shape)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def relative_position_index(ws: int) -> np.ndarray:
    """(ws², ws²) index into the (2ws-1)² relative-position bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0) \
        .astype(np.int64)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def _window_partition_np(x: np.ndarray, ws: int) -> np.ndarray:
    H, W = x.shape
    return (x.reshape(H // ws, ws, W // ws, ws)
             .transpose(0, 2, 1, 3).reshape(-1, ws * ws))


@functools.lru_cache(maxsize=None)
def shifted_window_mask(res: int, ws: int,
                        shift: int) -> Optional[np.ndarray]:
    """(nW, ws², ws²) additive attention mask (0 / -100) of the shifted
    windows; None when shift == 0."""
    if shift == 0:
        return None
    img = np.zeros((res, res), np.float32)
    cnt = 0
    slices = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    for hs in slices:
        for wsl in slices:
            img[hs, wsl] = cnt
            cnt += 1
    mw = _window_partition_np(img, ws)
    mask = mw[:, None, :] - mw[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


# ---------------------------------------------------------------------------
# device geometry (built on first use, then cached per shape and device)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def device_relative_position_index(ws: int,
                                   device: torch.device) -> torch.Tensor:
    """``relative_position_index(ws)`` flattened, as int64 on ``device``."""
    return torch.from_numpy(relative_position_index(ws).reshape(-1)) \
        .to(device)


@functools.lru_cache(maxsize=None)
def device_shifted_window_mask(res: int, ws: int, shift: int,
                               device: torch.device,
                               dtype: torch.dtype) -> torch.Tensor:
    """``shifted_window_mask(res, ws, shift)`` (shift > 0) cast to ``dtype``
    on ``device``."""
    return torch.from_numpy(shifted_window_mask(res, ws, shift)).to(
        device=device, dtype=dtype)


def window_bias_mask(table, ws: int, shift: int, res: int, dtype):
    """A block's (heads, N, N) rel-pos bias gathered from its (2ws-1)²
    ``table`` (heads its columns) and its (nW, N, N) shifted mask in
    ``dtype``, or None unshifted; on the table's device."""
    rpi = device_relative_position_index(ws, table.device)
    bias = table[rpi].reshape(ws * ws, ws * ws, table.shape[-1]) \
        .permute(2, 0, 1)
    mask = (device_shifted_window_mask(res, ws, shift, table.device, dtype)
            if shift else None)
    return bias, mask


# builds of the serving engines' B9 terms (``serving_terms``) and their
# lookups by the forward
_TERM_COUNTS = {"builds": 0, "hits": 0}
_GEOMETRY_CACHES = (("index", device_relative_position_index),
                    ("mask", device_shifted_window_mask))
_ZERO: Dict[str, Tuple[int, int]] = {}     # cache_info at the last reset


def geometry_counts() -> dict:
    """Builds and hits, since ``reset_geometry_counts``, of the device
    rel-pos index, the device shifted mask and the engines' B9 terms."""
    out = {}
    for key, fn in _GEOMETRY_CACHES:
        info = fn.cache_info()
        misses, hits = _ZERO.get(key, (0, 0))
        out[f"{key}_builds"] = info.misses - misses
        out[f"{key}_hits"] = info.hits - hits
    out["term_builds"] = _TERM_COUNTS["builds"]
    out["term_hits"] = _TERM_COUNTS["hits"]
    return out


def reset_geometry_counts() -> None:
    for key, fn in _GEOMETRY_CACHES:
        info = fn.cache_info()
        _ZERO[key] = (info.misses, info.hits)
    _TERM_COUNTS.update(builds=0, hits=0)


def serving_terms(params: Dict[str, Any], cfg: SwinConfig,
                  compute_dtype) -> Dict[str, Any]:
    """B9's additive logit term of every block, built once by a serving
    engine (``parallel/serve.ServingEngine``) from its params: ``packed``
    entries ``{"layers.i.blocks.j.attn": {"window_term": term}}``.  The
    term is made as the forward would make it a request: the table cast
    to ``compute_dtype``, gathered and permuted, the mask in
    ``compute_dtype``, then ``ops/int8_serve.window_term``."""
    terms = {}
    for i, layer in enumerate(params["layers"]):
        res = cfg.layer_resolution(i)
        for j, blk in enumerate(layer["blocks"]):
            ws, shift = cfg.block_geometry(i, j)
            table = blk["attn"]["relative_position_bias_table"] \
                .to(compute_dtype)
            bias, mask = window_bias_mask(table, ws, shift, res,
                                          compute_dtype)
            terms[f"layers.{i}.blocks.{j}.attn"] = {
                "window_term": serve.window_term(bias, mask)}
            _TERM_COUNTS["builds"] += 1
    return terms


def window_partition(x, ws: int):
    """(B, H, W, C) -> (B·nW, ws², C), images-major."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, C)


def window_reverse(xw, ws: int, H: int, W: int):
    """(B·nW, ws², C) -> (B, H, W, C)."""
    C = xw.shape[-1]
    B = xw.shape[0] // ((H // ws) * (W // ws))
    x = xw.reshape(B, H // ws, W // ws, ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def init_params(cfg: SwinConfig, generator: np.random.Generator,
                device="cpu") -> Dict[str, Any]:
    """Random-init parameter tree (timm key layout), drawn from
    ``generator``."""
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
        for j in range(depth):
            ws, _ = cfg.block_geometry(i, j)
            layer["blocks"].append({
                "norm1": ln(d),
                "attn": {"qkv": lin(d, 3 * d), "proj": lin(d, d),
                         "relative_position_bias_table": normal(
                             ((2 * ws - 1) ** 2, heads), 0.02)},
                "norm2": ln(d),
                "mlp": {"fc1": lin(d, hid), "fc2": lin(hid, d)},
            })
        if i < cfg.num_layers - 1:
            layer["downsample"] = {"norm": ln(4 * d),
                                   "reduction": lin(4 * d, 2 * d, bias=False)}
        params["layers"].append(layer)
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _window_attention(ctx: QuantCtx, prefix: str, x, attn_p, heads: int,
                      hd: int, bias, mask, term=None):
    """Window attention of ``heads`` heads of width ``hd`` (this rank's
    under tensor parallelism) over (B·nW, N, C) windows; bias (heads, N,
    N), mask (nW, N, N) tensor or None.  In fused serving the attention
    runs in B9 on the float qkv (``ctx.window_attention_qkv``), with the
    engine's ``term`` of bias and mask if it has one."""
    B_, N, _ = x.shape
    C = heads * hd
    qkv = ctx.linear(f"{prefix}.qkv", x, attn_p["qkv"]["weight"],
                     attn_p["qkv"]["bias"])
    nW = mask.shape[0] if mask is not None else 1
    y = ctx.window_attention_qkv(f"{prefix}.matmul1", f"{prefix}.matmul2",
                                 qkv, heads, nW, hd ** -0.5, bias, mask,
                                 term)
    if y is None:
        qkv = qkv.reshape(B_, N, 3, heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        q = q * (hd ** -0.5)                 # pre-scaled q
        attn = ctx.matmul(f"{prefix}.matmul1", q, k.transpose(-2, -1))
        attn = attn + bias[None]
        if mask is not None:
            attn = attn.reshape(B_ // nW, nW, heads, N, N) \
                + mask[None, :, None]
            attn = attn.reshape(B_, heads, N, N)
        attn = softmax_f32(attn, dim=-1)
        y = ctx.matmul(f"{prefix}.matmul2", attn, v)
        y = y.transpose(1, 2).reshape(B_, N, C)
    return ctx.linear(f"{prefix}.proj", y, attn_p["proj"]["weight"],
                      attn_p["proj"]["bias"])


def forward(params: Dict[str, Any], x, cfg: SwinConfig,
            qstate: Optional[Dict[str, Any]] = None,
            eps: Optional[Dict[str, torch.Tensor]] = None,
            capture: bool = False, int8=False, compute_dtype=None,
            packed: Optional[Dict[str, Any]] = None, mesh=None):
    """Swin forward.  x: (B, 3, H, W) float32.  Returns logits, or
    (logits, taps) when ``capture``.  ``int8``, ``compute_dtype`` and
    ``packed`` as in the ViT forward, and ``mesh`` too (the rel-pos bias
    table is then this rank's heads' columns).  ``int8="fused"`` tries
    each block's fused path (``ctx.swin_block``: B10, B9, B11, B6) first,
    then the per-op one (B6 linears, B9 on the float qkv), then the
    generic ops."""
    with span("ptq.forward.prep"):
        if compute_dtype is not None:
            params = cast_params(params, compute_dtype)
            x = x.to(compute_dtype)
        ctx = QuantCtx(qstate=qstate, eps=eps, capture=capture, int8=int8,
                       packed=packed, mesh=mesh)
    B = x.shape[0]
    with span("ptq.forward.embed"):
        pe = params["patch_embed"]
        x, _ = ctx.conv2d_patch("patch_embed.proj", x, pe["proj"]["weight"],
                                pe["proj"]["bias"], cfg.patch_size)
        x = layer_norm(x, pe["norm"]["weight"], pe["norm"]["bias"], cfg.ln_eps)

    for i, layer in enumerate(params["layers"]):
        res = cfg.layer_resolution(i)
        d = cfg.layer_dim(i)
        hd = d // cfg.num_heads[i]
        heads = ctx.local_heads(cfg.num_heads[i])
        for j, blk in enumerate(layer["blocks"]):
            with span("ptq.forward.block"):
                ws, shift = cfg.block_geometry(i, j)
                p = f"layers.{i}.blocks.{j}"
                table = blk["attn"]["relative_position_bias_table"]
                with span("ptq.forward.geometry"):
                    # a serving engine's term of bias and mask, else both
                    # from the device caches
                    term = (ctx.packed.get(f"{p}.attn") or {}).get(
                        "window_term")
                    if term is not None:
                        _TERM_COUNTS["hits"] += 1
                        bias = mask = None
                    else:
                        bias, mask = window_bias_mask(table, ws, shift, res,
                                                      x.dtype)
                xb = ctx.swin_block(p, x, blk, heads, ws, shift, res, bias,
                                    mask, cfg.ln_eps, term)
                if xb is not None:
                    x = xb
                    continue
                if bias is None:
                    bias, mask = window_bias_mask(table, ws, shift, res,
                                                  x.dtype)
                shortcut = x
                y = layer_norm(x, blk["norm1"]["weight"], blk["norm1"]["bias"],
                               cfg.ln_eps)
                y = y.reshape(B, res, res, d)
                if shift > 0:
                    y = torch.roll(y, (-shift, -shift), dims=(1, 2))
                yw = _window_attention(ctx, f"{p}.attn",
                                       window_partition(y, ws), blk["attn"],
                                       heads, hd, bias, mask, term)
                y = window_reverse(yw, ws, res, res)
                if shift > 0:
                    y = torch.roll(y, (shift, shift), dims=(1, 2))
                x = shortcut + y.reshape(B, res * res, d)
                y = layer_norm(x, blk["norm2"]["weight"], blk["norm2"]["bias"],
                               cfg.ln_eps)
                y = ctx.linear_gelu(f"{p}.mlp.fc1", y,
                                    blk["mlp"]["fc1"]["weight"],
                                    blk["mlp"]["fc1"]["bias"])
                y = ctx.linear(f"{p}.mlp.fc2", y, blk["mlp"]["fc2"]["weight"],
                               blk["mlp"]["fc2"]["bias"])
                x = x + y
        if "downsample" in layer:
            with span("ptq.forward.downsample"):
                # PatchMerging: 2x2 neighbourhood concat -> LN -> reduction
                ds = layer["downsample"]
                y = x.reshape(B, res, res, d)
                y = torch.cat([y[:, 0::2, 0::2], y[:, 1::2, 0::2],
                               y[:, 0::2, 1::2], y[:, 1::2, 1::2]], dim=-1)
                y = y.reshape(B, (res // 2) * (res // 2), 4 * d)
                y = layer_norm(y, ds["norm"]["weight"], ds["norm"]["bias"],
                               cfg.ln_eps)
                x = ctx.linear(f"layers.{i}.downsample.reduction", y,
                               ds["reduction"]["weight"], None)

    with span("ptq.forward.head"):
        x = layer_norm(x, params["norm"]["weight"], params["norm"]["bias"],
                       cfg.ln_eps)
        x = torch.mean(x, dim=1)                 # global average pool
        logits = ctx.linear("head", x, params["head"]["weight"],
                            params["head"]["bias"])
    if capture:
        return logits, ctx.taps
    return logits


def op_inventory(cfg: SwinConfig):
    """Ordered (name, module_type) list of quantizable ops (the reference's
    module walk)."""
    ops = [("patch_embed.proj", "qconv")]
    for i, depth in enumerate(cfg.depths):
        for j in range(depth):
            p = f"layers.{i}.blocks.{j}"
            ops += [
                (f"{p}.attn.qkv", "qlinear_qkv"),
                (f"{p}.attn.matmul1", "qmatmul_qk"),
                (f"{p}.attn.matmul2", "qmatmul_scorev"),
                (f"{p}.attn.proj", "qlinear_proj"),
                (f"{p}.mlp.fc1", "qlinear_MLP_1"),
                (f"{p}.mlp.fc2", "qlinear_MLP_2"),
            ]
        if i < cfg.num_layers - 1:
            ops.append((f"layers.{i}.downsample.reduction",
                        "qlinear_reduction"))
    ops.append(("head", "qlinear_classifier"))
    return ops


def op_shapes(cfg: SwinConfig):
    """Static per-op shape info; window matmuls carry ``windows``, the
    number of windows per image (their caches hold images × windows
    samples)."""
    info = {"patch_embed.proj": {
        "kind": "conv",
        "in_features": cfg.in_chans * cfg.patch_size ** 2,
        "out_features": cfg.embed_dim,
        "tokens": (cfg.img_size // cfg.patch_size) ** 2}}
    for i, depth in enumerate(cfg.depths):
        res = cfg.layer_resolution(i)
        d = cfg.layer_dim(i)
        heads = cfg.num_heads[i]
        hid = int(d * cfg.mlp_ratio)
        tokens = res * res
        for j in range(depth):
            ws, _ = cfg.block_geometry(i, j)
            p = f"layers.{i}.blocks.{j}"
            nwin = (res // ws) ** 2
            N = ws * ws
            info[f"{p}.attn.qkv"] = {"kind": "linear", "in_features": d,
                                     "out_features": 3 * d, "tokens": tokens}
            info[f"{p}.attn.matmul1"] = {"kind": "matmul", "heads": heads,
                                         "rows": N, "inner": d // heads,
                                         "cols": N, "windows": nwin}
            info[f"{p}.attn.matmul2"] = {"kind": "matmul", "heads": heads,
                                         "rows": N, "inner": N,
                                         "cols": d // heads, "windows": nwin}
            info[f"{p}.attn.proj"] = {"kind": "linear", "in_features": d,
                                      "out_features": d, "tokens": tokens}
            info[f"{p}.mlp.fc1"] = {"kind": "linear", "in_features": d,
                                    "out_features": hid, "tokens": tokens}
            info[f"{p}.mlp.fc2"] = {"kind": "linear", "in_features": hid,
                                    "out_features": d, "tokens": tokens}
        if i < cfg.num_layers - 1:
            info[f"layers.{i}.downsample.reduction"] = {
                "kind": "linear", "in_features": 4 * d,
                "out_features": 2 * d, "tokens": (res // 2) ** 2}
    info["head"] = {"kind": "linear",
                    "in_features": cfg.layer_dim(cfg.num_layers - 1),
                    "out_features": cfg.num_classes, "tokens": 1}
    return info
