"""Serving traffic of a Swin V2 configuration: the closed loop of
``traffic/serve.py`` (its ``window`` and ``release``, and the same mix
parameters), with its own set-up and check, since the weights, the
min-max serving qstate and the reference logits follow V2's parameter
tree and forward (``reference/swinv2.py``).

Weights are drawn on the device in one call of a seeded
``torch.Generator``, in float32, in the order of ``_leaves``: linear and
CPB weights normal with std sqrt(2 / (in + out)), biases and LayerNorm
shifts normal with std 0.02 (the k third of each qkv bias zero: timm's
k_bias is a zero buffer), LayerNorm scales 1 + 0.1 normal, and every
``logit_scale`` at ln 10, timm's init.
"""
from __future__ import annotations

import dataclasses
import math
import random
import time

import numpy as np
import torch

from .. import model
from ..reference import fq
from ..reference import swinv2 as ref
from ..reference.models import Hooks, op_kinds, op_weight
from ..reference.serve import judge
from .serve import release, window  # noqa: F401  (the generator's API)

CPB_HIDDEN = 512


def _leaves(cfg):
    """[(path, shape, kind)] of a Swin V2 configuration's parameters;
    kind: "lin", "small", "scale", "qkv_bias" (small, k third zero) or
    "tau" (ln 10)."""
    out = []

    def lin(p, n_in, n_out, bias="small"):
        out.append((p + ("weight",), (n_out, n_in), "lin"))
        if bias:
            out.append((p + ("bias",), (n_out,), bias))

    def ln(p, d):
        out.append((p + ("weight",), (d,), "scale"))
        out.append((p + ("bias",), (d,), "small"))

    c0, pz = cfg["embed_dim"], cfg["patch_size"]
    ic = cfg.get("in_chans", 3)
    mlp = cfg.get("mlp_ratio", 4.0)
    out.append((("patch_embed", "proj", "weight"), (c0, ic, pz, pz), "small"))
    out.append((("patch_embed", "proj", "bias"), (c0,), "small"))
    ln(("patch_embed", "norm"), c0)
    nl = len(cfg["depths"])
    for i, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        d = c0 * 2 ** i
        for j in range(depth):
            b = ("layers", i, "blocks", j)
            lin(b + ("attn", "qkv"), d, 3 * d, bias="qkv_bias")
            out.append((b + ("attn", "logit_scale"), (heads, 1, 1), "tau"))
            lin(b + ("attn", "cpb_mlp", "0"), 2, CPB_HIDDEN)
            lin(b + ("attn", "cpb_mlp", "2"), CPB_HIDDEN, heads, bias=None)
            lin(b + ("attn", "proj"), d, d)
            ln(b + ("norm1",), d)
            lin(b + ("mlp", "fc1"), d, int(d * mlp))
            lin(b + ("mlp", "fc2"), int(d * mlp), d)
            ln(b + ("norm2",), d)
        if i < nl - 1:
            lin(("layers", i, "downsample", "reduction"), 4 * d, 2 * d,
                bias=None)
            ln(("layers", i, "downsample", "norm"), 2 * d)
    ln(("norm",), c0 * 2 ** (nl - 1))
    lin(("head",), c0 * 2 ** (nl - 1), cfg.get("num_classes", 1000))
    return out


def make_params(cfg, seed: int, device):
    """The parameter tree, drawn on ``device`` in one call."""
    leaves = _leaves(cfg)
    total = sum(int(torch.Size(s).numel()) for _, s, _ in leaves)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    tree, off = {}, 0
    for path, shape, kind in leaves:
        n = int(torch.Size(shape).numel())
        v = flat[off:off + n].view(shape)
        off += n
        if kind == "lin":
            v.mul_((2.0 / (shape[0] + shape[1])) ** 0.5)
        elif kind in ("small", "qkv_bias"):
            v.mul_(0.02)
            if kind == "qkv_bias":
                v[n // 3:2 * n // 3] = 0.0
        elif kind == "tau":
            v.fill_(math.log(10.0))
        else:
            v.mul_(0.1).add_(1.0)
        model._put(tree, path, v)
    return tree


def serving_qstate(params, cfg, images, bits=(8, 8), block=8):
    """{op: fq.OpQuant} calibrated by min-max on ``images`` with the float
    net, as ``model.serving_qstate`` calibrates V1 (matmul1's operands
    are q̂ and k̂ᵀ here)."""
    kinds = op_kinds(cfg)
    w_qmax, a_qmax = 2 ** (bits[0] - 1), 2 ** (bits[1] - 1)
    dev = params["head"]["weight"].device
    top, errs = {}, {}
    splits = fq.split_grid(20, dev)

    def keep(name, v):
        top[name] = v if name not in top else torch.maximum(top[name], v)

    def heads(t):
        return t.abs().transpose(0, 1).reshape(t.shape[1], -1).amax(1)

    class MinMax(Hooks):
        def linear(self, name, x, w, b):
            keep(name, x.amax() if kinds[name] == "postgelu"
                 else x.abs().amax())
            return super().linear(name, x, w, b)

        def matmul(self, name, a, b):
            keep(name + "/b", heads(b))
            if kinds[name] == "sos":
                raw = a @ b
                e = torch.stack([((fq.quant_sos(a, s, a_qmax) @ b - raw) ** 2)
                                 .sum() for s in splits])
                errs[name] = errs.get(name, 0) + e
            else:
                keep(name + "/a", heads(a))
            return super().matmul(name, a, b)

    with torch.no_grad():
        for s0 in range(0, images.shape[0], block):
            ref.forward(params, images[s0:s0 + block].float(), cfg, MinMax())

    def iv(name):
        return fq.div(top[name], a_qmax - 0.5)

    out = {}
    for name, kind in kinds.items():
        if kind == "sos":
            out[name] = fq.OpQuant("matmul", bits, b=iv(name + "/b"),
                                   split=splits[torch.argmin(errs[name])])
        elif kind == "matmul":
            out[name] = fq.OpQuant("matmul", bits, a=iv(name + "/a"),
                                   b=iv(name + "/b"))
        else:
            w, _ = op_weight(params, name)
            if kind == "conv":
                out[name] = fq.OpQuant("conv", bits, w=fq.div(
                    w.abs().amax(1), w_qmax - 0.5))
                continue
            n_v = 3 if kind == "qkv" else 1
            out[name] = fq.OpQuant(
                "linear", bits,
                w=fq.div(w.abs().reshape(n_v, -1).amax(1), w_qmax - 0.5),
                a=iv(name),
                a_neg=(fq.div(torch.tensor(fq.GELU_NEG_CLIP, device=dev),
                              a_qmax) if kind == "postgelu" else None))
    return out


def port_config(cfg, name):
    """The program's SwinV2Config of a configuration's model group."""
    from ptq4vit_tpu_torch.models.swinv2 import SwinV2Config
    keys = {f.name for f in dataclasses.fields(SwinV2Config)}
    kw = {k: (tuple(v) if isinstance(v, list) else v)
          for k, v in cfg.items() if k in keys}
    return SwinV2Config(name=name, **kw)


def setup(run):
    from ptq4vit_tpu_torch import ServingEngine
    from ptq4vit_tpu_torch.models.registry import net_from_config
    mix, cfg, dev = run.mix, run.cfg, run.device
    if dev.type == "cuda":
        from ptq4vit_tpu_torch.ops import build
        build.build_all()
    pcfg = port_config(cfg, run.cell.config["name"])    # a program without
    params = make_params(cfg, run.seed, dev)            # V2 stops here
    b, n = mix["batch"], mix["pool"]
    imgs = model.make_images(b * n, cfg, run.seed, dev)
    plain = serving_qstate(params, cfg, imgs[:b],
                           tuple(mix.get("bits", (8, 8))))
    net = net_from_config(pcfg, params)
    engine = ServingEngine(net, model.port_qstate(plain, cfg), device=dev)
    imgs = imgs.cpu().numpy()
    pool = [np.ascontiguousarray(imgs[i * b:(i + 1) * b]) for i in range(n)]
    del imgs
    run.state.update(params=params, plain=plain, engine=engine, pool=pool)
    for i in range(mix.get("warmup", 3)):
        engine(pool[i % n]).cpu()


def check(run):
    """``traffic/serve.check`` with V2's reference logits: the widest
    logit error and the rms error over the sampled requests (and with
    ``run.control`` the control's, into ``run.records["control"]``)."""
    st, mix = run.state, run.mix
    outs = run.records["outs"]
    done = [i for i, o in enumerate(outs) if o is not None]
    if not done:
        return {k: float("inf") for k in run.cell.limits}
    rng = random.Random(run.seed)
    k = min(mix.get("check_requests", 4), len(done))
    by_pool = {}
    for i in rng.sample(done, len(done)):
        by_pool.setdefault(i % len(st["pool"]), i)
    picks = sorted(by_pool.values())[:k]
    if len(picks) < k:
        picks += rng.sample([i for i in done if i not in picks],
                            k - len(picks))
    t0 = time.time()
    numbers, control = {}, {}
    for i in picks:
        x = st["pool"][i % len(st["pool"])]
        r = ref.logits(st["params"], run.cfg, st["plain"], x)
        for name, v in judge(outs[i], r).items():
            numbers[name] = max(numbers.get(name, 0.0), v)
        if run.control:
            c = ref.logits(st["params"], run.cfg, st["plain"], x,
                           control=True)
            for name, v in judge(c, r).items():
                control[name] = max(control.get(name, 0.0), v)
    run.records["reference_s"] = time.time() - t0
    if run.control:
        run.records["control"] = control
        run.log(f"control: {control}")
    run.log(f"check of requests {picks}: {numbers} "
            f"(reference {run.records['reference_s']:.1f}s)")
    return numbers
