"""What the benchmark makes from ``--seed`` and hands to both sides: the
weights, the images, the probe noise and the serving qstate (min-max on
the float net), and the bridges between the program's types and the
reference's plain ones.

Weights are drawn on the device in one call of a seeded
``torch.Generator``, in float32, timm's layout: linear weights normal
with std sqrt(2 / (in + out)), embeddings, biases, relative-position
tables and LayerNorm shifts normal with std 0.02, LayerNorm scales 1 +
0.1 normal.
"""
from __future__ import annotations

import dataclasses

import torch

from .reference import fq
from .reference.models import op_kinds


def _leaves(cfg):
    """[(path, shape, kind)] of the configuration's parameters in timm's
    layout; kind: "lin" (std sqrt(2 / (in + out))), "small" (0.02),
    "scale" (1 + 0.1 N)."""
    out = []

    def lin(p, n_in, n_out, bias=True):
        out.append((p + ("weight",), (n_out, n_in), "lin"))
        if bias:
            out.append((p + ("bias",), (n_out,), "small"))

    def ln(p, d):
        out.append((p + ("weight",), (d,), "scale"))
        out.append((p + ("bias",), (d,), "small"))

    c0, pz = cfg["embed_dim"], cfg["patch_size"]
    ic = cfg.get("in_chans", 3)
    mlp = cfg.get("mlp_ratio", 4.0)
    classes = cfg.get("num_classes", 1000)
    if cfg["kind"] == "vit":
        n = (cfg["img_size"] // pz) ** 2 + 1
        out.append((("cls_token",), (1, 1, c0), "small"))
        out.append((("pos_embed",), (1, n, c0), "small"))
        out.append((("patch_embed", "proj", "weight"), (c0, ic, pz, pz),
                    "small"))
        out.append((("patch_embed", "proj", "bias"), (c0,), "small"))
        for i in range(cfg["depth"]):
            b = ("blocks", i)
            ln(b + ("norm1",), c0)
            lin(b + ("attn", "qkv"), c0, 3 * c0)
            lin(b + ("attn", "proj"), c0, c0)
            ln(b + ("norm2",), c0)
            lin(b + ("mlp", "fc1"), c0, int(c0 * mlp))
            lin(b + ("mlp", "fc2"), int(c0 * mlp), c0)
        ln(("norm",), c0)
        lin(("head",), c0, classes)
        return out
    out.append((("patch_embed", "proj", "weight"), (c0, ic, pz, pz), "small"))
    out.append((("patch_embed", "proj", "bias"), (c0,), "small"))
    ln(("patch_embed", "norm"), c0)
    nl = len(cfg["depths"])
    for i, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        d = c0 * 2 ** i
        res = cfg["img_size"] // pz // 2 ** i
        ws = min(cfg["window_size"], res)
        for j in range(depth):
            b = ("layers", i, "blocks", j)
            ln(b + ("norm1",), d)
            lin(b + ("attn", "qkv"), d, 3 * d)
            lin(b + ("attn", "proj"), d, d)
            out.append((b + ("attn", "relative_position_bias_table"),
                        ((2 * ws - 1) ** 2, heads), "small"))
            ln(b + ("norm2",), d)
            lin(b + ("mlp", "fc1"), d, int(d * mlp))
            lin(b + ("mlp", "fc2"), int(d * mlp), d)
        if i < nl - 1:
            ln(("layers", i, "downsample", "norm"), 4 * d)
            lin(("layers", i, "downsample", "reduction"), 4 * d, 2 * d,
                bias=False)
    ln(("norm",), c0 * 2 ** (nl - 1))
    lin(("head",), c0 * 2 ** (nl - 1), classes)
    return out


def _put(tree, path, value):
    node = tree
    for k, nxt in zip(path[:-1], path[1:]):
        if isinstance(k, int):
            while len(node) <= k:
                node.append({} if not isinstance(nxt, int) else [])
            node = node[k]
        else:
            node = node.setdefault(k, [] if isinstance(nxt, int) else {})
    node[path[-1]] = value


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
        elif kind == "small":
            v.mul_(0.02)
        else:
            v.mul_(0.1).add_(1.0)
        _put(tree, path, v)
    return tree


def make_images(n: int, cfg, seed: int, device, stream: int = 1):
    """(n, 3, H, W) float32 Gaussian images on ``device`` (normalized
    images' statistics), from the seed and a stream number."""
    gen = torch.Generator(device=device).manual_seed(seed * 7919 + stream)
    s = cfg["img_size"]
    return torch.randn((n, cfg.get("in_chans", 3), s, s), generator=gen,
                       device=device)


def make_probe_u(n: int, cfg, seed: int, device):
    """(n, classes) Gaussian probe noise of the hessian metric."""
    gen = torch.Generator(device=device).manual_seed(seed * 7919 + 2)
    return torch.randn((n, cfg.get("num_classes", 1000)), generator=gen,
                       device=device)


def serving_qstate(params, cfg, images, bits=(8, 8), block=8):
    """{op: fq.OpQuant} calibrated by min-max on ``images`` with the
    float net: weight intervals at absmax / (qmax - 0.5) (per channel for
    the patch embedding, per row block for a linear), every input at its
    absmax / (qmax - 0.5) (a post-GELU input at its max, with the fixed
    negative interval 0.1699... / qmax), matmul operands per head, and
    the post-softmax split, among 2^-i (i < 20), the one whose quantized
    product is nearest the float product.  The kernels' work does not
    depend on the values."""
    from .reference.models import Hooks, forward, op_weight
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
            forward(params, images[s0:s0 + block].float(), cfg, MinMax())

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


# -- bridges to the program's types ---------------------------------------

def port_config(cfg, name):
    """The program's ViTConfig / SwinConfig of a configuration's model
    group."""
    from ptq4vit_tpu_torch.models import swin, vit
    cls = vit.ViTConfig if cfg["kind"] == "vit" else swin.SwinConfig
    keys = {f.name for f in dataclasses.fields(cls)}
    kw = {k: (tuple(v) if isinstance(v, list) else v)
          for k, v in cfg.items() if k in keys}
    return cls(name=name, **kw)


def port_qstate(plain, cfg):
    """The program's qstate of the benchmark's plain one."""
    from ptq4vit_tpu_torch.quant.qparams import ConvQP, LinearQP, MatMulQP
    out = {}
    kinds = op_kinds(cfg)
    for name, q in plain.items():
        f = q.f
        bits = dict(w_bit=int(q.w_qmax).bit_length(),
                    a_bit=int(q.a_qmax).bit_length())
        if q.kind == "conv":
            out[name] = ConvQP(w_interval=f["w"].reshape(-1, 1, 1, 1),
                               a_interval=None, w_bit=bits["w_bit"],
                               a_bit=32)
        elif q.kind == "linear":
            out[name] = LinearQP(
                w_interval=f["w"].reshape(-1, 1, 1, 1),
                a_interval=f["a"].reshape(1, 1), a_neg_interval=f["a_neg"],
                postgelu=kinds[name] == "postgelu", **bits)
        else:
            G = f["b"].numel()
            split = f.get("split")
            a = (fq.div(split, q.a_qmax - 1) if split is not None
                 else f["a"].reshape(1, G, 1, 1, 1, 1, 1))
            out[name] = MatMulQP(A_interval=a,
                                 B_interval=f["b"].reshape(1, G, 1, 1, 1, 1,
                                                           1),
                                 split=split, A_bit=bits["a_bit"],
                                 B_bit=bits["a_bit"])
    return out


def plain_intervals(qp):
    """{field: tensor} of a program QP, in the reference's layout."""
    name = type(qp).__name__
    if name == "ConvQP":
        return {"w": qp.w_interval.reshape(-1)}
    if name == "LinearQP":
        return {"w": qp.w_interval.reshape(-1),
                "a": qp.a_interval.reshape(()),
                "a_neg": (None if qp.a_neg_interval is None
                          else qp.a_neg_interval.reshape(()))}
    if qp.split is not None:
        return {"split": qp.split.reshape(()),
                "b": qp.B_interval.reshape(-1)}
    return {"a": qp.A_interval.reshape(-1), "b": qp.B_interval.reshape(-1)}


def qstate_to_host(qstate):
    """A copy of a program qstate with every tensor field on the host."""
    return {n: None if qp is None else dataclasses.replace(
        qp, **{f.name: getattr(qp, f.name).cpu()
               for f in dataclasses.fields(qp)
               if torch.is_tensor(getattr(qp, f.name))})
            for n, qp in qstate.items()}
