"""The work of the algorithm, from a configuration's op shapes: operations
and bytes of a PTQ4ViT calibration job and of a served forward, and the
published peaks of one NVIDIA H100 SXM.

Counted from the algorithm, not from an implementation: a kernel that
pads, re-reads or splits its work does not change these numbers.  A
multiply-add is two operations.  Each input byte is read once and each
output byte written once.

Calibration (PTQ4ViT W8A8, int8 scoring): every round scores ``eq_n``
candidates on each side of each op; a linear's or a matmul's candidate
is the op's whole product on integer levels (int8); the post-softmax
split search (20 splits, the other operand raw) and the patch
embedding's channelwise search are float32, as is the raw output each
search compares with.  The capture is one float32 forward and one
backward to the activations (about a forward's products again) over the
calibration images.

Serving: every quantized op's product on int8 levels; the attention of a
head (q k^T, softmax, p v) is one unit that reads q, k and v as int8 and
writes its context in bfloat16; a linear reads int8 input levels and
int8 weights and writes bfloat16.
"""
from __future__ import annotations

from typing import Dict, List

PEAKS = {
    "int8": 1979e12,      # dense int8 tensor-core operations / s
    "bf16": 989e12,       # dense bf16 tensor-core FLOP / s
    "fp32": 67e12,        # float32 FLOP / s outside the tensor cores
    "hbm": 3.35e12,       # bytes / s
}
PEAK_SOURCE = "NVIDIA H100 SXM data sheet, dense rates, 700 W"


def op_shapes(cfg) -> List[Dict]:
    """[{name, kind, ...}] of the quantized ops of a configuration's
    ``model`` group: linears (tokens T per image, ic, oc), matmuls (S
    samples per image, heads G, R x Ci times Ci x Co) and the patch
    embedding (a linear over T patches)."""
    ops = []
    img, p = cfg["img_size"], cfg["patch_size"]
    tp = (img // p) ** 2
    c0 = cfg["embed_dim"]
    hid = lambda d: int(d * cfg.get("mlp_ratio", 4.0))   # noqa: E731
    ops.append(dict(name="patch_embed.proj", kind="conv", T=tp,
                    ic=cfg.get("in_chans", 3) * p * p, oc=c0))

    def block(prefix, T, d, G, S, N):
        hd = d // G
        return [dict(name=f"{prefix}.attn.qkv", kind="qkv", T=T, ic=d,
                     oc=3 * d),
                dict(name=f"{prefix}.attn.matmul1", kind="matmul", S=S, G=G,
                     R=N, Ci=hd, Co=N),
                dict(name=f"{prefix}.attn.matmul2", kind="sos", S=S, G=G,
                     R=N, Ci=N, Co=hd),
                dict(name=f"{prefix}.attn.proj", kind="linear", T=T, ic=d,
                     oc=d),
                dict(name=f"{prefix}.mlp.fc1", kind="linear", T=T, ic=d,
                     oc=hid(d)),
                dict(name=f"{prefix}.mlp.fc2", kind="postgelu", T=T,
                     ic=hid(d), oc=d)]

    if cfg["kind"] == "vit":
        N = tp + 1
        for i in range(cfg["depth"]):
            ops += block(f"blocks.{i}", N, c0, cfg["num_heads"], 1, N)
        d_last = c0
    else:
        for i, depth in enumerate(cfg["depths"]):
            res = img // p // 2 ** i
            d = c0 * 2 ** i
            for j in range(depth):
                ws = min(cfg["window_size"], res)
                ops += block(f"layers.{i}.blocks.{j}", res * res, d,
                             cfg["num_heads"][i], (res // ws) ** 2, ws * ws)
            if i < len(cfg["depths"]) - 1:
                ops.append(dict(name=f"layers.{i}.downsample.reduction",
                                kind="linear", T=(res // 2) ** 2, ic=4 * d,
                                oc=2 * d))
        d_last = c0 * 2 ** (len(cfg["depths"]) - 1)
    ops.append(dict(name="head", kind="linear", T=1, ic=d_last,
                    oc=cfg.get("num_classes", 1000)))
    return ops


def macs(op) -> int:
    """Multiply-adds of the op's product for one image."""
    if op["kind"] in ("matmul", "sos"):
        return op["S"] * op["G"] * op["R"] * op["Ci"] * op["Co"]
    return op["T"] * op["ic"] * op["oc"]


def forward_flops(cfg) -> int:
    """Float operations of one image's forward (its products)."""
    return sum(2 * macs(op) for op in op_shapes(cfg))


def calib_work(cfg, images: int, eq_n: int = 100, rounds: int = 3,
               splits: int = 20) -> Dict[str, Dict[str, float]]:
    """{"search": {"int8", "fp32", "bytes", "least_s"}, "capture": {...}}
    of one job.  A search side reads the op's caches (bfloat16) and weight
    (float32) and writes one score per candidate and group (row block,
    head or channel) each round; ``least_s`` sums, op by op, the larger of
    its operations over their peaks and its bytes over the bandwidth."""
    s = {"int8": 0.0, "fp32": 0.0, "bytes": 0.0, "least_s": 0.0}
    for op in op_shapes(cfg):
        m = macs(op) * images
        w = {"int8": 0.0, "fp32": 2.0 * m}                   # raw output
        if op["kind"] in ("matmul", "sos"):
            n = op["S"] * op["G"] * images
            ins = n * (op["R"] * op["Ci"] + op["Ci"] * op["Co"]
                       + op["R"] * op["Co"]) * 2
            groups = op["G"]
        else:
            ins = op["T"] * images * (op["ic"] + op["oc"]) * 2 \
                + op["ic"] * op["oc"] * 4
            groups = {"qkv": 3, "conv": op["oc"]}.get(op["kind"], 1)
        if op["kind"] == "conv":
            w["fp32"] += rounds * eq_n * 2 * m
            sides = 1
        elif op["kind"] == "sos":
            w["fp32"] += rounds * splits * 2 * m
            w["int8"] += rounds * eq_n * 2 * m
            sides = 2
        else:
            w["int8"] += rounds * 2 * eq_n * 2 * m
            sides = 2
        w["bytes"] = rounds * sides * (ins + eq_n * groups * 4)
        for k in ("int8", "fp32", "bytes"):
            s[k] += w[k]
        s["least_s"] += least_seconds(w)
    cap = {"int8": 0.0, "fp32": 2.0 * forward_flops(cfg) * images,
           "bytes": 0.0}
    cap["least_s"] = least_seconds(cap)
    return {"search": s, "capture": cap}


def serve_work(cfg, images: int) -> Dict[str, float]:
    """{"int8", "bytes", "least_s"} of one request of ``images``: the
    least time sums, op by op, the larger of its products over the int8
    peak and its bytes over the bandwidth."""
    ops = op_shapes(cfg)
    by = {op["name"]: op for op in ops}
    total, nbytes, least = 0.0, 0.0, 0.0
    for op in ops:
        if op["kind"] == "sos":
            continue
        if op["kind"] == "matmul":
            m2 = by[op["name"].replace("matmul1", "matmul2")]
            o = 2 * (macs(op) + macs(m2)) * images
            n = op["S"] * op["G"] * images
            b = n * op["R"] * op["Ci"] * 3 + n * op["R"] * m2["Co"] * 2
        else:
            o = 2 * macs(op) * images
            b = op["T"] * images * (op["ic"] + 2 * op["oc"]) \
                + op["ic"] * op["oc"]
        total += o
        nbytes += b
        least += max(o / PEAKS["int8"], b / PEAKS["hbm"])
    return {"int8": total, "bytes": nbytes, "least_s": least}


def least_seconds(work: Dict[str, float]) -> float:
    """The larger of a work item's operations over their peaks and its
    bytes over the bandwidth."""
    t_ops = work.get("int8", 0.0) / PEAKS["int8"] \
        + work.get("fp32", 0.0) / PEAKS["fp32"]
    return max(t_ops, work.get("bytes", 0.0) / PEAKS["hbm"])


def peak_seconds(work: Dict[str, float]) -> float:
    """Operations over their peaks: the time at the published peak."""
    return work.get("int8", 0.0) / PEAKS["int8"] \
        + work.get("fp32", 0.0) / PEAKS["fp32"]
