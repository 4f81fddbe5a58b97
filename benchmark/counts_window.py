"""The work of a served forward's window attention, from a windowed
configuration's op shapes (``counts.op_shapes``), for the window
attention kernels' roofline (``metrics/win_attn_roofline.py``), and the
bytes of Swin V2's res-post-norms for theirs
(``metrics/postnorm_roofline.py``).

A head of a window is one unit, as ``counts.serve_work`` counts it: both
products on int8 levels (q k^T and p v, a multiply-add two operations),
q, k and v read as int8 and the context written in bfloat16.  Besides,
the logits take an additive float32 term (the relative-position bias,
Swin V2's continuous position bias, and the shifted-window mask): a
block's term is fixed, (heads, N, N) or, shifted, (windows, heads, N, N),
and is counted once a request, as the least any kernel must read.
"""
from __future__ import annotations

from typing import Dict

from .counts import PEAKS, macs, op_shapes


def shifted(cfg, name: str) -> bool:
    """Whether block ``layers.i.blocks.j`` shifts its windows: odd blocks,
    where the stage's map holds more than one window."""
    parts = name.split(".")
    i, j = int(parts[1]), int(parts[3])
    res = cfg["img_size"] // cfg["patch_size"] // 2 ** i
    return j % 2 == 1 and res > cfg["window_size"]


def window_work(cfg, images: int) -> Dict[str, float]:
    """{"int8", "bytes", "least_s"} of one request's window attention;
    the least time sums, block by block, the larger of its products over
    the int8 peak and its bytes over the bandwidth."""
    ops = op_shapes(cfg)
    by = {op["name"]: op for op in ops}
    total, nbytes, least = 0.0, 0.0, 0.0
    for op in ops:
        if op["kind"] != "matmul":
            continue
        m2 = by[op["name"].replace("matmul1", "matmul2")]
        o = 2 * (macs(op) + macs(m2)) * images
        n = op["S"] * op["G"] * images
        term = (op["S"] if shifted(cfg, op["name"]) else 1) * op["G"] \
            * op["R"] * op["Co"] * 4
        b = n * op["R"] * op["Ci"] * 3 + n * op["R"] * m2["Co"] * 2 + term
        total += o
        nbytes += b
        least += max(o / PEAKS["int8"], b / PEAKS["hbm"])
    return {"int8": total, "bytes": nbytes, "least_s": least}


def row_epilogue_work(cfg, images: int) -> Dict[str, float]:
    """{"postnorm"}: the least seconds of a request's Swin V2
    res-post-norms, bound by their bytes (a few operations a byte): they
    read proj's int32 sums and fc2's two planes (tokens x C x 4 x 3) and
    each one's bfloat16 residual, and write the bfloat16 stream, twice a
    block."""
    post = 0.0
    for op in op_shapes(cfg):
        if op["name"].endswith("attn.proj"):
            post += op["T"] * images * op["oc"] * (4 * 3 + 2 * 2 * 2)
    return {"postnorm": post / PEAKS["hbm"]}

