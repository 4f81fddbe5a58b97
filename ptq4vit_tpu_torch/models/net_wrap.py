"""The reference's module-walk order, which sequential calibration steps
through.

A copy of ``reference_wrap_order`` from ``ptq4vit_tpu/models/net_wrap.py``
(framework-neutral; importing the JAX package would load JAX).
"""
from __future__ import annotations


def reference_wrap_order(pairs):
    """Reorder (op name, module type) pairs into the reference's module-walk
    order, which is what its SEQUENTIAL calibration steps through.

    The reference wraps modules in ``net.named_modules()`` order
    (net_wrap.py:44) and its calibrators "assume wrapped modules are in
    order" (quant_calib.py:316).  Because the patched ``matmul1``/``matmul2``
    are ``setattr``-ed onto the timm attention AFTER its native children
    (utils/models.py:81-86), that order within every attention is
    ``qkv, proj, matmul1, matmul2`` — i.e. ``proj`` is calibrated BEFORE the
    matmuls even though it consumes their output.  This is load-bearing in
    sequential mode: once ``proj`` is in quant_forward, the eps-probe
    gradient of the matmuls dies at proj's round() (derivative 0), so their
    hessian score curves are constant and the searches degenerate to the
    first candidate — the reference's actual behavior, pinned by the
    sequential differential golden.  Everywhere else the dataflow order the
    op inventory uses coincides with the module walk.
    """
    _RANK = {"qkv": 0, "proj": 1, "matmul1": 2, "matmul2": 3}
    first = {}
    keys = []
    for i, (n, _) in enumerate(pairs):
        scope, _sep, leaf = n.rpartition(".")
        if scope.endswith("attn") and leaf in _RANK:
            keys.append((first.setdefault(scope, i), _RANK[leaf]))
        else:
            keys.append((i, -1))
    return [p for _, p in sorted(zip(keys, pairs), key=lambda t: t[0])]
