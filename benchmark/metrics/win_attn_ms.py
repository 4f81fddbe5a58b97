"""win_attn_ms: device time of the window attention kernels (B9,
``metrics/_window.py``) per traced request, in ms."""
from benchmark.metrics import _window


def read(run):
    tr, n = run.trace, run.records.get("traced_n")
    if tr is None or not n:
        return None
    s = _window.kernel_s(tr)
    return 1e3 * s / n if s > 0 else None
