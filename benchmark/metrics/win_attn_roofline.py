"""win_attn_roofline: the least time of the traced requests' window
attention (both products at the int8 peak; q, k, v, the context and each
block's additive term at the bandwidth; ``counts_window.py``) over the
device time of the window attention kernels (``metrics/_window.py``), in
percent."""
from benchmark import counts_window
from benchmark.metrics import _window


def read(run):
    tr, n = run.trace, run.records.get("traced_n")
    if tr is None or not n or run.cfg["kind"] == "vit":
        return None
    busy = _window.kernel_s(tr)
    if busy <= 0:
        return None
    least = counts_window.window_work(run.cfg, run.mix["batch"])["least_s"]
    return 100.0 * least * n / busy
