"""Kernels of the window path in a traced window, picked by their name,
since the trace's device events carry no link to the spans that launched
them: B9's WINDOW instances of ``attention_kernel``
(``attention_kernel<true, ...>``) and Swin V2's res-post-norm."""
import re

from benchmark.trace import short

WINDOW_KERNEL = re.compile(r"^attention_kernel<true\b")


def kernel_s(tr, pattern=WINDOW_KERNEL):
    """Seconds of the kernels whose short name matches ``pattern`` (by
    default the window attention's) in a trace."""
    return sum(te - ts for ts, te, name, cat in tr.device
               if cat == "kernel" and re.match(pattern, short(name))) / 1e6


def row_roofline(run, kernel, work, key):
    """The least time ``work(cfg, images)[key]`` of the traced requests
    over the device time of the kernels named ``kernel`` (a template's
    instances included), in percent; None where none ran."""
    tr, n = run.trace, run.records.get("traced_n")
    if tr is None or not n:
        return None
    busy = kernel_s(tr, re.escape(kernel) + r"\b")
    if busy <= 0:
        return None
    return 100.0 * work(run.cfg, run.mix["batch"])[key] * n / busy
