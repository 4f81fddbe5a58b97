"""serve_roofline: the least time of the traced requests' forward work
(counts.py, from the op shapes) over the device time of every kernel in
the traced sub-window, in percent of the roofline; copies are the
engine's layer (serve_copy_ms)."""
from benchmark import counts


def read(run):
    tr = run.trace
    if tr is None or not run.records.get("traced_n"):
        return None
    busy = sum(te - ts for ts, te, _, cat in tr.device
               if cat == "kernel") / 1e6
    if busy <= 0:
        return None
    least = counts.serve_work(run.cfg, run.mix["batch"])["least_s"]
    return 100.0 * least * run.records["traced_n"] / busy
