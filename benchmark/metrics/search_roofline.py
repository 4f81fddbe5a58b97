"""search_roofline: the least time of a job's search work (counts.py,
from the op shapes) over the device time of every kernel that starts in
the traced job's ``bench.search`` spans, in percent of the roofline."""
from benchmark import counts


def read(run):
    tr = run.trace
    if tr is None or not tr.spans.get("bench.search"):
        return None
    busy = sum(te - ts for ts, te, _, cat in tr.in_spans("bench.search")
               if cat == "kernel") / 1e6
    if busy <= 0:
        return None
    mix = run.mix
    work = counts.calib_work(run.cfg, mix["images"], mix.get("eq_n", 100),
                             mix.get("search_round", 3))
    return 100.0 * work["search"]["least_s"] / busy
