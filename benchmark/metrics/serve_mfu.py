"""serve_mfu: the forward work of the run's untraced requests (int8
products, counts.py) at the published int8 peak, over their time on the
host clock, in percent."""
from benchmark import counts


def read(run):
    lat = run.records.get("latency")
    outs = run.records.get("outs")
    if not lat:
        return None
    traced = run.records.get("traced", range(0))
    keep = [i for i, o in enumerate(outs) if o is not None and i not in traced]
    wall = sum(lat[i] for i in keep)
    if not wall:
        return None
    images = sum(outs[i].shape[0] for i in keep)
    per_image = counts.peak_seconds(counts.serve_work(run.cfg, 1))
    return 100.0 * per_image * images / wall
