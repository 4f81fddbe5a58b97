"""capture_idle_s: the device's idle seconds inside the calibrator's
``ptq.calib.capture`` spans (each capture pass, ending in a device
synchronize) and ``ptq.calib.release`` spans (each ``empty_cache``, which
frees the caching allocator's free blocks on the device), in the traced
job."""
from benchmark.metrics import _spans


def read(run):
    tr = run.trace
    if tr is None or not run.records.get("traced_job"):
        return None
    spans = _spans.union(tr, "ptq.calib.capture", "ptq.calib.release")
    if not spans:
        return None
    return _spans.idle_s(tr, spans)
