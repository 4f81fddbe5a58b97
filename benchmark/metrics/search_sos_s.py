"""search_sos_s: the seconds of the traced job's searches of the
split-of-softmax matmuls (the calibrator's ``ptq.calib.search.sos_matmul``
spans; each ends after the op's device synchronize, so it covers the
op's device work)."""
from benchmark.metrics import _spans


def read(run):
    tr = run.trace
    if tr is None or not run.records.get("traced_job"):
        return None
    spans = _spans.union(tr, "ptq.calib.search.sos_matmul")
    if not spans:
        return None
    return _spans.length_s(spans)
