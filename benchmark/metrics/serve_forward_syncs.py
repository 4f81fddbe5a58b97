"""serve_forward_syncs: the runtime calls that make the host wait for the
device (stream, device and event synchronizes, and the synchronous
``cudaMemcpy``) starting inside the program's ``ptq.serve.forward``
spans, per traced request."""
from benchmark.metrics import _spans

SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")


def read(run):
    tr, n = run.trace, run.records.get("traced_n")
    if tr is None or not n:
        return None
    spans = _spans.union(tr, "ptq.serve.forward")
    if not spans:
        return None
    return _spans.starting_in(tr, spans, SYNCS) / n
