"""serve_forward_idle_ms: the device's idle time inside the program's
``ptq.serve.forward`` spans (the engine's forward, from the input on the
card to the logits enqueued), per traced request, in ms."""
from benchmark.metrics import _spans


def read(run):
    tr, n = run.trace, run.records.get("traced_n")
    if tr is None or not n:
        return None
    spans = _spans.union(tr, "ptq.serve.forward")
    if not spans:
        return None
    return 1e3 * _spans.idle_s(tr, spans) / n
