"""serve_launches: device kernels, copies and memsets per traced
request, counted from the profiler's device events."""


def read(run):
    tr = run.trace
    n = run.records.get("traced_n")
    if tr is None or not n or not tr.device:
        return None
    return len(tr.device) / n
