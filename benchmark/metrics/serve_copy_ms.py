"""serve_copy_ms: device time of the host-to-device copies per traced
request (the profiler's Memcpy HtoD events), in ms."""


def read(run):
    tr = run.trace
    n = run.records.get("traced_n")
    if tr is None or not n:
        return None
    copies = [te - ts for ts, te, name, cat in tr.device
              if cat == "gpu_memcpy" and "HtoD" in name]
    if not copies:
        return None
    return sum(copies) / 1e3 / n
