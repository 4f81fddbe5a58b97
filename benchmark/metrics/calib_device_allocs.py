"""calib_device_allocs: the device allocations (``cudaMalloc`` calls) the
caching allocator made during a calibration job (the program's
``CalibReport.device_allocs``), averaged over the window's untraced jobs
(the traced job where there is no other)."""


def read(run):
    jobs = run.records.get("jobs") or [j for j in [
        run.records.get("traced_job")] if j]
    counts = [getattr(j[3], "device_allocs", None) for j in jobs]
    if not counts or None in counts:
        return None
    return sum(counts) / len(counts)
