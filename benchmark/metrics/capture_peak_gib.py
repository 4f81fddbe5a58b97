"""capture_peak_gib: the device memory allocated at its peak by the end
of a capture pass (the program's ``CalibReport.capture_peak_bytes``),
the highest over the window's jobs, in GiB; nothing off the card."""


def read(run):
    jobs = list(run.records.get("jobs") or [])
    if run.records.get("traced_job"):
        jobs.append(run.records["traced_job"])
    peak = max((j[3].capture_peak_bytes for j in jobs), default=0)
    return peak / 2 ** 30 if peak else None
