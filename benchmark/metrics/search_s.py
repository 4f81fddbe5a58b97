"""search_s: seconds of the searches per calibration job, the program's
own ``CalibReport.search_seconds`` summed (each op's search ends in a
device synchronize), averaged over the window's untraced jobs (the
traced job where there is no other)."""


def read(run):
    jobs = run.records.get("jobs") or [j for j in [
        run.records.get("traced_job")] if j]
    reports = [j[3] for j in jobs]
    if not reports or not any(r.search_seconds for r in reports):
        return None
    return sum(sum(r.search_seconds.values()) for r in reports) / len(reports)
